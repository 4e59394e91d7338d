"""Learning-rate schedules, port of the JAX package's ``train/schedules.py``:
step -> learning rate, evaluated in fp32 as the JAX schedules are (a 0-dim
fp32 tensor).

  * CosineDecayRestarts (the CLI's CALR) — tf.keras CosineDecayRestarts of
    reference train_model.py:113-116 (t_mul, m_mul, alpha);
  * CyclicLR (triangular / triangular2 / exp_range) — callbacks.py:123-191;
  * PolyLR (nnU-Net) — callbacks.py:105-119;
  * ReduceLR piecewise schedule — callbacks.py:79-101.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_decay_restarts(initial_learning_rate: float, first_decay_steps: int,
                          t_mul: float = 2.0, m_mul: float = 1.0,
                          alpha: float = 0.0) -> Schedule:
    """SGDR cosine decay with warm restarts (TF CosineDecayRestarts parity)."""

    def schedule(step):
        completed = _f32(step) / float(first_decay_steps)
        if t_mul == 1.0:
            i_restart = torch.floor(completed)
            frac = completed - i_restart
        else:
            i_restart = torch.floor(
                torch.log(torch.clamp(1.0 - completed * (1.0 - t_mul), min=1e-30))
                / math.log(t_mul))
            sum_r = (1.0 - t_mul ** i_restart) / (1.0 - t_mul)
            frac = (completed - sum_r) / (t_mul ** i_restart)
        m_fac = m_mul ** i_restart
        cosine_decayed = 0.5 * m_fac * (1.0 + torch.cos(math.pi * frac))
        decayed = (1.0 - alpha) * cosine_decayed + alpha
        return initial_learning_rate * decayed

    return schedule


def cyclic_lr(base_lr: float = 0.001, max_lr: float = 0.006, step_size: float = 2000.0,
              mode: str = "triangular", gamma: float = 1.0) -> Schedule:
    """Per-step cyclic LR (reference callbacks.py:123-191)."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"Unknown CLR mode: {mode!r}")

    def schedule(step):
        it = _f32(step)
        cycle = torch.floor(1.0 + it / (2.0 * step_size))
        x = torch.abs(it / step_size - 2.0 * cycle + 1.0)
        amp = torch.clamp(1.0 - x, min=0.0)
        if mode == "triangular":
            scale = 1.0
        elif mode == "triangular2":
            scale = 1.0 / (2.0 ** (cycle - 1.0))
        else:
            scale = gamma ** it
        return base_lr + (max_lr - base_lr) * amp * scale

    return schedule


def poly_lr(initial_lr: float, exponent: float, max_epochs: int,
            steps_per_epoch: int) -> Schedule:
    """nnU-Net poly decay per epoch (reference callbacks.py:105-119)."""

    def schedule(step):
        epoch = torch.floor(_f32(step) / steps_per_epoch)
        return initial_lr * (1.0 - epoch / max_epochs) ** exponent

    return schedule


def piecewise_epoch_lr(lr_rates: Sequence[float], epoch_points: Sequence[int],
                       steps_per_epoch: int) -> Schedule:
    """ReduceLR_Schedule parity (reference callbacks.py:79-101): a step
    function of (epoch + 1) over the breakpoints."""
    if len(lr_rates) != len(epoch_points):
        raise ValueError("lr_rates and epoch_points differ in length")

    def schedule(step):
        epoch1 = torch.floor(_f32(step) / steps_per_epoch) + 1.0
        lr = _f32(lr_rates[0])
        for rate, point in zip(lr_rates, epoch_points):
            lr = torch.where(epoch1 >= point, _f32(rate), lr)
        return lr

    return schedule


def build_schedule(lr_mode: str = "CALR", base_lr: float = 1e-3, steps_per_epoch: int = 1,
                   num_epochs: int = 250, calr_params=(2.0, 1.0, 1e-3),
                   clr_params=(5e-5, 1.0, 1.25)) -> Schedule:
    """The reference's LR menu (train_model.py:113-117, 246-251; the JAX
    ``trainer.build_schedule``): CALR, CLR, or a constant."""
    if lr_mode == "CALR":
        return cosine_decay_restarts(
            base_lr, first_decay_steps=steps_per_epoch * num_epochs,
            t_mul=calr_params[0], m_mul=calr_params[1], alpha=calr_params[2])
    if lr_mode == "CLR":
        return cyclic_lr(base_lr=base_lr, max_lr=clr_params[0], mode="exp_range",
                         gamma=clr_params[1], step_size=steps_per_epoch * clr_params[2])
    return lambda step: _f32(base_lr)
