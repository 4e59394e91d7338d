"""Training objectives, port of the JAX package's ``losses.py`` (reference
tf2.5/scripts/model/losses.py):

  * Focal                       — losses.py:20-49 (per-class alpha, gamma)
  * EvidenceLowerBound          — losses.py:52-63 (beta * sum of the KL)
  * SoftDicePlusBoundarySurface — losses.py:66-128 (soft Dice over classes
                                  1.. + the boundary loss on a signed EDT)

Plain torch ops, fp32, differentiated by autograd. Every loss takes the
deep-supervision layout: where y_pred carries G * num_classes channels the
loss is averaged over the G groups. Clipping is ``minimum(maximum(.))`` as
``jnp.clip`` is, so a value on a bound passes half its gradient, as in JAX.

The boundary loss takes the signed EDT of y_true[..., 1:] as ``dist_map``;
without one it computes it on the host (``ops.edt``), the counterpart of
the JAX package's ``jax.pure_callback`` (and of the reference's
``tf.py_function``).

Data parallelism: with ``axis`` (a ``parallel.collectives.Axis`` over
which the batch's rows are split) each loss is the GLOBAL batch's, as the
JAX package's step over a sharded batch computes it: the focal mean is the
psum of the local sums over the global batch size, the soft Dice's
intersect and denominator are psum'd before the ratio, and the boundary
term is a psum'd sum. Every rank gets the same value; the psum's gradient
sums the ranks' cotangents (``collectives.psum``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch

EPSILON = 1e-7  # tf.keras.backend.epsilon()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jnp.clip: minimum(maximum(x, lo), hi); a tie splits the gradient
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None:
        return x
    from .parallel.collectives import psum

    return psum(x, axis)


def _group_reduce(loss_fn, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Average a per-prediction loss over deep-supervision channel groups."""
    nc = y_true.shape[-1]
    groups = y_pred.shape[-1] // nc
    vals = [loss_fn(y_true, y_pred[..., i * nc:(i + 1) * nc]) for i in range(groups)]
    return torch.mean(torch.stack(vals))


class Focal:
    """Focal loss (reference losses.py:20-49)."""

    def __init__(self, alpha: Sequence[float] = (0.25, 0.75), gamma: float = 2.0):
        self.alpha = tuple(alpha)
        self.gamma = float(gamma)

    def per_sample_sums(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        """Per-sample focal sums, shape (B,): the partial before the batch mean."""
        w = torch.tensor(self.alpha, dtype=torch.float32, device=y_pred.device)
        y_pred = y_pred.float()
        y_true = torch.as_tensor(y_true, device=y_pred.device).float()
        y_pred = y_pred / torch.sum(y_pred, dim=-1, keepdim=True)
        y_pred = _clip(y_pred, EPSILON, 1.0 - EPSILON)
        ce = y_true * (-torch.log(y_pred))
        gamma_weight = y_true * torch.pow(1.0 - y_pred, self.gamma)
        fl = w * gamma_weight * ce
        return torch.sum(fl, dim=tuple(range(1, fl.dim())))

    def fl(self, y_true: torch.Tensor, y_pred: torch.Tensor, axis=None) -> torch.Tensor:
        """Sum over voxels and classes, mean over the (global) batch
        (losses.py:32-39)."""
        sums = self.per_sample_sums(y_true, y_pred)
        if axis is None:
            return torch.mean(sums)
        return _psum(torch.sum(sums), axis) / (sums.shape[0] * axis.size)

    def __call__(self, y_true: torch.Tensor, y_pred: torch.Tensor, axis=None) -> torch.Tensor:
        return _group_reduce(partial(self.fl, axis=axis), y_true, y_pred)

    loss = __call__


class EvidenceLowerBound:
    """beta * sum(KL) pass-through (reference losses.py:52-63)."""

    def __init__(self, beta: float = 1.0):
        self.beta = float(beta)

    def __call__(self, y_true, y_pred) -> torch.Tensor:
        del y_true  # the reference ignores the target (losses.py:62-63)
        return self.beta * torch.sum(y_pred)

    loss = __call__


class SoftDicePlusBoundarySurface:
    """Soft Dice + boundary/surface loss (reference losses.py:66-128).

    ``dist_map`` (the signed EDT of y_true[..., 1:], shape == y_true[..., 1:])
    may be passed precomputed; otherwise the host computes it with
    ``ops.edt.signed_distance_map`` on every call.
    """

    def __init__(self, loss_weights: Sequence[float] = (1.0, 1.5), smooth: float = EPSILON):
        self.loss_weights = tuple(loss_weights)
        self.smooth = float(smooth)

    @staticmethod
    def _norm_pred(y_pred: torch.Tensor) -> torch.Tensor:
        y_pred = y_pred.float()
        y_pred = y_pred / torch.sum(y_pred, dim=-1, keepdim=True)
        return _clip(y_pred, EPSILON, 1.0 - EPSILON)

    def dice_loss(self, y_true: torch.Tensor, y_pred: torch.Tensor, axis=None) -> torch.Tensor:
        """Global (flattened) soft Dice over classes 1.. (losses.py:99-106)."""
        y_pred = self._norm_pred(y_pred)
        yt = torch.as_tensor(y_true, device=y_pred.device)[..., 1:].float().reshape(-1)
        yp = y_pred[..., 1:].reshape(-1)
        intersect = _psum(torch.sum(yt * yp), axis)
        denom = _psum(torch.sum(yt + yp), axis)
        return 1.0 - (2.0 * intersect / (denom + self.smooth))

    def boundary_surface_loss(self, y_true: torch.Tensor, y_pred: torch.Tensor,
                              dist_map: Optional[torch.Tensor] = None,
                              axis=None) -> torch.Tensor:
        """sum(softmax[..., 1:] * signed_EDT(y_true[..., 1:])) (losses.py:109-113)."""
        y_pred = self._norm_pred(y_pred)
        if dist_map is None:
            from .ops.edt import signed_distance_map

            fg = torch.as_tensor(y_true)[..., 1:].detach().float().cpu().numpy()
            dist_map = torch.from_numpy(signed_distance_map(fg))
        dist_map = torch.as_tensor(dist_map, device=y_pred.device).float()
        return _psum(torch.sum(y_pred[..., 1:] * dist_map), axis)

    def db(self, y_true, y_pred, dist_map=None, axis=None) -> torch.Tensor:
        return self.loss_weights[0] * self.dice_loss(y_true, y_pred, axis) + \
            self.loss_weights[1] * self.boundary_surface_loss(y_true, y_pred, dist_map, axis)

    def __call__(self, y_true, y_pred, dist_map=None, axis=None) -> torch.Tensor:
        return _group_reduce(partial(self.db, dist_map=dist_map, axis=axis), y_true, y_pred)

    loss = __call__
