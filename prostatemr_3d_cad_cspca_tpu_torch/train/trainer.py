"""The train step and the fit loop, port of the JAX package's
``train/trainer.py``.

One step is the reference's Keras ``compile``/``fit`` step (train_model.py:
230-259): the forward in training mode (+ KL), the focal or Dice/boundary
loss, the L2 terms, the backward through the hand-written kernels (K1/K2
data gradients, K6 weight gradients, K7 instance-norm gradients; see
``ops``), and the optimizer. Where the JAX step is one jitted, donated
program, the port runs eagerly and updates the module's parameters and the
optimizer state in place.

Optimizers follow optax's two-call shape: ``init(params)`` and
``update(grads, state, params) -> (updates, state)``, over ``{name:
tensor}`` mappings keyed by the parameters' '.'-joined paths (the flax
keypaths). Adam is the Keras-exact amsgrad of the JAX package
(``scale_by_keras_amsgrad``): ``torch.optim.Adam(amsgrad=True)`` maxes the
bias-corrected second moment and puts eps elsewhere, which the reference
does not.

Random bits: ``rng`` is a ``torch.Generator`` on the model's device, an int
seed, or a mapping of keep-masks and latents (see ``prng``); the multi-step
programs give step (or microbatch) i ``fold_in(rng, i)``, or take a
sequence of one ``rng`` a step.

``fit`` is the epoch loop around the step (WeightsSaver npz files,
train-time validation, full-state checkpoints from ``train.checkpoint``,
a metrics stream), and ``resume_training`` reloads the latest npz of a
fold; see ``fit`` for where it differs from the JAX loop.

On a mesh (``parallel.mesh``, one process a position) the step is the JAX
step's SPMD program over a ``data``-sharded global batch: every rank takes
the same global batch and draws, keeps its ``data`` rows of both, and
computes the GLOBAL batch's loss (``losses`` with the data axis; the KL's
batch mean likewise); it differentiates that loss over the mesh's size,
and the gradients are summed over the mesh (one all-reduce), so each
rank's update is the global batch's and the L2 term counts once. A state
sharded over ``model`` (``parallel.sharding.shard_state``) keeps only its
slice of the wide parameters and their moments: the step gathers them for
the forward, keeps its slice of their summed gradients and updates it.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import prng
from ..augment import as_params, augment_batch
from ..device import resolve_device
from ..losses import Focal, SoftDicePlusBoundarySurface
from ..ops.convolution import l2_penalty
from .schedules import build_schedule  # noqa: F401  (the JAX trainer's surface)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The module (whose parameters the step updates in place), the
    optimizer's state and the number of steps taken; under tensor
    parallelism ``shards`` holds this rank's ``model`` slices of the wide
    parameters, which the optimizer's state mirrors
    (``parallel.sharding.shard_state``)."""

    module: nn.Module
    opt_state: Any
    step: int
    shards: Optional[Dict[str, Any]] = None

    @property
    def params(self) -> Params:
        return dict(self.module.named_parameters())


def _lr_at(learning_rate, count: int) -> torch.Tensor:
    # optax.scale_by_learning_rate: a schedule reads the update count
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    return torch.as_tensor(lr, dtype=torch.float32)


class KerasAmsgrad:
    """Adam + amsgrad with tf.keras update semantics (the JAX package's
    ``keras_amsgrad``; reference train_model.py:120-121 -> keras
    optimizer_v2/adam.py):

        m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2;   vhat = max(vhat, v)
        update = -lr * [sqrt(1 - b2^t) / (1 - b1^t)] * m / (sqrt(vhat) + eps)

    the max taken over the RAW second moment, eps outside the square root
    and not bias-corrected; in fp32, in the JAX package's order."""

    def __init__(self, learning_rate: Any = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return dict(count=0, mu=zeros(), nu=zeros(), nu_hat=zeros())

    def update(self, grads: Params, state, params=None):
        """One update, leaf by leaf as the JAX package's tree_map, run as
        multi-tensor (``torch._foreach_*``) ops: the same fp32 operations,
        a dozen launches for all leaves."""
        del params
        b1, b2 = self.b1, self.b2
        keys = list(grads)
        g = [grads[k] for k in keys]
        count = state["count"] + 1
        c = torch.tensor(float(count), dtype=torch.float32)
        bc = float(torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c))  # an fp32 value
        lr = float(_lr_at(self.learning_rate, state["count"]))
        mu = torch._foreach_add(torch._foreach_mul([state["mu"][k] for k in keys], b1),
                                torch._foreach_mul(g, 1.0 - b1))
        nu = torch._foreach_add(torch._foreach_mul([state["nu"][k] for k in keys], b2),
                                torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        nu_hat = torch._foreach_maximum([state["nu_hat"][k] for k in keys], nu)
        upd = torch._foreach_div(torch._foreach_mul(mu, bc),
                                 torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        upd = torch._foreach_mul(upd, -lr)
        return dict(zip(keys, upd)), dict(count=count, mu=dict(zip(keys, mu)),
                                          nu=dict(zip(keys, nu)),
                                          nu_hat=dict(zip(keys, nu_hat)))


class SGDNesterov:
    """optax.sgd(momentum=0.9, nesterov=True) (reference train_model.py:121):
    t = g + 0.9 t;  update = -lr * (g + 0.9 t)."""

    def __init__(self, learning_rate: Any = 1e-3, momentum: float = 0.9):
        self.learning_rate, self.momentum = learning_rate, momentum

    def init(self, params: Params) -> Dict[str, Any]:
        return dict(count=0, trace={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, grads: Params, state, params=None):
        del params
        lr = _lr_at(self.learning_rate, state["count"])
        trace, updates = {}, {}
        for k, g in grads.items():
            trace[k] = g + self.momentum * state["trace"][k]
            updates[k] = (g + self.momentum * trace[k]) * (-lr).to(g.device)
        return updates, dict(count=state["count"] + 1, trace=trace)


def module_path(name: str) -> str:
    """The two-level module path of a parameter (the JAX package's
    ``path[:2]`` joined by '/')."""
    return "/".join(name.split(".")[:2])


class FreezeFirst:
    """--FREEZE_LAYERS (reference train_model.py:211-215; the JAX
    ``optax.multi_transform`` with ``set_to_zero``): the first ``n``
    two-level module paths, sorted, get zero updates; the inner optimizer
    sees only the other parameters."""

    def __init__(self, inner, n: int):
        self.inner, self.n = inner, int(n)

    def frozen(self, params) -> set:
        modules = sorted({module_path(k) for k in params})
        return set(modules[:self.n])

    def _train(self, tree, params):
        frozen = self.frozen(params)
        return {k: v for k, v in tree.items() if module_path(k) not in frozen}

    def init(self, params: Params):
        return self.inner.init(self._train(params, params))

    def update(self, grads: Params, state, params: Params):
        updates, state = self.inner.update(self._train(grads, params), state,
                                           self._train(params, params))
        return {k: updates.get(k, torch.zeros_like(g)) for k, g in grads.items()}, state


def make_optimizer(name: str = "adam", learning_rate: Any = 1e-3,
                   freeze_first_n: Optional[int] = None, **kwargs):
    """The reference's optimizer menu (train_model.py:120-121): Keras-exact
    Adam + amsgrad (eps 1e-7) or SGD + Nesterov momentum 0.9;
    ``freeze_first_n`` as :class:`FreezeFirst` (0 and 9999 freeze nothing)."""
    if name == "adam":
        kwargs.setdefault("eps", 1e-7)
        tx = KerasAmsgrad(learning_rate, **kwargs)
    elif name in ("momentum", "sgd"):
        tx = SGDNesterov(learning_rate, **kwargs)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    if freeze_first_n is not None and freeze_first_n not in (0, 9999):
        tx = FreezeFirst(tx, freeze_first_n)
    return tx


def make_loss(loss_mode: str = "distribution_focal", focal_alpha=(1.0, 1.0),
              focal_gamma: float = 2.0, dsc_bd_weights=(0.5, 0.5)) -> Callable:
    """The reference's loss menu (train_model.py:124-125)."""
    if loss_mode == "distribution_focal":
        return Focal(alpha=focal_alpha, gamma=focal_gamma).loss
    if loss_mode == "region_boundary":
        return SoftDicePlusBoundarySurface(loss_weights=dsc_bd_weights).loss
    raise ValueError(f"Unknown loss mode {loss_mode!r}")


def _on(x, device):
    if isinstance(x, (tuple, list)):  # a cascade's (image_1, image_2)
        return tuple(_on(t, device) for t in x)
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device).contiguous()


def _leading(tree) -> int:
    return int((tree[0] if isinstance(tree, (tuple, list)) else tree).shape[0])


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


def _step_rngs(rng, k: int, device):
    """One rng a step: the given sequence, or fold_in(rng, i)."""
    if isinstance(rng, (list, tuple)):
        if len(rng) != k:
            raise ValueError(f"{len(rng)} rngs for {k} steps")
        return [prng.as_rng(r, device) for r in rng]
    rng = prng.as_rng(rng, device)
    if rng is None:
        return [None] * k
    return [prng.fold_in(rng, i) for i in range(k)]


def _mesh_axes(mesh):
    """(data axis, mesh group, mesh size) of a mesh step; raises where this
    process cannot run one."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} holds no position of {mesh}")
    if mesh.size > 1 and not mesh.distributed:
        raise ValueError(
            f"a train step over {mesh.size} mesh positions runs one process a position: "
            "initialize_distributed() (or spawn the ranks, as the CLI's --GPU_DEVICE_IDs "
            "does) before make_mesh")
    return mesh.axis("data"), mesh.group, mesh.size


def make_train_step(model, seg_loss: Callable, optimizer, elbo_beta: float = 10.0,
                    loss_weights=(1.0,), mesh=None, augment_params=None,
                    train_obj: str = "lesion", scan_steps: Optional[int] = None,
                    accum_steps: Optional[int] = None):
    """The train step of an M1 (single-stage or cascaded), as the JAX
    package's: ``step(state, batch, rng) -> (state, metrics)``.

    The loss mirrors compile(loss=LOSSES, loss_weights=[1, beta])
    (train_model.py:126-131, 230-231) plus the L2 terms on every conv
    (networks.py:47-48): deterministic ``w * seg(y_softmax)``; probabilistic
    ``+ elbo_beta * prob_kl`` on ``prob_softmax``; cascaded ``w *
    (seg(detection_1) + seg(detection_2))`` (``+ elbo_beta * (KL_1 + KL_2)``
    for probabilistic stages). ``batch`` holds 'image' (a pair for a
    cascade) and 'detection', and may hold 'dist_map' for a loss that takes
    one; metrics are 0-dim tensors: seg_loss, reg, loss (+ kl).

    ``augment_params`` (an ``AugmentParams`` or the CLI's list): the batch
    is augmented on the device after it is moved there and before the
    forward (``augment.augment_batch`` for the task ``train_obj``), a
    'dist_map' warped with its label; the draws come from
    ``prng.augment_rng(rng)``, so the forward draws what a step without
    augmentation draws. A cascade with ``augment_params`` raises
    ``ValueError``.

    ``mesh`` (``parallel.mesh.Mesh``, one process a position): the step of
    the module docstring. ``batch`` and ``rng`` are the global batch's, the
    same on every rank; each rank keeps its ``data`` rows of the batch and
    of every draw (``prng.rows``), so the draws are the one-process step's.
    ``seg_loss`` must take ``axis`` (the package's losses do) where the
    data axis is wider than 1. The metrics are the global batch's.

    ``scan_steps=K``: ``step(state, batches, rng)`` runs K optimizer steps
    over batches with a leading K axis, metrics stacked (K,). ``accum_steps
    =K``: K microbatches' gradients summed in order and averaged, one
    update, metrics averaged. The state is updated in place.
    """
    if scan_steps is not None and accum_steps is not None:
        raise ValueError("scan_steps and accum_steps are mutually exclusive")
    cfg = model.config
    probabilistic, cascaded = bool(cfg["probabilistic"]), bool(cfg["cascaded"])
    augment = None if augment_params is None else as_params(augment_params)
    if augment is not None and cascaded:
        # the JAX step fails here too: it reads batch["image"].shape[0] of a pair
        raise ValueError("augment_params: a cascade's image is a pair of exams, which "
                         "the augmentation does not take")
    k_l2, b_l2 = float(cfg["kernel_regularizer"]), float(cfg["bias_regularizer"])
    w_seg = float(loss_weights[0]) if loss_weights else 1.0
    try:
        params_of_loss = inspect.signature(seg_loss).parameters
    except (TypeError, ValueError):
        params_of_loss = {}
    takes_dist_map = "dist_map" in params_of_loss
    device = model.device
    data_axis = group = None
    world = 1
    if mesh is not None:
        data_axis, group, world = _mesh_axes(mesh)
        device = mesh.device
        if data_axis.size > 1 and "axis" not in params_of_loss:
            raise ValueError("a data axis wider than 1 needs a seg_loss that takes axis= "
                             "(the global batch's loss; losses.Focal and "
                             "losses.SoftDicePlusBoundarySurface do)")
        if mesh.shape["data"] == 1:
            data_axis = None  # every rank holds the whole batch

    def batch_mean(v, b_local):
        # a per-sample mean (the KL's) over the global batch
        if data_axis is None:
            return v
        from ..parallel.collectives import psum

        return psum(v * b_local, data_axis) / (b_local * data_axis.size)

    def loss_fn(module, batch, rng):
        kw = ({"dist_map": batch["dist_map"]}
              if "dist_map" in batch and takes_dist_map else {})
        if data_axis is not None:
            kw["axis"] = data_axis
        y = batch["detection"]
        b_local = int(y.shape[0])
        out = module(batch["image"], train=True, rng=rng)
        metrics = {}
        if cascaded:
            seg = w_seg * (seg_loss(y, out["detection_1"], **kw)
                           + seg_loss(y, out["detection_2"], **kw))
            loss = seg
            if probabilistic:
                kl = batch_mean(out["KL_1"] + out["KL_2"], b_local)
                loss = loss + elbo_beta * kl
                metrics["kl"] = kl
        else:
            det = out["prob_softmax"] if probabilistic else out["y_softmax"]
            seg = w_seg * seg_loss(y, det, **kw)
            loss = seg
            if probabilistic:
                kl = batch_mean(out["prob_kl"], b_local)
                loss = loss + elbo_beta * kl
                metrics["kl"] = kl
        reg = l2_penalty(module, k_l2, b_l2).to(loss.device)
        loss = loss + reg
        metrics.update(seg_loss=seg, reg=reg, loss=loss)
        return loss, metrics

    def local_batch(batch, rng):
        """This rank's rows of the global batch and draws, on its device."""
        batch = {k: _on(v, device) for k, v in batch.items()}
        rng = prng.as_rng(rng, device)
        if mesh is None or mesh.shape["data"] == 1:
            return batch, rng
        from ..parallel.mesh import data_rows, host_local_batch_to_global

        total = _leading(batch["detection"])
        rows = data_rows(mesh, total)
        return (host_local_batch_to_global(mesh, batch),
                prng.rows(rng, [range(rows.start, rows.stop)], total)[0])

    def grads_of(state, batch, rng):
        """This rank's gradients (its share; summed over the mesh by
        ``reduce``) and the step's metrics."""
        params = state.params
        for p in params.values():
            p.grad = None
        batch, rng = local_batch(batch, rng)
        if augment is not None:
            batch = augment_batch(prng.augment_rng(rng), batch, augment, train_obj)
        loss, metrics = loss_fn(state.module, batch, rng)
        (loss / world if world > 1 else loss).backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return grads, {k: v.detach() for k, v in metrics.items()}

    def reduce(grads):
        """The gradients summed over the mesh (one all-reduce)."""
        if group is None:
            return grads
        from ..parallel.collectives import all_reduce_flat

        keys = list(grads)
        return dict(zip(keys, all_reduce_flat([grads[k] for k in keys], group)))

    def apply(state, grads):
        if state.shards is not None:
            from ..parallel.sharding import apply_sharded

            return apply_sharded(state, grads, optimizer, mesh)
        params = state.params
        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        with torch.no_grad():
            keys = list(updates)
            torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])
        return TrainState(state.module, opt_state, state.step + 1)

    def train_step(state: TrainState, batch, rng=None):
        grads, metrics = grads_of(state, batch, rng)
        return apply(state, reduce(grads)), metrics

    if accum_steps is not None:
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        k = int(accum_steps)

        def accum_step(state: TrainState, batches, rng=None):
            gsum, metrics = None, []
            for i, r in enumerate(_step_rngs(rng, k, device)):
                grads, m = grads_of(state, _index(batches, i), r)
                gsum = grads if gsum is None else {n: gsum[n] + g for n, g in grads.items()}
                metrics.append(m)
            grads = {n: g / k for n, g in reduce(gsum).items()}
            return apply(state, grads), {n: torch.stack([m[n] for m in metrics]).mean()
                                         for n in metrics[0]}

        return accum_step

    if scan_steps is not None:
        if scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        k = int(scan_steps)

        def multi_step(state: TrainState, batches, rng=None):
            metrics = []
            for i, r in enumerate(_step_rngs(rng, k, device)):
                state, m = train_step(state, _index(batches, i), r)
                metrics.append(m)
            return state, {n: torch.stack([m[n] for m in metrics]) for n in metrics[0]}

        return multi_step

    return train_step


def init_train_state(model, optimizer) -> TrainState:
    """The model's module, the optimizer's initial state and step 0."""
    return TrainState(module=model.net, opt_state=optimizer.init(
        dict(model.net.named_parameters())), step=0)


def _stack(chunk):
    """Batches -> one batch with a leading axis (a multi-step program's)."""
    first = chunk[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in chunk]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_stack(list(parts)) for parts in zip(*chunk))
    if torch.is_tensor(first):
        return torch.stack(chunk)
    return np.stack(chunk)


def _epoch_means(epoch_metrics: Dict[str, list]) -> Dict[str, float]:
    """Each metric's mean over the epoch's steps, read to the host in one
    transfer; the mean is numpy's over fp32 values, as JAX's ``np.mean``."""
    names = list(epoch_metrics)
    rows = torch.stack([torch.cat([v.detach().float().reshape(-1) for v in epoch_metrics[k]])
                        for k in names]).cpu().numpy()
    return {k: float(np.mean(rows[i])) for i, k in enumerate(names)}


def fit(
    model,
    x: Iterable,
    epochs: int = 1,
    steps_per_epoch: int = 1,
    initial_epoch: int = 0,
    optimizer: Any = None,
    loss: Any = None,
    loss_weights=None,
    elbo_beta: float = 10.0,
    mesh=None,
    weights_dir: Optional[str] = None,
    weights_min_epoch: int = 5,
    store_weights_per_n_epochs: int = 5,
    weights_overwrite: bool = False,
    validate_fn: Optional[Callable] = None,
    validate_per_n_epochs: int = 5,
    validate_min_epoch: int = 5,
    augment_params=None,
    train_obj: str = "lesion",
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    verbose: int = 2,
    schedule: Optional[Callable] = None,
    metrics_logger=None,
    checkpoint_manager=None,
    scan_steps: Optional[int] = None,
) -> Dict[str, list]:
    """Epoch/step fit loop with WeightsSaver + metrics history (JAX
    ``train/trainer.py:394-535``), on the model's device.

    ``x`` yields batches: dicts with 'image' (B,D,H,W,C) and 'detection'
    (B,D,H,W,nc) (+ 'dist_map' for a loss that takes one).

    * ``metrics_logger`` (``utils.profiling.MetricsLogger``): one JSONL
      record per epoch and per validation pass;
    * ``checkpoint_manager`` (``train.checkpoint.CheckpointManager``): a
      full-state checkpoint offered once per epoch (the manager's
      ``save_interval_steps`` governs cadence), restored from the latest
      step at entry (overriding ``initial_epoch``);
    * WeightsSaver: ``model_weights_{epoch:03d}.npz`` (``M1.save``, the JAX
      package's format) when ``(epoch + 1) % store_weights_per_n_epochs ==
      0``, ``epoch != 0`` and ``epoch + 1 >= weights_min_epoch``; with
      ``weights_overwrite`` the previous such file is removed;
    * ``validate_fn(params)`` every ``validate_per_n_epochs`` from
      ``validate_min_epoch`` on.

    Where the port differs from the JAX loop:

    * draws: program n since this entry (a step, or ``scan_steps`` steps)
      takes ``prng.fold_in(prng.generator(seed, device), n)`` where JAX
      splits ``PRNGKey(seed)`` once a program; both restart at every entry,
      as the batches do (``iter(x)``), so a resumed run follows JAX's rule,
      not an uninterrupted run's draws;
    * host reads: the steps' metrics stay device tensors and are read to the
      host once an epoch, so the loop adds no host read to a step;
    * ``validate_fn`` gets the live parameters by name (the module's own
      tensors, updated in place by the step) where JAX gets a host copy;
    * the model's module is the one the step trains, so ``model.params`` is
      current throughout; ``model.opt_state`` is set at the end;
    * ``mesh`` (one process a position, every rank iterating the same
      global batches): the step of ``make_train_step(mesh=)``, the model on
      the rank's device; only the writer (rank 0) validates, logs, writes
      weights, checkpoints and metrics (every rank restores a checkpoint).
    """
    resolve_device(model.device)
    writer = mesh is None or mesh.is_writer
    if not writer:
        weights_dir = validate_fn = metrics_logger = None
        verbose = 0
    if optimizer is None:
        optimizer = make_optimizer("adam", 1e-3)
    seg_loss = loss if callable(loss) else make_loss(loss or "distribution_focal")
    lw = loss_weights or (1.0, elbo_beta)
    if len(lw) > 1:
        elbo_beta = float(lw[1])

    if scan_steps is not None and scan_steps > 1 \
            and steps_per_epoch % scan_steps != 0:
        raise ValueError(
            f"scan_steps={scan_steps} must divide steps_per_epoch="
            f"{steps_per_epoch} (each epoch runs steps_per_epoch/scan_steps "
            "multi-step programs; pick a divisor)")
    use_scan = scan_steps is not None and scan_steps > 1
    step_fn = make_train_step(model, seg_loss, optimizer,
                              elbo_beta=elbo_beta, loss_weights=lw, mesh=mesh,
                              augment_params=augment_params, train_obj=train_obj,
                              scan_steps=scan_steps if use_scan else None)
    state = init_train_state(model, optimizer)
    base = prng.generator(seed, model.device)

    if checkpoint_manager is not None and checkpoint_manager.latest_step() is not None:
        state, resumed_epoch = checkpoint_manager.restore(state)
        initial_epoch = max(initial_epoch, int(resumed_epoch))
        if verbose:
            log_fn(f"Restored checkpoint @ epoch {resumed_epoch} "
                   f"({checkpoint_manager.directory})")

    history: Dict[str, list] = {"loss": [], "seg_loss": [], "epoch_time": []}
    it = iter(x)
    program = 0
    for epoch in range(initial_epoch, epochs):
        t0 = time.perf_counter()
        epoch_metrics: Dict[str, list] = {}
        for _ in range(steps_per_epoch // scan_steps if use_scan else steps_per_epoch):
            batch = _stack([next(it) for _ in range(scan_steps)]) if use_scan else next(it)
            state, metrics = step_fn(state, batch, prng.fold_in(base, program))
            program += 1
            for k, v in metrics.items():
                epoch_metrics.setdefault(k, []).append(v)
        epoch_metrics = _epoch_means(epoch_metrics)  # the epoch's one host read
        dt = time.perf_counter() - t0
        if schedule is not None:  # LR observability (Keras history parity)
            epoch_metrics["lr"] = float(schedule(int(state.step)))
            history.setdefault("lr", []).append(epoch_metrics["lr"])
        history["loss"].append(epoch_metrics.get("loss"))
        history["seg_loss"].append(epoch_metrics.get("seg_loss"))
        history["epoch_time"].append(dt)
        if verbose:
            log_fn(f"epoch {epoch + 1}/{epochs} - "
                   + " ".join(f"{k}: {v:.5f}" for k, v in epoch_metrics.items())
                   + f" - {dt:.2f}s")
        if metrics_logger is not None:
            metrics_logger.log("epoch", epoch=epoch + 1,
                               epoch_time_s=round(dt, 3), **epoch_metrics)

        # Train-time validation (reference 'TBA' callbacks, train_model.py:240-245).
        if validate_fn is not None and ((epoch + 1) % validate_per_n_epochs == 0) \
                and (epoch + 1) >= validate_min_epoch:
            val = validate_fn(state.params)
            history.setdefault("val", []).append({"epoch": epoch + 1, **val})
            if verbose:
                log_fn("validation @ epoch %d - %s" % (
                    epoch + 1, " ".join(f"{k}: {v:.4f}" for k, v in val.items())))
            if metrics_logger is not None:
                metrics_logger.log("validation", epoch=epoch + 1, **val)

        if checkpoint_manager is not None and writer:
            checkpoint_manager.save(epoch + 1, state, config=model.config)

        # WeightsSaver semantics (callbacks.py:44-75).
        if weights_dir and ((epoch + 1) % store_weights_per_n_epochs == 0) \
                and epoch != 0 and (epoch + 1) >= weights_min_epoch:
            path = os.path.join(weights_dir, f"model_weights_{epoch + 1:03d}.npz")
            model.save(path)
            if verbose:
                log_fn(f"Model Weights Saved: {path}")
            if weights_overwrite:
                prev = os.path.join(
                    weights_dir,
                    f"model_weights_{epoch + 1 - store_weights_per_n_epochs:03d}.npz")
                if os.path.exists(prev):
                    os.remove(prev)

    model.opt_state = state.opt_state
    if checkpoint_manager is not None and writer:
        checkpoint_manager.wait()  # async saves durable before returning
    return history


def resume_training(model, weights_dir: str, prefix: str = "model_weights"):
    """Scan ``weights_dir`` for the latest epoch's npz (the port's or the
    JAX package's) and reload it with ``M1.load`` on the model's device and
    in its compute dtype (reference callbacks.py:195-215). Returns (model,
    init_epoch)."""
    init_epoch = 0
    latest = None
    if os.path.isdir(weights_dir):
        for f in os.listdir(weights_dir):
            if f.startswith(prefix) and f.endswith(".npz"):
                try:
                    ep = int(f[len(prefix) + 1:].split(".npz")[0])
                except ValueError:
                    continue
                if ep > init_epoch:
                    init_epoch, latest = ep, f
    if latest is not None:
        from ..models.m1 import M1

        print("Loading Model Weights...")
        model = M1.load(os.path.join(weights_dir, latest), device=model.device,
                        dtype=model.dtype)
        print("Complete: ", os.path.join(weights_dir, latest))
        print(f"Resume Training @ Epoch {init_epoch}")
    else:
        print("Begin Training @ Epoch 0")
    return model, init_epoch
