"""Tensor-parallel parameter state over the mesh's ``model`` axis, port of
the JAX package's ``parallel/sharding.py``.

The partition rule is JAX's, on the port's flat parameter names (the flax
keypaths with '.'): a conv kernel whose last axis (output channels; a
transposed conv's input channels) has at least ``min_channels`` channels
and divides by the axis size is split along that axis, as are biases and
IN scales of such a width; everything else replicates.

Where XLA propagates such shardings through the program, the port keeps the
split in the STATE: each rank of the ``model`` axis stores its slice of
every split parameter and of its optimizer moments (``shard_state``); the
train step gathers the slices into the module for the forward, takes its
slice of the all-reduced whole gradient and updates that slice (Keras
amsgrad and SGD are elementwise, so this is exact). The compute itself runs
whole on every rank, as JAX's tests pin only the state's placement and the
loss.

This is a parity path: the module keeps the whole parameters and the step
the whole gradients, so the split saves only the optimizer moments' memory
(tens of MB at the CLI's default width) and costs an all-gather a step. No
command line, serving path or train loop of the port drives it, and
``state_shardings`` describes the placement for comparison with the JAX
package's and places nothing.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .collectives import all_gather
from .mesh import Mesh, NamedSharding, P


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1].rsplit("/", 1)[-1]


def _spec(name: str, shape, min_channels: int, axis: str, axis_size: int) -> P:
    def divisible(n):
        return axis_size <= 1 or n % axis_size == 0

    leaf, ndim = _leaf_name(name), len(shape)
    if ndim >= 2 and leaf == "kernel" and shape[-1] >= min_channels and divisible(shape[-1]):
        return P(*([None] * (ndim - 1)), axis)
    if (ndim == 1 and shape[0] >= min_channels and divisible(shape[0])
            and leaf in ("bias", "scale")):
        return P(axis)
    return P()


def param_partition_spec(params: Dict[str, Any], min_channels: int = 128,
                         axis: str = "model", axis_size: int = 1) -> Dict[str, P]:
    """{name: P}: JAX's rule (module docstring) for a flat parameter dict."""
    return {k: _spec(k, tuple(v.shape), min_channels, axis, axis_size)
            for k, v in params.items()}


def _slice(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    if "model" not in spec:
        return t
    ax = mesh.axis("model")
    return t.chunk(ax.size, dim=spec.index("model"))[ax.index].contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 min_channels: int = 128) -> Dict[str, torch.Tensor]:
    """This rank's part of each parameter: its ``model`` slice of a split
    one, a replicated one whole."""
    specs = param_partition_spec(params, min_channels, axis_size=mesh.shape["model"])
    return {k: _slice(v, specs[k], mesh) for k, v in params.items()}


def state_shardings(state_like, mesh: Mesh, min_channels: int = 128,
                    axis: str = "model") -> Dict[str, Any]:
    """The placement of a ``TrainState``'s leaves: ``params`` and every
    per-parameter dict of the optimizer state (mu/nu/nu_hat, trace) by the
    rule, counts and the step replicated (descriptors only, as
    ``mesh.NamedSharding``)."""
    size = mesh.shape.get(axis, 1)
    params = dict(state_like.module.named_parameters())

    def tree(t):
        if isinstance(t, dict) and set(t) <= set(params) and t:
            return {k: NamedSharding(mesh, _spec(k, tuple(params[k].shape), min_channels,
                                                 axis, size)) for k in t}
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return NamedSharding(mesh, P())

    return dict(params=tree(params), opt_state=tree(state_like.opt_state),
                step=NamedSharding(mesh, P()))


def shard_state(state, mesh: Mesh, min_channels: int = 128):
    """A ``TrainState`` whose split parameters and their optimizer moments
    are this rank's ``model`` slices (``state.shards`` holds the parameter
    slices; the module keeps the gathered whole for the forward)."""
    from ..train.trainer import TrainState

    params = dict(state.module.named_parameters())
    specs = param_partition_spec(params, min_channels, axis_size=mesh.shape["model"])
    split = [k for k, s in specs.items() if "model" in s]  # in the module's order

    def cut(t):
        if isinstance(t, dict):
            return {k: (_slice(v, specs[k], mesh) if k in split and torch.is_tensor(v)
                        else cut(v)) for k, v in t.items()}
        return t

    shards = {k: _slice(params[k].detach(), specs[k], mesh).clone() for k in split}
    return TrainState(state.module, cut(state.opt_state), state.step, shards)


def apply_sharded(state, grads: Dict[str, torch.Tensor], optimizer, mesh: Mesh):
    """One optimizer update of a sharded state from the mesh-summed
    gradients: the split parameters' slices and moments from their slice of
    the gradient, then the slices gathered into the module."""
    from ..train.trainer import TrainState

    params = dict(state.module.named_parameters())
    ax = mesh.axis("model")
    dims = {k: _split_dim(params[k], v, ax.size) for k, v in state.shards.items()}
    mixed_g = {k: (g.chunk(ax.size, dim=dims[k])[ax.index].contiguous() if k in dims else g)
               for k, g in grads.items()}
    mixed_p = {k: state.shards.get(k, p) for k, p in params.items()}
    updates, opt_state = optimizer.update(mixed_g, state.opt_state, mixed_p)
    with torch.no_grad():
        keys = list(updates)
        torch._foreach_add_([mixed_p[k] for k in keys], [updates[k] for k in keys])
        for k, shard in state.shards.items():
            params[k].copy_(all_gather(shard, ax, dims[k]))
    return TrainState(state.module, opt_state, state.step + 1, state.shards)


def _split_dim(full: torch.Tensor, shard: torch.Tensor, n: int) -> int:
    """The axis along which ``shard`` is one of ``n`` slices of ``full``."""
    for d, (a, b) in enumerate(zip(full.shape, shard.shape)):
        if a != b:
            assert a == n * b, (tuple(full.shape), tuple(shard.shape), n)
            return d
    return full.dim() - 1
