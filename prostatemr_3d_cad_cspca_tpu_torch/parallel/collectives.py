"""The collectives of the port's SPMD code, over the process groups of a
mesh axis (``mesh.Mesh.axis``): the counterparts of the JAX package's
``lax.psum``, ``lax.axis_index``, ``lax.axis_size`` and ``lax.ppermute``
inside ``shard_map``.

Each takes an :class:`Axis`: this rank's view of one mesh axis (its group,
its index along the axis, the axis's size). An axis of a mesh outside an
initialized world has no group; there every collective is the identity on
its one member.

One code path serves NCCL (tensors on the card) and gloo (CPU tensors, or
CUDA tensors where gloo supports the collective): only ``all_reduce`` and
``all_gather`` are used, since gloo's ``send``/``recv`` take CPU tensors
alone. A failed collective raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: ``group`` (a process group, None
    outside a world), this rank's ``index`` along it and its ``size``."""

    name: str
    size: int
    index: int = 0
    group: Any = None


def axis_index(axis: Axis) -> int:
    return axis.index


def axis_size(axis: Axis) -> int:
    return axis.size


class _PSum(torch.autograd.Function):
    """Sum over the axis; its transpose is the sum of the cotangents over the
    axis (JAX's psum under ``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis``'s members, differentiable: the gradient of
    each member's input is the sum of every member's output gradient. So a
    rank differentiates its LOCAL share of a loss and the shares' gradients
    are summed afterwards (a loss every member computes whole is divided by
    the axis size first)."""
    if axis.group is None:
        return x
    return _PSum.apply(x.contiguous(), axis.group)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every member's ``x`` (one shape on all) concatenated along ``dim`` in
    axis order; no gradient."""
    if axis.group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums over ``group`` of ``tensors`` (one dtype and device), as new
    tensors of their shapes: one all-reduce of one flat buffer."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out
