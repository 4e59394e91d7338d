"""K8 ``se_tail``: an SE block's squeeze-excite tail and the MC dropout after
it, in two launches over the block's output (``csrc/se_tail.cu``).

Without it the tail is a chain of torch kernels over the same tensor x_ (the
normalized conv3 output): the squeeze's fp32 mean (an fp32 copy of x_,
then a reduce), the gate ``x_ * s``, the shortcut's multiply, the LReLU,
and the dropout's compare, divide and where. Two kernels replace the chain,
each with its plain twin and its launch counter:

  * :func:`se_mean` — the squeeze's per-(batch, channel) fp32 mean over the
    spatial axes, keepdims, from x_ in its own dtype;
  * :func:`se_tail` — ``lrelu((x_ * s) * residual)``, and with a dropout's
    uniforms ``where(u < keep, · / keep_t, 0)``, rounded as the torch ops
    round, so that given the same ``s`` it is the chain's bits.

The squeeze MLP between them (``se_conv6``, LReLU, ``se_conv7``, sigmoid on
the (B, C) mean) stays torch's. ``models/blocks.py`` decides where the two
run (``SEResNetBottleNeck._fused_tail``). While ``torch.export`` traces,
the wrappers call the registered operators ``pmr::se_mean`` and
``pmr::se_tail``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_lib
from .normalization import (_check_5d, _tickets, global_spatial_mean, in_apply_plan,
                            in_stats_plan)


# ------------------------------------------------------------- K8 sums
def se_mean_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`se_mean`: the fp32 mean over the spatial axes,
    keepdims, ``normalization.global_spatial_mean``'s."""
    return global_spatial_mean(x)


def se_mean(x: torch.Tensor) -> torch.Tensor:
    """K8's first launch: the (B, 1, 1, 1, C) fp32 mean of an NDHWC tensor
    over its spatial axes, ``sum / n`` with fp32 sums.

    Bound on the H100: bytes (x read once in its own dtype). K3's grid
    (:func:`normalization.in_stats_plan`), 16-byte loads, per-chunk
    partials folded in chunk order by each sample's last block: no float
    atomics, the same bits on every run of one shape.
    """
    _check_5d("se_mean", x)
    if cuda_lib.exporting():
        return torch.ops.pmr.se_mean(x)
    if not cuda_lib.use_kernel("se_mean", x):
        return se_mean_plain(x)
    return _se_mean_cuda(x)


def _se_mean_cuda(x: torch.Tensor) -> torch.Tensor:
    code = cuda_lib.dtype_code(x, "se_mean")
    if not x.is_contiguous():
        raise ValueError("se_mean: x must be contiguous NDHWC")
    b, c = int(x.shape[0]), int(x.shape[-1])
    spatial = int(x.shape[1] * x.shape[2] * x.shape[3])
    plan = in_stats_plan(b, spatial, c, x.element_size(), x.data_ptr() % 16 == 0)
    part = torch.empty((b, plan["nchunk"], c), dtype=torch.float32, device=x.device)
    mean = torch.empty((b, 1, 1, 1, c), dtype=torch.float32, device=x.device)
    lib = cuda_lib.library()
    rc = lib.pmr_se_sums(x.data_ptr(), part.data_ptr(), mean.data_ptr(),
                         _tickets(x.device, b).data_ptr(), code, b, spatial, c, plan["vec"],
                         plan["chunk_rows"], plan["nchunk"], cuda_lib.stream_of(x))
    cuda_lib.check(rc, "se_mean")
    return mean


cuda_lib.register_op(
    "se_mean", "(Tensor x) -> Tensor", cpu=se_mean_plain, cuda=_se_mean_cuda,
    fake=lambda x: x.new_empty((x.shape[0], 1, 1, 1, x.shape[-1]), dtype=torch.float32))


# ------------------------------------------------------------ K8 apply
def se_tail_plain(x: torch.Tensor, s: torch.Tensor, residual: torch.Tensor,
                  u: Optional[torch.Tensor] = None, keep: float = 1.0) -> torch.Tensor:
    """Plain twin of :func:`se_tail`: the torch chain it replaces, op for
    op: ``lrelu((x * s) * residual)`` and, with uniforms ``u``, flax's
    dropout ``where(u < keep, · / keep_t, 0)`` with ``keep_t`` keep rounded
    to x's dtype (``blocks.dropout``)."""
    out = F.leaky_relu((x * s) * residual, 0.1)
    if u is None:
        return out
    return drop_where(out, u < keep, keep)


def drop_where(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """``where(mask, x / keep_t, 0)`` in x's dtype, ``keep_t`` a 0-dim tensor
    on x's device: CUDA would turn a Python scalar divisor into a multiply
    by its reciprocal, which rounds differently."""
    scale = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def se_tail(x: torch.Tensor, s: torch.Tensor, residual: torch.Tensor,
            u: Optional[torch.Tensor] = None, keep: float = 1.0) -> torch.Tensor:
    """K8's second launch: ``lrelu((x * s) * residual)`` of an NDHWC x, its
    shortcut ``residual`` and the (B, 1, 1, 1, C) gate ``s``, all of x's
    dtype; with ``u`` (fp32 uniforms of x's shape) the dropout at ``keep``:
    ``where(u < keep, · / keep_t, 0)``. Each product and the LReLU rounded
    to x's dtype and the division an IEEE one (where keep_t is a power of
    two, a multiply by its reciprocal: the same bits), as
    :func:`se_tail_plain`.

    Bound on the H100: bytes (x, residual and u read once, the output
    written once). K4's grid (:func:`normalization.in_apply_plan`), each
    thread's gate in registers, 16-byte loads and stores; where a base is
    not 16-byte aligned or C neither a multiple nor a divisor of the vector,
    one element a load. ``se_tail.launches`` counts the launches and
    ``se_tail.masked`` those with a dropout.
    """
    _check_5d("se_tail", x)
    if cuda_lib.exporting():
        return torch.ops.pmr.se_tail(x, s, residual, u, float(keep))
    if not cuda_lib.use_kernel("se_tail", x):
        return se_tail_plain(x, s, residual, u, keep)
    return _se_tail_cuda(x, s, residual, u, keep)


def _se_tail_cuda(x, s, residual, u, keep):
    code = cuda_lib.dtype_code(x, "se_tail")
    b, c = int(x.shape[0]), int(x.shape[-1])
    if tuple(s.shape) != (b, 1, 1, 1, c) or s.dtype != x.dtype or s.device != x.device:
        raise ValueError(f"se_tail: s must be {(b, 1, 1, 1, c)} of x's dtype on {x.device}")
    if residual.shape != x.shape or residual.dtype != x.dtype or residual.device != x.device:
        raise ValueError("se_tail: residual must have x's shape, dtype and device")
    if u is not None and (u.shape != x.shape or u.dtype != torch.float32
                          or u.device != x.device):
        raise ValueError("se_tail: u must be float32 of x's shape on its device")
    if not x.is_contiguous():
        raise ValueError("se_tail: x must be contiguous NDHWC")
    s, residual = s.contiguous(), residual.contiguous()
    u = None if u is None else u.contiguous()
    spatial = int(x.shape[1] * x.shape[2] * x.shape[3])
    y = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, residual, y) + (() if u is None else (u,)))
    plan = in_apply_plan(b, spatial, c, x.element_size(), aligned)
    keep_t = torch.full((), keep, dtype=x.dtype).item()  # keep as x's dtype rounds it
    # x / keep_t is x * (1 / keep_t), bit for bit, where keep_t is a power of two
    inv_keep = 1.0 / keep_t if 0.0 < keep_t and math.frexp(keep_t)[0] == 0.5 else 0.0
    lib = cuda_lib.library()
    se_tail.launches += 1
    se_tail.masked += u is not None
    rc = lib.pmr_se_apply(x.data_ptr(), s.data_ptr(), residual.data_ptr(),
                          None if u is None else u.data_ptr(), y.data_ptr(), code, b,
                          spatial * c, c, float(keep), float(keep_t), inv_keep, plan["vec"],
                          plan["blocks_per_sample"], plan["active"], cuda_lib.stream_of(x))
    cuda_lib.check(rc, "se_tail")
    return y


se_tail.launches = 0
se_tail.masked = 0
cuda_lib.register_op(
    "se_tail", "(Tensor x, Tensor s, Tensor residual, Tensor? u, float keep) -> Tensor",
    cpu=se_tail_plain, cuda=_se_tail_cuda,
    fake=lambda x, s, residual, u, keep: torch.empty_like(x))
