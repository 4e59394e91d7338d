"""Instance normalization for 3D volumes (NDHWC), port of the JAX package's
``ops/normalization.py``.

Per-sample, per-channel statistics over all spatial voxels, learned
scale/offset, epsilon 1e-3 (tfa default; torch's InstanceNorm3d uses 1e-5).
Statistics are fp32 whatever the input type. Two formulas, as in JAX:

  * fp32 input: two passes, the centred ``mean((x - mean)^2)``;
  * bf16 input: one pass, ``max(E[x^2] - mean^2, 0)`` with fp32 sums, and the
    affine as ``x * a + b`` with ``a``, ``b`` rounded to bf16 first.

Three kernels live here, each with its plain twin, its launch counter and
its source note in ``csrc/instance_norm.cu``:

  * K3 :func:`in_stats` — (B, 2, C) fp32 mean and variance;
  * K4 :func:`in_apply` — the normalizing affine, LeakyReLU(0.1) fused on
    request;
  * K7 :func:`in_backward` — the gradient of both (+ LReLU) over the grid
    of :func:`in_backward_plan`, whose ``torch.autograd.Function``
    :func:`instance_norm` uses under autograd.

While ``torch.export`` traces, K3's and K4's wrappers call the registered
operators ``pmr::in_stats`` and ``pmr::in_apply`` (``cuda_lib.register_op``,
``export.py``).

Under halo-sharded execution (``parallel.halo``) the statistics span the
whole volume (:class:`ShardedStats`): core-masked fp32 sums ``s``, ``ss``
and counts, summed over the spatial axis's ranks, ``var = max(ss/n -
mean^2, 0)`` in both dtypes, and the vacuum outside the volume re-zeroed
(:func:`revacuum`). Without grad, K3 runs on a contiguous copy of the core
(the core is strided along H) and K4 applies the global statistics, the
LeakyReLU fused (LReLU(0) = 0, so it commutes with the re-zeroing); K4's
bf16 route rounds its coefficients to bf16 first, where the JAX package's
sharded formula keeps them fp32 (held within 2**-6 of max(1, |ref|)).
Under autograd the sharded norm is plain differentiable ops around the
differentiable psum: K7 assumes statistics over every voxel it
differentiates, which a slab with halos does not have.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from . import cuda_lib

EPSILON = 1e-3


def _check_5d(name, x):
    if x.dim() != 5:
        raise ValueError(f"{name}: expects NDHWC, got shape {tuple(x.shape)}")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStats:
    """Context for exact full-volume statistics under halo-sharded SPMD
    (JAX ``ops/normalization.py:29-49``).

    Every rank holds slab + 2 * halo along ``spatial_axis``. The halo is a
    multiple of the network's cumulative stride, so a tensor of local
    extent t at any resolution has ``halo * t // extent`` halo rows a side:
    the rest is this rank's core, and the cores of the ranks along ``axis``
    (a ``parallel.collectives.Axis``) tile the volume. Statistics are
    core-masked local sums summed over the axis: the unsharded reduction
    set."""

    axis: object        # parallel.collectives.Axis to sum over
    spatial_axis: int   # NDHWC tensor axis that is sharded
    halo: int           # halo width at the network input resolution
    extent: int         # local input extent incl. both halos (slab + 2*halo)


def _local_halo(x: torch.Tensor, sharded: ShardedStats) -> int:
    return sharded.halo * x.shape[sharded.spatial_axis] // sharded.extent


def _core_slice(x: torch.Tensor, sharded: ShardedStats) -> torch.Tensor:
    """The core of this rank's slab (a strided view along the axis)."""
    t, h = x.shape[sharded.spatial_axis], _local_halo(x, sharded)
    return x.narrow(sharded.spatial_axis, h, t - 2 * h)


def revacuum(x: torch.Tensor, sharded: Optional[ShardedStats]) -> torch.Tensor:
    """Zero what lies outside the volume ("vacuum") on the edge ranks.

    An unsharded SAME conv pads the true volume boundary with zeros at every
    layer; sharded, the vacuum rows gather conv biases and IN offsets layer
    over layer, and a later conv whose window crosses the volume's edge
    would read them. Re-zeroing after each norm and transposed conv
    restores the zero extension. The identity on interior ranks."""
    if sharded is None:
        return x
    ax, t, h = sharded.spatial_axis, x.shape[sharded.spatial_axis], _local_halo(x, sharded)
    slab = t - 2 * h
    idx, n = sharded.axis.index, sharded.axis.size
    gpos = torch.arange(t, device=x.device) - h + idx * slab
    keep = ((gpos >= 0) & (gpos < n * slab)).reshape(
        [t if i == ax % x.dim() else 1 for i in range(x.dim())])
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _core_sums(x: torch.Tensor, sharded: ShardedStats, squares: bool = True):
    """(s, ss, n) over the spatial axes: fp32 core sums of x (and of x**2;
    fp64 for fp64 input), summed over the axis's ranks, and the global
    voxel count."""
    from ..parallel.collectives import psum

    axes = tuple(range(1, x.dim() - 1))
    core = _core_slice(x, sharded).to(_acc(x))
    n = math.prod(core.shape[1:-1]) * sharded.axis.size
    s = psum(core.sum(dim=axes, keepdim=True), sharded.axis)
    ss = psum(core.square().sum(dim=axes, keepdim=True), sharded.axis) if squares else None
    return s, ss, n


def global_spatial_mean(x: torch.Tensor, sharded: Optional[ShardedStats] = None
                        ) -> torch.Tensor:
    """fp32-accumulated mean over all spatial dims, keepdims (the SE
    squeeze), returned in fp32 (fp64 for fp64 input); over the whole volume
    when ``sharded`` is given."""
    if sharded is not None:
        s, _, n = _core_sums(x, sharded, squares=False)
        return s / n
    return x.to(_acc(x)).mean(dim=tuple(range(1, x.dim() - 1)), keepdim=True)


def _acc(x: torch.Tensor) -> torch.dtype:
    # the plain twins' arithmetic type: fp32, or fp64 for an fp64 reference
    return torch.promote_types(x.dtype, torch.float32)


# ------------------------------------------------------------------- K3
def in_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: (B, 2, C) fp32 [mean, var] over the spatial axes
    (fp64 for fp64 input, by the fp32 formula)."""
    axes = tuple(range(1, x.dim() - 1))
    xf = x.to(_acc(x))
    mean = xf.mean(dim=axes)
    if x.dtype != torch.bfloat16:
        var = (xf - mean.view(mean.shape[0], *([1] * len(axes)), -1)
               ).square().mean(dim=axes)
    else:
        var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
    return torch.stack([mean, var], dim=1)


SMS = 132                     # streaming multiprocessors of an H100 SXM
THREADS = 256                 # threads a block of K3 and K4
STAT_TARGET_BLOCKS = 2 * SMS  # about two blocks an SM where the tensor allows
STAT_MIN_CHUNK_BYTES = 4096   # one 16-byte load a thread of a 256-thread block
STAT_FOLD_FLOATS = 16384      # partials that one sample's last block folds
APPLY_UNROLL = 4              # K4's vectors in flight a thread (kApplyUnroll)
APPLY_INFLIGHT_BYTES = 32768  # K4's bytes in flight an SM where the tensor allows


def _check_plan_args(name, batch, spatial, channels, itemsize):
    if not (1 <= batch <= 65535 and spatial >= 1 and channels >= 1):
        raise ValueError(f"{name}: needs 1 <= B <= 65535 and a non-empty sample, got "
                         f"B={batch}, spatial={spatial}, C={channels}")
    if itemsize not in (2, 4):
        raise ValueError(f"{name}: takes 2- or 4-byte elements, got {itemsize}")
    if spatial * channels >= 2 ** 31:
        raise ValueError(f"{name}: one sample exceeds 2**31 elements")


def _vector_route(spatial, channels, itemsize, aligned):
    """(route, vec, groups): 16-byte vectors (8 bf16 or 4 fp32 channels)
    where C is a multiple of the vector or divides it, the sample's elements
    fill whole vectors and the base is 16-byte aligned; else one element a
    load. A voxel's channels are ``groups`` vectors (1 where C divides vec),
    so a thread whose stride is a multiple of ``groups`` vectors meets the
    same channels in every vector."""
    vec = 16 // itemsize
    vector = (aligned and (channels % vec == 0 or vec % channels == 0)
              and (spatial * channels) % vec == 0)
    if not vector:
        vec = 1
    return ("vector" if vector else "scalar"), vec, (channels // vec if channels % vec == 0
                                                       else 1)


def in_stats_plan(batch: int, spatial: int, channels: int, itemsize: int,
                  aligned: bool = True) -> dict:
    """The grid of K3 (csrc/instance_norm.cu in_stats_kernel) for a (batch,
    spatial, channels) tensor of ``itemsize``-byte elements.

    The vector route loads 16 bytes (``vec`` = 8 bf16 or 4 fp32 channels)
    where C is a multiple of ``vec`` or divides it and the base is 16-byte
    aligned; else the scalar route (``vec`` 1). A row is ``groups`` vectors
    (C / vec, or 1 where C divides vec), ``rows`` rows a sample. Each
    sample's rows are cut into ``nchunk`` chunks of ``chunk_rows``: as many
    as give STAT_TARGET_BLOCKS blocks in all, no more than leave a chunk
    STAT_MIN_CHUNK_BYTES, and no more than STAT_FOLD_FLOATS partials to fold
    a sample.
    """
    _check_plan_args("in_stats", batch, spatial, channels, itemsize)
    route, vec, groups = _vector_route(spatial, channels, itemsize, aligned)
    rows = spatial * channels // (vec * groups)
    row_bytes = groups * vec * itemsize
    per_sample = min(-(-STAT_TARGET_BLOCKS // batch),
                     max(1, rows * row_bytes // STAT_MIN_CHUNK_BYTES),
                     max(1, STAT_FOLD_FLOATS // (2 * channels)))
    chunk_rows = -(-rows // per_sample)
    nchunk = -(-rows // chunk_rows)
    return dict(route=route, vec=vec, groups=groups, rows=rows,
                chunk_rows=chunk_rows, nchunk=nchunk, blocks=batch * nchunk)


_TICKETS = {}  # device -> int32 counters, one a sample, zero between calls


def _tickets(device: torch.device, batch: int) -> torch.Tensor:
    """K3's per-sample tickets on ``device``: zeroed once, and every call's
    last block of a sample sets its ticket back to 0 (calls on one stream)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < batch:
        t = torch.zeros(max(batch, 64), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def in_stats(x: torch.Tensor) -> torch.Tensor:
    """K3: per-(batch, channel) fp32 mean and variance of an NDHWC tensor,
    shape (B, 2, C). bf16 one-pass, fp32 two-pass centred (see module doc).

    Replaces the statistics half of ``benchmarks/r2_probe_conv.py:198`` and
    the retired ``fused_norm.py`` ``_stats_kernel`` (TPU kernel table rows 2
    and 5). Bound on the H100: bytes (one read, two for fp32). 16-byte
    loads over the grid of :func:`in_stats_plan`, per-chunk partials, and a
    fixed-order fold by each sample's last block: deterministic, no atomics
    on the sums, one launch a pass.
    """
    _check_5d("in_stats", x)
    if cuda_lib.exporting():
        return torch.ops.pmr.in_stats(x)
    if not cuda_lib.use_kernel("in_stats", x):
        return in_stats_plain(x)
    return _in_stats_cuda(x)


def _in_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    code = cuda_lib.dtype_code(x, "in_stats")
    if not x.is_contiguous():
        raise ValueError("in_stats: x must be contiguous NDHWC")
    b, c = int(x.shape[0]), int(x.shape[-1])
    spatial = int(x.shape[1] * x.shape[2] * x.shape[3])
    plan = in_stats_plan(b, spatial, c, x.element_size(), x.data_ptr() % 16 == 0)
    part = torch.empty((b, plan["nchunk"], 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    tickets = _tickets(x.device, b)
    lib = cuda_lib.library()
    in_stats.launches += 1
    rc = lib.pmr_in_stats(x.data_ptr(), part.data_ptr(), stats.data_ptr(), tickets.data_ptr(),
                          code, b, spatial, c, plan["vec"], plan["chunk_rows"],
                          plan["nchunk"], cuda_lib.stream_of(x))
    cuda_lib.check(rc, "in_stats")
    return stats


in_stats.launches = 0
cuda_lib.register_op(
    "in_stats", "(Tensor x) -> Tensor", cpu=in_stats_plain, cuda=_in_stats_cuda,
    fake=lambda x: x.new_empty((x.shape[0], 2, x.shape[-1]), dtype=torch.float32))


# ------------------------------------------------------------------- K4
def _pre_activation_sign(x, stats, scale, bias, epsilon):
    """Where K4's pre-activation is negative (its LReLU's slope 0.1)."""
    return _pre_activation(x, stats, scale, bias, epsilon) < 0


def _pre_activation(x, stats, scale, bias, epsilon):
    """K4's pre-activation in fp64, as K4 computes it: fp32 ``fmaf(x -
    center, a, c)`` with K4's per-dtype coefficients (see
    :func:`in_apply_plain`). The product and sum are taken in fp64, which
    gives the fused multiply-add's sign exactly (fp64 for fp64 input)."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    acc = _acc(x)
    mean = stats[:, 0].reshape(shape).to(acc)
    a = torch.rsqrt(stats[:, 1].reshape(shape).to(acc) + epsilon) * scale.to(acc)
    if x.dtype != torch.bfloat16:
        d, c = x.to(acc) - mean, bias.to(acc)
    else:
        d = x.float()
        c = (bias.float() - mean * a).to(x.dtype)
        a = a.to(x.dtype)
    return d.double() * a.double() + c.double()


def in_apply_plain(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, lrelu: bool = False,
                   epsilon: float = EPSILON) -> torch.Tensor:
    """Plain twin of K4, the same arithmetic in fp32 (fp64 for fp64 input),
    rounded once."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    mean = stats[:, 0].reshape(shape)
    a = torch.rsqrt(stats[:, 1].reshape(shape) + epsilon) * scale.to(_acc(x))
    if x.dtype != torch.bfloat16:
        y = (x - mean) * a + bias.to(_acc(x))
    else:
        b = (bias.float() - mean * a).to(x.dtype).float()
        y = x.float() * a.to(x.dtype).float() + b
    if lrelu:  # the slope where K4's fused multiply-add is negative
        y = torch.where(_pre_activation_sign(x, stats, scale, bias, epsilon), 0.1 * y, y)
    return y.to(x.dtype)


def in_apply_plan(batch: int, spatial: int, channels: int, itemsize: int,
                  aligned: bool = True) -> dict:
    """The grid of K4 (csrc/instance_norm.cu in_apply_kernel) for a (batch,
    spatial, channels) tensor of ``itemsize``-byte elements; ``aligned``:
    input and output bases both 16-byte aligned.

    Routes as :func:`in_stats_plan`'s. A sample's ``vectors`` are streamed
    by ``active`` threads (a multiple of ``groups``, so each thread keeps
    its channels), thread i taking vectors i, i + active, ...; ``blocks`` a
    sample of THREADS threads. Their number is the least of: enough blocks
    in all to keep APPLY_INFLIGHT_BYTES in flight on each SM (APPLY_UNROLL
    16-byte vectors a thread), and one pass of APPLY_UNROLL vectors a
    thread over the sample; never fewer than ``groups`` threads need.
    """
    _check_plan_args("in_apply", batch, spatial, channels, itemsize)
    route, vec, groups = _vector_route(spatial, channels, itemsize, aligned)
    vectors = spatial * channels // vec
    target = SMS * APPLY_INFLIGHT_BYTES // (THREADS * APPLY_UNROLL * 16)
    per_sample = max(-(-groups // THREADS),
                     min(-(-target // batch), -(-vectors // (THREADS * APPLY_UNROLL))))
    active = per_sample * THREADS // groups * groups
    return dict(route=route, vec=vec, groups=groups, vectors=vectors,
                blocks_per_sample=per_sample, active=active, blocks=batch * per_sample)


def in_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, lrelu: bool = False,
             epsilon: float = EPSILON) -> torch.Tensor:
    """K4: ``y = x * a + b`` per (batch, channel) from K3's statistics, with
    ``a = rsqrt(var + eps) * scale``, ``b = bias - mean * a`` in fp32
    (fp32 input: ``(x - mean) * a + bias``); optional LeakyReLU(0.1);
    output in x's dtype.

    Replaces the apply + LReLU half of ``benchmarks/r2_probe_conv.py:198``
    and the retired ``fused_norm.py`` ``_norm_kernel`` (TPU kernel table
    rows 2 and 5). Bound on the H100: bytes (one read, one write). A
    16-byte stream over the grid of :func:`in_apply_plan`; each thread keeps
    the coefficients of its fixed channels in registers.
    """
    _check_5d("in_apply", x)
    if cuda_lib.exporting():
        return torch.ops.pmr.in_apply(x, stats, scale, bias, bool(lrelu), float(epsilon))
    if not cuda_lib.use_kernel("in_apply", x):
        return in_apply_plain(x, stats, scale, bias, lrelu, epsilon)
    return _in_apply_cuda(x, stats, scale, bias, lrelu, epsilon)


def _in_apply_cuda(x, stats, scale, bias, lrelu, epsilon):
    code = cuda_lib.dtype_code(x, "in_apply")
    b, c = int(x.shape[0]), int(x.shape[-1])
    for name, t, shape in (("stats", stats, (b, 2, c)), ("scale", scale, (c,)),
                           ("bias", bias, (c,))):
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"in_apply: {name} must be contiguous float32 "
                             f"{shape} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("in_apply: x must be contiguous NDHWC")
    spatial = int(x.shape[1] * x.shape[2] * x.shape[3])
    y = torch.empty_like(x)
    plan = in_apply_plan(b, spatial, c, x.element_size(),
                         x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = cuda_lib.library()
    in_apply.launches += 1
    rc = lib.pmr_in_apply(x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
                          bias.data_ptr(), y.data_ptr(), code, b, spatial * c, c,
                          float(epsilon), int(bool(lrelu)), plan["vec"],
                          plan["blocks_per_sample"], plan["active"],
                          cuda_lib.stream_of(x))
    cuda_lib.check(rc, "in_apply")
    return y


in_apply.launches = 0
cuda_lib.register_op(
    "in_apply",
    "(Tensor x, Tensor stats, Tensor scale, Tensor bias, bool lrelu, float epsilon) -> Tensor",
    cpu=in_apply_plain, cuda=_in_apply_cuda,
    fake=lambda x, stats, scale, bias, lrelu, epsilon: torch.empty_like(x))


# ------------------------------------------------------------------- K7
def in_backward_plain(x, g, stats, scale, bias, lrelu=False, epsilon=EPSILON):
    """Plain twin of K7, in fp32 (fp64 for fp64 input): ``(dx, sums)`` with
    sums (B, 2, C) = [sum g', sum g' * xhat] over the spatial axes and dx =
    rstd * scale * (g' - sum(g') / n - xhat * sum(g' xhat) / n) rounded
    once to x's dtype; g' is g times the LReLU's slope (0.1 where K4's
    pre-activation was negative). The sums take g' and xhat as computed
    and add them in fp64, rounded once: a channel whose total is small
    beside its terms keeps its digits, which an fp32 sum of ~1e5 terms can
    lose to its own rounding."""
    acc = _acc(x)
    axes = tuple(range(1, x.dim() - 1))
    shape = (x.shape[0],) + (1,) * len(axes) + (x.shape[-1],)
    mean = stats[:, 0].reshape(shape).to(acc)
    rstd = torch.rsqrt(stats[:, 1].reshape(shape).to(acc) + epsilon)
    gf = g.to(acc)
    if lrelu:
        gf = torch.where(_pre_activation_sign(x, stats, scale, bias, epsilon), 0.1 * gf, gf)
    xhat = (x.to(acc) - mean) * rstd
    s1 = gf.double().sum(dim=axes).to(acc)
    s2 = (gf.double() * xhat.double()).sum(dim=axes).to(acc)
    inv_n = 1.0 / math.prod(x.shape[1:-1])
    dx = (rstd * scale.to(acc)) * (gf - (s1 * inv_n).reshape(shape)
                                   - xhat * (s2 * inv_n).reshape(shape))
    return dx.to(x.dtype), torch.stack([s1, s2], dim=1)


BWD_BLOCKS_PER_SM = 4         # K7's blocks an SM at <= 64 registers (kBwdMinBlocks)
BWD_TARGET_BLOCKS = BWD_BLOCKS_PER_SM * SMS  # one wave of K7's grid where the tensor allows
BWD_MAX_CHANNELS = 2048       # K7's widest coefficient table (kBwdMaxChannels)


def in_backward_plan(batch: int, spatial: int, channels: int, itemsize: int,
                     aligned: bool = True) -> dict:
    """The grid of K7 (csrc/instance_norm.cu in_bwd_reduce_kernel and
    in_bwd_apply_kernel, one grid for both) for x and g of (batch, spatial,
    channels) ``itemsize``-byte elements; ``aligned``: x, g and dx all
    16-byte aligned.

    Routes, ``vec`` and ``groups`` as :func:`in_stats_plan`'s. Each
    sample's ``rows`` (``groups`` vectors each) are cut into ``nchunk``
    chunks of ``chunk_rows``: as many as give BWD_TARGET_BLOCKS blocks in
    all (one wave at BWD_BLOCKS_PER_SM blocks an SM), no more than leave a
    chunk STAT_MIN_CHUNK_BYTES of x, and no more than STAT_FOLD_FLOATS
    partials to fold a sample. Block (chunk, b) takes the same rows in both
    passes, THREADS // groups at a time (one where a row is wider than the
    block): pass 1 ascending from the chunk's first row, pass 2 descending
    from its last, so pass 2 starts on what pass 1 read last. Refuses C
    above BWD_MAX_CHANNELS (the kernels' coefficient tables).
    """
    _check_plan_args("in_backward", batch, spatial, channels, itemsize)
    if channels > BWD_MAX_CHANNELS:
        raise ValueError(f"in_backward: takes at most {BWD_MAX_CHANNELS} channels, "
                         f"got {channels}")
    route, vec, groups = _vector_route(spatial, channels, itemsize, aligned)
    rows = spatial * channels // (vec * groups)
    per_sample = min(-(-BWD_TARGET_BLOCKS // batch),
                     max(1, rows * groups * vec * itemsize // STAT_MIN_CHUNK_BYTES),
                     max(1, STAT_FOLD_FLOATS // (2 * channels)))
    chunk_rows = -(-rows // per_sample)
    nchunk = -(-rows // chunk_rows)
    return dict(route=route, vec=vec, groups=groups, rows=rows, chunk_rows=chunk_rows,
                nchunk=nchunk, blocks=batch * nchunk)


def in_backward(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, lrelu: bool = False, epsilon: float = EPSILON):
    """K7: the gradient of K3 + K4 (+ LReLU) with respect to x for the
    output gradient ``g``: ``(dx, sums)``, dx in x's dtype and sums (B, 2,
    C) fp32 = [sum g', sum g' * xhat] per (batch, channel), whose sums over
    the batch are the bias and scale gradients (see :func:`in_backward_plain`).

    Replaces the backward of the retired ``fused_norm.py`` (git
    ``cef1717^``, ``_vjp_bwd`` :181, run by XLA; TPU kernel table row 5).
    Bound on the H100: bytes (x and g read twice, dx written once). Two
    launches (csrc/instance_norm.cu) over the grid of
    :func:`in_backward_plan`: a reduce with a fixed-order fold, and an apply
    that walks each chunk backwards; 16-byte loads where x, g and dx allow.
    The LReLU's slope is recomputed from x and the statistics as K4
    computed it; no activation is saved. One count a call.
    """
    _check_5d("in_backward", x)
    if not cuda_lib.use_kernel("in_backward", x):
        return in_backward_plain(x, g, stats, scale, bias, lrelu, epsilon)
    code = cuda_lib.dtype_code(x, "in_backward")
    b, c = int(x.shape[0]), int(x.shape[-1])
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("in_backward: g must have x's shape, dtype and device")
    for name, t, shape in (("stats", stats, (b, 2, c)), ("scale", scale, (c,)),
                           ("bias", bias, (c,))):
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"in_backward: {name} must be contiguous float32 "
                             f"{shape} on {x.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("in_backward: x and g must be contiguous NDHWC")
    spatial = int(x.shape[1] * x.shape[2] * x.shape[3])
    dx = torch.empty_like(x)
    plan = in_backward_plan(b, spatial, c, x.element_size(),
                            all(t.data_ptr() % 16 == 0 for t in (x, g, dx)))
    part = torch.empty((b, plan["nchunk"], 2, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    lib = cuda_lib.library()
    in_backward.launches += 1
    rc = lib.pmr_in_backward(x.data_ptr(), g.data_ptr(), stats.data_ptr(), scale.data_ptr(),
                             bias.data_ptr(), part.data_ptr(), sums.data_ptr(),
                             _tickets(x.device, b).data_ptr(), dx.data_ptr(), code, b, spatial,
                             c, float(epsilon), int(bool(lrelu)), plan["vec"],
                             plan["chunk_rows"], plan["nchunk"], cuda_lib.stream_of(x))
    cuda_lib.check(rc, "in_backward")
    return dx, sums


in_backward.launches = 0


class _InstanceNormFn(torch.autograd.Function):
    """K3 + K4 (+ LReLU) with K7 as its backward; saves x and the
    statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, lrelu, epsilon):
        stats = in_stats(x)
        ctx.lrelu, ctx.epsilon = lrelu, epsilon
        ctx.save_for_backward(x, stats, scale, bias)
        return in_apply(x, stats, scale, bias, lrelu, epsilon)

    @staticmethod
    def backward(ctx, gy):
        x, stats, scale, bias = ctx.saved_tensors
        dx, sums = in_backward(x, gy.contiguous(), stats, scale, bias, ctx.lrelu, ctx.epsilon)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, sums[:, 1].sum(0) if need[1] else None,
                sums[:, 0].sum(0) if need[2] else None, None, None)


def _sharded_instance_norm(x, scale, bias, epsilon, lrelu, sharded):
    """The norm with whole-volume statistics (JAX ``normalization.py:
    184-200``), then :func:`revacuum`. Under autograd: fp32 core sums, the
    differentiable psum, the affine ``x * a + b`` in fp32 rounded once.
    Without grad: K3 on a contiguous copy of the core, its (mean, var) made
    sums again (``s = n mean``, ``ss = n (var + mean^2)``) and summed over
    the axis, and K4 with the global statistics."""
    from ..parallel.collectives import psum

    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        s, ss, n = _core_sums(x, sharded)
        mean = s / n
        var = torch.clamp(ss / n - mean.square(), min=0.0)
        a = torch.rsqrt(var + epsilon) * scale
        y = (x.to(a.dtype) * a + (bias - mean * a)).to(x.dtype)
        if lrelu:
            y = torch.nn.functional.leaky_relu(y, 0.1)
        return revacuum(y, sharded)
    core = _core_slice(x, sharded).contiguous()
    stats = in_stats(core)  # (B, 2, C): mean, var of this rank's core
    n_local = math.prod(core.shape[1:-1])
    sums = torch.stack([stats[:, 0], stats[:, 1] + stats[:, 0].square()], dim=1) * n_local
    sums = psum(sums, sharded.axis)
    n = n_local * sharded.axis.size
    mean = sums[:, 0] / n
    var = torch.clamp(sums[:, 1] / n - mean.square(), min=0.0)
    return revacuum(in_apply(x, torch.stack([mean, var], dim=1).contiguous(), scale, bias,
                             lrelu, epsilon), sharded)


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                  epsilon: float = EPSILON, lrelu: bool = False,
                  sharded: Optional[ShardedStats] = None) -> torch.Tensor:
    """Functional instance norm over all dims but batch (0) and channel
    (-1); ``lrelu`` fuses the LeakyReLU(0.1) that follows most norms.
    Differentiable where autograd asks for it (K7 is the backward); without
    grad it saves nothing and launches K3 and K4 alone. ``sharded``: the
    statistics of the whole volume under halo sharding (module docstring)."""
    scale, bias = scale.to(_acc(x)), bias.to(_acc(x))
    if sharded is not None:
        return _sharded_instance_norm(x, scale, bias, epsilon, lrelu, sharded)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return _InstanceNormFn.apply(x, scale, bias, lrelu, epsilon)
    return in_apply(x, in_stats(x), scale, bias, lrelu, epsilon)


class InstanceNorm(nn.Module):
    """Learned-affine instance normalization (parameters ``scale``, ``bias``)."""

    def __init__(self, features: int, epsilon: float = EPSILON,
                 param_dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor, lrelu: bool = False,
                sharded: Optional[ShardedStats] = None) -> torch.Tensor:
        return instance_norm(x, self.scale, self.bias, epsilon=self.epsilon,
                             lrelu=lrelu, sharded=sharded)
