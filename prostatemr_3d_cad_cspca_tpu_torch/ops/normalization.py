"""Instance normalization for 3D volumes (NDHWC), port of the JAX package's
``ops/normalization.py``.

Per-sample, per-channel statistics over all spatial voxels, learned
scale/offset, epsilon 1e-3 (tfa default; torch's InstanceNorm3d uses 1e-5).
Statistics are fp32 whatever the input type. Two formulas, as in JAX:

  * fp32 input: two passes, the centred ``mean((x - mean)^2)``;
  * bf16 input: one pass, ``max(E[x^2] - mean^2, 0)`` with fp32 sums, and the
    affine as ``x * a + b`` with ``a``, ``b`` rounded to bf16 first.

Two kernels live here, each with its plain twin, its launch counter and its
source note in ``csrc/instance_norm.cu``:

  * K3 :func:`in_stats` — (B, 2, C) fp32 mean and variance;
  * K4 :func:`in_apply` — the normalizing affine, LeakyReLU(0.1) fused on
    request.

Cross-shard statistics (``ShardedStats``, ``revacuum``) wait for the
multi-GPU slice.
"""

from __future__ import annotations

import torch
from torch import nn

from . import cuda_lib

EPSILON = 1e-3


def _check_5d(name, x):
    if x.dim() != 5:
        raise ValueError(f"{name}: expects NDHWC, got shape {tuple(x.shape)}")


def global_spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """fp32-accumulated mean over all spatial dims, keepdims (the SE
    squeeze), returned in fp32."""
    return x.float().mean(dim=tuple(range(1, x.dim() - 1)), keepdim=True)


# ------------------------------------------------------------------- K3
def in_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: (B, 2, C) fp32 [mean, var] over the spatial axes."""
    axes = tuple(range(1, x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=axes)
    if x.dtype == torch.float32:
        var = (xf - mean.view(mean.shape[0], *([1] * len(axes)), -1)
               ).square().mean(dim=axes)
    else:
        var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
    return torch.stack([mean, var], dim=1)


SMS = 132                     # streaming multiprocessors of an H100 SXM
STAT_TARGET_BLOCKS = 2 * SMS  # about two blocks an SM where the tensor allows
STAT_MIN_CHUNK_BYTES = 4096   # one 16-byte load a thread of a 256-thread block
STAT_FOLD_FLOATS = 16384      # partials that one sample's last block folds


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
    if not (1 <= batch <= 65535 and spatial >= 1 and channels >= 1):
        raise ValueError(f"in_stats: needs 1 <= B <= 65535 and a non-empty sample, got "
                         f"B={batch}, spatial={spatial}, C={channels}")
    if itemsize not in (2, 4):
        raise ValueError(f"in_stats: takes 2- or 4-byte elements, got {itemsize}")
    if spatial * channels >= 2 ** 31:
        raise ValueError("in_stats: one sample exceeds 2**31 elements")
    vec = 16 // itemsize
    vector = (aligned and (channels % vec == 0 or vec % channels == 0)
              and (spatial * channels) % vec == 0)
    if not vector:
        vec = 1
    groups = channels // vec if channels % vec == 0 else 1
    rows = spatial * channels // (vec * groups)
    row_bytes = groups * vec * itemsize
    per_sample = min(-(-STAT_TARGET_BLOCKS // batch),
                     max(1, rows * row_bytes // STAT_MIN_CHUNK_BYTES),
                     max(1, STAT_FOLD_FLOATS // (2 * channels)))
    chunk_rows = -(-rows // per_sample)
    nchunk = -(-rows // chunk_rows)
    return dict(route="vector" if vector else "scalar", vec=vec, groups=groups, rows=rows,
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
    if not cuda_lib.use_kernel("in_stats", x):
        return in_stats_plain(x)
    code = cuda_lib.dtype_code(x, "in_stats")
    if not x.is_contiguous():
        raise ValueError("in_stats: x must be contiguous NDHWC")
    cuda_lib.require_no_grad("in_stats", x)
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


# ------------------------------------------------------------------- K4
def in_apply_plain(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, lrelu: bool = False,
                   epsilon: float = EPSILON) -> torch.Tensor:
    """Plain twin of K4, the same arithmetic in fp32, rounded once."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    mean = stats[:, 0].reshape(shape)
    a = torch.rsqrt(stats[:, 1].reshape(shape) + epsilon) * scale.float()
    if x.dtype == torch.float32:
        y = (x - mean) * a + bias.float()
    else:
        b = (bias.float() - mean * a).to(x.dtype).float()
        y = x.float() * a.to(x.dtype).float() + b
    if lrelu:
        y = torch.where(y >= 0, y, 0.1 * y)
    return y.to(x.dtype)


def in_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, lrelu: bool = False,
             epsilon: float = EPSILON) -> torch.Tensor:
    """K4: ``y = x * a + b`` per (batch, channel) from K3's statistics, with
    ``a = rsqrt(var + eps) * scale``, ``b = bias - mean * a`` in fp32
    (fp32 input: ``(x - mean) * a + bias``); optional LeakyReLU(0.1);
    output in x's dtype.

    Replaces the apply + LReLU half of ``benchmarks/r2_probe_conv.py:198``
    and the retired ``fused_norm.py`` ``_norm_kernel`` (TPU kernel table
    rows 2 and 5). Bound on the H100: bytes (one read, one write). Each
    block keeps its sample's coefficients in shared memory and streams
    coalesced elements.
    """
    _check_5d("in_apply", x)
    if not cuda_lib.use_kernel("in_apply", x):
        return in_apply_plain(x, stats, scale, bias, lrelu, epsilon)
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
    per_batch = x.numel() // max(b, 1)
    if per_batch >= 2 ** 31:
        raise ValueError("in_apply: one sample exceeds 2**31 elements")
    cuda_lib.require_no_grad("in_apply", x, scale, bias)
    y = torch.empty_like(x)
    lib = cuda_lib.library()
    in_apply.launches += 1
    rc = lib.pmr_in_apply(x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
                          bias.data_ptr(), y.data_ptr(), code, b, per_batch, c,
                          float(epsilon), int(bool(lrelu)), cuda_lib.stream_of(x))
    cuda_lib.check(rc, "in_apply")
    return y


in_apply.launches = 0


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                  epsilon: float = EPSILON, lrelu: bool = False) -> torch.Tensor:
    """Functional instance norm over all dims but batch (0) and channel
    (-1); ``lrelu`` fuses the LeakyReLU(0.1) that follows most norms."""
    return in_apply(x, in_stats(x), scale.float(), bias.float(), lrelu, epsilon)


class InstanceNorm(nn.Module):
    """Learned-affine instance normalization (parameters ``scale``, ``bias``)."""

    def __init__(self, features: int, epsilon: float = EPSILON,
                 param_dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor, lrelu: bool = False) -> torch.Tensor:
        return instance_norm(x, self.scale, self.bias, epsilon=self.epsilon,
                             lrelu=lrelu)
