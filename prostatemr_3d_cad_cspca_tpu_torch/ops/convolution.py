"""Convolutions of the M1 path on channels-last (NDHWC) tensors.

Port of the JAX package's ``ops/convolution.py``. Layouts stay the JAX ones,
so weights move between the two packages with no permutation:

  * forward conv kernels are DHWIO ``(kd, kh, kw, Cin, Cout)``;
  * transposed conv kernels are ``(kd, kh, kw, Cout, Cin)``, the TF
    Conv3DTranspose convention (flax ``ConvTranspose(transpose_kernel=True)``).

Padding is XLA's SAME, which is asymmetric where torch's is not: at k=3, s=2
on an even size the window starts ON the first voxel (pad_lo 0, pad_hi 1),
while torch's ``padding=1`` starts one voxel before it. Both kernels below get
their windows from :func:`forward_plan` / :func:`transpose_plan`.

Two kernels live here, each with its plain PyTorch twin, its launch counter
and its source note in ``csrc/conv3d.cu``:

  * K1 :func:`conv3d` — forward conv over a list of channel parts
    (``SplitInputConv``'s identity ``conv(concat(parts), W) = sum_i
    conv(part_i, W_i)``), with fp32 bias and fp32 accumulation;
  * K2 :func:`conv3d_transpose` — the SAME transposed conv, output ``n * s``.

On a CPU (or meta) tensor each wrapper runs its plain twin; on a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_lib

MAX_PARTS = 5
MAX_PHASES = 8
MAX_TAPS = 27


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    """Shared convolution hyperparameters (the JAX ``ConvConfig``).

    Every field of the JAX dataclass is accepted so checkpoint configs load
    unchanged. ``fold2d``, ``subpixel`` and ``split_stitch`` chose among XLA
    lowerings of the same math; the port has one kernel for all of them (it
    always consumes part lists), so they change nothing here. ``act_store``
    rounds the block-boundary activations through a narrow float type, as
    the JAX ``store_act`` does. Initializers are names of INITIALIZERS or
    callables (see :func:`resolve_initializer`); the L2 coefficients wait
    for the training slice.
    """

    kernel_init: Any = "orthogonal"
    bias_init: Any = "truncated_normal"
    kernel_l2: float = 1e-4
    bias_l2: float = 1e-4
    use_bias: bool = True
    dtype: Any = None  # compute dtype; None = promote(input, params)
    param_dtype: Any = torch.float32
    fold2d: Any = False
    split_stitch: bool = True
    subpixel: bool = False
    act_store: Any = None


def store_act(cfg: ConvConfig, x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` through ``cfg.act_store`` (an fp8 type or its name) and
    back to its own dtype; identity when ``act_store`` is None."""
    if cfg.act_store is None:
        return x
    dt = cfg.act_store
    if isinstance(dt, str):
        dt = getattr(torch, dt)
    return x.to(dt).to(x.dtype)


# --------------------------------------------------------------- windows
def same_pads(n: int, k: int, s: int):
    """XLA SAME along one axis: (out, pad_lo, pad_hi)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return out, total // 2, total - total // 2


def _pad_a(k: int, s: int) -> int:
    # lo-padding of the dilated input in lax.conv_transpose(SAME)
    return k - 1 if s > k - 1 else -((k + s - 2) // -2)


def transpose_offset(k: int, s: int) -> int:
    """``c`` of the gather form y[p] = sum_j x[(p + c - j) / s] K[j]: also
    where the SAME output starts inside torch's full (padding 0) output."""
    return k - 1 - _pad_a(k, s)


@functools.lru_cache(maxsize=256)
def forward_plan(kernel_size, strides, in_spatial):
    """Row grid and tap table of a SAME forward conv: output voxel o reads
    input o * s - pad_lo + tap along each axis."""
    ks, st = tuple(kernel_size), tuple(strides)
    out, lo = [], []
    for n, k, s in zip(in_spatial, ks, st):
        o, plo, _ = same_pads(n, k, s)
        out.append(o)
        lo.append(plo)
    kd, kh, kw = ks
    taps = tuple((a, b, c, (a * kh + b) * kw + c)
                 for a in range(kd) for b in range(kh) for c in range(kw))
    return dict(out=tuple(out), grid=tuple(out), in_mul=st,
                in_add=tuple(-p for p in lo), out_mul=(1, 1, 1),
                phases=(((0, 0, 0), taps),))


@functools.lru_cache(maxsize=256)
def transpose_plan(kernel_size, strides, in_spatial):
    """Row grid and per-phase tap tables of a SAME transposed conv in gather
    form. Output p = q * s + r (phase r) reads input q + (r + c - j) / s for
    the taps j with s | (r + c - j); the kernel is not flipped."""
    ks, st = tuple(kernel_size), tuple(strides)
    per_axis = []
    for k, s in zip(ks, st):
        c = transpose_offset(k, s)
        per_axis.append([[((r + c - j) // s, j) for j in range(k)
                          if (r + c - j) % s == 0] for r in range(s)])
    _, kh, kw = ks
    phases = []
    for rd in range(st[0]):
        for rh in range(st[1]):
            for rw in range(st[2]):
                taps = tuple((od, oh, ow, (jd * kh + jh) * kw + jw)
                             for od, jd in per_axis[0][rd]
                             for oh, jh in per_axis[1][rh]
                             for ow, jw in per_axis[2][rw])
                phases.append(((rd, rh, rw), taps))
    return dict(out=tuple(n * s for n, s in zip(in_spatial, st)),
                grid=tuple(in_spatial), in_mul=(1, 1, 1), in_add=(0, 0, 0),
                out_mul=st, phases=tuple(phases))


def _pack_conv_args(parts, kernel, bias, y, plan, transposed):
    """The three host arrays the C entries of csrc/conv3d.cu read.

    ptrs (uint64[8]): part pointers 0..4, kernel, bias, output.
    meta (int32[64]): 0 nparts; 1-5 cin of each part; 6 cin total; 7 batch;
      8-10 input D,H,W; 11-13 output D,H,W; 14-16 row grid D,H,W; 17 cout;
      18-20 in_mul; 21-23 in_add; 24-26 out_mul; 27 weight ci stride;
      28 weight co stride; 29 nphase; 30-37 taps per phase; 38-61 phase
      residues (8 x 3); 62 dtype code; 63 has bias.
    taps (int8[8, 27, 4]): per phase and tap, (dz, dy, dx, weight tap).
    """
    cin = [int(p.shape[-1]) for p in parts]
    cin_total = sum(cin)
    cout = int(kernel.shape[3] if transposed else kernel.shape[4])
    meta = np.zeros(64, np.int32)
    meta[0] = len(parts)
    meta[1:1 + len(cin)] = cin
    meta[6] = cin_total
    meta[7] = parts[0].shape[0]
    meta[8:11] = parts[0].shape[1:4]
    meta[11:14] = plan["out"]
    meta[14:17] = plan["grid"]
    meta[17] = cout
    meta[18:21] = plan["in_mul"]
    meta[21:24] = plan["in_add"]
    meta[24:27] = plan["out_mul"]
    meta[27:29] = (1, cin_total) if transposed else (cout, 1)
    meta[29] = len(plan["phases"])
    taps = np.zeros((MAX_PHASES, MAX_TAPS, 4), np.int8)
    for i, (res, tp) in enumerate(plan["phases"]):
        meta[30 + i] = len(tp)
        meta[38 + 3 * i:41 + 3 * i] = res
        if tp:
            taps[i, :len(tp)] = tp
    meta[62] = cuda_lib.DTYPE_CODES.get(parts[0].dtype, -1)
    meta[63] = bias is not None
    ptrs = np.zeros(8, np.uint64)
    for i, p in enumerate(parts):
        ptrs[i] = p.data_ptr()
    ptrs[5] = kernel.data_ptr()
    ptrs[6] = bias.data_ptr() if bias is not None else 0
    ptrs[7] = y.data_ptr()
    return ptrs, meta, taps


def _check_cuda_args(name, parts, kernel, bias, cin_axis):
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"{name}: takes 1 to {MAX_PARTS} parts, got {len(parts)}")
    x0 = parts[0]
    cuda_lib.dtype_code(x0, name)
    for t in (*parts, kernel):
        if t.device != x0.device:
            raise ValueError(f"{name}: all tensors must be on {x0.device}")
        if t.dtype != x0.dtype:
            raise TypeError(f"{name}: parts and kernel must share one dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous (NDHWC)")
    for p in parts:
        if p.dim() != 5 or p.shape[:4] != x0.shape[:4]:
            raise ValueError(f"{name}: parts must be NDHWC of one shape, got "
                             f"{[tuple(q.shape) for q in parts]}")
    if kernel.dim() != 5 or math.prod(kernel.shape[:3]) > MAX_TAPS:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} unsupported")
    if sum(int(p.shape[-1]) for p in parts) != kernel.shape[cin_axis]:
        raise ValueError(f"{name}: input channels do not match the kernel")
    cout = kernel.shape[7 - cin_axis]
    if bias is not None and (bias.dtype != torch.float32 or bias.device != x0.device
                             or not bias.is_contiguous() or bias.numel() != cout):
        raise ValueError(f"{name}: bias must be contiguous float32 of {cout} "
                         f"on {x0.device}")
    cuda_lib.require_no_grad(name, *parts, kernel, bias)


# ------------------------------------------------------------------- K1
def conv3d_plain(parts, kernel, bias=None, strides=(1, 1, 1)):
    """Plain twin of K1: per-part SAME conv in fp32, summed, + bias, rounded
    once to the input dtype."""
    ks, st = tuple(kernel.shape[:3]), tuple(strides)
    y, off = None, 0
    for p in parts:
        ci = int(p.shape[-1])
        w = kernel[..., off:off + ci, :].float().permute(4, 3, 0, 1, 2)
        off += ci
        pads = []
        for axis in (2, 1, 0):  # F.pad lists the last axis first
            _, lo, hi = same_pads(int(p.shape[1 + axis]), ks[axis], st[axis])
            pads += [lo, hi]
        xt = F.pad(p.float().permute(0, 4, 1, 2, 3), pads)
        yi = F.conv3d(xt, w, stride=st)
        y = yi if y is None else y + yi
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(parts[0].dtype)


def conv3d(parts, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
           strides: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """K1: SAME conv of a list of NDHWC channel parts with one DHWIO kernel
    (the parts' channels stack along the kernel's I axis); fp32 ``bias``.

    Replaces ``benchmarks/r2_probe_pallas_mxu.py:80`` ``conv_probe`` (TPU
    kernel table row 1). Bound on the H100: bytes for the path's
    few-channel, large-extent convs, operations for the deep 3x3x3 ones. The
    design gathers the implicit im2col tile straight into shared memory (no
    im2col tensor in device memory) and sizes tiles by Cout; it computes in
    fp32 FMA, not on the tensor cores (csrc/conv3d.cu has the full note).
    """
    parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
    if not cuda_lib.use_kernel("conv3d", parts[0]):
        return conv3d_plain(parts, kernel, bias, strides)
    _check_cuda_args("conv3d", parts, kernel, bias, cin_axis=3)
    x0 = parts[0]
    plan = forward_plan(tuple(kernel.shape[:3]), tuple(strides),
                        tuple(x0.shape[1:4]))
    y = torch.empty((x0.shape[0], *plan["out"], kernel.shape[4]),
                    dtype=x0.dtype, device=x0.device)
    ptrs, meta, taps = _pack_conv_args(parts, kernel, bias, y, plan, False)
    lib = cuda_lib.library()
    conv3d.launches += 1
    rc = lib.pmr_conv3d(ptrs.ctypes.data, meta.ctypes.data, taps.ctypes.data,
                        cuda_lib.stream_of(x0))
    cuda_lib.check(rc, "conv3d")
    return y


conv3d.launches = 0


# ------------------------------------------------------------------- K2
def conv3d_transpose_plain(x, kernel, bias=None, strides=(1, 1, 1)):
    """Plain twin of K2: torch's full transposed conv (padding 0), cropped
    to the SAME window [c, c + n*s) per axis, in fp32."""
    ks, st = tuple(kernel.shape[:3]), tuple(strides)
    y = F.conv_transpose3d(x.float().permute(0, 4, 1, 2, 3),
                           kernel.float().permute(4, 3, 0, 1, 2), stride=st)
    for axis in range(3):
        c = transpose_offset(ks[axis], st[axis])
        size = int(x.shape[1 + axis]) * st[axis]
        short = c + size - y.shape[2 + axis]
        if short > 0:  # kernel narrower than the stride: the tail is zero
            pad = [0, 0] * (2 - axis) + [0, short] + [0, 0] * axis
            y = F.pad(y, pad)
        y = y.narrow(2 + axis, c, size)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)


def conv3d_transpose(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     strides: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """K2: SAME transposed conv (TF / flax ``transpose_kernel=True``) of an
    NDHWC tensor with a ``(kd, kh, kw, Cout, Cin)`` kernel; output n * s.

    Replaces the transposed use of ``conv_probe`` (TPU kernel table row 1).
    Same bound and tiles as K1; each block holds one output phase, so it
    multiplies only the taps that phase reads, never a dilated input's
    zeros.
    """
    if not cuda_lib.use_kernel("conv3d_transpose", x):
        return conv3d_transpose_plain(x, kernel, bias, strides)
    _check_cuda_args("conv3d_transpose", [x], kernel, bias, cin_axis=4)
    plan = transpose_plan(tuple(kernel.shape[:3]), tuple(strides),
                          tuple(x.shape[1:4]))
    if len(plan["phases"]) > MAX_PHASES:
        raise ValueError(f"conv3d_transpose: strides {tuple(strides)} give more "
                         f"than {MAX_PHASES} phases")
    y = torch.empty((x.shape[0], *plan["out"], kernel.shape[3]),
                    dtype=x.dtype, device=x.device)
    ptrs, meta, taps = _pack_conv_args([x], kernel, bias, y, plan, True)
    lib = cuda_lib.library()
    conv3d_transpose.launches += 1
    rc = lib.pmr_conv3d_transpose(ptrs.ctypes.data, meta.ctypes.data,
                                  taps.ctypes.data, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv3d_transpose")
    return y


conv3d_transpose.launches = 0


# --------------------------------------------------------------- modules
def _compute_dtype(cfg: ConvConfig, x: torch.Tensor, kernel: torch.Tensor):
    # flax promote_dtype: an explicit dtype wins, else the promoted type
    return cfg.dtype if cfg.dtype is not None else torch.promote_types(
        x.dtype, kernel.dtype)


class Conv3d(nn.Module):
    """SAME 3D conv over one tensor or a part list (JAX ``nn.Conv`` /
    ``SplitInputConv``; parameters ``kernel`` DHWIO and ``bias``)."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 strides=(1, 1, 1), cfg: ConvConfig = ConvConfig()):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(
            *self.kernel_size, in_channels, features, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=cfg.param_dtype)) \
            if cfg.use_bias else None

    def forward(self, parts) -> torch.Tensor:
        parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
        dt = _compute_dtype(self.cfg, parts[0], self.kernel)
        parts = [p.to(dt) for p in parts]
        bias = self.bias.float() if self.bias is not None else None
        return conv3d(parts, self.kernel.to(dt), bias, self.strides)


class ConvTranspose3d(nn.Module):
    """SAME transposed conv in the TF Conv3DTranspose convention (JAX
    ``nn.ConvTranspose(transpose_kernel=True)``; kernel (kd,kh,kw,out,in))."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides,
                 cfg: ConvConfig = ConvConfig()):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(
            *self.kernel_size, features, in_channels, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=cfg.param_dtype)) \
            if cfg.use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.cfg, x, self.kernel)
        bias = self.bias.float() if self.bias is not None else None
        return conv3d_transpose(x.to(dt), self.kernel.to(dt), bias, self.strides)


# ----------------------------------------------------------- initializers
def _orthogonal(shape, gen):
    # flax orthogonal(column_axis=-1): QR of a normal matrix over
    # (prod(leading), last), sign-fixed by diag(R)
    n_rows, n_cols = math.prod(shape[:-1]), shape[-1]
    big, small = max(n_rows, n_cols), min(n_rows, n_cols)
    a = torch.randn(big, small, generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).float()


def _truncated_normal(shape, gen, stddev=0.001):
    # flax truncated_normal: +/-2 sigma, rescaled to the requested stddev
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (stddev / 0.87962566103423978)


def _glorot_uniform(shape, gen):
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2 - 1) * limit


INITIALIZERS = {
    "orthogonal": _orthogonal,
    "truncated_normal": _truncated_normal,
    "zeros": lambda shape, gen: torch.zeros(shape),
    "glorot_uniform": _glorot_uniform,
}


def resolve_initializer(spec):
    """A name of INITIALIZERS or a callable ``(shape, generator) -> tensor``."""
    return INITIALIZERS[spec] if isinstance(spec, str) else spec
