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

Three kernels live here, each with its plain PyTorch twin and its launch
counter, all on the tensor cores (the sources' notes say how), bf16
directly and fp32 error-compensated (K1/K2 as 3xTF32, K6 in three bf16
parts):

  * K1 :func:`conv3d` — forward conv over a list of up to MAX_PARTS channel
    parts (``SplitInputConv``'s identity ``conv(concat(parts), W) = sum_i
    conv(part_i, W_i)``), with fp32 bias and fp32 accumulation;
  * K2 :func:`conv3d_transpose` — the SAME transposed conv, output ``n * s``
    (K1 and K2: on Hopper's wgmma with halo tiles in shared memory, bf16
    directly and fp32 as 3xTF32, ``csrc/conv3d_wgmma.cu`` and
    :func:`wgmma_plan`; :func:`kernel_route` names the route);
  * K6 :func:`conv3d_wgrad` — the weight gradient of both, on wgmma with
    halo boxes too (``csrc/conv3d_wgrad.cu`` and :func:`wgrad_plan`).

K1 and K2 are differentiable where autograd asks for it (a
``torch.autograd.Function`` each): their data gradients are each other
(K2 of the output gradient for K1, cropped where an input extent is not
the output extent times the stride; K1 for K2), their weight gradients K6.
Without grad (serving, ``torch.no_grad()``) they save nothing and launch
what the forward alone launches. On a CPU (or meta) tensor each wrapper
runs its plain twin; on a CUDA tensor it launches its kernel or raises.
While ``torch.export`` traces (``cuda_lib.exporting``), K1's and K2's
wrappers call the registered operators ``pmr::conv3d`` and
``pmr::conv3d_transpose`` instead: one node each in the exported program,
dispatched by device where it runs (``export.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_lib

MAX_PARTS = 6   # csrc/conv_params.cuh kMaxParts: a dense-skip ladder's stage-0 stitch
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
    callables (see :func:`resolve_initializer`); the L2 coefficients feed
    :func:`l2_penalty` through the model's config.
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


# --------------------------------- K1/K2: halo tiles on wgmma (Hopper)
# csrc/conv3d_wgmma.cu, bf16 and fp32 (3xTF32). A block owns WG_ROWS output
# voxels of one sample, a box of them (tile) or WG_ROWS consecutive rows
# (flat: 1x1x1 at stride 1); for each part and channel slab the producer
# brings the input box its taps read into shared memory once, and the
# consumers read every tap's rows of it. See the source's note for the
# design; here the plan and host arrays. Per dtype: the tile widths, the
# blocks of each width an SM holds (the kernel's launch bounds), a weight
# stage's K (128 bytes of a row) and the slab widths (a voxel 128, 64, 32
# or 16 bytes).
WG_ROWS = 128              # output rows a block: two consumer warpgroups of 64
WG_TILES_N = {torch.bfloat16: (8, 16, 32, 64, 128), torch.float32: (8, 16, 32, 64)}
WG_RESIDENT = {torch.bfloat16: {8: 2, 16: 2, 32: 2, 64: 1, 128: 1},
               torch.float32: {8: 1, 16: 1, 32: 1, 64: 1}}
WG_KSTAGE = {torch.bfloat16: 64, torch.float32: 32}
WG_SLAB_WIDTHS = {torch.bfloat16: (64, 32, 16, 8), torch.float32: (32, 16, 8, 4)}
WG_A_STAGES, WG_B_STAGES = (2, 4), 4  # box stages: 2 to 4 as they fit; weight stages
WG_A_STAGES_RESIDENT = 8   # fp32: box stages beside resident weights, as they fit
WG_RAW_STAGES = (3, 8)     # fp32: raw weight stages in flight, as many as fit beside the rings
WG_CHAIN_STAGES = 8        # fp32: weight stages a TF32 chain runs (kChainStages)
WG_SMEM_SM = 233472        # shared memory of an H100 SM (228 KB)
WG_SMEM_BLOCK = 232448     # the most one block may take (227 KB)
WG_SMEM_RESERVED = 1024    # the runtime's own per block
WG_SMEM_EXTRA = 1024 + 1408  # alignment slack of the dynamic base; barriers, tap tables
WG_MIN_STAGES_PER_SPLIT = 4
# waves of units split-K fills: fp32's one block an SM pays a unit's pipeline
# fill and drain, which more, shorter units a block hide
WG_SPLIT_WAVES = {torch.bfloat16: 1, torch.float32: 3}
WG_BOX_MAX = 256           # TMA's largest box extent
WG_TILE_SHAPES = tuple((d, h, w) for w in (8, 16, 32, 64, 128) for h in (1, 2, 4, 8, 16)
                       for d in (1, 2, 4, 8) if d * h * w == WG_ROWS)
WG_META = 98               # int32 fields of the host array (_wgmma_host)
SMS = 132                  # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 64
MAX_INDEX = 2 ** 31        # the kernel's row, voxel and element indices are int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _vec(dtype) -> int:
    """Elements of a 16-byte chunk: 8 bf16, 4 fp32."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def wgmma_slabs(cin: int, width: int, tma: bool, dtype):
    """The channel slabs of one part: (first channel, slab width) each.
    Every slab is ``width`` channels wide; a part on the staged route
    narrows its last slab to the least power of two (at least a 16-byte
    chunk: 8 bf16, 4 fp32) that holds what is left, while TMA's map has one
    box width and zero-fills the last slab's tail."""
    vec = _vec(dtype)
    out = []
    for c0 in range(0, cin, width):
        w = width if tma else min(width, max(vec, _pow2_at_least(cin - c0)))
        out.append((c0, w))
    return out


def _wgmma_smem(box_vox, width, bn, transposed, a_stages, dtype, resident=0,
                raw=WG_RAW_STAGES[0]):
    """(A stage, B stage, dynamic shared memory) bytes of one block: the
    box and weight rings (fp32: a stage is the hi and lo tiles, the raw
    stages ride beside the ring, and ``resident`` > 0 holds that many
    stages, every one of the call's, in place of the ring; ``raw`` raw
    stages), bf16's epilogue
    rows (BN + 4 floats each; fp32 writes from its registers) and the
    control block."""
    def kb(n):
        return -(-n // 1024) * 1024

    esize = 16 // _vec(dtype)
    a_stage = kb(box_vox * esize * width)
    if dtype == torch.float32:
        b_stage, raw, epi = 2 * bn * 128, raw * bn * 128, 0
    else:
        b_stage, raw = (kb(bn * 128) if transposed else 8192 * -(-bn // 64)), 0
        epi = WG_ROWS * (bn + 4) * 4
    rings = a_stages * a_stage + (resident or WG_B_STAGES) * b_stage + raw
    return a_stage, b_stage, rings + epi + WG_SMEM_EXTRA


def wgmma_plan(part_shapes, kernel_shape, strides, transposed, tma_ok=None, *, dtype):
    """Tile, slabs, routes and split-K of the kernel (csrc/conv3d_wgmma.cu)
    for one K1/K2 call in ``dtype`` (bf16 or fp32), from its shapes
    (``tma_ok``: per part, whether its base is 16-byte aligned; default
    all).

    * Geometry: the window plan's grid, in the kernel's view. A 1x1x1 conv
      at stride 1 is flat: one row of R = batch x voxels, tiles of WG_ROWS
      consecutive rows, no halo. Otherwise a tile is a box (td, th, tw) of
      WG_ROWS output voxels (WG_TILE_SHAPES) and its input box spans
      (t - 1) * in_mul + (hi - lo) + 1 a axis (lo, hi: the least and
      greatest tap offset over every phase); the tile is the one of least
      tiles x (box voxels + WG_ROWS): the voxels loaded a tile beside the
      rows it computes.
    * Slabs: every part's channels in slabs of one ``width`` (the widest of
      WG_SLAB_WIDTHS[dtype] that is no wider than the widest part needs and
      whose two box stages fit the block's shared memory beside the weight
      ring and the epilogue's rows); then as many box stages, up to four,
      as fit (``a_stages``: the producer runs further ahead of small
      boxes); a part narrower than ``width`` takes the least power of two
      of at least a 16-byte chunk that holds it (wgmma_slabs).
    * fp32's weights: where every unit takes the same ones (one channel
      tile, no split), and all of the call's weight stages fit beside the
      box stages, a block converts them once and keeps them
      (``resident``, with up to WG_A_STAGES_RESIDENT box stages); then as
      many raw stages in flight (``raw_stages``, 3-8) as fit.
    * Routes: a part goes by TMA where its channels make a 16-byte voxel
      stride (bf16 a multiple of 8, fp32 of 4) and its base is aligned,
      else "staged" (loaded through the producer's registers, each element
      once a block). The weights go by 16-byte loads where cout (K1) or
      cin (K2) is a multiple of a chunk, else element by element (bf16 by
      TMA or through registers; fp32 by cp.async into raw stages, split
      into TF32 hi and lo by the producer).
    * Split-K: a phase's K is its slabs' weight stages, ceil(ntap x width /
      WG_KSTAGE[dtype]) a slab. Where the output tiles fill less than
      ``target`` (WG_SPLIT_WAVES[dtype] waves of SMS x WG_RESIDENT), the
      stages are split into the most splits that fit it, a split keeping
      WG_MIN_STAGES_PER_SPLIT stages on average and at least one in every
      phase; split j of a phase of L stages walks [L*j // splits,
      L*(j+1) // splits), and the splits' fp32 partials are summed in split
      order by a second kernel.
    * Blocks: ``grid`` persistent blocks (at most one wave) walk the
      ``units`` (tile, channel tile, phase, split), block i taking units
      i, i + grid, ... A K2 call whose slabs' boxes all fit as box stages
      (one slab, or up to four without split-K: ``phase_loop``) makes a
      unit of every phase of a tile: its boxes load once, not once a
      phase.
    """
    cins = [int(s[-1]) for s in part_shapes]
    batch, in_spatial = int(part_shapes[0][0]), tuple(int(n) for n in part_shapes[0][1:4])
    ks = tuple(int(k) for k in kernel_shape[:3])
    cout = int(kernel_shape[3 if transposed else 4])
    geom = window_plan(ks, strides, in_spatial, transposed)
    tma_ok = [True] * len(cins) if tma_ok is None else list(tma_ok)
    vec, kstage, resident = _vec(dtype), WG_KSTAGE[dtype], WG_RESIDENT[dtype]
    bn = next((b for b in WG_TILES_N[dtype] if cout <= b), WG_TILES_N[dtype][-1])
    nphase = len(geom["phases"])
    flat = (ks == (1, 1, 1) and geom["in_mul"] == (1, 1, 1) and geom["in_add"] == (0, 0, 0)
            and geom["out_mul"] == (1, 1, 1) and nphase == 1)
    if flat:
        rows = batch * math.prod(geom["grid"])
        view = dict(batch=1, ind=(1, 1, rows), outd=(1, 1, rows), grid=(1, 1, rows),
                    in_mul=(1, 1, 1), in_add=(0, 0, 0), out_mul=(1, 1, 1), lo=(0, 0, 0))
        tile, box = (1, 1, WG_ROWS), (1, 1, WG_ROWS)
    else:
        offs = [t[:3] for _, taps in geom["phases"] for t in taps]
        lo = tuple(min(o[a] for o in offs) for a in range(3))
        hi = tuple(max(o[a] for o in offs) for a in range(3))
        view = dict(batch=batch, ind=in_spatial, outd=geom["out"], grid=geom["grid"],
                    in_mul=geom["in_mul"], in_add=geom["in_add"], out_mul=geom["out_mul"],
                    lo=lo)

        def box_of(t):
            return tuple((t[a] - 1) * geom["in_mul"][a] + hi[a] - lo[a] + 1 for a in range(3))

        def cost(t):
            tiles = math.prod(-(-g // e) for g, e in zip(geom["grid"], t))
            return tiles * (math.prod(box_of(t)) + WG_ROWS), -t[2]

        fits = [t for t in WG_TILE_SHAPES if max(box_of(t)) <= WG_BOX_MAX]
        tile = min(fits, key=cost)
        box = box_of(tile)
    box_vox = math.prod(box)
    budget = (WG_SMEM_BLOCK if resident[bn] == 1
              else (WG_SMEM_SM - resident[bn] * WG_SMEM_RESERVED) // resident[bn])

    def smem(w, n=WG_A_STAGES[0], resident=0, raw=WG_RAW_STAGES[0]):
        return _wgmma_smem(box_vox, w, bn, transposed, n, dtype, resident, raw)

    widest = max(vec, _pow2_at_least(max(cins)))
    width = next((w for w in WG_SLAB_WIDTHS[dtype] if w <= widest and smem(w)[2] <= budget),
                 WG_SLAB_WIDTHS[dtype][-1])
    a_stages = max(n for n in range(WG_A_STAGES[0], WG_A_STAGES[1] + 1)
                   if n == WG_A_STAGES[0] or smem(width, n)[2] <= budget)
    a_stage, b_stage, smem_bytes = smem(width, a_stages)
    widths = [min(width, max(vec, _pow2_at_least(c))) for c in cins]
    tma = [c % vec == 0 and ok for c, ok in zip(cins, tma_ok)]
    slabs = [wgmma_slabs(c, w, t, dtype) for c, w, t in zip(cins, widths, tma)]
    stages = tuple(sum(-(-len(taps) * w // kstage) for sl in slabs for _, w in sl)
                   for _, taps in geom["phases"])
    ws = [w for sl in slabs for _, w in sl]
    tiles_axis = tuple(-(-g // t) for g, t in zip(view["grid"], tile))
    m_tiles = view["batch"] * math.prod(tiles_axis)
    n_tiles = -(-cout // bn)
    tiles = m_tiles * n_tiles * nphase
    wave = SMS * resident[bn]
    target = wave * WG_SPLIT_WAVES[dtype]
    cap = max(1, min(min(stages), sum(stages) // (nphase * WG_MIN_STAGES_PER_SPLIT),
                     MAX_SPLITS))
    splits = max(1, min(target // tiles, cap))
    ranges = tuple(tuple((n * j // splits, n * (j + 1) // splits) for j in range(splits))
                   for n in stages)
    # a K2 call walks all its phases in a unit over boxes loaded once, where
    # its slabs' boxes fit as the ring's stages (one slab at any split; up
    # to four without split-K, the box stages then the slabs)
    # (several slabs: where the looped units still fill a wave, or a part
    # is staged, whose loads once a phase would cost the producer most)
    nslab = sum(len(sl) for sl in slabs)
    phase_loop = nphase > 1 and (nslab == 1 or (
        splits == 1 and nslab <= WG_A_STAGES[1]
        and smem(width, max(nslab, 2))[2] <= budget
        and (m_tiles * n_tiles >= target or not all(tma))))
    if phase_loop:
        a_stages = max(nslab, WG_A_STAGES[0])
        a_stage, b_stage, smem_bytes = smem(width, a_stages)
    # fp32: where every unit takes the same weights (one channel tile, no
    # split) and all of the call's weight stages fit beside the box stages,
    # a block converts them once and keeps them (``resident``: the stages),
    # with up to WG_A_STAGES_RESIDENT box stages
    resident = 0
    if dtype == torch.float32 and splits == 1 and n_tiles == 1:
        lows = [a_stages] if phase_loop else range(WG_A_STAGES[0], WG_A_STAGES_RESIDENT + 1)
        fit = [n for n in lows if smem(width, n, sum(stages))[2] <= budget]
        if fit:
            resident, a_stages = sum(stages), max(fit)
            a_stage, b_stage, smem_bytes = smem(width, a_stages, resident)
    # fp32: then as many raw weight stages in flight as fit (the least, 3,
    # is what the choices above counted)
    raw = WG_RAW_STAGES[0]
    if dtype == torch.float32:
        raw = max(n for n in range(WG_RAW_STAGES[0], WG_RAW_STAGES[1] + 1)
                  if n == WG_RAW_STAGES[0] or smem(width, a_stages, resident, n)[2] <= budget)
        a_stage, b_stage, smem_bytes = smem(width, a_stages, resident, raw)
    units = m_tiles * n_tiles * (1 if phase_loop else nphase) * splits
    out_numel = batch * math.prod(geom["out"]) * cout
    return dict(geom=geom, view=view, flat=flat, tile=tile, box=box, box_vox=box_vox,
                width=width, widths=widths, tma=tma, slabs=slabs, bn=bn, cout=cout,
                stages=stages, ranges=ranges, tiles_axis=tiles_axis, m_tiles=m_tiles,
                n_tiles=n_tiles, tiles=tiles, target=target, cap=cap, splits=splits,
                blocks=tiles * splits, phase_loop=phase_loop, resident=resident,
                raw_stages=raw, units=units,
                wave=wave, grid=min(units, wave), dtype=dtype,
                a_stage=a_stage, a_stages=a_stages, b_stage=b_stage, smem=smem_bytes,
                wbox=min(ws), wtaps=kstage // min(ws) if len(set(ws)) == 1 else 1,
                budget=budget, workspace=splits * out_numel if splits > 1 else 0,
                out=(batch, *geom["out"], cout))


@functools.lru_cache(maxsize=512)
def _wgmma_host(part_shapes, kernel_shape, strides, transposed, tma_ok, has_bias, b_vec, dtype):
    """The plan and the two host arrays of csrc/conv3d_wgmma.cu that depend
    only on the call's shapes, strides, dtype, bias presence and pointers'
    alignment: built once, so a call only writes its pointers
    (csrc/conv3d_wgmma.cu unpack lists the fields; P = MAX_PARTS).

    meta (int32[WG_META]): 0 nparts; 1..6 cin; 7..12 slab width; 13 bit p:
      part p by TMA; 14 weights by 16-byte loads; 15 cin total; 16 batch;
      17-19 input D,H,W; 20-22 output D,H,W; 23-25 row grid D,H,W (the
      kernel's view: flat is one row of R voxels); 26 cout; 27-29 in_mul;
      30-32 in_add; 33-35 out_mul; 36-38 lo (least tap offset); 39-41
      tile; 42-44 input box; 45-47 tiles a grid axis; 48 nphase; 49-56
      taps a phase; 57-80 phase residues; 81 splits; 82 transposed; 83
      tile n; 84 has bias; 85 A stage bytes; 86 B stage bytes; 87 dynamic
      shared memory; 88 m tiles; 89 dtype code; 90 persistent blocks; 91
      the kernel's taps; 92 box stages; 93, 94 the bf16 K1 weight box's
      rows (the narrowest slab) and taps (WG_KSTAGE / rows where every
      slab is that wide, else 1); 95 phase loop (a unit walks every phase
      of its tile over its boxes, slab i in box stage i); 96 fp32's resident
      weight stages (0: a ring of WG_B_STAGES); 97 fp32's raw weight stages
      in flight.
    taps (int8[8, 27, 4]): per phase and tap, (dz, dy, dx, weight tap).
    """
    plan = wgmma_plan(part_shapes, kernel_shape, strides, transposed, tma_ok, dtype=dtype)
    cins = [int(s[-1]) for s in part_shapes]
    v, geom = plan["view"], plan["geom"]
    meta = np.zeros(WG_META, np.int32)
    meta[0] = len(cins)
    meta[1:1 + len(cins)] = cins
    meta[7:7 + len(cins)] = plan["widths"]
    meta[13] = sum(1 << i for i, t in enumerate(plan["tma"]) if t)
    meta[14] = b_vec
    meta[15] = sum(cins)
    meta[16] = v["batch"]
    meta[17:20], meta[20:23], meta[23:26] = v["ind"], v["outd"], v["grid"]
    meta[26] = plan["cout"]
    meta[27:30], meta[30:33], meta[33:36] = v["in_mul"], v["in_add"], v["out_mul"]
    meta[36:39], meta[39:42], meta[42:45] = v["lo"], plan["tile"], plan["box"]
    meta[45:48] = plan["tiles_axis"]
    meta[48] = len(geom["phases"])
    taps = np.zeros((MAX_PHASES, MAX_TAPS, 4), np.int8)
    for i, (res, tp) in enumerate(geom["phases"]):
        meta[49 + i] = len(tp)
        meta[57 + 3 * i:60 + 3 * i] = (0, 0, 0) if plan["flat"] else res
        taps[i, :len(tp)] = tp
    meta[81], meta[82], meta[83] = plan["splits"], transposed, plan["bn"]
    meta[84] = has_bias
    meta[85], meta[86], meta[87] = plan["a_stage"], plan["b_stage"], plan["smem"]
    meta[88] = plan["m_tiles"]
    meta[89] = cuda_lib.DTYPE_CODES[dtype]
    meta[90] = plan["grid"]
    meta[91] = math.prod(kernel_shape[:3])
    meta[92] = plan["a_stages"]
    meta[93] = plan["wbox"]
    meta[94] = plan["wtaps"]
    meta[95] = plan["phase_loop"]
    meta[96] = plan["resident"]
    meta[97] = plan["raw_stages"]
    meta.setflags(write=False)
    taps.setflags(write=False)
    return plan, meta, taps


def wgmma_args(parts, kernel, bias, strides, transposed):
    """Everything one launch of the kernel takes, in the parts' dtype: the
    output, the split-K workspace (None without split-K), the plan and the
    host arrays (ptrs: the parts, kernel, bias, output, workspace).
    Device-agnostic, so the CPU tests replay the very schedule the card
    runs."""
    # the weights' last axis is the one the 16-byte loads run along: K1's
    # cout (DHWIO), K2's cin ((kd, kh, kw, Cout, Cin))
    x0 = parts[0]
    plan, meta, taps = _wgmma_host(
        tuple(tuple(p.shape) for p in parts), tuple(kernel.shape), tuple(strides),
        bool(transposed), tuple(p.data_ptr() % 16 == 0 for p in parts), bias is not None,
        int(kernel.shape[4]) % _vec(x0.dtype) == 0 and kernel.data_ptr() % 16 == 0, x0.dtype)
    y = torch.empty(plan["out"], dtype=x0.dtype, device=x0.device)
    ws = None
    if plan["splits"] > 1:
        ws = torch.empty((plan["splits"], y.numel()), dtype=torch.float32, device=x0.device)
    ptrs = np.zeros(MAX_PARTS + 4, np.uint64)
    for i, p in enumerate(parts):
        ptrs[i] = p.data_ptr()
    ptrs[MAX_PARTS] = kernel.data_ptr()
    ptrs[MAX_PARTS + 1] = bias.data_ptr() if bias is not None else 0
    ptrs[MAX_PARTS + 2] = y.data_ptr()
    ptrs[MAX_PARTS + 3] = ws.data_ptr() if ws is not None else 0
    return y, ws, plan, (ptrs, meta, taps)


def window_plan(kernel_size, strides, in_spatial, transposed):
    """:func:`transpose_plan` for K2, :func:`forward_plan` for K1."""
    fn = transpose_plan if transposed else forward_plan
    return fn(tuple(kernel_size), tuple(strides), tuple(in_spatial))


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


def kernel_route(dtype: torch.dtype) -> str:
    """Which CUDA kernel runs K1/K2 in ``dtype``: Hopper's wgmma with halo
    tiles (csrc/conv3d_wgmma.cu), bf16 directly and fp32 as 3xTF32."""
    if dtype not in WG_KSTAGE:
        raise TypeError(f"K1/K2 take float32 or bfloat16, got {dtype}")
    return "wgmma"


def _launch(name, fn, parts, kernel, bias, strides, transposed):
    """Launch K1 or K2 on the wgmma kernel (``fn`` is the wrapper, whose
    count rises by one)."""
    x0 = parts[0]
    lib = cuda_lib.library()
    y, _ws, _, arrays = wgmma_args(parts, kernel, bias, strides, transposed)
    if max(t.numel() for t in (*parts, y)) >= MAX_INDEX:
        raise ValueError(f"{name}: the kernel takes tensors of fewer than 2**31 elements")
    fn.launches += 1
    rc = lib.pmr_conv3d_wgmma(*(a.ctypes.data for a in arrays), cuda_lib.stream_of(x0))
    cuda_lib.check(rc, name)
    return y


# ------------------------------------------------------------------- K1
def _acc(t: torch.Tensor) -> torch.dtype:
    # the plain twins' arithmetic type: fp32, or fp64 for an fp64 reference
    return torch.promote_types(t.dtype, torch.float32)


def conv3d_plain(parts, kernel, bias=None, strides=(1, 1, 1)):
    """Plain twin of K1: per-part SAME conv in fp32 (fp64 for fp64 input),
    summed, + bias, rounded once to the input dtype."""
    ks, st = tuple(kernel.shape[:3]), tuple(strides)
    acc = _acc(parts[0])
    y, off = None, 0
    for p in parts:
        ci = int(p.shape[-1])
        w = kernel[..., off:off + ci, :].to(acc).permute(4, 3, 0, 1, 2)
        off += ci
        pads = []
        for axis in (2, 1, 0):  # F.pad lists the last axis first
            _, lo, hi = same_pads(int(p.shape[1 + axis]), ks[axis], st[axis])
            pads += [lo, hi]
        xt = F.pad(p.to(acc).permute(0, 4, 1, 2, 3), pads)
        yi = F.conv3d(xt, w, stride=st)
        y = yi if y is None else y + yi
    if bias is not None:
        y = y + bias.to(acc).view(1, -1, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(parts[0].dtype)


def conv3d(parts, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
           strides: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """K1: SAME conv of a list of NDHWC channel parts with one DHWIO kernel
    (the parts' channels stack along the kernel's I axis); fp32 ``bias``.

    Replaces ``benchmarks/r2_probe_pallas_mxu.py:80`` ``conv_probe`` (TPU
    kernel table row 1). Bound on the H100: bytes for the path's
    few-channel, large-extent convs, operations for the deep 3x3x3 ones.
    No im2col tensor reaches device memory (csrc/conv3d_wgmma.cu): each
    block loads the input box its taps read into shared memory once a
    channel slab (TMA, or staged loads at widths that make no 16-byte
    voxel stride) and a producer warpgroup feeds wgmma consumers over
    mbarrier rings. fp32 runs as 3xTF32 (each operand split into two TF32
    halves, three products), which holds the fp32 limits where TF32 alone
    could not. K is split deterministically where the output tiles
    underfill the card.
    """
    parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
    strides = tuple(int(s) for s in strides)
    if _needs_grad(*parts, kernel, bias):
        return _Conv3dFn.apply(kernel, bias, strides, *parts)
    if cuda_lib.exporting():
        return torch.ops.pmr.conv3d(parts, kernel, bias, list(strides))
    return _conv3d_forward(parts, kernel, bias, strides)


conv3d.launches = 0


def _conv3d_forward(parts, kernel, bias, strides):
    if not cuda_lib.use_kernel("conv3d", parts[0]):
        return conv3d_plain(parts, kernel, bias, strides)
    return _conv3d_cuda(parts, kernel, bias, strides)


def _conv3d_cuda(parts, kernel, bias, strides):
    _check_cuda_args("conv3d", parts, kernel, bias, cin_axis=3)
    return _launch("conv3d", conv3d, list(parts), kernel, bias, tuple(strides), False)


def _conv3d_fake(parts, kernel, bias, strides):
    x0 = parts[0]
    out = [same_pads(int(n), int(k), int(s))[0]
           for n, k, s in zip(x0.shape[1:4], kernel.shape[:3], strides)]
    return x0.new_empty((x0.shape[0], *out, kernel.shape[4]))


cuda_lib.register_op(
    "conv3d", "(Tensor[] parts, Tensor kernel, Tensor? bias, int[] strides) -> Tensor",
    cpu=lambda parts, kernel, bias, strides: conv3d_plain(parts, kernel, bias, strides),
    cuda=_conv3d_cuda, fake=_conv3d_fake)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _bias_grad(g: torch.Tensor) -> torch.Tensor:
    # the fp32 bias's gradient: the output gradient summed over all but C,
    # in fp32 (fp64 for fp64 input)
    return g.sum(dim=tuple(range(g.dim() - 1)), dtype=_acc(g))


def dgrad_crop(in_spatial, out_spatial, kernel_size, strides):
    """Where K1's input gradient sits in K2's output. K2 of the output
    gradient (extents o) gives the input gradient of a SAME conv over
    extents o * s, whose low pads are lo' = same_pads(o * s, k, s); the
    input's own extent n (o = ceil(n / s), so n <= o * s) has low pads lo >=
    lo', and its gradient is K2's output on [lo - lo', lo - lo' + n) of each
    axis (the same sums: o * s + t - lo = i there). Returns the three slices,
    or None where n = o * s on every axis (the whole output)."""
    crop = []
    for n, o, k, s in zip(in_spatial, out_spatial, kernel_size, strides):
        n, o, k, s = int(n), int(o), int(k), int(s)
        start = same_pads(n, k, s)[1] - same_pads(o * s, k, s)[1]
        crop.append(slice(start, start + n))
    if all(c.start == 0 and c.stop == int(o) * int(s)
           for c, o, s in zip(crop, out_spatial, strides)):
        return None
    return tuple(crop)


class _Conv3dFn(torch.autograd.Function):
    """K1 with its backward: data gradient by K2 on the output gradient with
    K1's own DHWIO kernel (read as K2's ``(kd, kh, kw, Cout=I, Cin=O)``: TF's
    SAME Conv3DTranspose is the input gradient of SAME Conv3D), cropped to
    the input's extents where they are not the output's times the stride
    (:func:`dgrad_crop`) and split into the parts' channel slices; weight
    gradient by K6 a part; bias gradient by a sum."""

    @staticmethod
    def forward(ctx, kernel, bias, strides, *parts):
        ctx.strides = strides
        ctx.save_for_backward(kernel, *parts)
        return _conv3d_forward(list(parts), kernel, bias, strides)

    @staticmethod
    def backward(ctx, gy):
        kernel, *parts = ctx.saved_tensors
        gy, st = gy.contiguous(), ctx.strides
        need = ctx.needs_input_grad
        dparts = [None] * len(parts)
        if any(need[3:]):
            dx = conv3d_transpose(gy, kernel, None, st)
            crop = dgrad_crop(parts[0].shape[1:4], gy.shape[1:4], kernel.shape[:3], st)
            if crop is not None:  # a view, as the parts' channel slices are
                dx = dx[(slice(None), *crop)]
            off = 0
            for i, p in enumerate(parts):
                ci = int(p.shape[-1])
                if need[3 + i]:
                    dparts[i] = dx[..., off:off + ci]
                off += ci
        dk = None
        if need[0]:
            dws = [conv3d_wgrad(p, gy, kernel.shape[:3], st) for p in parts]
            dk = dws[0] if len(dws) == 1 else torch.cat(dws, dim=3)
        db = _bias_grad(gy) if need[1] else None
        return (dk, db, None, *dparts)


# ------------------------------------------------------------------- K2
def conv3d_transpose_plain(x, kernel, bias=None, strides=(1, 1, 1)):
    """Plain twin of K2: torch's full transposed conv (padding 0), cropped
    to the SAME window [c, c + n*s) per axis, in fp32 (fp64 for fp64
    input)."""
    ks, st = tuple(kernel.shape[:3]), tuple(strides)
    acc = _acc(x)
    y = F.conv_transpose3d(x.to(acc).permute(0, 4, 1, 2, 3),
                           kernel.to(acc).permute(4, 3, 0, 1, 2), stride=st)
    for axis in range(3):
        c = transpose_offset(ks[axis], st[axis])
        size = int(x.shape[1 + axis]) * st[axis]
        short = c + size - y.shape[2 + axis]
        if short > 0:  # kernel narrower than the stride: the tail is zero
            pad = [0, 0] * (2 - axis) + [0, short] + [0, 0] * axis
            y = F.pad(y, pad)
        y = y.narrow(2 + axis, c, size)
    if bias is not None:
        y = y + bias.to(acc).view(1, -1, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)


def conv3d_transpose(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     strides: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """K2: SAME transposed conv (TF / flax ``transpose_kernel=True``) of an
    NDHWC tensor with a ``(kd, kh, kw, Cout, Cin)`` kernel; output n * s.

    Replaces the transposed use of ``conv_probe`` (TPU kernel table row 1).
    Same bound and kernels as K1; each block holds one output phase, so it
    multiplies only the taps that phase reads, never a dilated input's
    zeros.
    """
    strides = tuple(int(s) for s in strides)
    if _needs_grad(x, kernel, bias):
        return _ConvTranspose3dFn.apply(x, kernel, bias, strides)
    if cuda_lib.exporting():
        return torch.ops.pmr.conv3d_transpose(x, kernel, bias, list(strides))
    return _conv3d_transpose_forward(x, kernel, bias, strides)


conv3d_transpose.launches = 0


def _conv3d_transpose_forward(x, kernel, bias, strides):
    if not cuda_lib.use_kernel("conv3d_transpose", x):
        return conv3d_transpose_plain(x, kernel, bias, strides)
    return _conv3d_transpose_cuda(x, kernel, bias, strides)


def _conv3d_transpose_cuda(x, kernel, bias, strides):
    strides = tuple(strides)
    _check_cuda_args("conv3d_transpose", [x], kernel, bias, cin_axis=4)
    plan = transpose_plan(tuple(kernel.shape[:3]), strides, tuple(x.shape[1:4]))
    if len(plan["phases"]) > MAX_PHASES:
        raise ValueError(f"conv3d_transpose: strides {strides} give more "
                         f"than {MAX_PHASES} phases")
    return _launch("conv3d_transpose", conv3d_transpose, [x], kernel, bias, strides, True)


def _conv3d_transpose_fake(x, kernel, bias, strides):
    out = [int(n) * int(s) for n, s in zip(x.shape[1:4], strides)]
    return x.new_empty((x.shape[0], *out, kernel.shape[3]))


cuda_lib.register_op(
    "conv3d_transpose", "(Tensor x, Tensor kernel, Tensor? bias, int[] strides) -> Tensor",
    cpu=lambda x, kernel, bias, strides: conv3d_transpose_plain(x, kernel, bias, strides),
    cuda=_conv3d_transpose_cuda, fake=_conv3d_transpose_fake)


class _ConvTranspose3dFn(torch.autograd.Function):
    """K2 with its backward: data gradient by K1 with the same strides on the
    output gradient with K2's kernel (read as K1's DHWIO, I = Cout, O = Cin);
    weight gradient by K6 with A = the output gradient (fine grid) and B =
    K2's input (coarse grid), already in K2's layout; bias by a sum."""

    @staticmethod
    def forward(ctx, x, kernel, bias, strides):
        ctx.strides = strides
        ctx.save_for_backward(x, kernel)
        return _conv3d_transpose_forward(x, kernel, bias, strides)

    @staticmethod
    def backward(ctx, gy):
        x, kernel = ctx.saved_tensors
        gy, st = gy.contiguous(), ctx.strides
        need = ctx.needs_input_grad
        dx = conv3d([gy], kernel, None, st) if need[0] else None
        dk = conv3d_wgrad(gy, x, kernel.shape[:3], st) if need[1] else None
        db = _bias_grad(gy) if need[2] else None
        return dx, dk, db, None


# ------------------------------------------------------------------- K6
# csrc/conv3d_wgrad.cu, bf16 and fp32 (three bf16 parts, six products in
# three wgmmas a step): a box of WGRAD_BOX output
# voxels is one K chunk; a block owns a group of taps x a slab of A's
# channels (its rows, in 64-row warpgroup tiles) by a tile of B's channels
# and walks a fixed range of the boxes, whose A halo box and B box the
# producer loads once each (TMA, or staged at odd widths and bases; an fp32
# operand that several blocks read split into bf16 planes first). See the
# source's note for the design; here the plan and the geometry array. Per
# dtype: the tile widths, the 64-row tiles a consumer warpgroup holds at
# each (the kernel's tiles_per_wg), the slab widths (at least a 16-byte bf16
# ldmatrix row of 8 channels; a box row of at most 128 bytes) and the bf16
# parts an element takes.
WGRAD_BOX = 128            # output voxels a box (kBox): one stage's K
WGRAD_TILES_N = {torch.bfloat16: (8, 16, 32, 64, 128), torch.float32: (8, 16, 32)}
WGRAD_MT = {torch.bfloat16: {8: 2, 16: 2, 32: 2, 64: 2, 128: 1},
            torch.float32: {8: 2, 16: 2, 32: 1}}
WGRAD_WIDTHS = {torch.bfloat16: (8, 16, 32, 64), torch.float32: (8, 16, 32)}
WGRAD_PARTS = {torch.bfloat16: 1, torch.float32: 3}  # bf16 parts an element (kParts)
WGRAD_STAGES = (2, 8)      # the ring: as many stages as fit (kMaxStages)
WGRAD_MIN_BOXES = 4        # boxes a split walks at least, on average
WGRAD_REDUCE_GROUPS = 8    # wgrad_reduce_kernel's split groups (kReduceGroups)
WGRAD_GEOM = 45            # int32 fields of the geometry array (kGeom)
WGRAD_SMEM_EXTRA = 1024 + 256  # alignment slack of the dynamic base; barriers, tap table
# the plan's cost model (relative, not measured rates): L2 bytes a second and
# the tensor rate it assumes a kernel reaches, per dtype (fp32: six bf16
# products a term)
WGRAD_L2_RATE = 5.5e12
WGRAD_RATE = {torch.bfloat16: 0.5 * 989e12, torch.float32: 0.5 * 989e12 / 6}
HBM_RATE = 3.35e12
WGRAD_BOX_LATENCY = 1.0e-6  # a box's fixed cost a block
# fp32 operands split into bf16 planes before the kernel where at least this
# many blocks would convert each box: A's boxes are read by the blocks of
# every tap group and channel tile of B, B's by those of every tap group and
# slab of A (stride 1 only: a strided gradient's B is the coarse grid). Like
# the schedule's rule (ping-pong for flat gradients), set from per-shape
# times at the cfg1 train step on an H100 (PERF.md).
WGRAD_PARTS_READS = (3, 4)


def _kb(n: int) -> int:
    return -(-int(n) // 1024) * 1024


@functools.lru_cache(maxsize=512)
def wgrad_plan(ashape, cb: int, kernel_size, strides, dtype: torch.dtype,
               tma=(True, True), schedules=None) -> dict:
    """Boxes, block tiles, schedule and split of K6 (csrc/conv3d_wgrad.cu) in
    ``dtype`` for A of ``ashape`` (NDHWC), ``cb`` channels of B and a SAME
    ``kernel_size`` / ``strides`` window (``tma``: whether A and B take the
    TMA route, :func:`wgrad_routes`; ``schedules``: the values of
    ``pingpong`` it may take, by default the one of WGRAD_PINGPONG's rule).

    * Boxes: B's grid in tiles of WGRAD_BOX output voxels (WG_TILE_SHAPES),
      whose halo box ((t - 1) s + k a axis) stays within TMA's 256; a 1x1x1
      gradient at stride 1 is flat, one row of batch x voxels in boxes of
      WGRAD_BOX.
    * Block tiles: B's channels in tiles of ``bn`` (of WGRAD_TILES_N[dtype],
      at most the least that holds CB); a block's rows are ``tpb`` taps x a
      slab of ``width`` of A's channels, at most 64 x WGRAD_MT[dtype][bn] a
      warpgroup.
    * Schedule: split (the two consumer warpgroups share each box's rows)
      or ping-pong (``pingpong``: the rows fit one warpgroup, which takes
      every other box; two partial sums a split): ping-pong for a flat
      gradient, split for the rest (WGRAD_PINGPONG).
    * The tile, tile width and slab are the set of least estimated time
      over the boxes: a box costs a block the largest of the L2 bytes it
      reads (its halo slab and B's box), its padded products and a fixed
      latency (WGRAD_BOX_LATENCY), among the sets whose two stages fit a
      block's shared memory beside the consumers' buffers; then as many
      stages (up to eight) as fit, an even count with ping-pong.
    * fp32 operands in parts (``a_parts``, ``b_parts``): A, or B, split
      into three bf16 planes by wgrad_split_kernel before the kernel and
      TMA'd as bf16 boxes, where WGRAD_PARTS_READS blocks would convert
      each box (A also where it takes the staged route) and the plan's
      stages of them fit.
    * Split: the boxes in ``splits`` ranges, the count of least estimated
      time over the card's waves plus the partials' traffic (fp32, written
      and read by wgrad_reduce_kernel), at most one split a WGRAD_MIN_BOXES
      boxes and four a streaming multiprocessor; split j walks [nbox j //
      splits, nbox (j + 1) // splits).
    """
    ks, st = tuple(int(k) for k in kernel_size), tuple(int(s) for s in strides)
    batch, a_sp, ca, cb = int(ashape[0]), tuple(int(n) for n in ashape[1:4]), int(ashape[4]), \
        int(cb)
    geo = [same_pads(n, k, s) for n, k, s in zip(a_sp, ks, st)]
    out, lo = tuple(g[0] for g in geo), tuple(g[1] for g in geo)
    ntaps, es, vec = math.prod(ks), 16 // _vec(dtype), _vec(dtype)
    flat = ks == (1, 1, 1) and st == (1, 1, 1)
    if flat:
        rows = batch * math.prod(out)
        view = dict(batch=1, a=(1, 1, rows), o=(1, 1, rows), strides=(1, 1, 1), lo=(0, 0, 0))
        tiles = [(1, 1, WGRAD_BOX)]
    else:
        view = dict(batch=batch, a=a_sp, o=out, strides=st, lo=lo)
        tiles = WG_TILE_SHAPES
    fp32, rate, parts = dtype == torch.float32, WGRAD_RATE[dtype], WGRAD_PARTS[dtype]
    top = next((b for b in WGRAD_TILES_N[dtype] if cb <= b), WGRAD_TILES_N[dtype][-1])

    def smem(box_vox, a_stage, bn, n, w, pp, a_parts, b_parts=False):
        # n stages of A and B (fp32 in parts: their three bf16 part boxes);
        # two buffers of B's K-major tile (bf16 parts x bn rows of 64 voxels,
        # two a box)
        conv = 2 * parts * 2 * bn * 128
        if fp32:  # A's part boxes and B's part rows (bf16) unless in parts, a set a
            # warpgroup with ping-pong
            conv += (2 if pp else 1) * parts * (
                (0 if a_parts else _kb(box_vox * w * 2)) + (0 if b_parts else WGRAD_BOX * bn * 2))
        b_stage = _kb(parts * WGRAD_BOX * bn * 2) if b_parts else _kb(WGRAD_BOX * bn * es)
        return n * (a_stage + b_stage) + conv + WGRAD_SMEM_EXTRA

    widest = max(WGRAD_WIDTHS[dtype][0], _pow2_at_least(ca))
    best = None
    if schedules is None:  # ping-pong for a flat gradient (WGRAD_PARTS_READS' note)
        schedules = (flat,)
    for tile, bn, w, pp in itertools.product(tiles, WGRAD_TILES_N[dtype], WGRAD_WIDTHS[dtype],
                                             schedules):
        box = tuple((tile[i] - 1) * view["strides"][i] + (1 if flat else ks[i])
                    for i in range(3))
        box_vox, mt = math.prod(box), WGRAD_MT[dtype][bn]
        tpb = min(ntaps, 64 * mt * (1 if pp else 2) // w)
        if tpb < 1:
            continue
        tap_groups = -(-ntaps // tpb)
        tpb = -(-ntaps // tap_groups)
        a_stage = _kb(box_vox * w * es)
        if (bn > top or w > widest or max(box) > WG_BOX_MAX
                or smem(box_vox, a_stage, bn, WGRAD_STAGES[0], w, pp, False) > WG_SMEM_BLOCK):
            continue
        slabs = -(-ca // w)
        blocks = tap_groups * slabs * -(-cb // bn)
        nbox = view["batch"] * math.prod(-(-g // e) for g, e in zip(view["o"], tile))
        l2 = box_vox * w * es + WGRAD_BOX * bn * es  # a block's bytes a box
        flops = -(-tpb * w // 64) * 64 * bn * WGRAD_BOX * 2
        t_box = max(l2 / (WGRAD_L2_RATE / SMS), flops / (rate / SMS), WGRAD_BOX_LATENCY)
        key = (nbox * blocks * t_box, -bn, -w, -tile[2])
        if best is None or key < best[0]:
            best = (key, dict(tile=tile, box=box, box_vox=box_vox, nbox=nbox, bn=bn, mt=mt,
                              width=w, tpb=tpb, tap_groups=tap_groups, slabs=slabs,
                              a_stage=a_stage, t_box=t_box, pp=pp))
    if best is None:
        raise ValueError(f"conv3d_wgrad: no slab of {ashape} fits shared memory")
    pl = best[1]
    # fp32's A and B in bf16 parts split once before the kernel (no block
    # converts their boxes) where WGRAD_PARTS_READS blocks would and the
    # plan's stages of them fit
    a_reads = pl["tap_groups"] * -(-cb // pl["bn"])
    b_reads = pl["tap_groups"] * pl["slabs"] if st == (1, 1, 1) else 0
    parts_stage = parts * _kb(pl["box_vox"] * pl["width"] * 2)
    pl["a_parts"] = fp32 and (not tma[0] or not flat and a_reads >= WGRAD_PARTS_READS[0]) \
        and smem(pl["box_vox"], parts_stage, pl["bn"], WGRAD_STAGES[0], pl["width"], pl["pp"],
                 True) <= WG_SMEM_BLOCK
    if pl["a_parts"]:
        pl["a_stage"] = parts_stage
    pl["b_parts"] = fp32 and not flat and b_reads >= WGRAD_PARTS_READS[1] and smem(
        pl["box_vox"], pl["a_stage"], pl["bn"], WGRAD_STAGES[0], pl["width"], pl["pp"],
        pl["a_parts"], True) <= WG_SMEM_BLOCK
    bn, mt, tile, box, box_vox, nbox = (pl[k] for k in ("bn", "mt", "tile", "box", "box_vox",
                                                         "nbox"))
    tiles_ax = tuple(-(-g // e) for g, e in zip(view["o"], tile))
    n_tiles = -(-cb // bn)
    b_stage = _kb(parts * WGRAD_BOX * bn * 2) if pl["b_parts"] else _kb(WGRAD_BOX * bn * es)
    # ping-pong takes an even count: then every box of a stage is one
    # warpgroup's, which never waits on a stage's phase two ahead of the
    # last it saw (an mbarrier's parity tells only two apart)
    stages = max(n for n in range(WGRAD_STAGES[0], WGRAD_STAGES[1] + 1)
                 if n == WGRAD_STAGES[0]
                 or (smem(box_vox, pl["a_stage"], bn, n, pl["width"], pl["pp"], pl["a_parts"],
                          pl["b_parts"]) <= WG_SMEM_BLOCK and (n % 2 == 0 or not pl["pp"])))
    units = pl["tap_groups"] * pl["slabs"] * n_tiles
    m = ntaps * ca
    dram = (batch * math.prod(a_sp) * ca + batch * math.prod(out) * cb) * es

    per_split = 2 if pl["pp"] else 1  # partial sums a split
    cap, cbp = -(-ca // 8) * 8, -(-cb // 8) * 8  # the bf16 planes' channels (in parts)

    def est(s):  # one block an SM streams at most twice its share of HBM
        blocks = units * s
        run = max(-(-blocks // SMS) * -(-nbox // s) * pl["t_box"],
                  dram / HBM_RATE * max(1.0, SMS / (2 * min(blocks, SMS))))
        return run + (s * per_split * m * cb * 8 / HBM_RATE if s * per_split > 1 else 0.0)

    smax = max(1, min(nbox // WGRAD_MIN_BOXES, 4 * SMS))
    splits = min(range(1, smax + 1), key=lambda s: (est(s), s))
    return dict(flat=flat, view=view, out=out, lo=lo, tile=tile, box=box, box_vox=box_vox,
                tiles_ax=tiles_ax, nbox=nbox, ntaps=ntaps, m=m, bn=bn, mt=mt, n_tiles=n_tiles,
                width=pl["width"], tpb=pl["tpb"], tap_groups=pl["tap_groups"],
                slabs=pl["slabs"], a_stage=pl["a_stage"], b_stage=b_stage, stages=stages,
                smem=smem(box_vox, pl["a_stage"], bn, stages, pl["width"], pl["pp"],
                          pl["a_parts"], pl["b_parts"]),
                splits=splits,
                units=units,
                blocks=units * splits,
                tma=(bool(tma[0]) or pl["a_parts"], bool(tma[1]) or pl["b_parts"]),
                pingpong=pl["pp"], a_parts=pl["a_parts"], b_parts=pl["b_parts"],
                workspace=_wgrad_workspace(
                    splits * per_split, m * cb,
                    [3 * batch * math.prod(a_sp) * cap] * pl["a_parts"]
                    + [3 * batch * math.prod(out) * cbp] * pl["b_parts"]),
                dtype=dtype)


def _wgrad_workspace(partials: int, numel: int, planes) -> int:
    """K6's fp32 workspace (elements): the partials (none with one), then,
    each at the next 256 bytes, the bf16 planes of A and of B that are in
    parts (``planes``: their bf16 elements)."""
    n = partials * numel if partials > 1 else 0
    for e in planes:
        n = -(-n // 64) * 64 + -(-e // 2)
    return n


def wgrad_routes(a: torch.Tensor, b: torch.Tensor):
    """How K6 loads A's and B's boxes: "tma" where the tensor's voxel stride
    is a multiple of 16 bytes and its base 16-byte aligned (a tiled TMA
    map), else "staged" (16-byte chunks through the producer's registers:
    the stem's 3 channels, bf16's 4 and 12, the heads' 1 and 2, a base off
    the grid)."""
    def route(t):
        row = int(t.shape[-1]) * t.element_size()
        return "tma" if row % 16 == 0 and t.data_ptr() % 16 == 0 else "staged"

    return route(a), route(b)


def _check_wgrad_args(a, b, kernel_size, strides):
    if a.dim() != 5 or b.dim() != 5 or a.shape[0] != b.shape[0]:
        raise ValueError(f"conv3d_wgrad: A and B must be NDHWC of one batch, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    out = tuple(same_pads(int(n), k, s)[0]
                for n, k, s in zip(a.shape[1:4], kernel_size, strides))
    if tuple(b.shape[1:4]) != out:
        raise ValueError(f"conv3d_wgrad: B's grid {tuple(b.shape[1:4])} is not the SAME "
                         f"output {out} of A's {tuple(a.shape[1:4])}")
    if math.prod(kernel_size) > MAX_TAPS:
        raise ValueError(f"conv3d_wgrad: kernel {kernel_size} unsupported")


def conv3d_wgrad_plain(a, b, kernel_size, strides=(1, 1, 1)):
    """Plain twin of K6: per tap, the tap's strided SAME window of A (zero
    padded) transposed times B, in fp32 (fp64 for fp64 input), rounded once
    to A's dtype; shape ``(kd, kh, kw, CA, CB)``."""
    ks, st = tuple(int(k) for k in kernel_size), tuple(strides)
    _check_wgrad_args(a, b, ks, st)
    acc = _acc(a)
    pads = []
    for axis in (2, 1, 0):  # F.pad lists the last axis first (after C)
        _, lo, hi = same_pads(int(a.shape[1 + axis]), ks[axis], st[axis])
        pads += [lo, hi]
    ap = F.pad(a.to(acc), [0, 0] + pads)
    bm = b.to(acc).reshape(-1, b.shape[-1])
    od, oh, ow = b.shape[1:4]
    taps = []
    for i in range(ks[0]):
        for j in range(ks[1]):
            for k in range(ks[2]):
                win = ap[:, i:i + (od - 1) * st[0] + 1:st[0], j:j + (oh - 1) * st[1] + 1:st[1],
                         k:k + (ow - 1) * st[2] + 1:st[2]]
                taps.append(win.reshape(-1, a.shape[-1]).T @ bm)
    return torch.stack(taps).reshape(*ks, a.shape[-1], b.shape[-1]).to(a.dtype)


def wgrad_args(a, b, kernel_size, strides):
    """Everything one K6 launch takes: the output, the workspace (the split's
    partials and fp32's bf16 planes; None where there are neither), the plan
    (by A's dtype) and the geometry array the C entry reads
    (csrc/conv3d_wgrad.cu pmr_conv3d_wgrad lists the fields: the view's
    grids, window, tile, halo box and tiles an axis; the slab, taps a block,
    tap groups, slabs, tile n, channel tiles, splits, boxes; the two routes;
    stage bytes, stages, shared memory, taps, the schedule, A and B in
    parts).
    Device-agnostic, so the CPU tests replay the very schedule the card
    runs."""
    ks, st = tuple(int(k) for k in kernel_size), tuple(int(s) for s in strides)
    ca, cb = int(a.shape[-1]), int(b.shape[-1])
    routes = wgrad_routes(a, b)
    plan = wgrad_plan(tuple(a.shape), cb, ks, st, a.dtype, tuple(r == "tma" for r in routes))
    out = torch.empty((*ks, ca, cb), dtype=a.dtype, device=a.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32, device=a.device)
          if plan["workspace"] else None)
    v = plan["view"]
    geom = np.array([*v["a"], ca, *v["o"], cb, *ks, *v["strides"], *v["lo"], v["batch"],
                     *plan["tile"], *plan["box"], *plan["tiles_ax"], plan["width"],
                     plan["tpb"], plan["tap_groups"], plan["slabs"], plan["bn"],
                     plan["n_tiles"], plan["splits"], plan["nbox"], *plan["tma"],
                     plan["a_stage"], plan["b_stage"], plan["stages"], plan["smem"],
                     plan["ntaps"], plan["pingpong"], plan["a_parts"], plan["b_parts"]], np.int32)
    assert geom.size == WGRAD_GEOM
    return out, ws, plan, geom


def conv3d_wgrad(a: torch.Tensor, b: torch.Tensor, kernel_size,
                 strides: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """K6: ``dW[kd, kh, kw, ca, cb] = sum_{n, o} A[n, o * s + t - lo, ca] *
    B[n, o, cb]`` (A zero outside its grid; lo the SAME low pad of A's
    extents), in A's dtype rounded once from fp32 sums. K1's weight gradient
    with A = an input part, B = the output gradient; K2's with A = its
    output gradient and B = its input (the result is K2's layout).

    Replaces the weight half of the backward of ``conv_probe``
    (``benchmarks/r2_probe_pallas_mxu.py:80``, TPU kernel table row 1; XLA
    transposed it there). Bound on the H100: bytes in bf16 and at fp32's
    full-resolution levels, operations at fp32's deep 3x3x3 ones. On
    Hopper's wgmma (csrc/conv3d_wgrad.cu, :func:`wgrad_plan`): each box of
    output voxels loads A's halo box and B's box once (TMA, or staged at odd
    widths and bases), the consumers turn B K-major and read every tap's A
    rows from the halo box, bf16 directly and fp32 in three bf16 parts (six
    products, to about 2^-24 of each; an operand whose boxes several blocks
    read split into bf16 planes once a call, the rest in the blocks) with its
    chains promoted once a box; a fixed split of the boxes whose partials a
    second kernel sums in fp64 in a fixed order: no atomics, the same bits on
    every run.
    """
    ks, st = tuple(int(k) for k in kernel_size), tuple(int(s) for s in strides)
    if not cuda_lib.use_kernel("conv3d_wgrad", a):
        return conv3d_wgrad_plain(a, b, ks, st)
    _check_wgrad_args(a, b, ks, st)
    code = cuda_lib.dtype_code(a, "conv3d_wgrad")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError("conv3d_wgrad: A and B must share one dtype and device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3d_wgrad: A and B must be contiguous (NDHWC)")
    if max(a.numel(), b.numel()) >= MAX_INDEX:
        raise ValueError("conv3d_wgrad: the kernel takes tensors of fewer than 2**31 elements")
    out, ws, _, geom = wgrad_args(a, b, ks, st)
    lib = cuda_lib.library()
    conv3d_wgrad.launches += 1
    rc = lib.pmr_conv3d_wgrad(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              ws.data_ptr() if ws is not None else 0, geom.ctypes.data, code,
                              cuda_lib.stream_of(a))
    cuda_lib.check(rc, "conv3d_wgrad")
    return out


conv3d_wgrad.launches = 0


# --------------------------------------------------------------- modules
def _compute_dtype(cfg: ConvConfig, x: torch.Tensor, kernel: torch.Tensor):
    # flax promote_dtype: an explicit dtype wins, else the promoted type
    return cfg.dtype if cfg.dtype is not None else torch.promote_types(
        x.dtype, kernel.dtype)


def _check_width(parts, cin: int) -> None:
    # the plain twins slice the kernel per part, so they would take too few
    # channels silently; flax refuses the mismatch, and so does the port
    got = sum(int(p.shape[-1]) for p in parts)
    if got != cin:
        raise ValueError(f"the conv's kernel takes {cin} input channels, got {got}")


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
        _check_width(parts, self.kernel.shape[3])
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
        _check_width([x], self.kernel.shape[4])
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


# --------------------------------------------------------- regularization
def l2_penalty(params, kernel_l2: float, bias_l2: float) -> torch.Tensor:
    """L2 term over named parameters (a module or a ``{name: tensor}``
    mapping with '.'-joined paths): ``l2 * sum(w ** 2)`` in fp32 for every
    ``kernel`` and ``bias`` (``tf.keras.regularizers.l2`` on every conv of
    the reference, networks.py:47-48), except under instance norms
    (``norm*`` parents, tfa's unregularized scale and bias) and the
    squeeze-excite convs (``se_*`` parents, built without conv_params,
    network_blocks.py:45-46), as the JAX ``l2_penalty`` skips them."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    total = None
    for name, leaf in items:
        path = name.split(".")
        parent = path[-2] if len(path) > 1 else ""
        if parent.startswith(("norm", "se_")) or path[-1] not in ("kernel", "bias"):
            continue
        coef = kernel_l2 if path[-1] == "kernel" else bias_l2
        term = coef * torch.sum(torch.square(leaf.float()))
        total = term if total is None else total + term
    return total if total is not None else torch.zeros(())
