"""The GEMM-rate probe's loop product, K5.

``gemm_loop(a, w, iters)`` computes ``bf16(sum_{i < iters} a @ w)`` with the
sum in fp32: the function of the TPU package's two GEMM-rate probes
(``benchmarks/r2_probe_pallas_mxu.py`` ``mm_probe`` and
``benchmarks/r2_probe_pallas_mm2.py`` ``pallas_loop_mm``). No model path runs
it; ``probes/gemm_rate.py`` does. On a CPU tensor the wrapper runs the plain
twin; on a CUDA tensor it launches the TMA + wgmma kernel in
``csrc/gemm_loop.cu`` (which has the full note) or raises.

:func:`gemm_plan` is the kernel's schedule, computed here so that the CPU
tests can check it: 128 x 128 output tiles, each ``iters * k_tiles`` steps
(one iteration of one 64-deep K slab) ordered slab-major, and, where the
tiles alone would leave SMs idle, the flat (tile, step) space cut into at
most 132 ranges of equal tensor-core work whose partial sums a second
kernel adds in a fixed order.
"""

from __future__ import annotations

import bisect
import functools

import numpy as np
import torch

from . import cuda_lib

MAX_ITERS = 1 << 20
BM, BN, BK = 128, 128, 64   # output tile and K slab of csrc/gemm_loop.cu
K16 = BK // 16              # 16-deep wgmma steps in a full slab
SMS = 132                   # streaming multiprocessors of an H100 SXM
MIN_STEPS_PER_UNIT = 8      # a split range keeps about this many steps
META_LEN = 11 + (SMS + 1) + 2 * SMS  # csrc/gemm_loop.cu kMetaLen


def gemm_loop_plain(a: torch.Tensor, w: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain twin of K5: an fp32 loop of ``a.float() @ w.float()``, cast to
    bf16 once at the end."""
    af, wf = a.float(), w.float()
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    for _ in range(int(iters)):
        acc += af @ wf
    return acc.to(torch.bfloat16)


@functools.lru_cache(maxsize=64)
def gemm_plan(m: int, k: int, n: int, iters: int) -> dict:
    """The schedule of csrc/gemm_loop.cu for ``bf16(sum_{i<iters} A.W)``,
    A (m, k), W (k, n).

    A tile's work is ``steps = iters * k_tiles`` steps; step ``s`` applies
    slab ``s // iters`` for iteration ``s % iters``. A step weighs its count
    of 16-deep wgmma steps (4, or ``last_k16`` for the last slab). With
    ``blocks = min(SMS, tiles * steps // MIN_STEPS_PER_UNIT)`` no larger than
    ``tiles``, block ``t`` owns tile ``t`` whole (``split`` False, one unit a
    tile). Otherwise ``starts`` cuts the flat step space (tile-major) into
    ``blocks`` ranges of equal weight; ``tile_first`` / ``tile_last`` name the
    blocks whose ranges meet each tile, and ``workspace`` is the fp32
    partials' size (slot ``block + tile`` of BM x BN). The dict is cached
    and shared: callers read it only.
    """
    if m < 1 or k < 8 or n < 8 or k % 8 or n % 8:
        raise ValueError(f"gemm_loop: needs M >= 1 and K, N multiples of 8 (>= 8), "
                         f"got M={m}, K={k}, N={n}")
    if not 1 <= iters <= MAX_ITERS:
        raise ValueError(f"gemm_loop: iters must be in [1, {MAX_ITERS}], got {iters}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError("gemm_loop: a dimension exceeds 2**31")
    tiles_m, tiles_n = -(-m // BM), -(-n // BN)
    tiles = tiles_m * tiles_n
    k_tiles = -(-k // BK)
    last_k16 = -(-(k - (k_tiles - 1) * BK) // 16)
    steps = iters * k_tiles
    plan = dict(m=m, k=k, n=n, iters=iters, tiles_m=tiles_m, tiles_n=tiles_n, tiles=tiles,
                k_tiles=k_tiles, last_k16=last_k16, steps=steps)
    blocks = min(SMS, tiles * steps // MIN_STEPS_PER_UNIT)
    if blocks <= tiles:
        return dict(plan, split=False, blocks=tiles, splits=1, starts=None,
                    tile_first=None, tile_last=None, workspace=0)
    full = K16 * iters * (k_tiles - 1)  # weight of a tile's full slabs
    per_tile = full + last_k16 * iters

    def step_at(x):  # the first flat step whose preceding weight reaches x
        t, rem = divmod(x, per_tile)
        if rem <= full:
            s = -(-rem // K16)
        else:
            s = iters * (k_tiles - 1) + -(-(rem - full) // last_k16)
        return t * steps + s

    total = tiles * per_tile
    starts = tuple(step_at(total * b // blocks) for b in range(blocks + 1))
    first = tuple(bisect.bisect_right(starts, t * steps) - 1 for t in range(tiles))
    last = tuple(bisect.bisect_right(starts, (t + 1) * steps - 1) - 1 for t in range(tiles))
    return dict(plan, split=True, blocks=blocks,
                splits=max(b - a + 1 for a, b in zip(first, last)),
                starts=starts, tile_first=first, tile_last=last,
                workspace=(blocks + tiles - 1) * BM * BN)


def plan_units(plan: dict):
    """The plan's work units, in launch order: (block, tile, s0, s1), the
    steps [s0, s1) of the tile that the block walks."""
    steps = plan["steps"]
    if not plan["split"]:
        return [(t, t, 0, steps) for t in range(plan["tiles"])]
    units = []
    for b, (g0, g1) in enumerate(zip(plan["starts"], plan["starts"][1:])):
        g = g0
        while g < g1:
            t = g // steps
            end = min(g1, (t + 1) * steps)
            units.append((b, t, g - t * steps, end - t * steps))
            g = end
    return units


def gemm_meta(plan: dict) -> np.ndarray:
    """The int64 array the C entry reads: 0 m, 1 k, 2 n, 3 iters, 4 tiles_n,
    5 tiles, 6 k_tiles, 7 last_k16, 8 steps, 9 blocks, 10 split; then
    starts[SMS + 1], tile_first[SMS], tile_last[SMS] (split plans only)."""
    meta = np.zeros(META_LEN, np.int64)
    meta[:11] = [plan[key] for key in ("m", "k", "n", "iters", "tiles_n", "tiles", "k_tiles",
                                       "last_k16", "steps", "blocks", "split")]
    if plan["split"]:
        meta[11:11 + plan["blocks"] + 1] = plan["starts"]
        meta[12 + SMS:12 + SMS + plan["tiles"]] = plan["tile_first"]
        meta[12 + 2 * SMS:12 + 2 * SMS + plan["tiles"]] = plan["tile_last"]
    return meta


def _check(a: torch.Tensor, w: torch.Tensor, iters: int) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_loop: needs (M, K) and (K, N), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if not 1 <= int(iters) <= MAX_ITERS:
        raise ValueError(f"gemm_loop: iters must be in [1, {MAX_ITERS}], got {iters}")


def gemm_loop(a: torch.Tensor, w: torch.Tensor, iters: int) -> torch.Tensor:
    """K5: ``bf16(sum_{i < iters} a @ w)``, fp32 accumulation, a (M, K) and
    w (K, N) bf16 row-major; output (M, N) bf16.

    Replaces the TPU kernels ``benchmarks/r2_probe_pallas_mxu.py:56``
    ``mm_probe`` and ``benchmarks/r2_probe_pallas_mm2.py:45``
    ``pallas_loop_mm`` (TPU kernel table rows 3-4). Bound on the H100:
    operations, ``2*M*K*N*iters / 989 TFLOP/s`` (datasheet dense bf16).
    TMA loads into an mbarrier-gated shared-memory ring, two wgmma consumer
    warpgroups, slabs applied for every iteration while resident, and the
    schedule of :func:`gemm_plan` over the card's 132 SMs.
    """
    _check(a, w, iters)
    if not cuda_lib.use_kernel("gemm_loop", a):
        return gemm_loop_plain(a, w, iters)
    m, k = int(a.shape[0]), int(a.shape[1])
    n = int(w.shape[1])
    for name, t in (("a", a), ("w", w)):
        if t.dtype != torch.bfloat16 or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"gemm_loop: {name} must be contiguous bfloat16 on {a.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"gemm_loop: {name} must be 16-byte aligned")
    if k % 8 or n % 8:
        raise ValueError(f"gemm_loop: K and N must be multiples of 8, got K={k}, N={n}")
    cuda_lib.require_no_grad("gemm_loop", a, w)
    plan = gemm_plan(m, k, n, int(iters))
    meta = gemm_meta(plan)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32, device=a.device)
          if plan["split"] else None)
    lib = cuda_lib.library()
    gemm_loop.launches += 1
    rc = lib.pmr_gemm_loop(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                           None if ws is None else ws.data_ptr(), meta.ctypes.data,
                           cuda_lib.stream_of(a))
    cuda_lib.check(rc, "gemm_loop")
    return out


gemm_loop.launches = 0
