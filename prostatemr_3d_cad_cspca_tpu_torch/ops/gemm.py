"""The GEMM-rate probe's loop product, K5.

``gemm_loop(a, w, iters)`` computes ``bf16(sum_{i < iters} a @ w)`` with the
sum in fp32: the function of the TPU package's two GEMM-rate probes
(``benchmarks/r2_probe_pallas_mxu.py`` ``mm_probe`` and
``benchmarks/r2_probe_pallas_mm2.py`` ``pallas_loop_mm``). No model path runs
it; ``probes/gemm_rate.py`` does. On a CPU tensor the wrapper runs the plain
twin; on a CUDA tensor it launches the tensor-core kernel in
``csrc/gemm_loop.cu`` (which has the full note) or raises.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MAX_ITERS = 1 << 20


def gemm_loop_plain(a: torch.Tensor, w: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain twin of K5: an fp32 loop of ``a.float() @ w.float()``, cast to
    bf16 once at the end."""
    af, wf = a.float(), w.float()
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    for _ in range(int(iters)):
        acc += af @ wf
    return acc.to(torch.bfloat16)


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
    One 64x64 output tile per block, fp32 accumulators in registers across
    every iteration, K-slabs through shared memory by cp.async, mma.sync
    m16n8k16 on the tensor cores.
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
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    lib = cuda_lib.library()
    gemm_loop.launches += 1
    rc = lib.pmr_gemm_loop(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                           int(iters), cuda_lib.stream_of(a))
    cuda_lib.check(rc, "gemm_loop")
    return out


gemm_loop.launches = 0
