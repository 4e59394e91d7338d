// K5 gemm_loop: out = bf16(sum_{i < iters} A . W), A (M, K) and W (K, N) bf16
// row-major, the sum carried in fp32 registers, on the tensor cores.
//
// Replaces: the two GEMM-rate probes of the TPU package,
// benchmarks/r2_probe_pallas_mxu.py:56 `mm_probe` (640x1152x128, 200
// iterations) and benchmarks/r2_probe_pallas_mm2.py:45 `pallas_loop_mm` (the
// same loop at 7 shapes, 100 and 800 iterations). Both held A and W whole in
// VMEM and ran one program. At K = 1152 a block's share of A and W does not fit
// in 227 KB of shared memory, so this kernel does not copy that design: each
// block owns one 64x64 output tile, keeps its fp32 accumulators in registers
// across all iterations, and streams 32-deep K-slabs of A and W through a
// two-stage shared-memory ring with cp.async. From the second iteration on the
// slabs are L2 hits: the operands total at most 12 MB (5120x1152 A), well
// inside the 50 MB L2.
//
// Tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 in inline
// PTX. Four warps in a 2x2 layout, each computing 32x32 of the tile (2 x 4
// mma tiles, 32 fp32 accumulators a thread). A fragments come from shared
// memory by ldmatrix.x4, W fragments by ldmatrix.x4.trans (W is stored K-major
// in shared memory, as it is in device memory). Shared rows are padded by 8
// elements, so the eight 16-byte rows of each ldmatrix phase fall in distinct
// banks.
//
// Bound on an H100: operations. The work is 2*M*K*N*iters flops against
// (M*K + K*N + M*N) * 2 bytes, so the least time is
// 2*M*K*N*iters / 989 TFLOP/s, the H100 SXM datasheet's dense-bf16 tensor-core
// peak (a datasheet figure, at 700 W). mma.sync does not reach that peak; only
// wgmma does. That, TMA and a deeper pipeline are later work: this kernel is the
// simple, right one.
//
// Grid: one block per 64x64 output tile. At 640x128 output that is 10 x 2 =
// 20 blocks on the card's 132 SMs, so at the probe's first shape at most 20
// SMs work: that is one of the probe's findings, not a fault.
//
// Shapes taken: M >= 1, K and N multiples of 8 (16-byte rows for cp.async),
// iters >= 1, pointers 16-byte aligned. Ragged M, N and K edges are masked: a
// 16-byte chunk that lies outside A or W is zero-filled (cp.async src-size 0)
// and contributes nothing, and stores outside the output are skipped. The
// kernel allocates nothing.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using pmr::cp_async16;
using pmr::cp_async_commit;
using pmr::cp_async_wait;
using pmr::ldmatrix_x4;
using pmr::ldmatrix_x4_trans;
using pmr::mma_bf16;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kPad = 8;                  // bf16 elements of row padding
constexpr int kLdA = kBK + kPad;         // 40 elements = 80 bytes
constexpr int kLdW = kBN + kPad;         // 72 elements = 144 bytes
constexpr int kThreads = 128;            // 4 warps, 2 x 2
constexpr int kStages = 2;

__global__ void __launch_bounds__(kThreads)
    gemm_loop_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int m, int k, int n, int iters) {
  __shared__ __align__(16) __nv_bfloat16 sa[kStages][kBM * kLdA];
  __shared__ __align__(16) __nv_bfloat16 sw[kStages][kBK * kLdW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // warp's 32x32 quadrant
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int steps = k_tiles * iters;

  // Each thread copies 2 chunks of A's 64x32 slab (4 chunks of 8 a row) and
  // 2 chunks of W's 32x64 slab (8 chunks a row).
  auto load = [&](int stage, int step) {
    const int k0 = (step % k_tiles) * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, col = (c & 3) * 8;
      const int gm = m0 + row, gk = k0 + col;
      const bool ok = gm < m && gk < k;
      cp_async16(&sa[stage][row * kLdA + col], ok ? a + (size_t)gm * k + gk : a,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 3, col = (c & 7) * 8;
      const int gk = k0 + row, gn = n0 + col;
      const bool ok = gk < k && gn < n;
      cp_async16(&sw[stage][row * kLdW + col], ok ? w + (size_t)gk * n + gn : w,
                 ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses: lane -> (row within a 16-row block, 8-col half)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int stage = step & 1;
    if (step + 1 < steps) {
      load(stage ^ 1, step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ta = sa[stage];
    const __nv_bfloat16* tw = sw[stage];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], ta + (wm * 32 + i * 16 + lrow) * kLdA + kk + lcol);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)  // n-blocks 2jj and 2jj+1
        ldmatrix_x4_trans(bf[jj], tw + (kk + lrow) * kLdW + wn * 32 + jj * 16 + lcol);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();  // the next load overwrites this stage
  }

  // C fragment: c0, c1 at (g, 2t..2t+1); c2, c3 at (g+8, 2t..2t+1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + h * 8;
        if (row < m)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace

// a: (m, k), w: (k, n), out: (m, n), all bf16 row-major, 16-byte aligned.
extern "C" int pmr_gemm_loop(const void* a, const void* w, void* out, int m, int k,
                             int n, int iters, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 != 0 || n % 8 != 0 || iters < 1 ||
      (m + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_loop_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), m, k, n, iters);
  return (int)cudaGetLastError();
}
