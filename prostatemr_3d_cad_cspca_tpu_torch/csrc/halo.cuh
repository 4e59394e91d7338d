// Halo boxes in shared memory, the pieces K1/K2 (conv3d_wgmma.cu) and K6
// (conv3d_wgrad.cu) share: the box swizzle as TMA writes it, an mbarrier
// wait that traps rather than hangs, the staged route's chunked loads (16
// bytes of a voxel's channels, any alignment, zero past the valid ones) and
// ldmatrix / stmatrix by shared-memory address.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

#include "mma.cuh"

namespace pmr {

// The box swizzle: a row (voxel) of 16 x (smask + 1) bytes; the 16-byte
// chunk bits [4, 7) of a byte offset are XORed with bits [7, 10), as TMA's
// 32/64/128-byte swizzle writes them (smask 1, 3, 7; 0: none).
__device__ __forceinline__ uint32_t swizzle(uint32_t byte, uint32_t smask) {
  return byte ^ (((byte >> 7) & smask) << 4);
}

// An mbarrier wait that traps rather than hangs if the pipeline ever lost
// an arrival (2^24 polls: seconds).
__device__ __forceinline__ void wait_bar(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each 8x8 matrix transposed: lane (g, t) gets row g, columns 2t
// and 2t + 1 of the transpose of the matrix whose rows lanes 8j..8j + 7
// address.
__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ldmatrix's inverse: register j of lane (g, t) goes to row g, columns 2t
// and 2t + 1 of matrix j, whose rows lanes 8j..8j + 7 address.
__device__ __forceinline__ void stmatrix_x4_at(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// 8 consecutive bf16 from `src` (2-byte aligned), the first n of them valid
// (n >= 8: all), the rest zero; no byte at or past `end` is read. An aligned
// chunk is one 16-byte load; any other is cut from the two aligned 16-byte
// words that cover it (a funnel shift by 2 bytes where the offset is odd in
// 2-byte units) while they lie before `end`, else read element by element.
__device__ __forceinline__ uint4 load8_any(const __nv_bfloat16* src, int n,
                                           const __nv_bfloat16* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), a0 = a & ~uintptr_t(15);
  uint32_t o[4];
  if (a == a0 && n >= 8) return __ldg(reinterpret_cast<const uint4*>(src));
  if (a0 + 32 <= reinterpret_cast<uintptr_t>(end)) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(a0));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(a0 + 16));
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int q = (int)((a - a0) >> 2);
    const bool half = (a & 2) != 0;
    uint32_t r[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)  // r[i] = w[q + i], by selects (no local memory)
      r[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[min(i + 3, 7)];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = half ? __funnelshift_r(r[i], r[i + 1], 16) : r[i];
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t e0 = 2 * i < n ? __ldg(s + 2 * i) : 0;
      const uint32_t e1 = 2 * i + 1 < n ? __ldg(s + 2 * i + 1) : 0;
      o[i] = e0 | (e1 << 16);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
  if (n < 8) {  // zero the elements past the valid ones
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] &= (2 * i < n ? 0xFFFFu : 0u) | (2 * i + 1 < n ? 0xFFFF0000u : 0u);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 4 consecutive fp32 from `src`, the first n of them valid (n >= 4: all),
// the rest zero: one 16-byte load where aligned, else element by element
// (an fp32 element is always 4-byte aligned; none past the valid ones is
// read).
__device__ __forceinline__ uint4 load4_any(const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n >= 4)
    return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = i < n ? __float_as_uint(__ldg(src + i)) : 0u;
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One 16-byte chunk of a voxel's channels: 8 bf16 or 4 fp32, the first n
// valid.
__device__ __forceinline__ uint4 load_chunk(const float* src, int n, const float*) {
  return load4_any(src, n);
}
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* src, int n,
                                            const __nv_bfloat16* end) {
  return load8_any(src, n, end);
}

}  // namespace pmr
