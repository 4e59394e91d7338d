// Hopper warpgroup MMA (wgmma) in inline PTX: the consuming half of a TMA +
// wgmma pipeline (K5 gemm_loop.cu; tma.cuh is the loading half).
//
// A warpgroup (4 consecutive warps, the first a multiple of 4) issues
// wgmma.mma_async on operands in shared memory described by 64-bit matrix
// descriptors, accumulating fp32 in registers. Both operands here use the
// 128-byte swizzle that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: a
// swizzle atom is 8 rows of 128 bytes (1024 bytes, 1024-byte aligned).
//
//   K-major operand (K contiguous, e.g. A row-major (M, K), 64-deep slabs):
//     rows of 128 bytes; SBO = 1024 (next 8 rows); LBO unused (16);
//     the k-th 16-deep step starts 32 * k bytes into the atom.
//   MN-major operand (N contiguous, e.g. W row-major (K, N), trans-b = 1):
//     each K row holds 64 N values (128 bytes); SBO = 1024 (next 8 K rows);
//     LBO = the byte distance to the next 64 N values; the k-th 16-deep step
//     starts 16 rows (2048 bytes) further.
#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace pmr {

__device__ __forceinline__ uint64_t wgmma_desc_b128(const void* p, uint32_t lbo_bytes,
                                                    uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // layout: 128-byte swizzle
  return d;
}

// Orders this warpgroup's register and shared-memory writes before the
// wgmma that follows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma (which reads and writes them behind its back).
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, 64 registers a thread) = A (64 x 16) . B (16 x 128)
// + (accumulate ? d : 0), bf16 operands in shared memory. kTransB 1: B is
// MN-major. Fragment of d:
// thread t of the warpgroup (warp w = t / 32, lane l) holds d[i] at row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %66;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(kTransB), "r"(accumulate));
}

// Register budget of a warp-specialised block: the producer warpgroup gives
// registers back, the consumer warpgroups take them (multiples of 8, 24-256).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace pmr
