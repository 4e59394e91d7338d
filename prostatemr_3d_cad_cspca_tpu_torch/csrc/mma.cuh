// Tensor-core helpers shared by the conv kernels: the split of an fp32 value
// into two TF32 halves (conv3d_wgmma.cu's 3xTF32) or three bf16 parts
// (conv3d_wgrad.cu's fp32), and smem_addr, which also serves halo.cuh,
// tma.cuh and wgmma.cuh.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace pmr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi), each rounded
// as cvt.rna.tf32.f32 rounds a finite value (half a TF32 step added to the
// magnitude, the low 13 bits dropped), in integer ops: cvt.rna adds an
// infinity/NaN test and a select to each value. hi's low bits are cleared
// here, since x - hi must be exact; lo's are left to the tensor core, which
// reads only the top 19 bits of a TF32 operand.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) + 0x1000u;
}

// x = x1 + x2 + x3 to 2^-24 |x| or better: x1 = bf16(x), x2 = bf16(x - x1),
// x3 = bf16(x - x1 - x2), each rounded to nearest even; the remainders are
// exact in fp32. Two values at once (x low, y high in each part's 32 bits):
// the packed conversion (cvt.rn.bf16x2.f32) takes half the instructions of
// three scalar ones a value, and conversions are what the split costs. The
// six products a_i . b_j with i + j <= 4 give a . b to about 2^-24 of it.
__device__ __forceinline__ void split_bf16x3(float x, float y, uint32_t (&part)[3]) {
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(x, y);
  const float2 f1 = __bfloat1622float2(p1);
  const float rx = x - f1.x, ry = y - f1.y;
  const __nv_bfloat162 p2 = __floats2bfloat162_rn(rx, ry);
  const float2 f2 = __bfloat1622float2(p2);
  const __nv_bfloat162 p3 = __floats2bfloat162_rn(rx - f2.x, ry - f2.y);
  part[0] = *reinterpret_cast<const uint32_t*>(&p1);
  part[1] = *reinterpret_cast<const uint32_t*>(&p2);
  part[2] = *reinterpret_cast<const uint32_t*>(&p3);
}

}  // namespace pmr
