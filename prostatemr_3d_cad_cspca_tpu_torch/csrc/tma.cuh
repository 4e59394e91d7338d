// Hopper's Tensor Memory Accelerator and mbarriers in inline PTX, with the
// host-side tensor-map encoder: the loading half of a TMA + wgmma pipeline
// (K5 gemm_loop.cu; wgmma.cuh is the consuming half).
//
// Device side: mbarrier init / arrive / expect-tx / parity wait, 2D, 3D
// and 5D tiled TMA loads that report their bytes to an mbarrier, and the proxy
// fence that orders threads' shared-memory writes before wgmma reads them.
// Host side: encode_tensor_map_2d, a row-major bf16 matrix cut into boxes
// with 128-byte swizzle (the layout wgmma's B128 descriptors read), and
// encode_tensor_map_nd, a bf16 or fp32 tensor cut into boxes whose innermost
// extent sets the swizzle (conv3d_wgmma.cu's halo boxes of NDHWC voxels and its
// weight rows).
// cuTensorMapEncodeTiled (a libcuda function) is taken through the CUDA
// runtime's entry-point query, so the library links no libcuda of its own.
#pragma once

#include <stdint.h>

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace pmr {

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "-1", parity 1, as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// Copies the box at element coordinates (c0 innermost, c1) of `map` into
// shared memory at `dst` (1024-byte aligned for 128-byte swizzle); the bytes
// complete on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 3D map, coordinates innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 5D map, coordinates innermost first.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Brings a TMA map's descriptor into the cache ahead of its first load.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before the
// async proxy's reads (a wgmma descriptor's operand) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ host side
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix with `cols` contiguous, read in
// boxes of box_rows x box_cols with 128-byte swizzle (box_cols * 2 <= 128).
// Returns 0 or a cudaError_t code.
inline int encode_tensor_map_2d(CUtensorMap* map, const void* base, uint64_t rows,
                                uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};  // bytes between rows
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 (esize 2) or fp32 (esize 4) tensor of `rank` (3 or 5) dims
// (innermost first: dims[0] contiguous, strides in bytes of dims 1..,
// multiples of 16) read in boxes of box[0..rank) elements; box[0] x esize
// bytes is 16, 32, 64 or 128 and picks no swizzle or the 32-, 64- or
// 128-byte one, so that a box's rows of box[0] elements land as
// conv3d_wgmma.cu's swizzle reads them. Elements outside the tensor (and
// negative coordinates) arrive as zeros. Returns 0 or a cudaError_t code.
inline int encode_tensor_map_nd(CUtensorMap* map, const void* base, int rank,
                                const uint64_t* dims, const uint64_t* strides,
                                const uint32_t* box, int esize) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  if (esize != 2 && esize != 4) return (int)cudaErrorInvalidValue;
  CUtensorMapSwizzle swizzle;
  switch (box[0] * esize) {
    case 16: swizzle = CU_TENSOR_MAP_SWIZZLE_NONE; break;
    case 32: swizzle = CU_TENSOR_MAP_SWIZZLE_32B; break;
    case 64: swizzle = CU_TENSOR_MAP_SWIZZLE_64B; break;
    case 128: swizzle = CU_TENSOR_MAP_SWIZZLE_128B; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rank < 1 || rank > 5) return (int)cudaErrorInvalidValue;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = fn(map,
                        esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        rank, const_cast<void*>(base), d, st, bx, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace pmr
