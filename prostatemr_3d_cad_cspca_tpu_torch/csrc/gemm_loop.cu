// K5 gemm_loop: out = bf16(sum_{i < iters} A . W), A (M, K) and W (K, N) bf16
// row-major, the sum carried in fp32, on the tensor cores by wgmma.
//
// Replaces: the two GEMM-rate probes of the TPU package,
// benchmarks/r2_probe_pallas_mxu.py:56 `mm_probe` (640x1152x128, 200
// iterations) and benchmarks/r2_probe_pallas_mm2.py:45 `pallas_loop_mm` (the
// same loop at 7 shapes, 100 and 800 iterations). Both held A and W resident
// in VMEM and ran a loop of dots into one fp32 accumulator.
//
// Bound on an H100: operations, 2*M*K*N*iters / 989 TFLOP/s (the H100 SXM
// datasheet's dense-bf16 tensor-core peak, at 700 W). The operands total at
// most 12 MB, so only the first touch of each slab goes to device memory.
//
// Design (ops/gemm.py gemm_plan computes the schedule this kernel walks):
//
//  * Output tiles of 128 x 128. The work of one tile is iters x k_tiles
//    steps (a step: one iteration of one 64-deep K slab), ordered slab-major:
//    step s is slab s / iters of iteration s % iters. A contiguous range of
//    steps therefore touches few slabs, each for many iterations; the block
//    loads a slab once and applies it for every iteration of its range while
//    it is resident in shared memory, as the TPU kernel kept A and W in VMEM.
//    Every product of the function is computed: only the order of the fp32
//    sum differs from the plain twin's.
//  * Fill the card. Where the tiles alone would leave SMs idle (640 x 128
//    output: 5 tiles for 132 SMs), the plan cuts the flat (tile, step) space
//    into `blocks` (<= 132) contiguous ranges of equal tensor-core work (a
//    slab's weight is its count of 16-deep steps, so the short last slab of
//    K = 144 weighs 1 and the others 4). A range that crosses a tile boundary
//    is two work units. A unit that covers its whole tile stores bf16
//    directly; the others store fp32 partials to a workspace the wrapper
//    allocates (slot block + tile, which is unique), and
//    gemm_splitk_reduce_kernel sums each tile's partials in block order and
//    rounds once: no atomics, the same bits on every run. Where the tiles
//    fill the card or a tile's steps are few, one block owns one tile.
//  * Warp specialisation, one block of 3 warpgroups per SM. Warpgroup 2 is
//    the producer: one thread issues TMA loads (tma.cuh) of the A slab (128 x
//    64, one box) and the W slab (64 x 128, two boxes of 64 columns) into a
//    4-stage ring in dynamic shared memory (128 KB), 128-byte swizzled, each
//    stage gated by a full and an empty mbarrier. TMA zero-fills the ragged
//    M, N and K edges. Warpgroups 0 and 1 are the consumers: each owns 64
//    rows of the tile and issues wgmma.mma_async m64n128k16 (wgmma.cuh; A
//    K-major, W MN-major with trans-b), and hands each stage back when its
//    slab's products are done. setmaxnreg moves registers from the producer
//    (40) to the consumers (232).
//  * The epilogue stages each warp's 16 x 128 sums in shared memory (68 KB
//    beside the ring) and writes whole rows, 16 bytes a lane: the wgmma
//    fragment's own stores hit 8 rows with 32 bytes each, and writing them
//    so made a call of the probe's 640 x 144 x 128 at 100 iterations take 25
//    us instead of 15 on an H100.
//  * fp32 sums that hold at hundreds of iterations. The tensor core's fp32
//    accumulation is not round-to-nearest: chains of hundreds of wgmmas
//    applying the same slab drifted toward zero, and on an H100 100
//    iterations of 5120 x 1152 x 128 missed the one-rounding limit against
//    the plain twin (2^-6 where 2^-7 is allowed). So a chain is at most 32
//    16-deep steps (512 products, as deep as an ordinary K = 512 GEMM) into
//    64 scratch registers, which the consumer then adds to its 64 fp32 sums
//    on the CUDA cores. While one consumer warpgroup drains and adds, the
//    other keeps the tensor cores busy.
//
// Shapes taken: M >= 1, K and N multiples of 8 (TMA's 16-byte row stride),
// iters >= 1, pointers 16-byte aligned. The kernel allocates nothing.

#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                       // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2;              // 16 KB, one box
constexpr int kWBoxBytes = kBK * 64 * 2;            // 8 KB, 64 columns of W
constexpr int kStageBytes = kABytes + 2 * kWBoxBytes;
constexpr int kEpiPitch = kBN + 8;                  // staged row, floats (bank spread)
constexpr int kEpiOffset = kStages * kStageBytes + 1024;  // after the ring and barriers
constexpr int kSmemBytes = kEpiOffset + kConsumers * 4 * 16 * kEpiPitch * 4 + 1024;
constexpr int kChainSteps = 32;                     // 16-deep steps a wgmma chain
constexpr int kMaxSplitBlocks = 132;                // ops/gemm.py SMS
constexpr int kMetaLen = 11 + (kMaxSplitBlocks + 1) + 2 * kMaxSplitBlocks;

// The schedule, from ops/gemm.py gemm_plan (meta layout: gemm_meta there).
struct GemmArgs {
  int m, k, n, iters, tiles_n, tiles, k_tiles, last_k16, blocks, split;
  long long steps;                              // per tile: iters * k_tiles
  long long starts[kMaxSplitBlocks + 1];        // split: block b's flat steps
  int tile_first[kMaxSplitBlocks];              // split: first block of a tile
  int tile_last[kMaxSplitBlocks];               //        and its last
};

// acc += the slab's product, reps times: NK 16-deep wgmma steps a time (A:
// 32 bytes a step into its 128-byte rows; W: 16 rows of 128 bytes a step).
// The tensor core sums a chain of at most kChainSteps steps into tmp, which
// is then added to acc in fp32 on the CUDA cores (round to nearest).
template <int NK>
__device__ __forceinline__ void slab_mma(float (&acc)[64], float (&tmp)[64], uint64_t da,
                                         uint64_t dw, int reps) {
  constexpr int kChainReps = kChainSteps / NK;
  for (int r0 = 0; r0 < reps; r0 += kChainReps) {
    const int r1 = min(reps, r0 + kChainReps);
    pmr::fence_registers(tmp);
    for (int r = r0; r < r1; ++r) {
      pmr::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)  // the chain's first step overwrites tmp
        pmr::wgmma_m64n128k16_bf16<1>(tmp, da + 2 * kk, dw + 128 * kk, r > r0 || kk > 0);
    }
    pmr::wgmma_commit();
    pmr::wgmma_wait<0>();
    pmr::fence_registers(tmp);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += tmp[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_loop_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ GemmArgs p, bf16* __restrict__ out,
                     float* __restrict__ ws) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* epi = reinterpret_cast<float*>(smem + kEpiOffset);  // 16 rows a consumer warp
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      pmr::mbar_init(&full[s], 1);
      pmr::mbar_init(&empty[s], kConsumers * 128);
    }
    pmr::mbar_fence_init();
  }
  __syncthreads();

  const int b = blockIdx.x;
  const long long g0 = p.split ? p.starts[b] : (long long)b * p.steps;
  const long long g1 = p.split ? p.starts[b + 1] : g0 + p.steps;

  if (wg == kConsumers) {
    // ----------------------------------------------------------- producer
    pmr::setmaxnreg_dec<40>();
    if (tid == kConsumers * 128) {
      int stage = 0, phase = 0;
      for (long long g = g0; g < g1;) {
        const int tile = (int)(g / p.steps);
        const long long base = (long long)tile * p.steps;
        const long long s1 = min(g1, base + p.steps) - base;
        const int tm = tile / p.tiles_n, tn = tile % p.tiles_n;
        const int j1 = (int)((s1 - 1) / p.iters);
        for (int j = (int)((g - base) / p.iters); j <= j1; ++j) {
          pmr::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * kStageBytes;
          pmr::mbar_arrive_expect_tx(&full[stage], kStageBytes);
          pmr::tma_load_2d(st, &map_a, &full[stage], j * kBK, tm * kBM);
          pmr::tma_load_2d(st + kABytes, &map_w, &full[stage], tn * kBN, j * kBK);
          pmr::tma_load_2d(st + kABytes + kWBoxBytes, &map_w, &full[stage], tn * kBN + 64,
                           j * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        g = base + s1;
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    pmr::setmaxnreg_inc<232>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    float acc[64], tmp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tmp[i] = 0.f;  // overwritten by each chain's first step
    int stage = 0, phase = 0;
    for (long long g = g0; g < g1;) {
      const int tile = (int)(g / p.steps);
      const long long base = (long long)tile * p.steps;
      const long long s0 = g - base, s1 = min(g1, base + p.steps) - base;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      const int j1 = (int)((s1 - 1) / p.iters);
      for (int j = (int)(s0 / p.iters); j <= j1; ++j) {
        const long long lo = max(s0, (long long)j * p.iters);
        const long long hi = min(s1, (long long)(j + 1) * p.iters);
        const int reps = (int)(hi - lo);
        const int nk = j == p.k_tiles - 1 ? p.last_k16 : kBK / 16;
        pmr::mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * kStageBytes;
        const uint64_t da = pmr::wgmma_desc_b128(st + wg * 64 * 128, 16, 1024);
        const uint64_t dw = pmr::wgmma_desc_b128(st + kABytes, kWBoxBytes, 1024);
        switch (nk) {  // straight-line wgmma runs: no predicate inside one
          case 1: slab_mma<1>(acc, tmp, da, dw, reps); break;
          case 2: slab_mma<2>(acc, tmp, da, dw, reps); break;
          case 3: slab_mma<3>(acc, tmp, da, dw, reps); break;
          default: slab_mma<kBK / 16>(acc, tmp, da, dw, reps); break;
        }
        pmr::mbar_arrive(&empty[stage]);  // the slab's products are done
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: each warp stages its 16 rows of sums in shared memory
      // (d[i] at row lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
      // 2 (lane % 4) + i % 2) and writes them back as whole rows, 4 columns
      // a lane: the fragment's own stores touch 8 rows of 32 bytes each.
      float* st = epi + (wg * 4 + warp) * 16 * kEpiPitch;
#pragma unroll
      for (int i = 0; i < 64; i += 2)
        *reinterpret_cast<float2*>(st + (lane / 4 + 8 * ((i >> 1) & 1)) * kEpiPitch +
                                   (i >> 2) * 8 + 2 * (lane % 4)) =
            make_float2(acc[i], acc[i + 1]);
      __syncwarp();
      const int row0 = wg * 64 + warp * 16;  // the warp's first row in the tile
      if (s0 == 0 && s1 == p.steps) {        // the whole tile: round and store
        const int grow = (tile / p.tiles_n) * kBM + row0;
        const int gcol = (tile % p.tiles_n) * kBN + 4 * lane;  // n % 8 == 0: 4 inside
        for (int r = 0; r < 16 && grow + r < p.m && gcol < p.n; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(st + r * kEpiPitch + 4 * lane);
          __nv_bfloat162* dst =
              reinterpret_cast<__nv_bfloat162*>(out + (size_t)(grow + r) * p.n + gcol);
          dst[0] = __floats2bfloat162_rn(v.x, v.y);
          dst[1] = __floats2bfloat162_rn(v.z, v.w);
        }
      } else {  // a part of the tile: fp32 partial in slot b + tile
        float* w = ws + ((size_t)(b + tile) * kBM + row0) * kBN + 4 * lane;
#pragma unroll 4
        for (int r = 0; r < 16; ++r)
          *reinterpret_cast<float4*>(w + r * kBN) =
              *reinterpret_cast<const float4*>(st + r * kEpiPitch + 4 * lane);
      }
      __syncwarp();  // the staged rows are read before the next unit writes them
      g = base + s1;
    }
  }
}

// out = bf16(sum of a split tile's partials in block order). Grid (16, tiles),
// 256 threads of 4 elements each cover one 128 x 128 tile.
__global__ void __launch_bounds__(256)
    gemm_splitk_reduce_kernel(const float* __restrict__ ws, const __grid_constant__ GemmArgs p,
                              bf16* __restrict__ out) {
  const int tile = blockIdx.y;
  const int first = p.tile_first[tile], last = p.tile_last[tile];
  if (first == last) return;  // its one block stored it whole
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int row = (tile / p.tiles_n) * kBM + e / kBN;
  const int col = (tile % p.tiles_n) * kBN + e % kBN;
  if (row >= p.m || col >= p.n) return;  // n % 8 == 0: all 4 columns inside
  const float* src = ws + (size_t)tile * kBM * kBN + e;
  float4 s = __ldcg(reinterpret_cast<const float4*>(src + (size_t)first * kBM * kBN));
#pragma unroll 8  // the loads are independent: keep 8 in flight, add in order
  for (int bb = first + 1; bb <= last; ++bb) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)bb * kBM * kBN));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * p.n + col);
  dst[0] = __floats2bfloat162_rn(s.x, s.y);
  dst[1] = __floats2bfloat162_rn(s.z, s.w);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Unpacks and checks the wrapper's schedule against the shapes.
int unpack(const long long* mt, GemmArgs* p) {
  p->m = (int)mt[0];
  p->k = (int)mt[1];
  p->n = (int)mt[2];
  p->iters = (int)mt[3];
  p->tiles_n = (int)mt[4];
  p->tiles = (int)mt[5];
  p->k_tiles = (int)mt[6];
  p->last_k16 = (int)mt[7];
  p->steps = mt[8];
  p->blocks = (int)mt[9];
  p->split = (int)mt[10];
  const long long m = mt[0], k = mt[1], n = mt[2], iters = mt[3];
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || iters < 1 || m >= (1LL << 31) ||
      k >= (1LL << 31) || n >= (1LL << 31) || iters >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long k_tiles = cdiv(k, kBK);
  if (p->tiles_n != cdiv(n, kBN) || p->tiles != cdiv(m, kBM) * cdiv(n, kBN) ||
      p->k_tiles != k_tiles || p->last_k16 != cdiv(k - (k_tiles - 1) * kBK, 16) ||
      p->steps != iters * k_tiles || p->tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!p->split) return p->blocks == p->tiles ? 0 : (int)cudaErrorInvalidValue;
  if (p->blocks < 1 || p->blocks > kMaxSplitBlocks || p->tiles > kMaxSplitBlocks)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= p->blocks; ++i) {
    p->starts[i] = mt[11 + i];
    if (i > 0 && p->starts[i] < p->starts[i - 1]) return (int)cudaErrorInvalidValue;
  }
  if (p->starts[0] != 0 || p->starts[p->blocks] != (long long)p->tiles * p->steps)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < p->tiles; ++t) {
    p->tile_first[t] = (int)mt[11 + kMaxSplitBlocks + 1 + t];
    p->tile_last[t] = (int)mt[11 + 2 * kMaxSplitBlocks + 1 + t];
    if (p->tile_first[t] < 0 || p->tile_last[t] < p->tile_first[t] ||
        p->tile_last[t] >= p->blocks)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// a: (m, k), w: (k, n), out: (m, n), all bf16 row-major, 16-byte aligned;
// ws: the fp32 workspace of a split schedule (else unused); meta: int64[kMetaLen]
// from ops/gemm.py gemm_meta.
extern "C" int pmr_gemm_loop(const void* a, const void* w, void* out, void* ws,
                             const void* meta, void* stream) {
  static_assert(sizeof(GemmArgs) <= 3072, "kernel parameters stay under 4 KB");
  static_assert(kMetaLen == 408, "ops/gemm.py META_LEN");
  GemmArgs p;
  int rc = unpack(static_cast<const long long*>(meta), &p);
  if (rc != 0) return rc;
  if (p.split && ws == nullptr) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ws)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap map_a, map_w;
  rc = pmr::encode_tensor_map_2d(&map_a, a, p.m, p.k, kBM, kBK);
  if (rc != 0) return rc;
  rc = pmr::encode_tensor_map_2d(&map_w, w, p.k, p.n, kBK, 64);
  if (rc != 0) return rc;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gemm_loop_kernel<<<p.blocks, kThreads, kSmemBytes, s>>>(
      map_a, map_w, p, static_cast<bf16*>(out), static_cast<float*>(ws));
  if (p.split)
    gemm_splitk_reduce_kernel<<<dim3(kBM * kBN / 4 / 256, p.tiles), 256, 0, s>>>(
        static_cast<const float*>(ws), p, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}
