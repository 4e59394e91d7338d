// K1 conv3d and K2 conv3d_transpose for bf16: implicit-GEMM 3D convolution on
// channels-last (NDHWC) tensors on the tensor cores, bf16 in, fp32
// accumulation, bf16 out (rounded once).
//
// Replaces: benchmarks/r2_probe_pallas_mxu.py:80 conv_probe (its body `kern`
// at :96), the streaming (1,3,3) SAME conv + bias that built a 9-tap im2col in
// VMEM and ran one deep-K matmul on the MXU. Here the im2col is implicit: each
// block gathers its (128 rows x 32) slab of the virtual im2col matrix straight
// from the NDHWC parts into shared memory. The GEMM view, the SAME tap tables
// and K2's gather form by output phase are those of conv3d.cu (its note has
// them); both kernels read one ConvParams (conv_params.cuh).
//
// What bounds it on an H100. Levels 0-1 (20x160x160 and 20x80x80, 4-64
// channels) sit far below the card's ~295 bf16 FLOP/byte ridge: bytes bound,
// and the implicit gather re-reads each input voxel once per tap from L2. The
// deep 3x3x3 stitches at levels 2-4 (K up to 6,912) are bound by operations,
// but at batch 2 their output tiles alone give 8-63 blocks for 132 SMs, so
// what bounds them in practice is grid fill. The design:
//
//  * Tensor cores through mma.sync m16n8k16 bf16 -> fp32, fragments by
//    ldmatrix (the building blocks of K5, mma.cuh). Not wgmma: the path is
//    bound by bytes and by grid fill, not by the peak tensor rate (the whole
//    forward is 186 GFLOP, 0.19 ms at the 989 TFLOP/s peak, against a byte
//    bound of 0.34 ms), and mma.sync takes the model's narrow outputs (cout
//    1..16) at n8 granularity where wgmma's 64-row warpgroup tile would not
//    pay. The consumer (`mma_k16`) only reads shared tiles, so a later wgmma
//    consumer replaces it without touching the gather (`load_a`, `load_b`).
//  * 8 warps, a 128 x BN block tile with BN in {8, 16, 32, 64, 128} picked by
//    the wrapper from cout; K advances in slabs of 32.
//  * A 4-stage shared-memory ring with one __syncthreads per slab; the next
//    slab's loads are issued between the current slab's two k16 steps, and
//    each thread advances its (tap, channel) cursor without a division. A is
//    gathered by 16-byte cp.async, 8 channels of one tap of one voxel, with
//    padding taps and rows past the end zero-filled through cp.async's
//    src-size operand. A part whose channel count is not a multiple of 8
//    (the stem's 3, level 0's bottleneck width 4) or whose address is not
//    16-byte aligned is gathered element by element through registers into
//    the same bf16 tiles; the wrapper picks the route per part. Weights take
//    cp.async too: K1's DHWIO kernel is K x N with co contiguous (ldmatrix
//    .trans), K2's (kd,kh,kw,Cout,Cin) kernel is N x K with ci contiguous
//    (plain ldmatrix); a cout (K1) or cin (K2) that is not a multiple of 8
//    takes a scalar, zero-filled load. Shared rows are padded so the eight
//    16-byte rows of each ldmatrix phase fall in distinct banks.
//  * Parts are walked in order into one accumulator (no concat); within a
//    part k is tap-major, each part's K rounded up to whole slabs.
//  * Deterministic split-K for grids below ~2 waves: the wrapper picks the
//    split count (ops/convolution.py, igemm_plan); split j of a phase walks
//    slabs [L*j/S, L*(j+1)/S) and writes fp32 partials to a workspace the
//    wrapper allocates; splitk_reduce_kernel then sums the splits in order
//    0..S-1, adds the fp32 bias and rounds once to bf16. No float atomics:
//    the same inputs give the same bits.
//  * Without split-K the epilogue adds the fp32 bias to the fp32 accumulator
//    and rounds once to bf16, as the FMA kernel does.

#include <stdint.h>

#include "common.cuh"
#include "conv_params.cuh"
#include "mma.cuh"

namespace {

using pmr::ConvParams;
using pmr::kMaxParts;
using pmr::kMaxTaps;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kLdA = kBK + 8;  // 40 elements = 80 bytes a row

template <int BN, bool kNK>
struct Tile {
  // K1 keeps the weight slab K x N (row = k), K2 keeps it N x K (row = n).
  static constexpr int kLdB = kNK ? kLdA : (BN == 8 ? 24 : BN + 8);
  static constexpr int kAElems = kBM * kLdA;
  static constexpr int kBElems = kNK ? BN * kLdA : kBK * kLdB;
  static constexpr int kSmemBytes = kStages * (kAElems + kBElems) * (int)sizeof(bf16);
};

__device__ __forceinline__ bool inside(int z, int y, int x, int d, int h, int w) {
  return (unsigned)z < (unsigned)d && (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
}

// Blocks resident on one SM, by tile width: narrow tiles hold few
// accumulators, so more of their blocks fit (registers capped to match);
// ops/convolution.py's RESIDENT_BLOCKS mirrors this for the split-K plan.
constexpr int resident_blocks(int bn) { return bn <= 16 ? 4 : bn <= 32 ? 3 : 2; }

// Warp tile WM x WN = (kBM / WARPS_M) x (BN / (8 / WARPS_M)): MT x NT mma tiles.
template <int BN, int WARPS_M, bool kNK>
__global__ void __launch_bounds__(kThreads, resident_blocks(BN))
    conv3d_mma_kernel(const ConvParams p) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WARPS_M * WARPS_N == 8 && MT >= 1 && NT >= 1, "8 warps tile the block");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs");
  using T = Tile<BN, kNK>;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const sa = reinterpret_cast<bf16*>(smem);
  bf16* const sb = sa + kStages * T::kAElems;
  __shared__ int4 row_in[kBM];        // (batch or -1, z0, y0, x0)
  __shared__ int row_vox[kBM];        // input voxel index of (z0, y0, x0)
  __shared__ int row_out[kBM];       // output element offset or -1
  __shared__ int4 taps[kMaxTaps];     // dz, dy, dx, weight tap
  __shared__ int tap_vox[kMaxTaps];   // voxel offset of the tap
  __shared__ int part_slab[kMaxParts + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int phase = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  // the wrapper keeps rows, voxels and output elements below 2^31
  const int m_total = p.batch * p.g_d * p.g_h * p.g_w;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int ntap = p.ntap[phase];

  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    int4 info = make_int4(-1, 0, 0, 0);
    int vox = 0;
    int oofs = -1;
    if (m < m_total) {
      int t = m;
      const int gw = t % p.g_w;
      t /= p.g_w;
      const int gh = t % p.g_h;
      t /= p.g_h;
      const int gd = t % p.g_d;
      const int b = t / p.g_d;
      info = make_int4(b, gd * p.in_mul[0] + p.in_add[0], gh * p.in_mul[1] + p.in_add[1],
                       gw * p.in_mul[2] + p.in_add[2]);
      vox = ((b * p.in_d + info.y) * p.in_h + info.z) * p.in_w + info.w;
      const int od = gd * p.out_mul[0] + p.res[phase][0];
      const int oh = gh * p.out_mul[1] + p.res[phase][1];
      const int ow = gw * p.out_mul[2] + p.res[phase][2];
      oofs = (((b * p.out_d + od) * p.out_h + oh) * p.out_w + ow) * p.cout;
    }
    row_in[r] = info;
    row_vox[r] = vox;
    row_out[r] = oofs;
  }
  for (int t = tid; t < ntap; t += kThreads) {
    const int dz = p.tap[phase][t][0], dy = p.tap[phase][t][1], dx = p.tap[phase][t][2];
    taps[t] = make_int4(dz, dy, dx, p.tap[phase][t][3]);
    tap_vox[t] = (dz * p.in_h + dy) * p.in_w + dx;
  }
  if (tid == 0) {
    int s = 0;
    for (int q = 0; q < p.nparts; ++q) {
      part_slab[q] = s;
      s += (ntap * p.cin[q] + kBK - 1) / kBK;
    }
    part_slab[p.nparts] = s;
  }
  __syncthreads();

  // This split's slabs of this phase.
  const int nslab_phase = part_slab[p.nparts];
  const int s_begin = nslab_phase * split / p.splits;
  const int s_end = nslab_phase * (split + 1) / p.splits;
  const int nslab = s_end - s_begin;

  // The vector A loader's two rows (tid / 4 and tid / 4 + 64), in registers.
  int4 vrow[2];
  int vvox[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    vrow[j] = row_in[(tid >> 2) + j * 64];
    vvox[j] = row_vox[(tid >> 2) + j * 64];
  }

  const bf16* const wgt = static_cast<const bf16*>(p.w);
  const int w_tap_stride = p.cin_total * p.cout;

  // ---------------------------------------------------------- producer
  // The slabs of this split are loaded in order, so each thread keeps a
  // cursor: the part, the slab within it, and the (tap, channel) of each k
  // it loads, advanced 32 a slab without a division (one per part).
  constexpr int kBChunks = (kBK * BN / 8 + kThreads - 1) / kThreads;
  int b_koff[kBChunks], b_n[kBChunks];
#pragma unroll
  for (int j = 0; j < kBChunks; ++j) {
    const int c = tid + j * kThreads;  // may lie past the slab: b_n >= BN then
    b_n[j] = kNK ? c / (kBK / 8) : (c % (BN / 8)) * 8 + (c / (BN / 8) >= kBK ? BN : 0);
    b_koff[j] = kNK ? (c % (kBK / 8)) * 8 : (c / (BN / 8)) % kBK;
  }
  int part = 0, pslab = 0, part_nslab = 0, cin = 1, ci_base = 0;
  bool avec = false;
  int a_t = 0, a_ci = 0, a_k = 0;  // a_k: the thread's k within a slab
  int b_t[kBChunks], b_ci[kBChunks];

  auto seek = [&](int s) {  // the cursor at slab s of this phase
    part = 0;
    ci_base = 0;
    while (part + 1 < p.nparts && s >= part_slab[part + 1]) ci_base += p.cin[part++];
    pslab = s - part_slab[part];
    part_nslab = part_slab[part + 1] - part_slab[part];
    cin = p.cin[part];
    avec = (p.a_vec >> part) & 1;
    a_k = avec ? (tid & 3) * 8 : tid & 31;
    const int k0 = pslab * kBK;
    a_t = (k0 + a_k) / cin;
    a_ci = k0 + a_k - a_t * cin;
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      b_t[j] = (k0 + b_koff[j]) / cin;
      b_ci[j] = k0 + b_koff[j] - b_t[j] * cin;
    }
  };
  auto step = [&](int& t, int& ci) {  // k += 32
    ci += kBK;
    if (ci >= cin) {
      if (ci < 2 * cin) {
        ci -= cin;
        ++t;
      } else {  // cin < 32: the narrow parts only
        t += ci / cin;
        ci %= cin;
      }
    }
  };
  auto advance = [&]() {
    if (++pslab == part_nslab) {
      if (part + 1 < p.nparts) seek(part_slab[part + 1]);
      return;
    }
    step(a_t, a_ci);
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) step(b_t[j], b_ci[j]);
  };

  // A: 128 rows x 32 k of the implicit im2col matrix, into ring stage `stage`
  auto load_a = [&](int stage) {
    bf16* const ta = sa + stage * T::kAElems;
    const bf16* const xp = static_cast<const bf16*>(p.x[part]);
    const bool k_ok = a_t < ntap;
    const int4 tp = taps[k_ok ? a_t : 0];
    const int tv = tap_vox[k_ok ? a_t : 0];
    if (avec) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k_ok && vrow[j].x >= 0 &&
                        inside(vrow[j].y + tp.x, vrow[j].z + tp.y, vrow[j].w + tp.z, p.in_d,
                               p.in_h, p.in_w);
        const bf16* src = ok ? xp + (size_t)(vvox[j] + tv) * cin + a_ci : xp;
        pmr::cp_async16_l1(ta + ((tid >> 2) + j * 64) * kLdA + a_k, src, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kBM / 8; ++j) {
        const int r = (tid >> 5) + j * 8;
        const int4 info = row_in[r];
        const bool ok = k_ok && info.x >= 0 &&
                        inside(info.y + tp.x, info.z + tp.y, info.w + tp.z, p.in_d, p.in_h,
                               p.in_w);
        ta[r * kLdA + a_k] =
            ok ? xp[(size_t)(row_vox[r] + tv) * cin + a_ci] : __float2bfloat16(0.f);
      }
    }
  };

  // B: the 32 x BN weight slab, into ring stage `stage`
  auto load_b = [&](int stage) {
    bf16* const tb = sb + stage * T::kBElems;
    if (p.b_vec) {
#pragma unroll
      for (int j = 0; j < kBChunks; ++j) {
        if (b_n[j] >= BN) continue;
        const int co = n0 + b_n[j];
        const bool ok = b_t[j] < ntap && co < p.cout;
        const bf16* src = ok ? wgt + taps[b_t[j]].w * w_tap_stride +
                                   (ci_base + b_ci[j]) * p.w_ci_stride + co * p.w_co_stride
                             : wgt;
        bf16* dst = kNK ? tb + b_n[j] * T::kLdB + b_koff[j] : tb + b_koff[j] * T::kLdB + b_n[j];
        pmr::cp_async16(dst, src, ok ? 16 : 0);
      }
    } else {
      const int k0 = pslab * kBK, k_total = ntap * cin;
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int kk = kNK ? e % kBK : e / BN;
        const int n = kNK ? e / kBK : e % BN;
        const int k = k0 + kk, co = n0 + n;
        bf16 v = __float2bfloat16(0.f);
        if (k < k_total && co < p.cout) {
          const int t = k / cin;
          const int ci = k - t * cin;
          v = wgt[taps[t].w * w_tap_stride + (ci_base + ci) * p.w_ci_stride +
                  co * p.w_co_stride];
        }
        tb[kNK ? n * T::kLdB + kk : kk * T::kLdB + n] = v;
      }
    }
  };

  // ---------------------------------------------------------- consumer
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // ldmatrix row addresses. A (and K1's K-major B): matrices (rows 0-7, k 0),
  // (rows 8-15, k 0), (rows 0-7, k 8), (rows 8-15, k 8). K2's N-major B:
  // (n 0-7, k 0), (n 0-7, k 8), (n 8-15, k 0), (n 8-15, k 8).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int nrow = (lane & 7) + (lane >> 4) * 8;
  const int ncol = ((lane >> 3) & 1) * 8;

  // One k16 step of the block tile from ring stage `stage`.
  auto mma_k16 = [&](int stage, int kk) {
    const bf16* const ta = sa + stage * T::kAElems;
    const bf16* const tb = sb + stage * T::kBElems;
    uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      pmr::ldmatrix_x4(af[i], ta + (wm * WM + i * 16 + lrow) * kLdA + kk + lcol);
    if constexpr (NT == 1) {
      if constexpr (kNK)
        pmr::ldmatrix_x2(bfr[0], tb + (wn * WN + (lane & 7)) * T::kLdB + kk + ncol);
      else
        pmr::ldmatrix_x2_trans(bfr[0], tb + (kk + (lane & 15)) * T::kLdB + wn * WN);
    } else {
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        if constexpr (kNK)
          pmr::ldmatrix_x4(r, tb + (wn * WN + jj * 16 + nrow) * T::kLdB + kk + ncol);
        else
          pmr::ldmatrix_x4_trans(r, tb + (kk + lrow) * T::kLdB + wn * WN + jj * 16 + lcol);
        bfr[2 * jj][0] = r[0];
        bfr[2 * jj][1] = r[1];
        bfr[2 * jj + 1][0] = r[2];
        bfr[2 * jj + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) pmr::mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
  };

  // ------------------------------------------------------------ the ring
  // Slab i + 3's loads are issued between slab i's two k16 steps, so the
  // gather's integer work overlaps the tensor cores.
  if (nslab > 0) seek(s_begin);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslab) {
      load_a(s);
      load_b(s);
      advance();
    }
    pmr::cp_async_commit();
  }
  for (int i = 0; i < nslab; ++i) {
    pmr::cp_async_wait<kStages - 2>();  // slab i has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and slab i - 1's stage is free again
    const int next = i + kStages - 1;
    const int stage = i % kStages;
    if (next < nslab) load_a(next % kStages);
    mma_k16(stage, 0);
    if (next < nslab) {
      load_b(next % kStages);
      advance();
    }
    pmr::cp_async_commit();
    mma_k16(stage, 16);
  }

  // ------------------------------------------------------------ epilogue
  // C fragment: c0, c1 at (g, 2t..2t+1); c2, c3 at (g + 8, 2t..2t+1).
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (p.cout & 1) == 0;
  const int out_numel = p.batch * p.out_d * p.out_h * p.out_w * p.cout;
  float* const part_out = p.splits > 1 ? p.ws + (size_t)split * out_numel : nullptr;
  bf16* const y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oofs = row_out[wm * WM + i * 16 + g + h * 8];
      if (oofs < 0) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = n0 + wn * WN + j * 8 + 2 * t4;
        if (co >= p.cout) continue;
        const bool both = co + 1 < p.cout;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (part_out != nullptr) {
          float* dst = part_out + oofs + co;
          if (both && pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (both) dst[1] = v1;
          }
          continue;
        }
        if (p.bias != nullptr) {
          v0 += p.bias[co];
          if (both) v1 += p.bias[co + 1];
        }
        bf16* dst = y + oofs + co;
        if (both && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (both) dst[1] = __float2bfloat16(v1);
        }
      }
    }
}

// y = bf16(sum_{j < splits} ws[j] + bias), the splits summed in order.
__global__ void __launch_bounds__(kThreads)
    splitk_reduce_kernel(const float* __restrict__ ws, int splits, long long numel, int cout,
                         const float* __restrict__ bias, bf16* __restrict__ y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < numel;
       e += stride) {
    float s = ws[e];
    for (int j = 1; j < splits; ++j) s += ws[(size_t)j * numel + e];
    if (bias != nullptr) s += bias[e % cout];
    y[e] = __float2bfloat16(s);
  }
}

template <int BN, int WARPS_M, bool kNK>
int launch_tile(const ConvParams& p, cudaStream_t stream) {
  auto kernel = conv3d_mma_kernel<BN, WARPS_M, kNK>;
  constexpr int smem = Tile<BN, kNK>::kSmemBytes;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long m_total = (long long)p.batch * p.g_d * p.g_h * p.g_w;
  const dim3 grid((unsigned)((m_total + kBM - 1) / kBM), (unsigned)((p.cout + BN - 1) / BN),
                  (unsigned)(p.nphase * p.splits));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kNK>
int launch_bn(const ConvParams& p, cudaStream_t stream) {
  switch (p.bn) {
    case 8: return launch_tile<8, 8, kNK>(p, stream);
    case 16: return launch_tile<16, 8, kNK>(p, stream);
    case 32: return launch_tile<32, 4, kNK>(p, stream);
    case 64: return launch_tile<64, 4, kNK>(p, stream);
    case 128: return launch_tile<128, 2, kNK>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1 and K2 in bf16 (the wrapper's meta[67] says which): the main kernel
// and, with split-K, the reduce, both on `stream`.
extern "C" int pmr_conv3d_mma(const void* ptrs, const void* meta, const void* taps,
                              void* stream) {
  ConvParams p;
  int rc = pmr::unpack_conv_args(ptrs, meta, taps, &p);
  if (rc != 0) return rc;
  if (p.dtype != pmr::kBFloat16 || p.splits < 1 || p.splits > 64 ||
      (p.splits > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = p.transposed ? launch_bn<true>(p, s) : launch_bn<false>(p, s);
  if (rc != 0 || p.splits == 1) return rc;
  const long long numel = (long long)p.batch * p.out_d * p.out_h * p.out_w * p.cout;
  const long long blocks = (numel + kThreads - 1) / kThreads;
  splitk_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      p.ws, p.splits, numel, p.cout, p.bias, static_cast<bf16*>(p.y));
  return (int)cudaGetLastError();
}
