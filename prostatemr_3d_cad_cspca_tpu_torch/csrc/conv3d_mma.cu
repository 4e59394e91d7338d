// K1 conv3d and K2 conv3d_transpose in fp32: implicit-GEMM 3D convolution on
// channels-last (NDHWC) tensors on the tensor cores, fp32 accumulation:
// mma.sync m16n8k8 on TF32 operands, error-compensated (3xTF32). bf16 K1/K2
// run on wgmma with halo tiles in conv3d_wgmma.cu; this file served bf16
// too (mma.sync m16n8k16) until that kernel replaced it.
//
// Replaces: benchmarks/r2_probe_pallas_mxu.py:80 conv_probe (its body `kern`
// at :96), the streaming (1,3,3) SAME conv + bias that built a 9-tap im2col in
// VMEM and ran one deep-K matmul on the MXU. Here the im2col is implicit: each
// block gathers its (128 rows x one K-slab) tile of the virtual im2col matrix
// straight from the NDHWC parts into shared memory, so no im2col tensor ever
// reaches device memory. Generalized to every conv of the M1 path: kernels
// (1,3,3), (3,3,3), (1,1,1); strides (1,1,1), (1,2,2), (2,2,2); a list of up
// to six channel parts summed into one output (SplitInputConv); and the
// TF-convention transposed conv (K2). Both kernels read one ConvParams
// (conv_params.cuh).
//
// GEMM view: rows M = output voxels, columns N = output channels, depth
// K = taps x input channels. XLA SAME padding is asymmetric for even sizes at
// stride 2 (pad_lo = 0, pad_hi = 1); the Python wrapper computes it and hands
// the kernel one table of tap offsets, so the kernel knows nothing of padding
// rules. The transposed conv runs in gather form, split by output phase
// (output coordinate mod stride): every row of a block shares one phase and
// hence one set of contributing taps, so no multiply is spent on the zeros a
// dilated input would hold.
//
// What bounds it on an H100. Levels 0-1 (20x160x160 and 20x80x80, 4-64
// channels) sit far below the card's ~295 bf16 FLOP/byte ridge: bytes bound,
// and the implicit gather re-reads each input voxel once per tap from L2. The
// deep 3x3x3 stitches at levels 2-4 (K up to 6,912) are bound by operations,
// but at batch 2 their output tiles alone give 8-63 blocks for 132 SMs, so
// what bounds them in practice is grid fill. fp32 moves twice the bytes and
// does three TF32 products for each one (495 TFLOP/s TF32 peak: 1/6 of the
// bf16 rate for the same convolution). The design:
//
//  * Tensor cores through mma.sync (the building blocks of K5, mma.cuh).
//    wgmma, the only way to Hopper's full tensor-core rate, takes TF32 only
//    with K-major B and would need the hi/lo split in shared memory: not
//    done yet. (An earlier note here declined wgmma because its "64-row
//    tile" would not pay at cout 1-16; that misread the 64: it is M, the
//    output voxels, of which there are always plenty, and N goes down to 8.
//    conv3d_wgmma.cu runs bf16 so.)
//  * 8 warps, a 128 x BN block tile with BN in {8, 16, 32, 64} picked by
//    the wrapper from cout; K advances in slabs of 64 bytes a row: 16 fp32
//    elements, two k8 mma steps a slab.
//  * A 4-stage shared-memory ring with one __syncthreads per slab; the next
//    slab's loads are issued between the current slab's two mma steps, and
//    each thread advances its (tap, channel) cursor without a division. A is
//    gathered by 16-byte cp.async, 8 bf16 or 4 fp32 channels of one tap of
//    one voxel, with padding taps and rows past the end zero-filled through
//    cp.async's src-size operand. A part whose channel count is not a
//    multiple of the chunk (the stem's 3) or whose address is not 16-byte
//    aligned is gathered element by
//    element through registers into the same tiles; the wrapper picks the
//    route per part (ops/convolution.py, gather_routes). Weights take
//    cp.async too: K1's DHWIO kernel is K x N with co contiguous, K2's
//    (kd,kh,kw,Cout,Cin) kernel is N x K with ci contiguous; a cout (K1) or
//    cin (K2) that is not a multiple of the chunk takes a scalar, zero-filled
//    load.
//  * Fragments: rows are padded so the eight 16-byte rows of each ldmatrix
//    phase fall in distinct banks. A and K2's N-major B by plain ldmatrix, whose
//    8 rows of 16 bytes hand lane (g, t) the 32-bit element (g, t): the TF32
//    fragment order. K1's K-major B has no 32-bit transposing load, so each
//    lane reads its two elements with lds.32 from rows padded to BN + 8
//    floats (8 for BN 8): the four rows t = 0..3 a load reads then start 8
//    banks apart and the 32 lanes hit 32 distinct banks.
//  * fp32 by 3xTF32. The tensor cores take fp32 only as TF32 (10 mantissa
//    bits, ~1e-3 relative), which alone cannot hold the port's fp32 limits
//    (kernel vs twin 2e-4, card vs CPU softmax 1e-3). Each fragment value x
//    is split in registers as it is read: hi = tf32(x), lo = tf32(x - hi),
//    both rounded as cvt.rna rounds (split_tf32: four integer and float ops
//    a value where cvt.rna takes six or seven); a product is lo*hi + hi*lo,
//    then hi*hi, three TF32 mmas into one fp32 accumulator (lo*lo, ~2^-22
//    relative, is dropped).
//    The tensor core's fp32 sums lose accuracy over long chains (K5's
//    finding), so the mmas accumulate into a chain that is added into plain
//    fp32 registers every kChainSlabs slabs (ops/convolution.py mirrors the
//    count for the CPU replay). At the path's deepest K (6,912) on an H100,
//    against an fp64 product: 2.8e-6 relative with chains of 8 slabs,
//    1.1e-5 with 32, 8e-5 with none (the fp32 twin: 7e-6), at device times
//    within 2 % of each other. fp32 tiles stop at BN 64 and fewer of their
//    blocks fit an SM: each holds twice the accumulators.
//  * ptxas: 75-128 registers; K2's BN 64 variant, at the 128-register cap
//    of two blocks an SM, spills 28 bytes.
//  * Parts are walked in order into one accumulator (no concat); within a
//    part k is tap-major, each part's K rounded up to whole slabs.
//  * Deterministic split-K for grids below ~2 waves: the wrapper picks the
//    split count (ops/convolution.py, igemm_plan); split j of a phase walks
//    slabs [L*j/S, L*(j+1)/S) and writes fp32 partials to a workspace the
//    wrapper allocates; splitk_reduce_kernel then sums the splits in order
//    0..S-1, adds the fp32 bias and rounds once to the output type. No float
//    atomics: the same inputs give the same bits.
//  * Without split-K the epilogue adds the fp32 bias to the fp32 accumulator
//    and rounds once to the output type.

#include <stdint.h>

#include "common.cuh"
#include "conv_params.cuh"
#include "mma.cuh"
#include "stamps.cuh"

namespace {

using pmr::ConvParams;
using pmr::kMaxParts;
using pmr::kMaxTaps;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;
constexpr int kStages = 4;
constexpr int kChainSlabs = 8;  // fp32: slabs (16 k8 steps, 48 mmas) a tensor-core chain

// Per element type: the K-slab depth (64 bytes a row), one mma step's depth
// and the elements of a 16-byte chunk.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kBK = 16, kKS = 8, kVec = 4;
};

template <typename T, int BN, bool kNK>
struct Tile {
  static constexpr int kBK = Elem<T>::kBK;
  static constexpr int kLdA = kBK + Elem<T>::kVec;  // 80 bytes a row
  // K1 keeps the weight slab K x N (row = k), K2 keeps it N x K (row = n).
  static constexpr int kLdB = kNK ? kLdA : (BN == 8 ? 8 : BN + 8);
  static constexpr int kAElems = kBM * kLdA;
  static constexpr int kBElems = kNK ? BN * kLdA : kBK * kLdB;
  static constexpr int kSmemBytes = kStages * (kAElems + kBElems) * (int)sizeof(T);
};

__device__ __forceinline__ bool inside(int z, int y, int x, int d, int h, int w) {
  return (unsigned)z < (unsigned)d && (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
}

// Blocks resident on one SM, by element type and tile width: narrow tiles
// hold few accumulators, so more of their blocks fit (registers capped to
// match); ops/convolution.py's RESIDENT_BLOCKS mirrors this for the split-K
// plan.
template <typename T>
constexpr int resident_blocks(int bn) {
  return bn <= 16 ? 3 : 2;
}

__device__ __forceinline__ void store_pair(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// Warp tile WM x WN = (kBM / WARPS_M) x (BN / (8 / WARPS_M)): MT x NT mma tiles.
template <typename T, int BN, int WARPS_M, bool kNK>
__global__ void __launch_bounds__(kThreads, resident_blocks<T>(BN))
    conv3d_mma_kernel(const ConvParams p) {
  static_assert(sizeof(T) == 4, "fp32 only: bf16 runs in conv3d_wgmma.cu");
  constexpr int kBK = Elem<T>::kBK, kKS = Elem<T>::kKS, kVec = Elem<T>::kVec;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WARPS_M * WARPS_N == 8 && MT >= 1 && NT >= 1, "8 warps tile the block");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs");
  static_assert(kBK / kVec == 4 && kBK == 2 * kKS, "four chunks, two mma steps a slab row");
  using Tl = Tile<T, BN, kNK>;
  constexpr int kLdA = Tl::kLdA;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sa = reinterpret_cast<T*>(smem);
  T* const sb = sa + kStages * Tl::kAElems;
  __shared__ int4 row_in[kBM];        // (batch or -1, z0, y0, x0)
  __shared__ int row_vox[kBM];        // input voxel index of (z0, y0, x0)
  __shared__ int row_out[kBM];       // output element offset or -1
  __shared__ int4 taps[kMaxTaps];     // dz, dy, dx, weight tap
  __shared__ int tap_vox[kMaxTaps];   // voxel offset of the tap
  __shared__ int part_slab[kMaxParts + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PMR_STAMP_DECL(tid == 0);
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
  PMR_STAMP(kStampSetup);

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

  const T* const wgt = static_cast<const T*>(p.w);
  const int w_tap_stride = p.cin_total * p.cout;

  // ---------------------------------------------------------- producer
  // The slabs of this split are loaded in order, so each thread keeps a
  // cursor: the part, the slab within it, and the (tap, channel) of each k
  // it loads, advanced one slab at a time without a division (one per part).
  constexpr int kBChunks = (kBK * BN / kVec + kThreads - 1) / kThreads;
  int b_koff[kBChunks], b_n[kBChunks];
#pragma unroll
  for (int j = 0; j < kBChunks; ++j) {
    const int c = tid + j * kThreads;  // may lie past the slab: b_n >= BN then
    b_n[j] = kNK ? c / (kBK / kVec)
                 : (c % (BN / kVec)) * kVec + (c / (BN / kVec) >= kBK ? BN : 0);
    b_koff[j] = kNK ? (c % (kBK / kVec)) * kVec : (c / (BN / kVec)) % kBK;
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
    a_k = avec ? (tid & 3) * kVec : tid & (kBK - 1);
    const int k0 = pslab * kBK;
    a_t = (k0 + a_k) / cin;
    a_ci = k0 + a_k - a_t * cin;
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      b_t[j] = (k0 + b_koff[j]) / cin;
      b_ci[j] = k0 + b_koff[j] - b_t[j] * cin;
    }
  };
  auto step = [&](int& t, int& ci) {  // k += kBK
    ci += kBK;
    if (ci >= cin) {
      if (ci < 2 * cin) {
        ci -= cin;
        ++t;
      } else {  // cin < kBK: the narrow parts only
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

  // A: 128 rows x kBK k of the implicit im2col matrix, into ring stage `stage`
  auto load_a = [&](int stage) {
    T* const ta = sa + stage * Tl::kAElems;
    const T* const xp = static_cast<const T*>(p.x[part]);
    const bool k_ok = a_t < ntap;
    const int4 tp = taps[k_ok ? a_t : 0];
    const int tv = tap_vox[k_ok ? a_t : 0];
    if (avec) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k_ok && vrow[j].x >= 0 &&
                        inside(vrow[j].y + tp.x, vrow[j].z + tp.y, vrow[j].w + tp.z, p.in_d,
                               p.in_h, p.in_w);
        const T* src = ok ? xp + (size_t)(vvox[j] + tv) * cin + a_ci : xp;
        pmr::cp_async16_l1(ta + ((tid >> 2) + j * 64) * kLdA + a_k, src, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kBM * kBK / kThreads; ++j) {
        const int r = (tid >> (kBK == 32 ? 5 : 4)) + j * (kThreads / kBK);  // tid / kBK
        const int4 info = row_in[r];
        const bool ok = k_ok && info.x >= 0 &&
                        inside(info.y + tp.x, info.z + tp.y, info.w + tp.z, p.in_d, p.in_h,
                               p.in_w);
        ta[r * kLdA + a_k] =
            ok ? xp[(size_t)(row_vox[r] + tv) * cin + a_ci] : pmr::from_f32<T>(0.f);
      }
    }
  };

  // B: the kBK x BN weight slab, into ring stage `stage`
  auto load_b = [&](int stage) {
    T* const tb = sb + stage * Tl::kBElems;
    if (p.b_vec) {
#pragma unroll
      for (int j = 0; j < kBChunks; ++j) {
        if (b_n[j] >= BN) continue;
        const int co = n0 + b_n[j];
        const bool ok = b_t[j] < ntap && co < p.cout;
        const T* src = ok ? wgt + taps[b_t[j]].w * w_tap_stride +
                                (ci_base + b_ci[j]) * p.w_ci_stride + co * p.w_co_stride
                          : wgt;
        T* dst = kNK ? tb + b_n[j] * Tl::kLdB + b_koff[j] : tb + b_koff[j] * Tl::kLdB + b_n[j];
        pmr::cp_async16(dst, src, ok ? 16 : 0);
      }
    } else {
      const int k0 = pslab * kBK, k_total = ntap * cin;
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int kk = kNK ? e % kBK : e / BN;
        const int n = kNK ? e / kBK : e % BN;
        const int k = k0 + kk, co = n0 + n;
        T v = pmr::from_f32<T>(0.f);
        if (k < k_total && co < p.cout) {
          const int t = k / cin;
          const int ci = k - t * cin;
          v = wgt[taps[t].w * w_tap_stride + (ci_base + ci) * p.w_ci_stride +
                  co * p.w_co_stride];
        }
        tb[kNK ? n * Tl::kLdB + kk : kk * Tl::kLdB + n] = v;
      }
    }
  };

  // ---------------------------------------------------------- consumer
  // The mmas accumulate in chain, added into acc every kChainSlabs slabs
  // (promote).
  float acc[MT][NT][4], chain[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = chain[i][j][e] = 0.f;
  auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] += chain[i][j][e];
          chain[i][j][e] = 0.f;
        }
  };

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // ldmatrix row addresses. A: matrices (rows 0-7,
  // k 0), (rows 8-15, k 0), (rows 0-7, k +16 B), (rows 8-15, k +16 B). K2's
  // N-major B: (n 0-7, k 0), (n 0-7, k +16 B), (n 8-15, k 0), (n 8-15, k +16 B).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * kVec;
  const int nrow = (lane & 7) + (lane >> 4) * 8;
  const int ncol = ((lane >> 3) & 1) * kVec;

  // One k8 mma step of the block tile from ring stage `stage`.
  auto mma_step = [&](int stage, int kk) {
    const T* const ta = sa + stage * Tl::kAElems;
    const T* const tb = sb + stage * Tl::kBElems;
    uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      pmr::ldmatrix_x4(af[i], ta + (wm * WM + i * 16 + lrow) * kLdA + kk + lcol);
    if constexpr (!kNK) {
      const T* const col0 = tb + (kk + (lane & 3)) * Tl::kLdB + wn * WN + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* col = col0 + j * 8;
        bfr[j][0] = __float_as_uint(col[0]);
        bfr[j][1] = __float_as_uint(col[4 * Tl::kLdB]);
      }
    } else if constexpr (NT == 1) {
      pmr::ldmatrix_x2(bfr[0], tb + (wn * WN + (lane & 7)) * Tl::kLdB + kk + ncol);
    } else {
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        pmr::ldmatrix_x4(r, tb + (wn * WN + jj * 16 + nrow) * Tl::kLdB + kk + ncol);
        bfr[2 * jj][0] = r[0];
        bfr[2 * jj][1] = r[1];
        bfr[2 * jj + 1][0] = r[2];
        bfr[2 * jj + 1][1] = r[3];
      }
    }
    {
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) pmr::split_tf32(bfr[j][h], bhi[j][h], blo[j][h]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pmr::split_tf32(af[i][e], ahi[e], alo[e]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          pmr::mma_tf32(chain[i][j], alo, bhi[j][0], bhi[j][1]);
          pmr::mma_tf32(chain[i][j], ahi, blo[j][0], blo[j][1]);
          pmr::mma_tf32(chain[i][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
  };

  // ------------------------------------------------------------ the ring
  // Slab i + 3's loads are issued between slab i's two mma steps, so the
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
  PMR_STAMP(kStampIssue);
  for (int i = 0; i < nslab; ++i) {
    pmr::cp_async_wait<kStages - 2>();  // slab i has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and slab i - 1's stage is free again
    PMR_STAMP(kStampWait);
    const int next = i + kStages - 1;
    const int stage = i % kStages;
    if (next < nslab) load_a(next % kStages);
    PMR_STAMP(kStampIssue);
    mma_step(stage, 0);
    PMR_STAMP(kStampMma);
    if (next < nslab) {
      load_b(next % kStages);
      advance();
    }
    pmr::cp_async_commit();
    PMR_STAMP(kStampIssue);
    mma_step(stage, kKS);
    if ((i + 1) % kChainSlabs == 0) promote();
    PMR_STAMP(kStampMma);
  }
  promote();

  // ------------------------------------------------------------ epilogue
  // C fragment: c0, c1 at (g, 2t..2t+1); c2, c3 at (g + 8, 2t..2t+1).
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (p.cout & 1) == 0;
  const int out_numel = p.batch * p.out_d * p.out_h * p.out_w * p.cout;
  float* const part_out = p.splits > 1 ? p.ws + (size_t)split * out_numel : nullptr;
  T* const y = static_cast<T*>(p.y);
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
        T* dst = y + oofs + co;
        if (both && pairs) {
          store_pair(dst, v0, v1);
        } else {
          dst[0] = pmr::from_f32<T>(v0);
          if (both) dst[1] = pmr::from_f32<T>(v1);
        }
      }
    }
  PMR_STAMP(kStampEpilogue);
  PMR_STAMP_WRITE();
}

// y = T(sum_{j < splits} ws[j] + bias), the splits summed in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    splitk_reduce_kernel(const float* __restrict__ ws, int splits, long long numel, int cout,
                         const float* __restrict__ bias, T* __restrict__ y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < numel;
       e += stride) {
    float s = ws[e];
    for (int j = 1; j < splits; ++j) s += ws[(size_t)j * numel + e];
    if (bias != nullptr) s += bias[e % cout];
    y[e] = pmr::from_f32<T>(s);
  }
}

template <typename T, int BN, int WARPS_M, bool kNK>
int launch_tile(const ConvParams& p, cudaStream_t stream) {
  auto kernel = conv3d_mma_kernel<T, BN, WARPS_M, kNK>;
  constexpr int smem = Tile<T, BN, kNK>::kSmemBytes;
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

template <typename T, bool kNK>
int launch_bn(const ConvParams& p, cudaStream_t stream) {
  switch (p.bn) {
    case 8: return launch_tile<T, 8, 8, kNK>(p, stream);
    case 16: return launch_tile<T, 16, 8, kNK>(p, stream);
    case 32: return launch_tile<T, 32, 4, kNK>(p, stream);
    case 64: return launch_tile<T, 64, 4, kNK>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const ConvParams& p, cudaStream_t s) {
  int rc = p.transposed ? launch_bn<T, true>(p, s) : launch_bn<T, false>(p, s);
  if (rc != 0 || p.splits == 1) return rc;
  const long long numel = (long long)p.batch * p.out_d * p.out_h * p.out_w * p.cout;
  const long long blocks = (numel + kThreads - 1) / kThreads;
  splitk_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      p.ws, p.splits, numel, p.cout, p.bias, static_cast<T*>(p.y));
  return (int)cudaGetLastError();
}

}  // namespace

// K1 and K2 in fp32 (meta's dtype field must say so; bf16 goes to
// pmr_conv3d_wgmma): the main kernel and, with split-K, the reduce, both on
// `stream`.
extern "C" int pmr_conv3d_mma(const void* ptrs, const void* meta, const void* taps,
                              void* stream) {
  ConvParams p;
  const int rc = pmr::unpack_conv_args(ptrs, meta, taps, &p);
  if (rc != 0) return rc;
  if (p.splits < 1 || p.splits > 64 || (p.splits > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == pmr::kFloat32) return run<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The stamps build's buffer for this source's kernels (stamps.cuh).
extern "C" int pmr_conv3d_mma_stamps(void* buf) { return pmr_stamp_install(buf); }
