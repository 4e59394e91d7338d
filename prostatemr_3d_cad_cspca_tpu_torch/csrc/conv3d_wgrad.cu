// K6 conv3d_wgrad: the weight gradient of the SAME 3D convolutions K1 and K2,
// on channels-last (NDHWC) tensors, on the tensor cores:
//
//   dW[kd, kh, kw, ci, co] = sum over b, o of A[b, o * s + t - lo, ci] * B[b, o, co]
//
// with A zero outside its grid. For K1, A is an input part and B the output
// gradient; for K2, A is K2's output gradient (the fine grid) and B K2's input
// (the coarse grid), which gives the gradient in K2's own (kd, kh, kw, Cout,
// Cin) layout. The output is row-major [taps * CA, CB], i.e. DHWIO, rounded
// once to A's type from fp32 sums.
//
// Replaces: the weight half of the backward of the TPU's conv kernel,
// benchmarks/r2_probe_pallas_mxu.py:80 conv_probe (the JAX package leaves its
// backward to XLA's transposes of the forward); ops/convolution.py in the
// port says how K1 and K2 take the data gradients.
//
// What bounds it on an H100. As a GEMM, C[M = taps * CA, N = CB] = sum over
// K = batch * output voxels of Â^T B, with a small M (4-3456), a small N
// (1-256) and a huge K (about 1.02 M rows at the cfg1 window's level 0, batch
// 2). Both operands are MN-major in memory: channels are contiguous, rows are
// the reduction. In bf16 every shape of the train step is bound by bytes
// (A and B read once); in fp32, whose tensor-core form (3xTF32, below) runs
// at a third of the TF32 rate, the deep 3x3x3 shapes are bound by
// operations and the level-0 and level-1 shapes by bytes.
//
// Why mma.sync and not wgmma: bf16 is bound by bytes at every shape, so the
// gather, not the tensor rate, decides; and wgmma's TF32 form takes only
// K-major shared operands, which these MN-major tiles are not. An in-smem
// transpose into a wgmma consumer is later work, once the per-shape times
// show where operations bind.
//
// The design (ops/convolution.py wgrad_plan picks the tile and the chunks):
//  * A block computes a BM x BN tile of C over one fixed chunk of rows, with
//    WM x WN x WK warps: WM x WN split the tile, WK split each stage's rows;
//    the WK partial tiles are summed in a fixed order through shared memory.
//    The tile family fits M and N: 16 x 8 and 16 x 16 for the level-0
//    1x1x1 shapes (M = 16), 48 x 8 and 48 x 16 (the stem's 27, three taps
//    of 16 channels), 144 x 8 and 144 x 16 (all nine taps of a 1x3x3 conv
//    of 16 channels, 3 x 2 warps: one B slab serves every tap), 64 x 32,
//    128 x 64 and, in bf16, 128 x 128. Every column of a tile reads the
//    same B rows, so a B slab is loaded once for all the taps it holds.
//  * Each stage holds BK rows of A's gathered columns (the tap's shifted,
//    strided window) and of B, in a cp.async ring of 4 stages (3 for the
//    deep tiles' 4 mma steps a stage) with one __syncthreads a stage. A is gathered in 16-byte chunks (8 bf16 or 4
//    fp32 channels of one tap of one voxel) by cp.async.ca, since
//    neighbouring taps re-read the same lines; padding taps and rows past
//    the chunk are zero-filled through the src-size operand. B's rows are
//    dense: 16-byte cp.async.cg. A channel row that is not a multiple of 16
//    bytes takes 8- or 4-byte copies (cp.async.ca: bf16's CA or CB of 4 or
//    2, fp32's 3, 2 or 1), as does a base off the 16-byte grid; bf16 with an
//    odd channel count (the stem's 3, a head's 1) takes a scalar route into
//    the same tiles (the wrapper picks each operand's width,
//    ops/convolution.py wgrad_routes). Each stage's copies are issued from
//    fully unrolled loops, back to back.
//  * Row coordinates come from a per-stage table in shared memory that BK
//    threads fill a stage ahead, each advancing its row's (batch, d, h, w)
//    cursor by BK with one carry a digit: no division in the loop. Each
//    column's tap offset and channel sit in a second table, set once.
//  * Fragments. bf16: mma.sync m16n8k16; the tiles are stored [row][m] and
//    [row][n], so both fragments come by ldmatrix .trans; rows are padded to
//    an odd number of 16-byte units, so the eight rows of each ldmatrix
//    phase fall in distinct banks. fp32: m16n8k8 on TF32 operands, each
//    lane reading its elements with lds.32 from the same rows (an odd number
//    of 8-float units: the four rows t = 0..3 a load reads start 8 banks
//    apart and the 32 lanes hit 32 banks).
//  * fp32 as 3xTF32 (split_tf32, mma.cuh, shared with K1): each operand
//    split into hi = tf32(x) and lo = tf32(x - hi); products lo*hi, hi*lo,
//    hi*hi into a chain that is added into plain fp32 registers every
//    kChainSteps k8 steps of a warp (ops/convolution.py mirrors the count
//    for the CPU replay): the tensor core's own fp32 sums lose accuracy
//    over long chains (K1's and K5's finding).
//  * Deterministic split of the rows: each chunk writes fp32 partials;
//    wgrad_reduce_kernel sums them in a fixed order (eight groups of
//    chunks j = g, g + 8, ..., each in order, then the groups in order) and
//    rounds once. No atomics: the same bits on every run. With one chunk
//    the tile kernel rounds and stores directly.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChainSteps = 16;   // fp32: k8 steps of a warp's tensor-core chain
constexpr int kReduceGroups = 8;  // chunk groups of wgrad_reduce_kernel
constexpr int kFar = -(1 << 29);  // a coordinate that fails every bounds test

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int kKS = 16;  // rows of one mma step
};
template <>
struct Elem<float> {
  static constexpr int kKS = 8;
};

// A shared row of x elements, padded to an odd number of 8-element units.
constexpr int pad_ld(int x) { return (x / 8) % 2 == 1 ? x : x + 8; }

// Blocks of a variant resident on one SM (the launch bounds' minimum):
// ops/convolution.py wgrad_tile mirrors it for the plan.
constexpr int resident_blocks(int warps, int tiles_a_warp) {
  return warps >= 6 || tiles_a_warp > 8 ? 2 : 4;
}

struct WgradParams {
  const void* a;
  const void* b;
  void* out;
  float* ws;
  int a_d, a_h, a_w, ca;  // A's grid and channels
  int o_d, o_h, o_w, cb;  // B's (the output) grid and channels
  int kd, kh, kw;
  int sd, sh, sw;
  int ld, lh, lw;  // SAME low pads
  int rows;        // batch * o_d * o_h * o_w
  int chunk_rows;
  int chunks;
  int m;        // taps * ca
  int a_bytes;  // A's copies: 16, 8 or 4 bytes by cp.async; 0 element by element
  int b_bytes;  // B's the same
};

template <int N>
struct Bytes {
  static constexpr int value = N;
};

template <typename T, int MT, int NT, int WM, int WN, int WK, int KSTEPS>
struct Tile {
  static constexpr int kKS = Elem<T>::kKS;
  static constexpr int kWarps = WM * WN * WK, kThreads = 32 * kWarps;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static constexpr int BK = WK * KSTEPS * kKS;  // rows a stage
  static constexpr int kStages = KSTEPS >= 4 ? 3 : 4;  // the ring: 4 stages, 3 of deep ones
  static constexpr int kLdA = pad_ld(BM), kLdB = pad_ld(BN);
  static constexpr int kAElems = BK * kLdA, kBElems = BK * kLdB;
  static constexpr int kRingBytes = kStages * (kAElems + kBElems) * (int)sizeof(T);
  static constexpr int kRedBytes = WK * BM * BN * 4;  // the warps' partial tiles
  static constexpr int kSmemBytes = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static constexpr int kResident = resident_blocks(kWarps, MT * NT);
};

__device__ __forceinline__ bool inside(int z, int y, int x, int d, int h, int w) {
  return (unsigned)z < (unsigned)d && (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
}

template <typename T, int MT, int NT, int WM, int WN, int WK, int KSTEPS>
__global__ void __launch_bounds__(Tile<T, MT, NT, WM, WN, WK, KSTEPS>::kThreads,
                                  Tile<T, MT, NT, WM, WN, WK, KSTEPS>::kResident)
    wgrad_mma_kernel(const WgradParams p) {
  using Tl = Tile<T, MT, NT, WM, WN, WK, KSTEPS>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kThreads = Tl::kThreads, BM = Tl::BM, BN = Tl::BN, BK = Tl::BK;
  constexpr int kKS = Tl::kKS, kLdA = Tl::kLdA, kLdB = Tl::kLdB, kStages = Tl::kStages;
  static_assert(BK <= kThreads, "one thread a row of the stage's row table");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs");
  static_assert(kChainSteps % KSTEPS == 0, "chains end on stage boundaries");

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sa = reinterpret_cast<T*>(smem);
  T* const sb = sa + kStages * Tl::kAElems;
  __shared__ int4 row_tab[kStages][BK];  // (z0, y0, x0, voxel); z0 = kFar past the chunk
  __shared__ int4 col_tab[BM];           // (dz, dy, dx, element offset); dz = kFar past M
  __shared__ int4 cursor[BK];            // (batch, d, h, w) of thread tid's next row
  __shared__ int4 stage_step;            // BK rows in the same mixed radix

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, chunk = blockIdx.z;
  const int r_begin = chunk * p.chunk_rows;  // the wrapper keeps rows + chunk_rows < 2^31
  const int r_end = min(p.rows, r_begin + p.chunk_rows);
  const int nstage = (r_end - r_begin + BK - 1) / BK;
  const T* const A = static_cast<const T*>(p.a);
  const T* const B = static_cast<const T*>(p.b);

  for (int j = tid; j < BM; j += kThreads) {
    const int m = m0 + j;
    int4 c = make_int4(kFar, 0, 0, 0);
    if (m < p.m) {
      const int t = m / p.ca, ci = m - t * p.ca;
      const int tw = t % p.kw, th = (t / p.kw) % p.kh, td = t / (p.kw * p.kh);
      c = make_int4(td, th, tw, ((td * p.a_h + th) * p.a_w + tw) * p.ca + ci);
    }
    col_tab[j] = c;
  }

  // The row cursor of thread tid < BK: row r_begin + tid + s * BK of stage s,
  // as (batch, d, h, w), advanced by BK in the same radix with one carry a
  // digit; kept in shared memory, off the registers of the loop.
  auto decode = [&](int q) {
    const int w = q % p.o_w;
    q /= p.o_w;
    const int h = q % p.o_h;
    q /= p.o_h;
    return make_int4(q / p.o_d, q % p.o_d, h, w);
  };
  if (tid < BK) cursor[tid] = decode(r_begin + tid);
  if (tid == 0) stage_step = decode(BK);
  __syncthreads();
  auto write_rows = [&](int slot, int s) {  // stage s's row of this thread, then advance
    int4 c = cursor[tid];
    const int4 d = stage_step;
    const int r = r_begin + s * BK + tid;
    int4 e = make_int4(kFar, 0, 0, 0);
    if (r < r_end) {
      const int z0 = c.y * p.sd - p.ld, y0 = c.z * p.sh - p.lh, x0 = c.w * p.sw - p.lw;
      e = make_int4(z0, y0, x0, ((c.x * p.a_d + z0) * p.a_h + y0) * p.a_w + x0);
    }
    row_tab[slot][tid] = e;
    c.w += d.w;
    int carry = c.w >= p.o_w;
    if (carry) c.w -= p.o_w;
    c.z += d.z + carry;
    carry = c.z >= p.o_h;
    if (carry) c.z -= p.o_h;
    c.y += d.y + carry;
    carry = c.y >= p.o_d;
    if (carry) c.y -= p.o_d;
    c.x += d.x + carry;
    cursor[tid] = c;
  };

  // A: BK rows x BM gathered columns into ring slot `slot` (the rows of the
  // stage whose table sits in the same slot). By cp.async, each copy of
  // kBytes holds channels of one tap of one voxel (the wrapper keeps CA's
  // row and A's base multiples of kBytes); every copy of the stage issued
  // back to back (a fully unrolled loop).
  auto gather_a = [&](int slot, auto bytes) {
    constexpr int kBytes = decltype(bytes)::value, kElems = kBytes / (int)sizeof(T);
    constexpr int kCPR = BM / kElems, kN = BK * kCPR;
    T* const ta = sa + slot * Tl::kAElems;
#pragma unroll 8
    for (int k = 0; k < (kN + kThreads - 1) / kThreads; ++k) {
      const int e = tid + k * kThreads;
      if (kN % kThreads != 0 && e >= kN) break;
      const int row = e / kCPR, q = e - row * kCPR;
      const int4 r = row_tab[slot][row];
      const int4 c = col_tab[q * kElems];
      const bool ok = inside(r.x + c.x, r.y + c.y, r.z + c.z, p.a_d, p.a_h, p.a_w);
      const T* src = ok ? A + (r.w * p.ca + c.w) : A;
      pmr::cp_async_l1<kBytes>(ta + row * kLdA + q * kElems, src, ok ? kBytes : 0);
    }
  };
  auto gather_a_scalar = [&](int slot) {  // element by element through registers
    constexpr int kN = BK * BM;
    T* const ta = sa + slot * Tl::kAElems;
#pragma unroll 8
    for (int k = 0; k < (kN + kThreads - 1) / kThreads; ++k) {
      const int e = tid + k * kThreads;
      if (kN % kThreads != 0 && e >= kN) break;
      const int row = e / BM, j = e - row * BM;
      const int4 r = row_tab[slot][row];
      const int4 c = col_tab[j];
      const bool ok = inside(r.x + c.x, r.y + c.y, r.z + c.z, p.a_d, p.a_h, p.a_w);
      ta[row * kLdA + j] = ok ? A[r.w * p.ca + c.w] : pmr::from_f32<T>(0.f);
    }
  };
  auto load_a = [&](int slot) {
    switch (p.a_bytes) {
      case 16: gather_a(slot, Bytes<16>{}); break;
      case 8: gather_a(slot, Bytes<8>{}); break;
      case 4: gather_a(slot, Bytes<4>{}); break;
      default: gather_a_scalar(slot);
    }
  };

  // B: BK rows x BN channels of stage s into ring slot `slot`; dense rows,
  // 16-byte copies bypass L1 (.cg), narrower ones go through it
  auto copy_b = [&](int slot, int s, auto bytes) {
    constexpr int kBytes = decltype(bytes)::value, kElems = kBytes / (int)sizeof(T);
    constexpr int kCPR = BN / kElems, kN = BK * kCPR;
    T* const tb = sb + slot * Tl::kBElems;
    const int r0 = r_begin + s * BK;
#pragma unroll 8
    for (int k = 0; k < (kN + kThreads - 1) / kThreads; ++k) {
      const int e = tid + k * kThreads;
      if (kN % kThreads != 0 && e >= kN) break;
      const int row = e / kCPR, q = e - row * kCPR;
      const int r = r0 + row, n = n0 + q * kElems;
      const bool ok = r < r_end && n < p.cb;
      const T* src = ok ? B + (r * p.cb + n) : B;
      T* const dst = tb + row * kLdB + q * kElems;
      if constexpr (kBytes == 16)
        pmr::cp_async16(dst, src, ok ? 16 : 0);
      else
        pmr::cp_async_l1<kBytes>(dst, src, ok ? kBytes : 0);
    }
  };
  auto copy_b_scalar = [&](int slot, int s) {
    constexpr int kN = BK * BN;
    T* const tb = sb + slot * Tl::kBElems;
    const int r0 = r_begin + s * BK;
#pragma unroll 8
    for (int k = 0; k < (kN + kThreads - 1) / kThreads; ++k) {
      const int e = tid + k * kThreads;
      if (kN % kThreads != 0 && e >= kN) break;
      const int row = e / BN, j = e - row * BN;
      const int r = r0 + row, n = n0 + j;
      tb[row * kLdB + j] = r < r_end && n < p.cb ? B[r * p.cb + n] : pmr::from_f32<T>(0.f);
    }
  };
  auto load_b = [&](int slot, int s) {
    switch (p.b_bytes) {
      case 16: copy_b(slot, s, Bytes<16>{}); break;
      case 8: copy_b(slot, s, Bytes<8>{}); break;
      case 4: copy_b(slot, s, Bytes<4>{}); break;
      default: copy_b_scalar(slot, s);
    }
  };

  // ---------------------------------------------------------- consumer
  // bf16: the mmas accumulate in acc. fp32: in chain, added into acc every
  // kChainSteps k8 steps (promote).
  const int wn = warp % WN, wm = (warp / WN) % WM, wk = warp / (WN * WM);
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
  const int mb = wm * (16 * MT), nb = wn * (8 * NT);  // the warp's tile in the block's
  // ldmatrix .trans row addresses: A's four 8x8 matrices (k 0-7, m 0-7),
  // (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15) give a0..a3; B's
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) give
  // b0, b1 of two n8 tiles.
  const int a_row = (lane & 7) + (lane >> 4) * 8, a_col = ((lane >> 3) & 1) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  const int g = lane >> 2, t4 = lane & 3;

  auto mma_stage = [&](int slot) {
    const T* const ta = sa + slot * Tl::kAElems;
    const T* const tb = sb + slot * Tl::kBElems;
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
      const int k0 = (wk * KSTEPS + st) * kKS;
      if constexpr (!kF32) {
        uint32_t bfr[NT][2];
        if constexpr (NT == 1) {
          pmr::ldmatrix_x2_trans(bfr[0], tb + (k0 + (lane & 15)) * kLdB + nb);
        } else {
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) {
            uint32_t r[4];
            pmr::ldmatrix_x4_trans(r, tb + (k0 + b_row) * kLdB + nb + jj * 16 + b_col);
            bfr[2 * jj][0] = r[0];
            bfr[2 * jj][1] = r[1];
            bfr[2 * jj + 1][0] = r[2];
            bfr[2 * jj + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          pmr::ldmatrix_x4_trans(af, ta + (k0 + a_row) * kLdA + mb + i * 16 + a_col);
#pragma unroll
          for (int j = 0; j < NT; ++j) pmr::mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
        }
      } else {
        // m16n8k8 TF32 fragments: a0 (m g, k t), a1 (m g + 8, k t), a2 (m g,
        // k t + 4), a3 (m g + 8, k t + 4); b0 (k t, n g), b1 (k t + 4, n g)
        const T* const arow = ta + (k0 + t4) * kLdA + mb + g;
        const T* const brow = tb + (k0 + t4) * kLdB + nb + g;
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          pmr::split_tf32(__float_as_uint(brow[j * 8]), bhi[j][0], blo[j][0]);
          pmr::split_tf32(__float_as_uint(brow[4 * kLdB + j * 8]), bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float x[4] = {arow[i * 16], arow[i * 16 + 8], arow[4 * kLdA + i * 16],
                              arow[4 * kLdA + i * 16 + 8]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) pmr::split_tf32(__float_as_uint(x[e]), ahi[e], alo[e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            pmr::mma_tf32(chain[i][j], alo, bhi[j][0], bhi[j][1]);
            pmr::mma_tf32(chain[i][j], ahi, blo[j][0], blo[j][1]);
            pmr::mma_tf32(chain[i][j], ahi, bhi[j][0], bhi[j][1]);
          }
        }
      }
    }
  };

  // ------------------------------------------------------------ the ring
  // Stage i's loads read the row table in slot i % kStages, written one
  // iteration (one __syncthreads) before they are issued.
  if (tid < BK)
    for (int s = 0; s < kStages; ++s) write_rows(s, s);
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstage) {
      load_a(s);
      load_b(s, s);
    }
    pmr::cp_async_commit();
  }
  for (int i = 0; i < nstage; ++i) {
    pmr::cp_async_wait<kStages - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();  // ... everyone's; stage i - 1's slot is free again
    const int slot = i % kStages;
    if (tid < BK) write_rows(slot, i + kStages);  // stage i's table was read long ago
    const int next = i + kStages - 1;
    if (next < nstage) {
      load_a(next % kStages);
      load_b(next % kStages, next);
    }
    pmr::cp_async_commit();
    mma_stage(slot);
    if constexpr (kF32) {
      if ((i + 1) % (kChainSteps / KSTEPS) == 0) promote();
    }
  }
  if constexpr (kF32) promote();

  // ------------------------------------------------------------ epilogue
  // The warps' tiles through shared memory: [wk][BM][BN] fp32, summed over
  // wk in order; then coalesced stores along n.
  pmr::cp_async_wait<0>();
  __syncthreads();
  float* const red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ml = mb + i * 16 + g + h * 8, nl = nb + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(red + (wk * BM + ml) * BN + nl) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  float* const part = p.chunks > 1 ? p.ws + (size_t)chunk * p.m * p.cb : nullptr;
  T* const out = static_cast<T*>(p.out);
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int ml = e / BN, nl = e - ml * BN;
    const int m = m0 + ml, n = n0 + nl;
    if (m >= p.m || n >= p.cb) continue;
    float v = red[e];
#pragma unroll
    for (int w = 1; w < WK; ++w) v += red[w * BM * BN + e];
    if (part != nullptr)
      part[m * p.cb + n] = v;
    else
      out[m * p.cb + n] = pmr::from_f32<T>(v);
  }
}

// out[e] = the chunks' partials of element e in a fixed order: group g of
// kReduceGroups sums chunks g, g + kReduceGroups, ... in order; the groups
// are then summed in order; rounded once. A block: 32 elements x 8 groups.
template <typename T>
__global__ void __launch_bounds__(32 * kReduceGroups)
    wgrad_reduce_kernel(const float* __restrict__ ws, int chunks, int numel,
                        T* __restrict__ out) {
  __shared__ float part[kReduceGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < numel && grp < chunks) {
    s = ws[(size_t)grp * numel + e];
    for (int j = grp + kReduceGroups; j < chunks; j += kReduceGroups)
      s += ws[(size_t)j * numel + e];
  }
  part[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && e < numel) {
    float v = part[0][lane];
    for (int q = 1; q < kReduceGroups && q < chunks; ++q) v += part[q][lane];
    out[e] = pmr::from_f32<T>(v);
  }
}

template <typename T, int MT, int NT, int WM, int WN, int WK, int KSTEPS>
int launch_tile(const WgradParams& p, cudaStream_t s) {
  using Tl = Tile<T, MT, NT, WM, WN, WK, KSTEPS>;
  auto kernel = wgrad_mma_kernel<T, MT, NT, WM, WN, WK, KSTEPS>;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((p.m + Tl::BM - 1) / Tl::BM),
                  (unsigned)((p.cb + Tl::BN - 1) / Tl::BN), (unsigned)p.chunks);
  kernel<<<grid, Tl::kThreads, Tl::kSmemBytes, s>>>(p);
  return (int)cudaGetLastError();
}

// The tile family by (BM, BN): ops/convolution.py WGRAD_VARIANTS lists the
// same (MT, NT, WM, WN, WK, KSTEPS).
template <typename T>
int launch_bm_bn(const WgradParams& p, int bm, int bn, cudaStream_t s) {
  constexpr bool kBF16 = sizeof(T) == 2;
  if (bm == 16 && bn == 8) return launch_tile<T, 1, 1, 1, 1, 4, 2>(p, s);
  if (bm == 16 && bn == 16) return launch_tile<T, 1, 2, 1, 1, 4, 2>(p, s);
  if (bm == 48 && bn == 8) return launch_tile<T, 3, 1, 1, 1, 4, 2>(p, s);
  if (bm == 48 && bn == 16) return launch_tile<T, 3, 2, 1, 1, 4, 2>(p, s);
  if (bm == 144 && bn == 8) return launch_tile<T, 3, 1, 3, 1, 2, 2>(p, s);
  if (bm == 144 && bn == 16) return launch_tile<T, 3, 2, 3, 1, 2, 2>(p, s);
  if (bm == 64 && bn == 32) return launch_tile<T, 2, 4, 2, 1, 2, 2>(p, s);
  if (bm == 128 && bn == 64) return launch_tile<T, 2, 4, 4, 2, 1, 4>(p, s);
  if constexpr (kBF16) {
    if (bm == 128 && bn == 128) return launch_tile<T, 2, 8, 4, 2, 1, 4>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const WgradParams& p, int bm, int bn, cudaStream_t s) {
  const int rc = launch_bm_bn<T>(p, bm, bn, s);
  if (rc != 0 || p.chunks == 1) return rc;
  const int numel = p.m * p.cb;
  wgrad_reduce_kernel<T><<<(unsigned)((numel + 31) / 32), 32 * kReduceGroups, 0, s>>>(
      p.ws, p.chunks, numel, static_cast<T*>(p.out));
  return (int)cudaGetLastError();
}

bool copy_width_ok(int bytes) { return bytes == 0 || bytes == 4 || bytes == 8 || bytes == 16; }

}  // namespace

// geom (int32[24]): A's D, H, W, C; B's D, H, W, C; kd, kh, kw; strides
// d, h, w; low pads d, h, w; batch; chunks; tile m (bm); tile n (bn); chunk
// rows; A's and B's copy bytes (16, 8, 4; 0: scalar) (ops/convolution.py
// wgrad_args, wgrad_routes).
// ws: chunks * taps * CA * CB fp32 (unused with one chunk); out: taps * CA * CB.
extern "C" int pmr_conv3d_wgrad(const void* a, const void* b, void* out, void* ws,
                                const void* geom, int dtype, void* stream) {
  const int* g = static_cast<const int*>(geom);
  WgradParams p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.a_d = g[0]; p.a_h = g[1]; p.a_w = g[2]; p.ca = g[3];
  p.o_d = g[4]; p.o_h = g[5]; p.o_w = g[6]; p.cb = g[7];
  p.kd = g[8]; p.kh = g[9]; p.kw = g[10];
  p.sd = g[11]; p.sh = g[12]; p.sw = g[13];
  p.ld = g[14]; p.lh = g[15]; p.lw = g[16];
  const long long batch = g[17];
  p.chunks = g[18];
  const int bm = g[19], bn = g[20];
  p.chunk_rows = g[21];
  p.a_bytes = g[22];
  p.b_bytes = g[23];
  const long long rows = batch * p.o_d * p.o_h * p.o_w;
  p.m = p.kd * p.kh * p.kw * p.ca;
  if (batch < 1 || p.ca < 1 || p.cb < 1 || p.m < 1 || p.chunks < 1 || p.chunks > 65535 ||
      p.chunk_rows < 1 || rows + p.chunk_rows >= (1LL << 31) ||
      (long long)p.chunks * p.chunk_rows < rows ||
      (long long)(p.chunks - 1) * p.chunk_rows >= rows || (p.chunks > 1 && p.ws == nullptr) ||
      !copy_width_ok(p.a_bytes) || !copy_width_ok(p.b_bytes))
    return (int)cudaErrorInvalidValue;
  p.rows = (int)rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pmr::kBFloat16) return run<bf16>(p, bm, bn, s);
  if (dtype == pmr::kFloat32) return run<float>(p, bm, bn, s);
  return (int)cudaErrorInvalidValue;
}
