// K1 conv3d and K2 conv3d_transpose on Hopper's tensor cores, bf16 and
// fp32: implicit-GEMM 3D convolution on channels-last (NDHWC) tensors, fp32
// accumulation, the output rounded once to its type. bf16 runs wgmma
// m64nNk16 on its operands; fp32 runs three TF32 wgmma m64nNk8 products a
// step (3xTF32, below).
//
// Replaces: benchmarks/r2_probe_pallas_mxu.py:80 conv_probe (its body `kern`
// at :96), the streaming (1,3,3) SAME conv + bias that built a 9-tap im2col in
// VMEM and ran one deep-K matmul on the MXU; generalized to every conv of
// the M1 path: kernels (1,3,3), (3,3,3), (1,1,1); strides (1,1,1), (1,2,2),
// (2,2,2); up to six channel parts summed into one output; and the
// TF-convention transposed conv (K2) in gather form, one output phase a
// unit. ops/convolution.py wgmma_plan computes the schedule.
//
// What bounds it on an H100: bytes at levels 0-1 (4-64 channels over
// 20x160x160 and 20x80x80), operations in the deep 3x3x3 stitches; fp32
// moves twice the bytes and does three TF32 products for each one (495
// TFLOP/s TF32: 1/6 of the bf16 rate for the same convolution). The
// mma.sync kernels this replaces (one a dtype, retired in turn) reached
// neither: they re-gathered every input voxel once per tap from L2
// (9x at (1,3,3), 27x at 3x3x3) through 16-byte cp.async with a (tap,
// channel) cursor a chunk, and element by element at widths that are not a
// multiple of the chunk. The design:
//
//  * A halo tile in shared memory, read once a block. A block owns 128
//    output rows of one sample: a box (td, th, tw) of output voxels chosen
//    per shape by the plan, or 128 consecutive rows where the conv is 1x1x1
//    at stride 1 (flat: no halo). For each part and channel slab (a voxel
//    16-128 bytes: 8-64 bf16 or 4-32 fp32 channels), the producer brings the
//    input box that the tile's taps touch into shared memory once; every
//    tap's A rows are then read from that box. Zero padding (XLA's
//    asymmetric SAME), the box's overhang and channels past a part's width
//    arrive as zeros.
//  * Two routes into the box: TMA (a 5D tiled map over NDHWC, its box
//    origin possibly negative, its out-of-bounds fill the padding) where a
//    part's voxel stride is a multiple of 16 bytes and its base aligned
//    (bf16 channels a multiple of 8, fp32 of 4: level 0's 4 fp32 channels);
//    else staged through the producer's registers, each element once a
//    block (the stem's 3 channels, bf16's 4, the ladder's 65/130/259).
//  * bf16 weights: each stage (64 of a slab's taps x channels) goes into a
//    4-stage ring by TMA where cout (K1) or cin (K2, at 64-wide slabs) is a
//    multiple of 8 (one box a stage: K1's consecutive DHWIO taps, K2's one
//    tap), by 16-byte cp.async for K2's narrower slabs, else element by
//    element; K1's slab lands MN-major (trans-b), K2's K-major, both with
//    the 128-byte swizzle.
//  * fp32 weights: TF32 wgmma reads B only K-major and takes no transposed
//    operand, and each value must be split (below) before the tensor core
//    sees it. Each stage (32 of a slab's k) arrives raw by TMA where the
//    weights' last axis is a multiple of 4 (K1: boxes of consecutive DHWIO
//    taps x channels x 32 couts, as bf16's; K2: a box a tap, channels x BN
//    couts), else element by element by 4-byte cp.async, into a ring of raw
//    stages (3-8, as the plan fits them); a full mbarrier a stage says it
//    has landed, an empty one that every producer thread has read it. Each producer thread then reads 4 x 4 blocks of it, transposes
//    K1's, splits each value into hi and lo and writes both K-major tiles
//    with the 128-byte swizzle. The producer converts the stages in order as
//    they land (polled between its other work, and while it waits for a
//    free box stage, which the consumers may free only once they have those
//    stages), and waits for the oldest only when the raw ring is full.
//  * wgmma consumers with A from registers. Two consumer warpgroups take 64
//    rows each and issue wgmma.mma_async m64nNk16 (bf16, N = the plan's
//    tile width 8-128; WgmmaRS in wgmma.cuh) or m64nNk8 (TF32, N 8-64;
//    WgmmaTF32): A's fragments come by ldmatrix from the box at each tap's
//    shifted rows, the addresses per lane with the box's swizzle applied (an
//    ldmatrix row of 16 bytes is 8 bf16 or 4 fp32 values; the 8x8 b16
//    matrix hands lane (g, t) 32-bit word (g, t): TF32's fragment order);
//    B, the stage's weights, by descriptor. The next step's ldmatrix
//    overlaps the wgmma in flight (two A register buffers, one wgmma group
//    left in flight). wgmma's 64 rows are output voxels, of which there are
//    always plenty; narrow couts take N = 8. At bf16's 8-channel slab a
//    16-deep step spans two taps, as an 8-deep step does at fp32's 4 (lanes
//    16-31 read the second tap's rows).
//  * The epilogue: fp32 rows go from the accumulator fragments straight to
//    memory, a column pair a thread (a quad of lanes writes 32 contiguous
//    bytes of a row); bf16 rows are staged in shared memory and written in
//    16-byte chunks.
//  * Two outputs (K1 only): where the call hands a second output y2, the
//    weights' columns [0, split) go to y (rows of split) and [split, cout)
//    to y2 (rows of cout - split): two convs of one input, kernel size and
//    stride (an SE block's first and projection convs) in one pass over the
//    input boxes. split is a multiple of 8, so no bf16 chunk of 8 columns
//    and no fp32 column pair crosses it. The two-output epilogue is a
//    variant of its own (kPair), so a one-output call runs the code it ran
//    before. No split-K with two outputs.
//  * fp32 by 3xTF32. The tensor cores take fp32 only as TF32 (10 mantissa
//    bits, ~1e-3 relative; raw fp32 bits are truncated, not rounded), which
//    alone cannot hold the port's fp32 limits (kernel vs twin 2e-4, card vs
//    CPU softmax 1e-3). Each value x is split as hi = tf32(x), lo =
//    tf32(x - hi), both rounded as cvt.rna rounds (mma.cuh split_tf32): A in
//    the consumers' registers after its ldmatrix, B by the producer; a step
//    is lo*hi, hi*lo, then hi*hi, three wgmmas into one fp32 chain (lo*lo,
//    ~2^-22 relative, is dropped). The tensor core's fp32 sums lose accuracy
//    over long chains (K5's finding; the mma.sync kernel measured 2.8e-6
//    from fp64 at K = 6,912 with chains of 128 k, 8e-5 with none), so every
//    kChainStages weight stages (256 k) the chain is added into plain fp32
//    registers (ops/convolution.py mirrors the count for the CPU replay).
//    fp32 tiles stop at N 64 and one block runs an SM: a thread holds the
//    chain beside the sums, and hi and lo of two stages' A fragments.
//  * A producer warpgroup over mbarrier rings (2-4 box stages as the plan
//    fits them, up to 8 beside fp32's resident weights; 4 weight stages),
//    full and empty barriers, no
//    __syncthreads in the main loop; setmaxnreg moves registers from the
//    producer to the consumers.
//  * Persistent blocks: at most one wave, each walking work units (tile,
//    channel tile, phase, split), so a block's setup is paid once and the
//    producer fills the rings for the next unit during an epilogue.
//  * Parts walked in order into one accumulator (up to six), K2's phases
//    (up to eight), the fp32 bias added once and one rounding to the output
//    type, deterministic split-K where the output tiles underfill the card
//    (split j of a phase's weight stages writes fp32 partials that
//    wgmma_splitk_reduce_kernel sums in split order: the same inputs give
//    the same bits), int32 indices under the wrapper's 2^31 check.

#include <stdint.h>

#include <cuda.h>

#include "common.cuh"
#include "conv_params.cuh"
#include "halo.cuh"
#include "stamps.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pmr::kMaxParts;
using pmr::kMaxPhases;
using pmr::kMaxTaps;
using pmr::ldmatrix_x4_at;
using pmr::load8_any;
using pmr::swizzle;
using pmr::wait_bar;

constexpr int kRows = 128;       // output rows a block (ops/convolution.py WG_ROWS)
constexpr int kConsumers = 2;    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxAStages = 8, kBStages = 4;  // box stages: the plan's a_stages, 2-8
constexpr int kGroup = 2;  // staged chunks a producer thread keeps in flight
constexpr int kChainStages = 8;  // fp32: weight stages a TF32 chain runs (WG_CHAIN_STAGES)

// Per element type: a 16-byte chunk's elements, one wgmma's K (32 bytes of
// a row: k16 bf16, k8 TF32), a weight stage's K (four steps, 128 bytes of
// a K-major row) and the producer's registers after setmaxnreg (fp32's
// converts the weight stages).
template <typename T>
struct Elem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kStep = 32 / (int)sizeof(T);
  static constexpr int kKStage = 128 / (int)sizeof(T);
  static constexpr int kProducerRegs = kF32 ? 120 : 56;
};

// The launch's parameters (ops/convolution.py _wgmma_host lists the meta
// fields they come from), with the TMA maps of the parts that take TMA.
struct WgParams {
  CUtensorMap maps[kMaxParts];
  // bf16 weights by TMA: K1's as (cout, cin, taps) in boxes of 64 x wbox x
  // wtaps; K2's, where every slab is 64 wide, as (cin, cout, taps) in boxes
  // of 64 x BN x 1 (a stage's one tap, K-major)
  CUtensorMap wmap;
  const void* x[kMaxParts];
  const void* w;
  const float* bias;  // null without bias
  void* y;
  float* ws;  // split-K partials (fp32), splits x output elements
  int nparts, cin[kMaxParts], width[kMaxParts], tma_bits, b_vec, cin_total, ntaps, wbox,
      wtaps;
  int batch, in_d, in_h, in_w, out_d, out_h, out_w, g_d, g_h, g_w, cout;
  int in_mul[3], in_add[3], out_mul[3], lo[3], tile[3], box[3], tiles_ax[3];
  int nphase, ntap[kMaxPhases], res[kMaxPhases][3];
  int splits, transposed, bn, a_stage, a_stages, b_stage, smem;
  int phase_loop;  // 1: a unit walks every phase of its tile over its boxes, loaded once
  int nres;  // fp32: > 0, every unit's weight stages (nres) resident, converted once a block
  int raw_stages;  // fp32: raw weight stages in flight (3-8)
  signed char tap[kMaxPhases][kMaxTaps][4];  // dz, dy, dx, weight tap
  void* y2;   // a pair's second output, columns [split, cout) (kPair); else null
  int split;  // a pair's columns of y
};

// Blocks resident on one SM by element type and tile width, and the
// consumers' registers after setmaxnreg: the producer gives back down to
// its kProducerRegs, so that 128 x producer + 256 x consumer <= 384 x the
// launch's registers (65536 / (384 x blocks), to a multiple of 8: 168 or
// 80). fp32 runs one block an SM at every width (its chain and split A
// fragments need the registers).
template <typename T>
__host__ __device__ constexpr int resident_blocks(int bn) {
  return Elem<T>::kF32 ? 1 : bn <= 32 ? 2 : 1;
}
template <typename T>
__host__ __device__ constexpr int launch_regs(int bn) {
  return (65536 / (kThreads * resident_blocks<T>(bn))) & ~7;
}
template <typename T>
__host__ __device__ constexpr int consumer_regs(int bn) {
  return ((kThreads * launch_regs<T>(bn) - 128 * Elem<T>::kProducerRegs) /
          (128 * kConsumers)) & ~7;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// One poll of an mbarrier's phase: true once the phase of `parity` is done.
__device__ __forceinline__ bool try_bar(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(pmr::smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// The walk of one block's K: parts in order, each part's slabs, each slab's
// weight stages; fn(q, c0, w, ci_base, j0, j1) for every slab that has
// stages [j0, j1) inside this split's range [s0, s1) of the phase's stages.
template <typename T, typename Fn>
__device__ __forceinline__ void walk_slabs(const WgParams& p, int ntap, int s0, int s1,
                                           Fn&& fn) {
  constexpr int kVec = Elem<T>::kVec, kKStage = Elem<T>::kKStage;
  int g = 0, ci_base = 0;
  for (int q = 0; q < p.nparts && g < s1; ++q) {
    const int cin = p.cin[q], wq = p.width[q];
    const bool tma = (p.tma_bits >> q) & 1;
    for (int c0 = 0; c0 < cin && g < s1; c0 += wq) {
      const int w = tma ? wq : min(wq, max(kVec, pow2_at_least(cin - c0)));
      const int ns = (ntap * w + kKStage - 1) / kKStage;
      if (g + ns > s0) fn(q, c0, w, ci_base, max(0, s0 - g), min(ns, s1 - g));
      g += ns;
    }
    ci_base += cin;
  }
}

// One work unit of a block: an output tile (sample b, first grid voxel
// g0), a tile of BN output channels, a phase (or, with phase_loop, every
// phase in turn) and a split of its stages.
struct Unit {
  int b, gz0, gy0, gx0, oz, oy, ox, n0, phase, split;
};

__device__ __forceinline__ Unit unit_of(const WgParams& p, int u, int m_tiles, int n_tiles) {
  Unit t;
  int mt = u % m_tiles;
  const int rest = u / m_tiles;
  t.n0 = (rest % n_tiles) * p.bn;
  const int z = rest / n_tiles;
  t.phase = p.phase_loop ? 0 : z / p.splits;
  t.split = p.phase_loop ? z : z % p.splits;
  const int tx = mt % p.tiles_ax[2];
  mt /= p.tiles_ax[2];
  const int ty = mt % p.tiles_ax[1];
  mt /= p.tiles_ax[1];
  const int tz = mt % p.tiles_ax[0];
  t.b = mt / p.tiles_ax[0];
  t.gz0 = tz * p.tile[0];
  t.gy0 = ty * p.tile[1];
  t.gx0 = tx * p.tile[2];
  // the input box starts here, in the input's coordinates
  t.oz = t.gz0 * p.in_mul[0] + p.in_add[0] + p.lo[0];
  t.oy = t.gy0 * p.in_mul[1] + p.in_add[1] + p.lo[1];
  t.ox = t.gx0 * p.in_mul[2] + p.in_add[2] + p.lo[2];
  return t;
}

// This unit's range [s0, s1) of its phase's weight stages.
template <typename T>
__device__ __forceinline__ void split_range(const WgParams& p, const Unit& t, int* s0,
                                            int* s1) {
  *s0 = 0;
  *s1 = 1 << 30;  // one split: every stage
  if (p.splits == 1) return;
  int nstage = 0;
  walk_slabs<T>(p, p.ntap[t.phase], 0, 1 << 30,
                [&](int, int, int, int, int j0, int j1) { nstage += j1 - j0; });
  *s0 = nstage * t.split / p.splits;  // under 2^31: a few thousand stages, 64 splits
  *s1 = nstage * (t.split + 1) / p.splits;
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// 4 bytes (one fp32) by cp.async; bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   pmr::smem_addr(bar))
               : "memory");
}

template <typename T, int BN, bool kNK, bool kPair>
__global__ void __launch_bounds__(kThreads, resident_blocks<T>(BN))
    conv3d_wgmma_kernel(const __grid_constant__ WgParams p, int m_tiles, int units) {
  using E = Elem<T>;
  constexpr bool kF32 = E::kF32;
  constexpr int kVec = E::kVec, kStep = E::kStep, kKStage = E::kKStage;
  constexpr int kEsize = (int)sizeof(T);
  static_assert(!kF32 || BN <= 64, "fp32 tiles stop at N 64");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t smem_base = pmr::smem_addr(smem);
  // [A ring][B ring, or fp32's resident table of every weight stage][fp32: raw
  // weight stages][epilogue rows][barriers, tap tables]
  const int b_off = p.a_stages * p.a_stage;
  const int raw_off = b_off + (p.nres ? p.nres : kBStages) * p.b_stage;
  const int nraw = p.raw_stages;  // fp32: raw weight stages in flight
  const int epi_off = raw_off + (kF32 ? nraw * BN * 128 : 0);
  constexpr int kPitch = BN + 4;  // floats a staged output row (bf16; fp32 stages none)
  uint8_t* const ctrl = smem + epi_off + (kF32 ? 0 : kRows * kPitch * 4);
  uint64_t* const full_a = reinterpret_cast<uint64_t*>(ctrl);
  uint64_t* const empty_a = full_a + kMaxAStages;
  uint64_t* const full_b = empty_a + kMaxAStages;
  uint64_t* const empty_b = full_b + kBStages;
  uint64_t* const raw_full = empty_b + kBStages;  // fp32: a raw weight stage has landed
  uint64_t* const raw_empty = raw_full + 8;        // ... and has been read
  int* const tapvox = reinterpret_cast<int*>(raw_empty + 8);  // kMaxPhases x 32
  const int n_tiles = (p.cout + BN - 1) / BN;

  const int tid = threadIdx.x;
  PMR_STAMP_DECL(tid == 0 || tid == 128 * kConsumers);
  if (tid == 0) {
    for (int s = 0; s < p.a_stages; ++s) {
      pmr::mbar_init(&full_a[s], 128);
      pmr::mbar_init(&empty_a[s], 128 * kConsumers);
    }
    for (int s = 0; s < kBStages; ++s) {
      pmr::mbar_init(&full_b[s], 128);
      pmr::mbar_init(&empty_b[s], 128 * kConsumers);
    }
    for (int s = 0; s < (kF32 ? nraw : 0); ++s) {
      pmr::mbar_init(&raw_full[s], 128);
      pmr::mbar_init(&raw_empty[s], 128);
    }
    pmr::mbar_fence_init();
  }
  // the box voxel of each phase's tap offsets; the padding tap reads voxel 0
  for (int i = tid; i < p.nphase * 32; i += kThreads) {
    const int ph = i / 32, t = i % 32;
    tapvox[i] = t >= p.ntap[ph] ? 0
                                : ((p.tap[ph][t][0] - p.lo[0]) * p.box[1] +
                                   (p.tap[ph][t][1] - p.lo[1])) * p.box[2] +
                                      (p.tap[ph][t][2] - p.lo[2]);
  }
  __syncthreads();
  PMR_STAMP(kStampSetup);
  const int box_vox = p.box[0] * p.box[1] * p.box[2];

  if (tid >= 128 * kConsumers) {
    // ------------------------------------------------------------ producer
    pmr::setmaxnreg_dec<E::kProducerRegs>();
    const int pt = tid - 128 * kConsumers;
    if (pt == 0) {  // the TMA maps' descriptors into the cache ahead of their first use
      for (int q = 0; q < p.nparts; ++q)
        if ((p.tma_bits >> q) & 1) pmr::prefetch_tensormap(&p.maps[q]);
      if (p.b_vec && (kF32 || !kNK || p.wbox == kKStage)) pmr::prefetch_tensormap(&p.wmap);
    }
    int ai = 0, aph = 0, bi = 0, bph = 0;
    // fp32: raw weight stages issued and converted. A raw stage holds the
    // stage's 32 k x BN n as TMA lands them, swizzled by its box's row
    // bytes: K1's (DHWIO) as rows of k, BN n (32-n groups of 128-byte rows
    // at N 64); K2's ((taps, Cout, Cin)) as wbox-channel boxes, each BN rows
    // of n. A thread converts 4 x 4 blocks (n 4 nb.., k 4 kb..), 2 BN of them:
    // K2's kb 0-7 of one nb, K1's kb 0-3 of two nb (eight consecutive threads
    // write eight distinct 16-byte bank groups of the K-major tiles).
    int rq = 0, rc = 0;
    auto block_of = [&](int it, int* nb, int* kb) {
      if (kNK) {
        *kb = it & 7;
        *nb = it >> 3;
      } else {
        *kb = (it & 3) | (((it >> 3) & 1) << 2);
        *nb = ((it >> 4) << 1) | ((it >> 2) & 1);
      }
    };
    constexpr int kRowB = (BN < 32 ? BN : 32) * 4;  // K1: bytes a raw row of a group
    // the byte offset in a raw stage of (k, n) before its box's swizzle
    // (where TMA lands a box) and after it (where a 16-byte chunk is: 4 n of
    // K1's row, 4 k of K2's)
    const int lwbox = __ffs(p.wbox) - 1;
    auto raw_lin = [&](int k, int n) -> uint32_t {
      if (kNK) {
        const int b = k >> lwbox;
        return (uint32_t)((((b * BN + n) << lwbox) + k - (b << lwbox)) * 4);
      }
      const int g = n / (kRowB / 4);
      return (uint32_t)(g * 32 * kRowB + k * kRowB + (n - g * (kRowB / 4)) * 4);
    };
    auto raw_at = [&](int k, int n) -> uint32_t {
      return swizzle(raw_lin(k, n), (uint32_t)((kNK ? p.wbox * 4 : kRowB) / 16 - 1));
    };
    // the oldest raw stage into ring stage bi: hi and lo K-major tiles
    auto convert = [&]() {
      wait_bar(&raw_full[rc % nraw], (rc / nraw) & 1);
      if (!p.nres) wait_bar(&empty_b[bi], bph ^ 1);
      PMR_STAMP(kStampProducerWait);
      const uint8_t* const raw = smem + raw_off + (rc % nraw) * BN * 128;
      uint8_t* const hi = smem + b_off + (p.nres ? rc : bi) * p.b_stage;
      uint8_t* const lo = hi + BN * 128;
      for (int it = pt; it < 2 * BN; it += 128) {
        int nb, kb;
        block_of(it, &nb, &kb);
        float4 v[4];  // v[i]: row n = 4 nb + i, k 4 kb..4 kb + 3
        if (kNK) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = *reinterpret_cast<const float4*>(raw + raw_at(4 * kb, 4 * nb + i));
        } else {
          float4 r[4];  // r[i]: k = 4 kb + i, n 4 nb..4 nb + 3
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = *reinterpret_cast<const float4*>(raw + raw_at(4 * kb + i, 4 * nb));
          v[0] = make_float4(r[0].x, r[1].x, r[2].x, r[3].x);
          v[1] = make_float4(r[0].y, r[1].y, r[2].y, r[3].y);
          v[2] = make_float4(r[0].z, r[1].z, r[2].z, r[3].z);
          v[3] = make_float4(r[0].w, r[1].w, r[2].w, r[3].w);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint4 h, l;
          pmr::split_tf32(__float_as_uint(v[i].x), h.x, l.x);
          pmr::split_tf32(__float_as_uint(v[i].y), h.y, l.y);
          pmr::split_tf32(__float_as_uint(v[i].z), h.z, l.z);
          pmr::split_tf32(__float_as_uint(v[i].w), h.w, l.w);
          const int n = 4 * nb + i;
          const uint32_t byte = n * 128 + ((kb ^ (n & 7)) << 4);
          *reinterpret_cast<uint4*>(hi + byte) = h;
          *reinterpret_cast<uint4*>(lo + byte) = l;
        }
      }
      pmr::mbar_arrive(&raw_empty[rc % nraw]);  // this thread's reads of the raw stage are done
      if (!p.nres) {
        pmr::fence_proxy_async();  // the wgmmas read this stage through the async proxy
        pmr::mbar_arrive(&full_b[bi]);
        if (++bi == kBStages) {
          bi = 0;
          bph ^= 1;
        }
      }
      ++rc;
      PMR_STAMP(kStampProducerLoad);
    };
    // the oldest raw stage, where it has landed
    auto ready = [&]() { return rq > rc && try_bar(&raw_full[rc % nraw], (rc / nraw) & 1); };
    // a free box stage: fp32 converts raw stages as they land meanwhile
    // (the consumers may need them before they free it)
    auto wait_empty_a = [&]() {
      if constexpr (kF32) {
        while (rq > rc && !try_bar(&empty_a[ai], aph ^ 1))
          if (ready()) convert();
      }
      wait_bar(&empty_a[ai], aph ^ 1);
    };
    // fp32: weight stage j of the slab (part q, channels [c0, c0 + w)) of
    // unit t's phase and channel tile into the raw ring: by TMA where the
    // weights' last axis is a multiple of 4 (K1's boxes of wtaps consecutive
    // DHWIO taps x wbox channels x 32 n, as bf16's; K2's of one tap x wbox
    // channels x BN n), else element by element by cp.async. Padding taps,
    // and channels past the part, arrive as zeros (or meet zeros in A).
    auto issue_raw = [&](const Unit& t, int q, int c0, int w, int ci_base, int j) {
      const int ntap = p.ntap[t.phase], cin = p.cin[q], lw = __ffs(w) - 1;
      const int slot = rq % nraw, free_parity = ((rq / nraw) & 1) ^ 1;
      const uint32_t dst0 = smem_base + raw_off + slot * BN * 128;
      if (p.b_vec) {
        if (pt == 0) {
          wait_bar(&raw_empty[slot], free_parity);  // every thread has read its last use
          pmr::mbar_arrive_expect_tx(&raw_full[slot], kKStage * BN * 4);
          const int step = kNK ? p.wbox : p.wbox * p.wtaps;
          for (int rr = 0; rr < kKStage; rr += step) {
            const int k = j * kKStage + rr, tp = k >> lw, ch = c0 + (k & (w - 1));
            const int wt = tp < ntap && ch < cin ? p.tap[t.phase][tp][3] : p.ntaps;
            if (kNK) {
              pmr::tma_load_3d(dst0 + raw_lin(rr, 0), &p.wmap, &raw_full[slot], ci_base + ch, t.n0,
                               wt);
            } else {
#pragma unroll
              for (int g = 0; g < (BN + 31) / 32; ++g)
                pmr::tma_load_3d(dst0 + raw_lin(rr, g * 32), &p.wmap, &raw_full[slot],
                                 t.n0 + g * 32, ci_base + ch, wt);
            }
          }
        } else {
          pmr::mbar_arrive(&raw_full[slot]);
        }
      } else {
        const float* const wf = static_cast<const float*>(p.w);
        wait_bar(&raw_empty[slot], free_parity);
        for (int it = pt; it < kKStage * BN; it += 128) {
          const int kk = it / BN, n = it % BN;  // n fastest: K1's rows, K2's boxes
          const int k = j * kKStage + kk, tp = k >> lw, ch = c0 + (k & (w - 1)), co = t.n0 + n;
          const bool ok = tp < ntap && ch < cin && co < p.cout;
          const float* src =
              !ok ? wf
              : kNK ? wf + ((size_t)p.tap[t.phase][tp][3] * p.cout + co) * p.cin_total + ci_base + ch
                    : wf + ((size_t)p.tap[t.phase][tp][3] * p.cin_total + ci_base + ch) * p.cout + co;
          const uint32_t at = kNK ? raw_at(kk & ~3, n) + (kk & 3) * 4 : raw_at(kk, n & ~3) + (n & 3) * 4;
          cp_async4_zfill(dst0 + at, src, ok ? 4 : 0);
        }
        cp_async_arrive(&raw_full[slot]);  // once this thread's copies land
      }
      ++rq;
      if (rq - rc == nraw) convert();  // the raw ring is full: its oldest stage
    };
    if constexpr (kF32) {
      if (p.nres) {  // the call's every weight stage, once, into table slot rc
        Unit t = unit_of(p, 0, m_tiles, n_tiles);
        for (t.phase = 0; t.phase < p.nphase; ++t.phase)
          walk_slabs<T>(p, p.ntap[t.phase], 0, 1 << 30,
                        [&](int q, int c0, int w, int ci_base, int j0, int j1) {
                          for (int j = j0; j < j1; ++j) issue_raw(t, q, c0, w, ci_base, j);
                        });
        while (rc < rq) convert();
        pmr::fence_proxy_async();
        pmr::mbar_arrive(&full_b[0]);
      }
    }
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      Unit t = unit_of(p, u, m_tiles, n_tiles);
      const int ph0 = t.phase, ph1 = p.phase_loop ? p.nphase : t.phase + 1;
      for (t.phase = ph0; t.phase < ph1; ++t.phase) {
        const int ntap = p.ntap[t.phase];
        int s0, s1, slab = 0;
        split_range<T>(p, t, &s0, &s1);
        walk_slabs<T>(p, ntap, s0, s1, [&](int q, int c0, int w, int ci_base, int j0, int j1) {
          const int cin = p.cin[q];
          const uint32_t smask = (uint32_t)(w / kVec - 1);
          // the input box of (part q, channels [c0, c0 + w)); a phase loop
          // loads its unit's boxes in the first phase, slab i into stage i
          if (p.phase_loop) ai = slab++;
          if (t.phase == ph0) {
            wait_empty_a();
            PMR_STAMP(kStampProducerWait);
            uint8_t* const abox = smem + ai * p.a_stage;
            if ((p.tma_bits >> q) & 1) {
              if (pt == 0) {
                pmr::mbar_arrive_expect_tx(&full_a[ai], (uint32_t)(box_vox * w * kEsize));
                pmr::tma_load_5d(smem_base + ai * p.a_stage, &p.maps[q], &full_a[ai], c0, t.ox,
                                 t.oy, t.oz, t.b);
              } else {
                pmr::mbar_arrive(&full_a[ai]);
              }
            } else {  // each element once: 16-byte chunks of a voxel's channels
              const T* const xq = static_cast<const T*>(p.x[q]);
              const T* const xend =
                  xq + (size_t)p.batch * p.in_d * p.in_h * p.in_w * cin;  // the part's end
              const int nc = w / kVec, lc = __ffs(nc) - 1, total = box_vox * nc;
              for (int base = pt; base < total; base += 128 * kGroup) {
                uint4 val[kGroup];
#pragma unroll
                for (int k = 0; k < kGroup; ++k) {
                  const int it = base + k * 128, v = it >> lc, ch = c0 + (it & (nc - 1)) * kVec;
                  const int x = v % p.box[2], yz = v / p.box[2];
                  const int gz = t.oz + yz / p.box[1], gy = t.oy + yz % p.box[1], gx = t.ox + x;
                  val[k] = make_uint4(0, 0, 0, 0);
                  if (it < total && (unsigned)gz < (unsigned)p.in_d &&
                      (unsigned)gy < (unsigned)p.in_h && (unsigned)gx < (unsigned)p.in_w &&
                      ch < cin)
                    val[k] = pmr::load_chunk(
                        xq + (size_t)(((t.b * p.in_d + gz) * p.in_h + gy) * p.in_w + gx) * cin + ch,
                        cin - ch, xend);
                }
#pragma unroll
                for (int k = 0; k < kGroup; ++k) {
                  const int it = base + k * 128, v = it >> lc, c = it & (nc - 1);
                  const uint32_t byte = swizzle((uint32_t)(v * w * kEsize + c * 16), smask);
                  if (it < total) *reinterpret_cast<uint4*>(abox + byte) = val[k];
                }
              }
              pmr::mbar_arrive(&full_a[ai]);
            }
            if (!p.phase_loop && ++ai == p.a_stages) {
              ai = 0;
              aph ^= 1;
            }
            PMR_STAMP(kStampProducerLoad);
          }
          // its weight stages: kKStage of the slab's (tap, channel) k, tap-major
          const int lw = __ffs(w) - 1;
          for (int j = j0; j < j1; ++j) {
            if constexpr (kF32) {
              if (!p.nres) issue_raw(t, q, c0, w, ci_base, j);  // resident: loaded once
              continue;
            }
            wait_bar(&empty_b[bi], bph ^ 1);
            PMR_STAMP(kStampProducerWait);
            const uint32_t bst = smem_base + b_off + bi * p.b_stage;
            if (!kNK && p.b_vec) {  // K1 by TMA: boxes of wtaps taps x wbox k rows x 64 n
              if (pt == 0) {
                // wbox (the call's narrowest slab, 8-64) divides every slab's
                // width, so a box's rows are whole runs of one tap's channels;
                // where every slab is wbox wide, one box holds the stage's
                // 64 / wbox taps (a forward conv's taps are consecutive in
                // DHWIO), else a box is one tap's (wtaps 1)
                constexpr int kGroups = (BN + 63) / 64;
                pmr::mbar_arrive_expect_tx(&full_b[bi], kKStage * kGroups * 128);
                for (int rr = 0; rr < kKStage; rr += p.wbox * p.wtaps) {
                  const int k = j * kKStage + rr, tp = k >> lw, ch = c0 + (k & (w - 1));
                  // a padding tap, or channels past the part: rows of zeros
                  const int wt = tp < ntap && ch < cin ? p.tap[t.phase][tp][3] : p.ntaps;
#pragma unroll
                  for (int g = 0; g < kGroups; ++g)
                    pmr::tma_load_3d(bst + g * 8192 + rr * 128, &p.wmap, &full_b[bi],
                                     t.n0 + g * 64, ci_base + ch, wt);
                }
              } else {
                pmr::mbar_arrive(&full_b[bi]);
              }
            } else if (kNK && p.b_vec && p.wbox == kKStage) {  // K2 by TMA: one tap a stage
              if (pt == 0) {
                const int tp = (j * kKStage) >> lw;
                pmr::mbar_arrive_expect_tx(&full_b[bi], BN * 128);
                pmr::tma_load_3d(bst, &p.wmap, &full_b[bi], ci_base + c0, t.n0,
                                 p.tap[t.phase][tp][3]);
              } else {
                pmr::mbar_arrive(&full_b[bi]);
              }
            } else if (p.b_vec) {  // K2: 16-byte cp.async chunks, zero-filled outside
              const bf16* const wb = static_cast<const bf16*>(p.w);
              for (int it = pt; it < kKStage * (BN / 8); it += 128) {
                // row n of 64 k (128 bytes), chunk kc of 8 k
                const int n = it >> 3, kc = it & 7;
                const int k = j * kKStage + kc * 8, tp = k >> lw, ch = c0 + (k & (w - 1));
                const int co = t.n0 + n;
                const bool ok = tp < ntap && co < p.cout && ch < cin;
                const bf16* src = ok ? wb + ((size_t)p.tap[t.phase][tp][3] * p.cout + co) *
                                                 p.cin_total +
                                           ci_base + ch
                                     : wb;
                cp_async16_zfill(bst + n * 128 + ((kc ^ (n & 7)) << 4), src, ok ? 16 : 0);
              }
              cp_async_arrive(&full_b[bi]);  // the consumers fence the async proxy
            } else {  // chunks of 8 along the weights' last axis, staged
              const bf16* const wb = static_cast<const bf16*>(p.w);
              const bf16* const wend = wb + (size_t)p.ntaps * p.cin_total * p.cout;
              for (int base = pt; base < kKStage * (BN / 8); base += 128 * kGroup) {
                uint4 val[kGroup];
                uint32_t byte[kGroup];
#pragma unroll
                for (int k = 0; k < kGroup; ++k) {
                  const int it = base + k * 128;
                  val[k] = make_uint4(0, 0, 0, 0);
                  if constexpr (kNK) {  // K2: row n, chunk kc of 8 k (one tap's channels)
                    const int n = it >> 3, kc = it & 7;
                    const int kq = j * kKStage + kc * 8, tp = kq >> lw, ch = c0 + (kq & (w - 1));
                    const int co = t.n0 + n;
                    if (it < kKStage * (BN / 8) && tp < ntap && co < p.cout && ch < cin)
                      val[k] = load8_any(wb + ((size_t)p.tap[t.phase][tp][3] * p.cout + co) *
                                                  p.cin_total +
                                             ci_base + ch,
                                         cin - ch, wend);
                    byte[k] = n * 128 + ((kc ^ (n & 7)) << 4);
                  } else {  // K1: row r (k), chunk cc of 8 n
                    const int r = it / (BN / 8), cc = it % (BN / 8);
                    const int kq = j * kKStage + r, tp = kq >> lw, ch = c0 + (kq & (w - 1));
                    const int co = t.n0 + cc * 8;
                    if (it < kKStage * (BN / 8) && tp < ntap && ch < cin && co < p.cout)
                      val[k] = load8_any(wb + ((size_t)p.tap[t.phase][tp][3] * p.cin_total +
                                               ci_base + ch) * p.cout +
                                             co,
                                         p.cout - co, wend);
                    byte[k] = (cc >> 3) * 8192 + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
                  }
                }
#pragma unroll
                for (int k = 0; k < kGroup; ++k)
                  if (base + k * 128 < kKStage * (BN / 8))
                    *reinterpret_cast<uint4*>(smem + b_off + bi * p.b_stage + byte[k]) = val[k];
              }
              pmr::fence_proxy_async();  // the wgmmas read this stage through the async proxy
              pmr::mbar_arrive(&full_b[bi]);
            }
            if (++bi == kBStages) {
              bi = 0;
              bph ^= 1;
            }
            PMR_STAMP(kStampProducerLoad);
          }
        });
      }
      if (p.phase_loop) aph ^= 1;  // the unit's boxes are the ring's round
    }
    if constexpr (kF32) {
      while (rc < rq) convert();
    }
    PMR_STAMP_WRITE();
  } else {
    // ----------------------------------------------------------- consumers
    pmr::setmaxnreg_inc<consumer_regs<T>(BN)>();
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this lane's ldmatrix row (of its warp's 16) and k half (16 bytes on)
    const int m = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int khalf = (lane >> 4) * kVec;
    constexpr int kLv = kVec == 8 ? 3 : 2;  // log2 kVec
    // tile extents are powers of two: a row's (z, y, x) by shifts
    const int sx = __ffs(p.tile[2]) - 1, sy = __ffs(p.tile[1]) - 1;
    const int lx = m & (p.tile[2] - 1), ly = (m >> sx) & (p.tile[1] - 1), lz = m >> (sx + sy);
    const int rowvox =
        (lz * p.in_mul[0] * p.box[1] + ly * p.in_mul[1]) * p.box[2] + lx * p.in_mul[2];
    float* const st = reinterpret_cast<float*>(smem + epi_off);
    const int out_numel = p.batch * p.out_d * p.out_h * p.out_w * p.cout;
    const bool vec8_y = (p.cout & 7) == 0;
    const int ec = tid % (BN / 8);  // the epilogue's column chunk of this thread, every row
    float acc[BN / 2];
    float chain[kF32 ? BN / 2 : 1];  // fp32: the wgmmas' sums, added into acc (promote)
    // a stage's steps' A fragments, two stages in turn; fp32 as hi (a*) and
    // lo (l*), split after the ldmatrix
    uint32_t a0[4][4], a1[4][4];
    uint32_t l0[kF32 ? 4 : 1][4], l1[kF32 ? 4 : 1][4];
    auto promote = [&]() {
      if constexpr (kF32) {
        pmr::fence_registers(chain);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          acc[i] += chain[i];
          chain[i] = 0.f;
        }
      }
    };
    int par = 0;
    int ai = 0, aph = 0, bi = 0, bph = 0;
    if (p.nres) wait_bar(&full_b[0], 0);  // fp32's resident weight stages, once
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      Unit t = unit_of(p, u, m_tiles, n_tiles);
      const int ph0 = t.phase, ph1 = p.phase_loop ? p.nphase : t.phase + 1;
      for (t.phase = ph0; t.phase < ph1; ++t.phase) {
        const int ntap = p.ntap[t.phase];
        const int* const tv = tapvox + t.phase * 32;
        int s0, s1, slab = 0, nst = 0;
        split_range<T>(p, t, &s0, &s1);
        int g = 0;  // resident: the table slot of this phase's next stage (no split)
        for (int ph = 0; ph < t.phase && p.nres; ++ph)
          walk_slabs<T>(p, p.ntap[ph], 0, 1 << 30,
                        [&](int, int, int, int, int j0, int j1) { g += j1 - j0; });
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        if constexpr (kF32) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) chain[i] = 0.f;
        }
        int pend = -1;  // the weight stage whose wgmmas may still be in flight
        walk_slabs<T>(p, ntap, s0, s1, [&](int, int, int w, int, int j0, int j1) {
          const uint32_t smask = (uint32_t)(w / kVec - 1), pitch = (uint32_t)(w * kEsize);
          const int lw = __ffs(w) - 1, ktot = ntap * w;
          if (p.phase_loop) ai = slab++;  // slab i's box is stage i in every phase
          if (t.phase == ph0) wait_bar(&full_a[ai], aph);
          PMR_STAMP(kStampWait);
          const uint32_t abox = smem_base + ai * p.a_stage;
          for (int j = j0; j < j1; ++j) {
            const int ksteps = min(4, (ktot - j * kKStage + kStep - 1) / kStep);
            // A for every step of the stage, into the buffer not in flight
            auto load_a = [&](uint32_t(&a)[4][4]) {
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                if (s < ksteps) {
                  const int k = j * kKStage + s * kStep + khalf;
                  const uint32_t byte = (uint32_t)(rowvox + tv[k >> lw]) * pitch +
                                        (uint32_t)((k & (w - 1)) >> kLv) * 16;
                  ldmatrix_x4_at(a[s], abox + swizzle(byte, smask));
                }
              }
            };
            if (par)
              load_a(a1);
            else
              load_a(a0);
            if (!p.nres) {
              wait_bar(&full_b[bi], bph);
              pmr::fence_proxy_async();  // the producer's writes, before the wgmmas read them
            }
            PMR_STAMP(kStampWait);
            const uint32_t bst = smem_base + b_off + (p.nres ? g++ : bi) * p.b_stage;
            // fp32's hi and lo tiles and K2's stage are K-major; bf16 K1's
            // MN-major (trans-b)
            const uint64_t desc = kF32 || kNK ? pmr::wgmma_desc_b128_at(bst, 16, 1024)
                                              : pmr::wgmma_desc_b128_at(bst, 8192, 1024);
            auto issue = [&](uint32_t(&a)[4][4], uint32_t(&l)[kF32 ? 4 : 1][4]) {
              if constexpr (kF32) {  // x = hi + lo, each rounded to TF32
#pragma unroll
                for (int s = 0; s < 4; ++s)
                  if (s < ksteps) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      const uint32_t x = a[s][e];
                      pmr::split_tf32(x, a[s][e], l[s][e]);
                    }
                  }
              }
              pmr::wgmma_fence();
#pragma unroll
              for (int s = 0; s < 4; ++s)
                if (s < ksteps) {
                  if constexpr (kF32) {
                    const uint64_t dh = desc + 2 * s,
                                   dl = pmr::wgmma_desc_b128_at(bst + BN * 128, 16, 1024) + 2 * s;
                    pmr::WgmmaTF32<BN>::mma(chain, l[s], dh);  // lo . hi
                    pmr::WgmmaTF32<BN>::mma(chain, a[s], dl);  // hi . lo
                    pmr::WgmmaTF32<BN>::mma(chain, a[s], dh);  // hi . hi
                  } else {
                    pmr::WgmmaRS<BN, kNK ? 0 : 1>::mma(acc, a[s],
                                                        desc + (kNK ? 2 * s : 128 * s));
                  }
                }
              pmr::wgmma_commit();
            };
            if (par)
              issue(a1, l1);
            else
              issue(a0, l0);
            par ^= 1;
            PMR_STAMP(kStampIssue);
            pmr::wgmma_wait<1>();  // the stage before is done: its A buffer and B stage are free
            PMR_STAMP(kStampMma);
            if (!p.nres) {
              if (pend >= 0) pmr::mbar_arrive(&empty_b[pend]);
              pend = bi;
              if (++bi == kBStages) {
                bi = 0;
                bph ^= 1;
              }
            }
            if (kF32 && ++nst == kChainStages) {  // the chain into the fp32 sums
              nst = 0;
              pmr::wgmma_wait<0>();
              promote();
            }
          }
          if (t.phase == ph1 - 1) {
            pmr::mbar_arrive(&empty_a[ai]);  // every ldmatrix of this box has returned
            if (!p.phase_loop && ++ai == p.a_stages) {
              ai = 0;
              aph ^= 1;
            }
          }
        });
        pmr::wgmma_wait<0>();
        pmr::fence_registers(acc);
        promote();
        if (pend >= 0) pmr::mbar_arrive(&empty_b[pend]);

        // -------------------------------------------------------- epilogue
        // The 128 x BN fp32 sums: d[i] at row 16 warp + lane / 4 + 8
        // ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2. fp32 rows
        // go straight from the fragments, a float2 a column pair (the four
        // lanes of a quad write 32 contiguous bytes of a row); bf16 stages
        // them in the epilogue rows, then writes whole chunks of 8 outputs
        // a thread. The output type with the bias, or fp32 partials of a
        // split. The producer meanwhile fills the rings for the next unit.
        if constexpr (kF32) {
          float* const base =
              p.splits > 1 ? p.ws + (size_t)t.split * out_numel : static_cast<float*>(p.y);
          int ofs[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // this thread's rows: lane / 4, 8 on
            const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
            const int gx = t.gx0 + (r & (p.tile[2] - 1)),
                      gy = t.gy0 + ((r >> sx) & (p.tile[1] - 1)), gz = t.gz0 + (r >> (sx + sy));
            ofs[h] = -1;  // the row's first element (a pair's: its voxel)
            if (gz < p.g_d && gy < p.g_h && gx < p.g_w)
              ofs[h] = (((t.b * p.out_d + gz * p.out_mul[0] + p.res[t.phase][0]) * p.out_h +
                         gy * p.out_mul[1] + p.res[t.phase][1]) * p.out_w +
                        gx * p.out_mul[2] + p.res[t.phase][2]) * (kPair ? 1 : p.cout);
          }
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = t.n0 + 8 * j + 2 * (lane & 3);
            if (co >= p.cout) continue;
            const bool two = co + 1 < p.cout;
            // a pair's column pair: y's [0, split) or y2's [split, cout), in
            // rows of their own width
            float* out = base;
            int ld = 1, col = co;  // one output: ofs holds the row's first element
            if constexpr (kPair) {
              const bool first = co < p.split;
              out = first ? base : static_cast<float*>(p.y2);
              ld = first ? p.split : p.cout - p.split;
              col = first ? co : co - p.split;
            }
            float b0 = 0.f, b1 = 0.f;
            if (p.splits == 1 && p.bias != nullptr) {
              b0 = p.bias[co];
              if (two) b1 = p.bias[co + 1];
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (ofs[h] < 0) continue;
              const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
              float* const dst = out + ofs[h] * ld + col;
              if (two && !((kPair ? ld : p.cout) & 1)) {
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                dst[0] = v0;
                if (two) dst[1] = v1;
              }
            }
          }
        } else {
          consumers_sync();  // the previous unit's rows have been read
#pragma unroll
          for (int i = 0; i < BN / 2; i += 2) {
            const int row = wg * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
            *reinterpret_cast<float2*>(st + row * kPitch + (i >> 2) * 8 + 2 * (lane & 3)) =
                make_float2(acc[i], acc[i + 1]);
          }
          consumers_sync();
          const int co = t.n0 + ec * 8, n = min(8, p.cout - co);
          // this thread's 8 columns; a pair's: y's [0, split) or y2's [split,
          // cout), in rows of their own width
          bf16* out = static_cast<bf16*>(p.y);
          int ld = p.cout, col = co;
          bool vec8 = vec8_y;
          if constexpr (kPair) {
            const bool first = co < p.split;
            out = static_cast<bf16*>(first ? p.y : p.y2);
            ld = first ? p.split : p.cout - p.split;
            col = first ? co : co - p.split;
            vec8 = (ld & 7) == 0;
          }
          float bias8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            bias8[e] = p.splits == 1 && p.bias != nullptr && e < n ? p.bias[co + e] : 0.f;
          for (int r = tid / (BN / 8); r < kRows && co < p.cout;
               r += 128 * kConsumers / (BN / 8)) {
            const int gx = t.gx0 + (r & (p.tile[2] - 1)),
                      gy = t.gy0 + ((r >> sx) & (p.tile[1] - 1)), gz = t.gz0 + (r >> (sx + sy));
            if (gz >= p.g_d || gy >= p.g_h || gx >= p.g_w) continue;
            const int od = gz * p.out_mul[0] + p.res[t.phase][0];
            const int oh = gy * p.out_mul[1] + p.res[t.phase][1];
            const int ow = gx * p.out_mul[2] + p.res[t.phase][2];
            const int ofs = (((t.b * p.out_d + od) * p.out_h + oh) * p.out_w + ow) * ld + col;
            const float* src = st + r * kPitch + ec * 8;
            if (p.splits > 1) {  // fp32 partials
              float* const dst = p.ws + (size_t)t.split * out_numel + ofs;
              if (vec8) {
                reinterpret_cast<float4*>(dst)[0] = *reinterpret_cast<const float4*>(src);
                reinterpret_cast<float4*>(dst)[1] = *reinterpret_cast<const float4*>(src + 4);
              } else {
                for (int e = 0; e < n; ++e) dst[e] = src[e];
              }
              continue;
            }
            union {
              uint4 v;
              unsigned short h[8];
            } o;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              o.h[e] = __bfloat16_as_ushort(__float2bfloat16(src[e] + bias8[e]));
            bf16* const y = out + ofs;
            if (vec8) {
              *reinterpret_cast<uint4*>(y) = o.v;
            } else {
              for (int e = 0; e < n; ++e) y[e] = __ushort_as_bfloat16(o.h[e]);
            }
          }
        }
        PMR_STAMP(kStampEpilogue);
      }
      if (p.phase_loop) aph ^= 1;
    }
    PMR_STAMP_WRITE();
  }
}

// y = T(sum_{j < splits} ws[j] + bias), the splits summed in order.
template <typename T>
__global__ void __launch_bounds__(256)
    wgmma_splitk_reduce_kernel(const float* __restrict__ ws, int splits, long long numel,
                               int cout, const float* __restrict__ bias, T* __restrict__ y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < numel;
       e += stride) {
    float s = ws[e];
    for (int j = 1; j < splits; ++j) s += ws[(size_t)j * numel + e];
    if (bias != nullptr) s += bias[e % cout];
    y[e] = pmr::from_f32<T>(s);
  }
}

// Unpacks the wrapper's host arrays (ptrs: the parts, kernel, bias, output,
// workspace, second output; meta: ops/convolution.py _wgmma_host; taps) and
// encodes the TMA maps of the parts (and, bf16, the weights) that take TMA. *esize:
// the element size of meta[89]'s dtype (bf16 2, fp32 4).
int unpack(const uint64_t* ptrs, const int* m, const signed char* taps, WgParams* p,
           int* esize) {
  p->nparts = m[0];
  if (p->nparts < 1 || p->nparts > kMaxParts) return (int)cudaErrorInvalidValue;
  const int es = m[89] == pmr::kBFloat16 ? 2 : m[89] == pmr::kFloat32 ? 4 : 0;
  if (es == 0) return (int)cudaErrorInvalidValue;
  *esize = es;
  const int kstage = 128 / es;
  for (int i = 0; i < kMaxParts; ++i) {
    p->x[i] = reinterpret_cast<const void*>(ptrs[i]);
    p->cin[i] = m[1 + i];
    p->width[i] = m[7 + i];
  }
  p->w = reinterpret_cast<const void*>(ptrs[kMaxParts]);
  p->bias = m[84] ? reinterpret_cast<const float*>(ptrs[kMaxParts + 1]) : nullptr;
  p->y = reinterpret_cast<void*>(ptrs[kMaxParts + 2]);
  p->ws = reinterpret_cast<float*>(ptrs[kMaxParts + 3]);
  p->y2 = m[98] ? reinterpret_cast<void*>(ptrs[kMaxParts + 4]) : nullptr;
  p->split = m[98] ? m[98] : m[26];
  p->tma_bits = m[13];
  p->b_vec = m[14];
  p->cin_total = m[15];
  p->ntaps = m[91];
  p->wbox = m[93];
  p->wtaps = m[94];
  p->batch = m[16];
  p->in_d = m[17], p->in_h = m[18], p->in_w = m[19];
  p->out_d = m[20], p->out_h = m[21], p->out_w = m[22];
  p->g_d = m[23], p->g_h = m[24], p->g_w = m[25];
  p->cout = m[26];
  for (int a = 0; a < 3; ++a) {
    p->in_mul[a] = m[27 + a];
    p->in_add[a] = m[30 + a];
    p->out_mul[a] = m[33 + a];
    p->lo[a] = m[36 + a];
    p->tile[a] = m[39 + a];
    p->box[a] = m[42 + a];
    p->tiles_ax[a] = m[45 + a];
  }
  p->nphase = m[48];
  if (p->nphase < 1 || p->nphase > kMaxPhases) return (int)cudaErrorInvalidValue;
  for (int ph = 0; ph < kMaxPhases; ++ph) {
    p->ntap[ph] = m[49 + ph];
    if (p->ntap[ph] < 0 || p->ntap[ph] > kMaxTaps) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a) p->res[ph][a] = m[57 + 3 * ph + a];
    for (int t = 0; t < kMaxTaps; ++t)
      for (int c = 0; c < 4; ++c) p->tap[ph][t][c] = taps[(ph * kMaxTaps + t) * 4 + c];
  }
  p->splits = m[81];
  p->transposed = m[82];
  p->bn = m[83];
  p->a_stage = m[85];
  p->a_stages = m[92];
  p->phase_loop = m[95];
  p->b_stage = m[86];
  p->smem = m[87];
  p->nres = m[96];
  p->raw_stages = m[97];
  auto row_bytes_ok = [](int bytes) {  // 16-128 bytes: a box row, a weight box row
    return bytes == 16 || bytes == 32 || bytes == 64 || bytes == 128;
  };
  if (p->splits < 1 || p->splits > 64 || (p->splits > 1 && p->ws == nullptr) ||
      p->smem > 232448 || p->a_stages < 2 || p->a_stages > kMaxAStages ||
      !row_bytes_ok(p->wbox * es) || (p->wtaps != 1 && p->wtaps * p->wbox != kstage) ||
      p->tile[0] * p->tile[1] * p->tile[2] != kRows || p->nres < 0 ||
      (es == 4 && (p->raw_stages < 1 || p->raw_stages > 8)) ||
      (p->nres > 0 && (es != 4 || p->splits != 1)) ||
      (m[98] && (p->y2 == nullptr || p->transposed || p->splits != 1 || p->split % 8 ||
                 p->split <= 0 || p->split >= p->cout)))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < p->nparts; ++q) {
    const int w = p->width[q];
    if (!row_bytes_ok(w * es)) return (int)cudaErrorInvalidValue;
    if (!((p->tma_bits >> q) & 1)) continue;
    const uint64_t c = (uint64_t)p->cin[q];
    const uint64_t dims[5] = {c, (uint64_t)p->in_w, (uint64_t)p->in_h, (uint64_t)p->in_d,
                              (uint64_t)p->batch};
    const uint64_t strides[4] = {c * es, c * es * p->in_w, c * es * p->in_w * p->in_h,
                                 c * es * p->in_w * p->in_h * p->in_d};
    const uint32_t box[5] = {(uint32_t)w, (uint32_t)p->box[2], (uint32_t)p->box[1],
                             (uint32_t)p->box[0], 1};
    const int rc = pmr::encode_tensor_map_nd(&p->maps[q], p->x[q], 5, dims, strides, box, es);
    if (rc != 0) return rc;
  }
  const uint64_t co = (uint64_t)p->cout, ci = (uint64_t)p->cin_total;
  if (es == 4) {  // fp32 weights into raw stages: K1 (cout, cin, taps), K2 (cin, cout, taps)
    if (!p->b_vec) return 0;
    const uint64_t dims1[3] = {co, ci, (uint64_t)p->ntaps}, dims2[3] = {ci, co, (uint64_t)p->ntaps};
    const uint64_t strides1[2] = {co * 4, co * 4 * ci}, strides2[2] = {ci * 4, ci * 4 * co};
    const uint32_t box1[3] = {(uint32_t)(p->bn < 32 ? p->bn : 32), (uint32_t)p->wbox,
                              (uint32_t)p->wtaps};
    const uint32_t box2[3] = {(uint32_t)p->wbox, (uint32_t)p->bn, 1};
    return p->transposed ? pmr::encode_tensor_map_nd(&p->wmap, p->w, 3, dims2, strides2, box2, 4)
                         : pmr::encode_tensor_map_nd(&p->wmap, p->w, 3, dims1, strides1, box1, 4);
  }
  if (!p->transposed && p->b_vec) {  // K1's DHWIO weights: (cout, cin, taps)
    const uint64_t dims[3] = {co, ci, (uint64_t)p->ntaps};
    const uint64_t strides[2] = {co * 2, co * 2 * ci};
    const uint32_t box[3] = {64, (uint32_t)p->wbox, (uint32_t)p->wtaps};
    const int rc = pmr::encode_tensor_map_nd(&p->wmap, p->w, 3, dims, strides, box, 2);
    if (rc != 0) return rc;
  } else if (p->b_vec && p->wbox == kstage) {  // K2's (taps, cout, cin) weights
    const uint64_t dims[3] = {ci, co, (uint64_t)p->ntaps};
    const uint64_t strides[2] = {ci * 2, ci * 2 * co};
    const uint32_t box[3] = {64, (uint32_t)p->bn, 1};
    const int rc = pmr::encode_tensor_map_nd(&p->wmap, p->w, 3, dims, strides, box, 2);
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename T, int BN, bool kNK, bool kPair>
int launch_tile(const WgParams& p, int m_tiles, int blocks, cudaStream_t stream) {
  auto kernel = conv3d_wgmma_kernel<T, BN, kNK, kPair>;
  static bool configured = false;  // per kernel, set once
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg's budget holds only if the launch has the registers it
    // was planned for: refuse rather than let the consumers wait forever
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * kThreads <
        128 * Elem<T>::kProducerRegs + 128 * kConsumers * consumer_regs<T>(BN))
      return (int)cudaErrorInvalidConfiguration;
    configured = true;
  }
  const int units =
      m_tiles * ((p.cout + BN - 1) / BN) * (p.phase_loop ? 1 : p.nphase) * p.splits;
  kernel<<<(unsigned)(blocks < units ? blocks : units), kThreads, p.smem, stream>>>(p, m_tiles,
                                                                                      units);
  return (int)cudaGetLastError();
}

// The tile widths: bf16 8-128, fp32 8-64.
template <typename T, bool kNK, bool kPair>
int launch_bn(const WgParams& p, int m_tiles, int blocks, cudaStream_t s) {
  switch (p.bn) {
    case 8: return launch_tile<T, 8, kNK, kPair>(p, m_tiles, blocks, s);
    case 16: return launch_tile<T, 16, kNK, kPair>(p, m_tiles, blocks, s);
    case 32: return launch_tile<T, 32, kNK, kPair>(p, m_tiles, blocks, s);
    case 64: return launch_tile<T, 64, kNK, kPair>(p, m_tiles, blocks, s);
    case 128:
      if constexpr (!Elem<T>::kF32)
        return launch_tile<T, 128, kNK, kPair>(p, m_tiles, blocks, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const WgParams& p, const int* m, cudaStream_t s) {
  // K2; K1; K1 with two outputs
  int rc = p.transposed ? launch_bn<T, true, false>(p, m[88], m[90], s)
           : p.y2 ? launch_bn<T, false, true>(p, m[88], m[90], s)
                  : launch_bn<T, false, false>(p, m[88], m[90], s);
  if (rc != 0 || p.splits == 1) return rc;
  const long long numel = (long long)p.batch * p.out_d * p.out_h * p.out_w * p.cout;
  const long long blocks = (numel + 255) / 256;
  wgmma_splitk_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      p.ws, p.splits, numel, p.cout, p.bias, static_cast<T*>(p.y));
  return (int)cudaGetLastError();
}

}  // namespace

// K1 (meta[82] 0) or K2 (1) in bf16 or fp32 (meta[89]): the main kernel
// and, with split-K, the reduce, both on `stream`.
extern "C" int pmr_conv3d_wgmma(const void* ptrs, const void* meta, const void* taps,
                                void* stream) {
  static_assert(sizeof(WgParams) <= 4096 - 64, "kernel parameters stay under 4 KB");
  WgParams p;
  int esize = 0;
  const int* m = static_cast<const int*>(meta);
  const int rc = unpack(static_cast<const uint64_t*>(ptrs), m,
                        static_cast<const signed char*>(taps), &p, &esize);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return esize == 4 ? run<float>(p, m, s) : run<bf16>(p, m, s);
}

// The stamps build's buffer for this source's kernels (stamps.cuh).
extern "C" int pmr_conv3d_wgmma_stamps(void* buf) { return pmr_stamp_install(buf); }
