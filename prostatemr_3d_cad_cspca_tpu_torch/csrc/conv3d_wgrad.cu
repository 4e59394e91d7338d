// K6 conv3d_wgrad: the weight gradient of the SAME 3D convolutions K1 and K2,
// on channels-last (NDHWC) tensors, on Hopper's tensor cores:
//
//   dW[kd, kh, kw, ca, cb] = sum over n, o of A[n, o * s + t - lo, ca] * B[n, o, cb]
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
// K = batch * output voxels of Â^T B, with a small M (4-6912), a small N
// (1-256) and a huge K (about 1.02 M rows at the cfg1 window's level 0, batch
// 2). Both operands are MN-major in memory: channels are contiguous, rows are
// the reduction. In bf16 every shape of the train step is bound by bytes (A
// and B read once); in fp32 (six bf16 products a term, below) the deep
// 3x3x3 shapes are bound by operations, level 0 and 1 by bytes. The
// mma.sync kernel this replaces re-gathered A from L2 once a tap (nine
// times at (1,3,3), 27 at 3x3x3) in 16-byte cp.async copies addressed from
// row and column tables, and ran Ampere's m16n8k16 / m16n8k8. The design:
//
//  * A box of output voxels is one K chunk. A block owns a tile of C: a
//    group of taps x a slab of A's channels (its rows, in 64-row warpgroup
//    tiles) by a tile of BN of B's channels, and walks a fixed range of the
//    boxes (its split of K). For each box the producer brings in, once,
//    B's box [voxel][cb] and A's halo box ((td - 1) sd + kd) x ((th - 1) sh
//    + kh) x ((tw - 1) sw + kw) voxels of the slab, which every tap's rows
//    are read from (K2's gradient reads A at strides (1,2,2) and (2,2,2),
//    so the halo follows the stride). A 1x1x1 gradient at stride 1 is flat:
//    boxes of 128 consecutive rows.
//  * Two routes into the boxes: TMA (5D tiled maps over NDHWC; a negative
//    origin and the out-of-bounds fill give XLA's asymmetric SAME padding
//    and the box's overhang as zeros) where a tensor's voxel stride is a
//    multiple of 16 bytes and its base aligned; else staged through the
//    producer's registers in 16-byte chunks, each element once a box,
//    into the same swizzled layout (the stem's 3 channels, bf16's 4 and
//    12, the heads' 1 and 2, a base off the 16-byte grid). A slab is at
//    least 8 channels (a 16-byte bf16 ldmatrix row); narrower tensors'
//    boxes carry zeros past their channels, whose rows the epilogue drops.
//  * The consumers turn each box into the tensor cores' operands: B into
//    a K-major tile (wgmma takes the shared operand K-major, and a box's B
//    is MN-major, [voxel][cb]): bf16 by ldmatrix .trans and stmatrix of
//    8 x 8 blocks into 128-byte-swizzled [cb][64 voxels] tiles. fp32 runs
//    on bf16 tensor cores in three parts, x = x1 + x2 + x3 (mma.cuh
//    split_bf16x3, two values a packed conversion): B's tile holds the
//    parts' rows one after another, and A's slab becomes three bf16 part
//    boxes, once a box (each is read by every tap). Two B tiles: box q + 1's
//    is written while box q's wgmmas run.
//  * fp32 operands in parts: where several blocks would convert the same
//    box (A's by the blocks of every tap group and channel tile of B, B's by
//    those of every tap group and slab of A), wgrad_split_kernel splits the
//    operand once a call into three bf16 planes in the workspace (channels
//    rounded up to 8: a TMA row, so the stem's staged A takes it too), and
//    the producer brings each box in as three bf16 boxes by TMA: the
//    consumers then only transpose B, as bf16 does. Converting in the
//    blocks cost the deep 3x3x3 shapes about half their cycles; at level 0,
//    where one block reads each box, the split's own pass over A and B
//    costs more than it saves.
//  * wgmma consumers with A from registers: two warpgroups, each MT tiles of
//    64 rows. wgmma m64nNk16 (WgmmaRS), A's fragment by ldmatrix .trans
//    from the (part) box, each lane addressing its own voxel row shifted by
//    its 8-row group's tap (a group is 8 channels of one tap), B by
//    descriptor. fp32: three wgmmas a step and tile, a1 . [b1 | b2 | b3], a2
//    . [b1 | b2] and a3 . b1 (N 3 BN, 2 BN and BN over prefixes of the part
//    rows), the six products whose sum is a . b to about 2^-24 of it, into a
//    chain of three column blocks that is added into plain fp32 sums once a
//    box (128 k; ops/convolution.py's CPU replay mirrors it): the tensor
//    core's own fp32 sums lose accuracy over long chains (K1's and K5's
//    finding), and K reaches 1.02 M rows here. Why not 3xTF32, as K1's fp32:
//    TF32's k8 and three products a step take 6 instructions a 16 voxels
//    against 3 here, and 8 lds.32 and splits a fragment against 3 ldmatrix.
//    A warpgroup issues its wgmmas on every tile it holds (MT, a template
//    parameter the launch sets to what the block's rows need; a dead tile
//    reads tap 0 and the epilogue drops its rows): a wgmma under a branch on
//    a count unknown at compile time is serialized by ptxas (C7520), each
//    then costing its full latency.
//  * Two schedules of the warpgroups: split, the two sharing each box's
//    rows; or ping-pong, for a flat gradient (whose rows fit one
//    warpgroup): each takes alternate boxes and every row, so one's
//    conversion and wgmma drain overlap the other's wgmmas. It takes an
//    even count of stages, so that every box of a stage is one
//    warpgroup's: with an odd count a warpgroup could wait on a stage's
//    phase two ahead of the last it saw, which an mbarrier's parity cannot
//    tell from the one before.
//  * A producer warpgroup over a ring of 2-8 stages (as the plan fits them)
//    with a full and an empty mbarrier each, a box a warp in turn (four
//    boxes' staged loads in flight); setmaxnreg moves registers from the
//    producer to the consumers.
//  * Deterministic split of K: split j of a block's tile walks boxes
//    [nbox j / splits, nbox (j + 1) / splits) and writes fp32 partials (two
//    with ping-pong, one a warpgroup); wgrad_reduce_kernel sums them in
//    fp64 in a fixed order (eight groups of partials j = g, g + 8, ...,
//    each in order, then the groups in order) and rounds: at level 0 (1.02
//    M rows, 132 partials of ~60 boxes each) fp32 sums of the partials
//    lose more of the small results of a long K's cancelling sums. No
//    atomics: the same bits on every run. With one partial the block
//    rounds and stores directly.

#include <stdint.h>

#include <algorithm>

#include <cuda.h>

#include "common.cuh"
#include "halo.cuh"
#include "stamps.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pmr::swizzle;
using pmr::wait_bar;

constexpr int kBox = 128;         // output voxels a box: one stage's K (WGRAD_BOX)
constexpr int kConsumers = 2;     // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxStages = 8;     // the ring: the plan's stages, 2-8 (WGRAD_STAGES)
constexpr int kMaxTaps = 27;
constexpr int kReduceGroups = 8;  // split groups of wgrad_reduce_kernel
constexpr int kGeom = 45;         // int32 fields of the geometry array (WGRAD_GEOM)
constexpr int kProducerRegs = 96;
constexpr int kGroup = 4;         // staged chunks a producer lane keeps in flight

// Per element type: a 16-byte chunk's elements and the bf16 parts the
// tensor cores take an element in (fp32: three, x = x1 + x2 + x3).
template <typename T>
struct Elem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kParts = kF32 ? 3 : 1;
};

// 64-row tiles a consumer warpgroup holds by element type and tile width
// (ops/convolution.py WGRAD_MT): a thread keeps MT x BN / 2 sums (fp32: and
// a chain of 3 BN / 2 beside them) and two buffers of a commit group's A
// fragments (fp32: of each part).
template <typename T>
__host__ __device__ constexpr int tiles_per_wg(int bn) {
  return Elem<T>::kF32 ? (bn <= 16 ? 2 : 1) : (bn <= 64 ? 2 : 1);
}

// One block an SM: 65536 registers over 384 threads (168 each), of which
// the producer gives back down to kProducerRegs and the consumers take the
// rest (200).
constexpr int kLaunchRegs = (65536 / kThreads) & ~7;
constexpr int kConsumerRegs =
    ((kThreads * kLaunchRegs - 128 * kProducerRegs) / (128 * kConsumers)) & ~7;

struct WgradParams {
  CUtensorMap amap;  // TMA route: A as (CA, W, H, D, batch), boxes (width, box w, h, d, 1)
  CUtensorMap bmap;  // B as (CB, W, H, D, batch), boxes (B group, tile w, h, d, 1)
  const void* a;
  const void* b;
  void* out;
  float* ws;
  int batch, a_d, a_h, a_w, ca, o_d, o_h, o_w, cb;  // the view (flat: batch 1, D = H = 1)
  int kd, kh, kw, ntaps, m;
  int st[3], lo[3], tile[3], box[3], tiles_ax[3];
  int width;       // A's slab: channels of a box row (8-64 bf16, 8-32 fp32)
  int tpb;         // taps a block
  int tap_groups;  // ceil(ntaps / tpb)
  int slabs;       // ceil(ca / width)
  int bn, n_tiles, splits, nbox;
  int a_tma, b_tma;
  int a_stage, b_stage, stages, smem;
  int pingpong;  // 1: the warpgroups take alternate boxes, each every row
  int a_parts;   // fp32: A split into bf16 parts before the kernel, TMA'd as three boxes
  int b_parts;   // fp32: B the same
};

// The walk of a block: blockIdx.x as (tap group, slab, channel tile, split),
// the tap group fastest, so that the blocks that run together read the
// same boxes.
struct Unit {
  int t0, ntb, ca0, n0, split, bx0, bx1;
};

__device__ __forceinline__ Unit unit_of(const WgradParams& p) {
  Unit t;
  int u = blockIdx.x;
  const int tg = u % p.tap_groups;
  u /= p.tap_groups;
  const int slab = u % p.slabs;
  u /= p.slabs;
  t.n0 = (u % p.n_tiles) * p.bn;
  t.split = u / p.n_tiles;
  t.t0 = tg * p.tpb;
  t.ntb = min(p.tpb, p.ntaps - t.t0);
  t.ca0 = slab * p.width;
  t.bx0 = (int)((long long)p.nbox * t.split / p.splits);
  t.bx1 = (int)((long long)p.nbox * (t.split + 1) / p.splits);
  return t;
}

// A box: its sample and the first output voxel of its tile.
struct Box {
  int b, oz, oy, ox;
};

__device__ __forceinline__ Box box_of(const WgradParams& p, int q) {
  Box x;
  const int tx = q % p.tiles_ax[2];
  q /= p.tiles_ax[2];
  const int ty = q % p.tiles_ax[1];
  q /= p.tiles_ax[1];
  x.oz = (q % p.tiles_ax[0]) * p.tile[0];
  x.b = q / p.tiles_ax[0];
  x.oy = ty * p.tile[1];
  x.ox = tx * p.tile[2];
  return x;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ int log2i(int n) { return __ffs(n) - 1; }

template <typename T, int BN, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_wgmma_kernel(const __grid_constant__ WgradParams p) {
  using E = Elem<T>;
  constexpr bool kF32 = E::kF32;
  constexpr int kEs = (int)sizeof(T), kVec = E::kVec, kParts = E::kParts;
  static_assert(MT >= 1 && MT <= tiles_per_wg<T>(BN), "the tiles fit the registers");
  constexpr int kBW = BN * kEs <= 128 ? BN : 128 / kEs;  // B channels of a raw box row
  constexpr uint32_t kBMask = (uint32_t)(kBW * kEs / 16 - 1);
  constexpr int kKBlocks = kBox / 64;                   // K-major tiles of a box (64 voxels)
  constexpr int kRowsKB = kParts * BN;                  // a K-major tile's rows: the parts' n
  constexpr int kTileBytes = kKBlocks * kRowsKB * 128;  // one of the two B buffers
  static_assert(BN % kBW == 0, "B's box is whole groups");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = pmr::smem_addr(smem);
  const int box_vox = p.box[0] * p.box[1] * p.box[2];
  // [A boxes][B boxes (fp32 in parts: three bf16 boxes each)][two K-major
  // B buffers][fp32: A's three bf16 part boxes unless A is in parts, then
  // B's three bf16 part rows unless B is, a set a warpgroup with ping-pong,
  // else one][barriers, tap table]
  const int b_off = p.stages * p.a_stage;
  const int t_off = b_off + p.stages * p.b_stage;
  const int c_off = t_off + 2 * kTileBytes;
  // a part box's bytes: fp32's A stage holds three where A comes in parts,
  // else the consumers convert each box into a set of their own
  const int cpart = kF32 ? (p.a_parts ? p.a_stage / kParts : (box_vox * p.width * 2 + 1023) & ~1023)
                         : 0;
  const int nset = p.pingpong ? 2 : 1;  // fp32's sets of part boxes and part rows of B
  const int s_off = c_off + (p.a_parts ? 0 : nset * kParts * cpart);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(smem + s_off + (kF32 && !p.b_parts ? nset * 3 * kBox * BN * 2 : 0));
  uint64_t* const empty = full + kMaxStages;
  int* const tapvox = reinterpret_cast<int*>(empty + kMaxStages);  // kMaxTaps

  const int tid = threadIdx.x;
  PMR_STAMP_DECL(tid == 0 || tid == 128 * kConsumers);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      pmr::mbar_init(&full[s], 32);  // the box's producer warp
      pmr::mbar_init(&empty[s], p.pingpong ? 128 : 128 * kConsumers);
    }
    pmr::mbar_fence_init();
  }
  // each tap's voxel offset in the halo box (tap t = (dz, dy, dx), DHW order)
  for (int t = tid; t < p.ntaps; t += kThreads) {
    const int dx = t % p.kw, dy = (t / p.kw) % p.kh, dz = t / (p.kw * p.kh);
    tapvox[t] = (dz * p.box[1] + dy) * p.box[2] + dx;
  }
  __syncthreads();
  PMR_STAMP(kStampSetup);
  const Unit u = unit_of(p);
  const uint32_t pitch = (uint32_t)(p.width * kEs), amask = pitch / 16 - 1;

  if (tid >= 128 * kConsumers) {
    // -------------------------------------------------------------- producer
    pmr::setmaxnreg_dec<kProducerRegs>();
    const int pt = tid - 128 * kConsumers;
    if (pt == 0) {
      if (p.a_tma) pmr::prefetch_tensormap(&p.amap);
      if (p.b_tma) pmr::prefetch_tensormap(&p.bmap);
    }
    const T* const A = static_cast<const T*>(p.a);
    const T* const B = static_cast<const T*>(p.b);
    const T* const a_end = A + (size_t)p.batch * p.a_d * p.a_h * p.a_w * p.ca;
    const T* const b_end = B + (size_t)p.batch * p.o_d * p.o_h * p.o_w * p.cb;
    const uint32_t tx_bytes =
        (p.a_tma ? (uint32_t)(box_vox * p.width * (p.a_parts ? 2 * kParts : kEs)) : 0u) +
                              (p.b_tma ? (uint32_t)(kBox * BN * (p.b_parts ? 2 * kParts : kEs)) : 0u);
    const int ltw = log2i(p.tile[2]), lth = log2i(p.tile[1]);
    // Stage s is producer warp s % 4's, so that one warp walks each stage's
    // phases in order (an mbarrier's parity tells only two apart) while up
    // to four boxes load at once: its 32 lanes stage what the staged routes
    // load (kGroup chunks a lane in flight before their stores), then lane
    // 0 brings in the rest by TMA. Each lane arrives once a box on the
    // stage's full barrier (lane 0 with the TMA bytes), after its own
    // stores.
    const int pw = pt / 32, pl = pt % 32;
    for (int j = 0; j < u.bx1 - u.bx0; ++j) {
      const int slot = j % p.stages;
      if (slot % 4 != pw) continue;
      const Box x = box_of(p, u.bx0 + j);
      const int az = x.oz * p.st[0] - p.lo[0], ay = x.oy * p.st[1] - p.lo[1],
                ax = x.ox * p.st[2] - p.lo[2];
      wait_bar(&empty[slot], ((j / p.stages) & 1) ^ 1);
      PMR_STAMP(kStampProducerWait);
      uint8_t* const abox = smem + slot * p.a_stage;
      uint8_t* const braw = smem + b_off + slot * p.b_stage;
      if (!p.a_tma) {  // A's halo box, 16-byte chunks of the slab's channels
        const int nc = p.width / kVec, lc = log2i(nc), total = box_vox * nc;
        for (int base = pl; base < total; base += 32 * kGroup) {
          uint4 val[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int it = base + 32 * g, v = it >> lc, ch = u.ca0 + (it & (nc - 1)) * kVec;
            const int x0 = v % p.box[2], yz = v / p.box[2];
            const int gz = az + yz / p.box[1], gy = ay + yz % p.box[1], gx = ax + x0;
            val[g] = make_uint4(0, 0, 0, 0);
            if (it < total && (unsigned)gz < (unsigned)p.a_d && (unsigned)gy < (unsigned)p.a_h &&
                (unsigned)gx < (unsigned)p.a_w && ch < p.ca)
              val[g] = pmr::load_chunk(
                  A + (size_t)(((x.b * p.a_d + gz) * p.a_h + gy) * p.a_w + gx) * p.ca + ch,
                  p.ca - ch, a_end);
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int it = base + 32 * g;
            if (it < total)
              *reinterpret_cast<uint4*>(
                  abox + swizzle((uint32_t)(it >> lc) * pitch + (it & (nc - 1)) * 16, amask)) =
                  val[g];
          }
        }
      }
      if (!p.b_tma) {  // B's box as TMA would land it: groups of kBW channels
        constexpr int kNC = BN / kVec, kGC = kBW / kVec;
        for (int base = pl; base < kBox * kNC; base += 32 * kGroup) {
          uint4 val[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int it = base + 32 * g, k = it / kNC, ch = u.n0 + (it % kNC) * kVec;
            const int gz = x.oz + (k >> (ltw + lth)), gy = x.oy + ((k >> ltw) & (p.tile[1] - 1)),
                      gx = x.ox + (k & (p.tile[2] - 1));
            val[g] = make_uint4(0, 0, 0, 0);
            if (it < kBox * kNC && gz < p.o_d && gy < p.o_h && gx < p.o_w && ch < p.cb)
              val[g] = pmr::load_chunk(
                  B + (size_t)(((x.b * p.o_d + gz) * p.o_h + gy) * p.o_w + gx) * p.cb + ch,
                  p.cb - ch, b_end);
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int it = base + 32 * g, k = it / kNC, c = it % kNC;
            if (it < kBox * kNC)
              *reinterpret_cast<uint4*>(
                  braw + (c / kGC) * kBox * kBW * kEs +
                  swizzle((uint32_t)(k * kBW * kEs + (c % kGC) * 16), kBMask)) = val[g];
          }
        }
      }
      if (pl == 0 && tx_bytes != 0) {
        pmr::mbar_arrive_expect_tx(&full[slot], tx_bytes);
        if (p.a_tma) {  // A's box, or its three part boxes (parts q at batch q x batch + b)
          for (int q = 0; q < (p.a_parts ? kParts : 1); ++q)
            pmr::tma_load_5d(sbase + slot * p.a_stage + q * cpart, &p.amap, &full[slot], u.ca0, ax,
                             ay, az, q * p.batch + x.b);
        }
        if (p.b_parts) {  // B's three part boxes: rows of BN bf16 (BN * 2 <= 64 bytes)
          for (int q = 0; q < kParts; ++q)
            pmr::tma_load_5d(sbase + b_off + slot * p.b_stage + q * kBox * BN * 2, &p.bmap,
                             &full[slot], u.n0, x.ox, x.oy, x.oz, q * p.batch + x.b);
        } else if (p.b_tma) {
#pragma unroll
          for (int g = 0; g < BN / kBW; ++g)
            pmr::tma_load_5d(sbase + b_off + slot * p.b_stage + g * kBox * kBW * kEs, &p.bmap,
                             &full[slot], u.n0 + g * kBW, x.ox, x.oy, x.oz, x.b);
        }
      } else {
        pmr::mbar_arrive(&full[slot]);
      }
      PMR_STAMP(kStampProducerLoad);
    }
    PMR_STAMP_WRITE();
  } else {
    // ------------------------------------------------------------ consumers
    pmr::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int rows_b = u.ntb * p.width, lwd = log2i(p.width);
    const int ltw = log2i(p.tile[2]), lth = log2i(p.tile[1]);
    // the bf16 box the fragments come from: bf16's A box itself, fp32's part
    // boxes (its slab's channels as bf16, 2 x width bytes a voxel)
    const uint32_t cpitch = (uint32_t)(p.width * 2), cmask = cpitch / 16 - 1;
    // a tile voxel k's row in the halo box: k = (z, y, x) of the tile
    const int mz = p.st[0] * p.box[1] * p.box[2], my = p.st[1] * p.box[2], mx = p.st[2];
    auto rowvox = [&](int k) {
      return (k >> (ltw + lth)) * mz + ((k >> ltw) & (p.tile[1] - 1)) * my +
             (k & (p.tile[2] - 1)) * mx;
    };
    // Two schedules (p.pingpong). Split: the warpgroups share every box,
    // warpgroup w taking tiles 2i + w of the block's rows; the two convert
    // each box together, B into two tiles in turn, box q + 1's while box
    // q's wgmmas run, and one named barrier a box says both that box q's
    // wgmmas are done and that box q + 1's tile is written (fp32's part
    // boxes, one set, wait for a second barrier: box q's ldmatrix). Ping-pong
    // (the block's rows within one warpgroup's MT tiles): warpgroup w takes
    // every row and the boxes j = w, w + 2, ... of the block's range, with a
    // buffer and named barriers of its own, so that one warpgroup's
    // conversion and wgmma drain overlap the other's wgmmas; each writes
    // its own partial sums.
    const bool pp = p.pingpong != 0;
    const int ctid = pp ? tid % 128 : tid, cthreads = pp ? 128 : 128 * kConsumers;
    auto sync = [&]() {
      if (pp)
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      else
        consumers_sync();
    };
    // this lane's ldmatrix row group of each tile (8 channels of one tap) as
    // its tap's box voxel x pitch + its first channel's byte
    int rbase[MT];
    bool live[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int gt = pp ? i : 2 * i + wg;
      live[i] = gt * 64 < rows_b;  // uniform over the warpgroup
      const int r = gt * 64 + warp * 16 + ((lane >> 3) & 1) * 8, tl = r >> lwd;
      const int tv = tl < u.ntb ? tapvox[u.t0 + tl] : 0;  // padding rows read tap 0
      rbase[i] = tv * (int)cpitch + (r & (p.width - 1)) * 2;
    }
    float acc[MT][BN / 2];
    float chain[kF32 ? MT : 1][kF32 ? 3 * BN / 2 : 1];  // fp32: a box's wgmma sums, 3 parts
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 3 * BN / 2; ++j) chain[i][j] = 0.f;
    }

    // The box in `slot` into buffer `t` (of two), by the converting threads
    // (ctid of cthreads). B: its K-major tile, per 64 voxels kParts x BN
    // rows of 128 bytes (the parts' rows one after another), 128-byte
    // swizzle. fp32 also turns A's slab into three bf16 part boxes.
    //
    // bf16 B rows (kbw channels a raw row, bmask its swizzle) into tile rows
    // row0 + n: 8 x 8 blocks (8 voxels x 8 channels), four a warp; quad qd
    // holds channel block qd / 4 and voxel blocks 4 (qd % 4) ..+ 3;
    // ldmatrix .trans of the raw rows, stmatrix of the transposes.
    auto transpose_b = [&](uint32_t braw, int kbw, uint32_t bmask, uint32_t tile, int row0) {
      const int j = lane >> 3, r = lane & 7;
      for (int qd = ctid / 32; qd < BN / 2; qd += cthreads / 32) {
        const int n8 = (qd >> 2) * 8, kk = ((qd & 3) * 4 + j) * 8;
        uint32_t v[4];
        pmr::ldmatrix_x4_trans_at(
            v, braw + (uint32_t)((n8 / kbw) * kBox * kbw * 2) +
                   swizzle((uint32_t)((kk + r) * kbw * 2 + (n8 % kbw) * 2), bmask));
        const int n = row0 + n8 + r;
        pmr::stmatrix_x4_at(tile + (uint32_t)((kk / 64) * kRowsKB * 128 + n * 128) +
                                ((((kk % 64) >> 3) ^ (n & 7)) << 4),
                            v);
      }
    };
    auto convert = [&](int slot, int t) {
      const uint32_t tile = sbase + t_off + t * kTileBytes;
      if constexpr (!kF32) {
        transpose_b(sbase + b_off + slot * p.b_stage, kBW, kBMask, tile, 0);
      } else {
        // B: each fp32 element into three bf16 parts, each part as a bf16
        // raw box (rows of BN, the part stage's own swizzle; 4 channels of
        // a voxel a thread, reading whole rows), then transposed into the
        // part's rows of the tile as bf16's; where B came in parts, its
        // stage holds the three raw boxes already
        const uint8_t* const raw = smem + b_off + slot * p.b_stage;
        uint8_t* const ps =
            p.b_parts ? smem + b_off + slot * p.b_stage : smem + s_off + (pp ? wg : 0) * 3 * kBox * BN * 2;
        constexpr uint32_t kPMask = (uint32_t)(BN * 2 / 16 - 1);
        for (int it = p.b_parts ? kBox * (BN / 4) : ctid; it < kBox * (BN / 4); it += cthreads) {
          const int k = it / (BN / 4), c4 = it % (BN / 4);
          const float4 v4 =
              *reinterpret_cast<const float4*>(raw + swizzle((uint32_t)(k * BN * 4 + c4 * 16), kBMask));
          uint32_t lo[3], hi[3];
          pmr::split_bf16x3(v4.x, v4.y, lo);
          pmr::split_bf16x3(v4.z, v4.w, hi);
          const uint32_t dst = swizzle((uint32_t)(k * BN * 2 + c4 * 8), kPMask);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            *reinterpret_cast<uint2*>(ps + q * kBox * BN * 2 + dst) = make_uint2(lo[q], hi[q]);
        }
        if (!p.b_parts) sync();  // the part rows are written
#pragma unroll 1
        for (int q = 0; q < 3; ++q)
          transpose_b(pmr::smem_addr(ps + q * kBox * BN * 2), BN, kPMask, tile, q * BN);
        // A, unless it came in parts: 8 channels of a voxel a thread (two
        // 16-byte chunks of the fp32 box) into one 16-byte chunk of each
        // part box
        const uint8_t* const abox = smem + slot * p.a_stage;
        uint8_t* const cb = smem + c_off + (pp ? wg : 0) * kParts * cpart;
        const int nc8 = p.width / 8, lc8 = log2i(nc8);
        for (int it = p.a_parts ? box_vox * nc8 : ctid; it < box_vox * nc8; it += cthreads) {
          const int v = it >> lc8, c8 = it & (nc8 - 1);
          const uint32_t src = (uint32_t)v * pitch + c8 * 32;
          const float4 lo4 = *reinterpret_cast<const float4*>(abox + swizzle(src, amask));
          const float4 hi4 = *reinterpret_cast<const float4*>(abox + swizzle(src + 16, amask));
          const float x8[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
          uint32_t w[3][4];
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            uint32_t q2[3];
            pmr::split_bf16x3(x8[e], x8[e + 1], q2);
#pragma unroll
            for (int q = 0; q < 3; ++q) w[q][e / 2] = q2[q];
          }
          const uint32_t dst = swizzle((uint32_t)v * cpitch + c8 * 16, cmask);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            *reinterpret_cast<uint4*>(cb + q * cpart + dst) =
                make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
        }
      }
      pmr::fence_proxy_async();  // the wgmmas read the tile through the async proxy
    };

    // A box's wgmmas against buffer `t`: kG steps (16 voxels each) a
    // commit group (as many as the registers of two buffers allow), the groups in pairs whose A fragments go to register
    // buffers 0 and 1 (each waits for the group two before it, whose buffer
    // it takes). A lane's ldmatrix row is its voxel's row in the box (its
    // step's voxel plus its tap's) at its channels. bf16: one wgmma a
    // step and tile. fp32: A and B in three bf16 parts each, x = x1 + x2 +
    // x3; three wgmmas a step and tile, a1 . [b1 | b2 | b3], a2 . [b1 | b2]
    // and a3 . b1 (N 3 BN, 2 BN, BN: prefixes of the part rows), the six
    // products whose sum is x . y to 2^-24 of it, into a chain of 3 BN
    // columns.
    constexpr int kSteps = kBox / 16;
    constexpr int kG = kF32 ? (MT == 1 ? 2 : 1) : (MT * BN >= 128 ? 2 : 4);
    uint32_t a0[kG][kParts][MT][4], a1[kG][kParts][MT][4];
    auto group = [&](uint32_t abox, uint32_t tile, int s0,
                     uint32_t(&af)[kG][kParts][MT][4]) {
#pragma unroll
      for (int gs = 0; gs < kG; ++gs) {
        const int rb = rowvox((s0 + gs) * 16 + (lane & 7) + ((lane >> 4) << 3)) * (int)cpitch;
#pragma unroll
        for (int q = 0; q < kParts; ++q)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            pmr::ldmatrix_x4_trans_at(
                af[gs][q][i], abox + q * cpart + swizzle((uint32_t)(rb + rbase[i]), cmask));
      }
      PMR_STAMP(kStampIssue);
      pmr::wgmma_fence();
#pragma unroll
      for (int gs = 0; gs < kG; ++gs) {
        const int s = s0 + gs;  // the step's K-major tile (s / 4), its 32 bytes a row
        const uint64_t desc =
            pmr::wgmma_desc_b128_at(tile + (s / 4) * kRowsKB * 128, 16, 1024) + 2 * (s % 4);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if constexpr (kF32) {
            pmr::WgmmaRS<3 * BN, 0>::mma(chain[i], af[gs][0][i], desc);
            pmr::WgmmaRS<2 * BN, 0>::mma(chain[i], af[gs][1][i], desc);
            pmr::WgmmaRS<BN, 0>::mma(chain[i], af[gs][2][i], desc);
          } else {
            pmr::WgmmaRS<BN, 0>::mma(acc[i], af[gs][0][i], desc);
          }
      }
      pmr::wgmma_commit();
      PMR_STAMP(kStampMma);
    };
    auto issue_box = [&](int slot, int t) {
      const uint32_t abox =
          kF32 && !p.a_parts ? sbase + c_off + (pp ? wg : 0) * kParts * cpart
                             : sbase + slot * p.a_stage;
      const uint32_t tile = sbase + t_off + t * kTileBytes;
#pragma unroll 1
      for (int s0 = 0; s0 < kSteps; s0 += 2 * kG) {
        if (s0 > 0) pmr::wgmma_wait<1>();  // the pair before's first group: buffer 0 is free
        group(abox, tile, s0, a0);
        if (s0 > 0) pmr::wgmma_wait<1>();  // ... and its second: buffer 1
        group(abox, tile, s0 + kG, a1);
      }
    };
    // every wgmma of the box done; fp32: its chain's three parts into the
    // fp32 sums, the small ones first
    auto drain = [&]() {
      pmr::wgmma_wait<0>();
      if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          pmr::fence_registers(chain[i]);
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            acc[i][j] += chain[i][j] + (chain[i][j + BN / 2] + chain[i][j + BN]);
            chain[i][j] = chain[i][j + BN / 2] = chain[i][j + BN] = 0.f;
          }
        }
      }
      PMR_STAMP(kStampMma);
    };

    const int nb = u.bx1 - u.bx0;
    if (pp) {
      for (int j = wg; j < nb; j += 2) {
        const int slot = j % p.stages;
        wait_bar(&full[slot], (j / p.stages) & 1);
        sync();  // this warpgroup's last box is drained: its buffer is free
        PMR_STAMP(kStampWait);
        convert(slot, wg);
        sync();
        PMR_STAMP(kStampConvert);
        issue_box(slot, wg);
        pmr::mbar_arrive(&empty[slot]);  // every read of this box's stage has returned
        drain();
      }
    } else {
      int slot = 0, ph = 0;
      if (nb > 0) {
        wait_bar(&full[0], 0);
        convert(0, 0);
        sync();
      }
      for (int j = 0, t = 0; j < nb; ++j, t ^= 1) {
        PMR_STAMP(kStampWait);
        issue_box(slot, t);
        pmr::mbar_arrive(&empty[slot]);  // every read of this box's stage has returned
        if (kF32 && !p.a_parts) sync();  // every ldmatrix of the part boxes has returned
        if (++slot == p.stages) {
          slot = 0;
          ph ^= 1;
        }
        if (j + 1 < nb) {
          wait_bar(&full[slot], ph);
          PMR_STAMP(kStampWait);
          convert(slot, t ^ 1);
          PMR_STAMP(kStampConvert);
        }
        drain();
        sync();
      }
    }
    if (nb == 0) pmr::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) pmr::fence_registers(acc[i]);

    // -------------------------------------------------------------- epilogue
    // d[j] of a tile at row 16 warp + lane / 4 + 8 ((j / 2) % 2), column
    // 8 (j / 4) + 2 (lane % 4) + j % 2; row r of the block is channel
    // ca0 + r % width of tap t0 + r / width. Partial sums go to the
    // workspace, one a split (ping-pong: one a split and warpgroup).
    const int parts = p.splits * (pp ? 2 : 1);
    float* const part =
        parts > 1 ? p.ws + (size_t)(pp ? 2 * u.split + wg : u.split) * p.m * p.cb : nullptr;
    T* const out = static_cast<T*>(p.out);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int j = 0; j < BN / 2; j += 2) {  // a column pair: d[j], d[j + 1]
        const int r = (pp ? i : 2 * i + wg) * 64 + warp * 16 + lane / 4 + 8 * ((j >> 1) & 1);
        const int c = u.ca0 + (r & (p.width - 1));
        const int n = u.n0 + 8 * (j >> 2) + 2 * (lane & 3);
        if (r >= rows_b || c >= p.ca || n >= p.cb) continue;
        const size_t e = (size_t)((u.t0 + (r >> lwd)) * p.ca + c) * p.cb + n;
        const bool two = n + 1 < p.cb;
        if (part != nullptr) {
          if (two && (e & 1) == 0) {
            *reinterpret_cast<float2*>(part + e) = make_float2(acc[i][j], acc[i][j + 1]);
          } else {
            part[e] = acc[i][j];
            if (two) part[e + 1] = acc[i][j + 1];
          }
        } else {
          out[e] = pmr::from_f32<T>(acc[i][j]);
          if (two) out[e + 1] = pmr::from_f32<T>(acc[i][j + 1]);
        }
      }
    }
    PMR_STAMP(kStampEpilogue);
    PMR_STAMP_WRITE();
  }
}

// out[e] = the splits' partials of element e in a fixed order, in fp64 (the
// partials of a long K cancel: fp32 sums of a hundred of them lose the
// small results): group g of kReduceGroups sums partials g, g +
// kReduceGroups, ... in order; the groups are then summed in order; rounded
// once. A block: 32 elements x 8 groups.
template <typename T>
__global__ void __launch_bounds__(32 * kReduceGroups)
    wgrad_reduce_kernel(const float* __restrict__ ws, int splits, int numel,
                        T* __restrict__ out) {
  __shared__ double part[kReduceGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (e < numel && grp < splits) {
    s = ws[(size_t)grp * numel + e];
    for (int j = grp + kReduceGroups; j < splits; j += kReduceGroups)
      s += ws[(size_t)j * numel + e];
  }
  part[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && e < numel) {
    double v = part[0][lane];
    for (int q = 1; q < kReduceGroups && q < splits; ++q) v += part[q][lane];
    out[e] = pmr::from_f32<T>((float)v);
  }
}

// fp32 A into its three bf16 parts (x = x1 + x2 + x3, mma.cuh
// split_bf16x3), each a plane of `voxels` rows of `cap` channels (ca
// rounded up to 8, the rest zero: a 16-byte row TMA can take), once a call:
// a block converting its boxes itself would convert each of them once for
// every block of other taps or channels of B that reads it.
__global__ void __launch_bounds__(256)
    wgrad_split_kernel(const float* __restrict__ a, long long voxels, int ca, int cap,
                       bf16* __restrict__ parts) {
  const long long plane = voxels * cap, items = voxels * (cap / 8);
  for (long long it = blockIdx.x * 256LL + threadIdx.x; it < items;
       it += (long long)gridDim.x * 256) {
    const long long v = it / (cap / 8);
    const int c0 = (int)(it % (cap / 8)) * 8;
    const float* const src = a + v * ca + c0;
    const uint4 lo = c0 < ca ? pmr::load4_any(src, ca - c0) : make_uint4(0, 0, 0, 0);
    const uint4 hi = c0 + 4 < ca ? pmr::load4_any(src + 4, ca - c0 - 4) : make_uint4(0, 0, 0, 0);
    const uint32_t e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t w[3][4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      uint32_t q2[3];
      pmr::split_bf16x3(__uint_as_float(e[i]), __uint_as_float(e[i + 1]), q2);
#pragma unroll
      for (int q = 0; q < 3; ++q) w[q][i / 2] = q2[q];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint4*>(parts + q * plane + v * cap + c0) =
          make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
  }
}

template <typename T, int BN, int MT>
int launch_tile(const WgradParams& p, cudaStream_t s) {
  auto kernel = wgrad_wgmma_kernel<T, BN, MT>;
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
    if (attr.numRegs * kThreads < 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs)
      return (int)cudaErrorInvalidConfiguration;
    configured = true;
  }
  const unsigned grid = (unsigned)(p.tap_groups * p.slabs * p.n_tiles * p.splits);
  kernel<<<grid, kThreads, p.smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The tiles a consumer warpgroup holds: as many as the block's rows need, at
// most tiles_per_wg (a warpgroup's wgmmas run on every tile it holds, the
// dead ones' rows dropped by the epilogue: a wgmma under a branch would be
// serialized by ptxas).
template <typename T, int BN>
int launch_mt(const WgradParams& p, cudaStream_t s) {
  constexpr int kMax = tiles_per_wg<T>(BN);
  const int tiles = (p.tpb * p.width + 63) / 64;
  const int need = p.pingpong ? tiles : (tiles + 1) / 2;
  if constexpr (kMax > 1) {
    if (need < kMax) return launch_tile<T, BN, 1>(p, s);
  }
  return launch_tile<T, BN, kMax>(p, s);
}

// The tile widths: bf16 8-128, fp32 8-32 (ops/convolution.py WGRAD_TILES_N;
// fp32's chain of three parts is 3 BN / 2 registers).
template <typename T>
int launch_bn(const WgradParams& p, cudaStream_t s) {
  switch (p.bn) {
    case 8: return launch_mt<T, 8>(p, s);
    case 16: return launch_mt<T, 16>(p, s);
    case 32: return launch_mt<T, 32>(p, s);
    case 64:
      if constexpr (!Elem<T>::kF32) return launch_mt<T, 64>(p, s);
      return (int)cudaErrorInvalidValue;
    case 128:
      if constexpr (!Elem<T>::kF32) return launch_mt<T, 128>(p, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const WgradParams& p, cudaStream_t s) {
  const int rc = launch_bn<T>(p, s);
  const int parts = p.splits * (p.pingpong ? 2 : 1);
  if (rc != 0 || parts == 1) return rc;
  const int numel = p.m * p.cb;
  wgrad_reduce_kernel<T><<<(unsigned)((numel + 31) / 32), 32 * kReduceGroups, 0, s>>>(
      p.ws, parts, numel, static_cast<T*>(p.out));
  return (int)cudaGetLastError();
}

// An fp32 tensor of `voxels` rows of c channels into three bf16 planes of
// cp (c rounded up to 8) channels in the workspace at *off rounded up to
// 256 bytes (wgrad_split_kernel); *off moves past them.
int split_planes(const float* x, long long voxels, int c, int cp, void* ws, size_t* off,
                 bf16** planes, cudaStream_t s) {
  *off = (*off + 255) / 256 * 256;
  *planes = reinterpret_cast<bf16*>(static_cast<char*>(ws) + *off);
  *off += (size_t)3 * voxels * cp * 2;
  const long long items = voxels * (cp / 8);
  const unsigned blocks = (unsigned)std::min<long long>((items + 255) / 256, 132LL * 16);
  wgrad_split_kernel<<<blocks, 256, 0, s>>>(x, voxels, c, cp, *planes);
  return (int)cudaGetLastError();
}

// A 5D map over an NDHWC view (channels c, grid d x h x w, batch n) in boxes
// of (box0 channels, bw, bh, bd, 1).
int encode_ndhwc(CUtensorMap* map, const void* base, int c, int d, int h, int w, int n,
                 int box0, int bd, int bh, int bw, int es) {
  const uint64_t cs = (uint64_t)c * es;
  const uint64_t dims[5] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)d, (uint64_t)n};
  const uint64_t strides[4] = {cs, cs * w, cs * w * h, cs * w * h * d};
  const uint32_t box[5] = {(uint32_t)box0, (uint32_t)bw, (uint32_t)bh, (uint32_t)bd, 1};
  return pmr::encode_tensor_map_nd(map, base, 5, dims, strides, box, es);
}

}  // namespace

// geom (int32[kGeom], ops/convolution.py wgrad_args): 0-3 A's view D, H, W,
// C; 4-7 B's view D, H, W, C; 8-10 kd, kh, kw; 11-13 strides; 14-16 SAME
// low pads; 17 the view's batch; 18-20 tile; 21-23 A's halo box; 24-26
// tiles a grid axis; 27 slab width; 28 taps a block; 29 tap groups; 30
// slabs; 31 tile n; 32 channel tiles; 33 splits; 34 boxes; 35 A by TMA; 36
// B by TMA; 37 A stage bytes; 38 B stage bytes; 39 stages; 40 dynamic
// shared memory; 41 taps; 42 ping-pong; 43 A in parts, 44 B in parts (fp32).
// ws: partials (splits, x 2 with ping-pong) * taps * CA * CB fp32 (none with
// one), then, at the next 256 bytes each, A's three bf16 planes of batch *
// voxels * CAP (CA rounded up to 8) where A is in parts and B's of its
// voxels * CBP where B is; out: taps * CA * CB.
extern "C" int pmr_conv3d_wgrad(const void* a, const void* b, void* out, void* ws,
                                const void* geom, int dtype, void* stream) {
  static_assert(sizeof(WgradParams) <= 4096 - 64, "kernel parameters stay under 4 KB");
  const int* g = static_cast<const int*>(geom);
  const int es = dtype == pmr::kBFloat16 ? 2 : dtype == pmr::kFloat32 ? 4 : 0;
  if (es == 0) return (int)cudaErrorInvalidValue;
  WgradParams p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.a_d = g[0], p.a_h = g[1], p.a_w = g[2], p.ca = g[3];
  p.o_d = g[4], p.o_h = g[5], p.o_w = g[6], p.cb = g[7];
  p.kd = g[8], p.kh = g[9], p.kw = g[10];
  for (int i = 0; i < 3; ++i) {
    p.st[i] = g[11 + i];
    p.lo[i] = g[14 + i];
    p.tile[i] = g[18 + i];
    p.box[i] = g[21 + i];
    p.tiles_ax[i] = g[24 + i];
  }
  p.batch = g[17];
  p.width = g[27];
  p.tpb = g[28];
  p.tap_groups = g[29];
  p.slabs = g[30];
  p.bn = g[31];
  p.n_tiles = g[32];
  p.splits = g[33];
  p.nbox = g[34];
  p.a_tma = g[35];
  p.b_tma = g[36];
  p.a_stage = g[37];
  p.b_stage = g[38];
  p.stages = g[39];
  p.smem = g[40];
  p.ntaps = g[41];
  p.pingpong = g[42];
  p.a_parts = g[43];
  p.b_parts = g[44];
  p.m = p.ntaps * p.ca;
  auto pow2 = [](int n) { return n > 0 && (n & (n - 1)) == 0; };
  const int vec = 16 / es;
  const int mt = es == 2 ? tiles_per_wg<bf16>(p.bn) : tiles_per_wg<float>(p.bn);
  if (p.ntaps != p.kd * p.kh * p.kw || p.ntaps > kMaxTaps || p.ca < 1 || p.cb < 1 ||
      p.batch < 1 || p.splits < 1 || p.splits > 65535 || p.nbox < p.splits ||
      (p.splits > 1 && p.ws == nullptr) || p.stages < 2 || p.stages > kMaxStages ||
      p.smem > 232448 || p.tile[0] * p.tile[1] * p.tile[2] != kBox || !pow2(p.tile[1]) ||
      !pow2(p.tile[2]) || !pow2(p.width) || p.width < 8 ||
      p.width * es > 128 || p.width % vec != 0 || p.tpb < 1 ||
      p.tpb * p.width > 64 * mt * (p.pingpong ? 1 : kConsumers) ||
      (p.pingpong != 0 && p.pingpong != 1) || (p.pingpong && (p.ws == nullptr || p.stages % 2)) ||
      (p.a_parts != 0 && p.a_parts != 1) || (p.b_parts != 0 && p.b_parts != 1) ||
      (p.b_parts && (es != 4 || !p.b_tma || p.ws == nullptr ||
                     p.b_stage != (kBox * 3 * p.bn * 2 + 1023) / 1024 * 1024)) ||
      (p.a_parts && (es != 4 || !p.a_tma || p.ws == nullptr ||
                     p.a_stage != 3 * ((p.box[0] * p.box[1] * p.box[2] * p.width * 2 + 1023) &
                                       ~1023))) ||
      p.tap_groups * p.tpb < p.ntaps || p.slabs * p.width < p.ca ||
      p.nbox != p.batch * p.tiles_ax[0] * p.tiles_ax[1] * p.tiles_ax[2])
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nparts = p.splits * (p.pingpong ? 2 : 1);
  size_t off = nparts > 1 ? (size_t)nparts * p.m * p.cb * 4 : 0;  // the workspace's next bytes
  if (p.a_parts) {  // A's three bf16 planes, then a map over them as 3 x batch samples
    const int cap = (p.ca + 7) / 8 * 8;
    bf16* planes = nullptr;
    const int rc = split_planes(static_cast<const float*>(a),
                                (long long)p.batch * p.a_d * p.a_h * p.a_w, p.ca, cap, ws, &off,
                                &planes, s);
    if (rc != 0) return rc;
    const int rc2 = encode_ndhwc(&p.amap, planes, cap, p.a_d, p.a_h, p.a_w, 3 * p.batch,
                                 p.width, p.box[0], p.box[1], p.box[2], 2);
    if (rc2 != 0) return rc2;
  } else if (p.a_tma) {
    const int rc = encode_ndhwc(&p.amap, a, p.ca, p.a_d, p.a_h, p.a_w, p.batch, p.width,
                                p.box[0], p.box[1], p.box[2], es);
    if (rc != 0) return rc;
  }
  if (p.b_parts) {  // B's the same, boxes of one tile of B's channels
    const int cbp = (p.cb + 7) / 8 * 8;
    bf16* planes = nullptr;
    const int rc = split_planes(static_cast<const float*>(b),
                                (long long)p.batch * p.o_d * p.o_h * p.o_w, p.cb, cbp, ws, &off,
                                &planes, s);
    if (rc != 0) return rc;
    const int rc2 = encode_ndhwc(&p.bmap, planes, cbp, p.o_d, p.o_h, p.o_w, 3 * p.batch, p.bn,
                                 p.tile[0], p.tile[1], p.tile[2], 2);
    if (rc2 != 0) return rc2;
  } else if (p.b_tma) {
    const int bw = p.bn * es <= 128 ? p.bn : 128 / es;
    const int rc = encode_ndhwc(&p.bmap, b, p.cb, p.o_d, p.o_h, p.o_w, p.batch, bw, p.tile[0],
                                p.tile[1], p.tile[2], es);
    if (rc != 0) return rc;
  }
  return es == 2 ? run<bf16>(p, s) : run<float>(p, s);
}

// The stamps build's buffer for this source's kernels (stamps.cuh).
extern "C" int pmr_conv3d_wgrad_stamps(void* buf) { return pmr_stamp_install(buf); }
