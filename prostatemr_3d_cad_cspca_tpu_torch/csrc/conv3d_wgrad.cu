// K6 conv3d_wgrad: the weight gradient of the SAME 3D convolutions K1 and K2,
// on channels-last (NDHWC) tensors:
//
//   dW[kd, kh, kw, ci, co] = sum over b, o of A[b, o * s + t - lo, ci] * B[b, o, co]
//
// with A zero outside its grid. For K1, A is an input part and B the output
// gradient; for K2, A is K2's output gradient (the fine grid) and B K2's input
// (the coarse grid), which gives the gradient in K2's own (kd, kh, kw, Cout,
// Cin) layout. The output is row-major [taps * CA, CB], i.e. DHWIO.
//
// Replaces: the weight half of the backward of the TPU's conv kernel,
// benchmarks/r2_probe_pallas_mxu.py:80 conv_probe (the JAX package leaves its
// backward to XLA's transposes of the forward); ops/convolution.py in the
// port says how K1 and K2 take the data gradients.
//
// What bounds it on an H100: a GEMM with a small M = taps * CA (4-3456), a
// small N = CB (1-256) and a huge K = batch * output voxels (about 1.02 M at
// the cfg1 window's level 0, batch 2). The level-0 and level-1 shapes are
// bound by bytes (A and B read once), the deep 3x3x3 ones by operations.
//
// Design (simple and right first; ops/convolution.py wgrad_plan picks the
// tile and the chunk count):
//  * K is split into `chunks` fixed ranges of rows; a block computes one
//    BM x BN output tile over one range with fp32 FMAs, MM x MN outputs a
//    thread, staging kRows rows of A (gathered: the tap's shifted, strided
//    window, zero outside A) and of B in shared memory a step.
//  * Each chunk writes fp32 partials; wgrad_reduce_kernel sums them in chunk
//    order and rounds once to the compute type. No atomics: the same bits on
//    every run. With one chunk the tile kernel rounds and stores directly.
//  * Each thread's A column (tap and channel) is fixed for the whole call, so
//    its tap offsets are decoded once; the rows' coordinates are decoded once
//    a step by kRows threads into shared memory.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows of A and B staged a step

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
  long long rows;  // batch * o_d * o_h * o_w
  long long chunk_rows;
  int chunks;
  int m;  // taps * ca
};

// Threads TM x TN (= kThreads), MM x MN outputs each: a BM x BN tile.
template <typename T, int TM, int TN, int MM, int MN>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradParams p) {
  constexpr int BM = TM * MM, BN = TN * MN;
  static_assert(TM * TN == kThreads, "one thread an (MM x MN) micro tile");
  static_assert(kThreads % BM == 0, "each thread loads one fixed A column");
  __shared__ float As[kRows][BM];
  __shared__ float Bs[kRows][BN];
  __shared__ long long row_voxel[kRows];  // b * a_d (the sample's first depth row)
  __shared__ int row_d[kRows], row_h[kRows], row_w[kRows];
  __shared__ bool row_ok[kRows];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, chunk = blockIdx.z;
  const long long r_begin = (long long)chunk * p.chunk_rows;
  const long long r_end = min(p.rows, r_begin + p.chunk_rows);
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);

  // this thread's A column: tap (td, th, tw) and channel ci of m = m0 + tid % BM
  const int lm = tid % BM;
  const int m = m0 + lm;
  const bool m_ok = m < p.m;
  int td = 0, th = 0, tw = 0, ci = 0;
  if (m_ok) {
    const int t = m / p.ca;
    ci = m - t * p.ca;
    tw = t % p.kw;
    th = (t / p.kw) % p.kh;
    td = t / (p.kw * p.kh);
  }
  const int tm = tid / TN, tn = tid % TN;
  float acc[MM][MN];
#pragma unroll
  for (int i = 0; i < MM; ++i)
#pragma unroll
    for (int j = 0; j < MN; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    if (tid < kRows) {
      const long long r = r0 + tid;
      row_ok[tid] = r < r_end;
      if (r < r_end) {
        const int ow = (int)(r % p.o_w);
        const long long q = r / p.o_w;
        const int oh = (int)(q % p.o_h);
        const long long q2 = q / p.o_h;
        const int od = (int)(q2 % p.o_d);
        const long long b = q2 / p.o_d;
        row_voxel[tid] = b * p.a_d;
        row_d[tid] = od * p.sd - p.ld;
        row_h[tid] = oh * p.sh - p.lh;
        row_w[tid] = ow * p.sw - p.lw;
      }
    }
    __syncthreads();
    for (int kk = tid / BM; kk < kRows; kk += kThreads / BM) {
      float v = 0.f;
      if (m_ok && row_ok[kk]) {
        const int id = row_d[kk] + td, ih = row_h[kk] + th, iw = row_w[kk] + tw;
        if (id >= 0 && id < p.a_d && ih >= 0 && ih < p.a_h && iw >= 0 && iw < p.a_w) {
          const long long voxel = ((row_voxel[kk] + id) * p.a_h + ih) * p.a_w + iw;
          v = pmr::to_f32<T>(A[voxel * p.ca + ci]);
        }
      }
      As[kk][lm] = v;
    }
    for (int e = tid; e < kRows * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN, n = n0 + nn;
      Bs[kk][nn] = row_ok[kk] && n < p.cb ? pmr::to_f32<T>(B[(r0 + kk) * p.cb + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      float a[MM], b[MN];
#pragma unroll
      for (int i = 0; i < MM; ++i) a[i] = As[kk][tm * MM + i];
#pragma unroll
      for (int j = 0; j < MN; ++j) b[j] = Bs[kk][tn * MN + j];
#pragma unroll
      for (int i = 0; i < MM; ++i)
#pragma unroll
        for (int j = 0; j < MN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MM; ++i) {
    const int mo = m0 + tm * MM + i;
    if (mo >= p.m) continue;
#pragma unroll
    for (int j = 0; j < MN; ++j) {
      const int no = n0 + tn * MN + j;
      if (no >= p.cb) continue;
      const size_t e = (size_t)mo * p.cb + no;
      if (p.chunks == 1)
        static_cast<T*>(p.out)[e] = pmr::from_f32<T>(acc[i][j]);
      else
        p.ws[(size_t)chunk * p.m * p.cb + e] = acc[i][j];
    }
  }
}

// out[e] = the chunks' partials of element e summed in chunk order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_reduce_kernel(const float* __restrict__ ws, int chunks, long long numel,
                        T* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < numel;
       e += (long long)gridDim.x * kThreads) {
    float s = ws[e];
    for (int j = 1; j < chunks; ++j) s += ws[(size_t)j * numel + e];
    out[e] = pmr::from_f32<T>(s);
  }
}

template <typename T, int TM, int TN, int MM, int MN>
int launch_tile(const WgradParams& p, cudaStream_t s) {
  constexpr int BM = TM * MM, BN = TN * MN;
  const dim3 grid((unsigned)((p.m + BM - 1) / BM), (unsigned)((p.cb + BN - 1) / BN),
                  (unsigned)p.chunks);
  wgrad_kernel<T, TM, TN, MM, MN><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// tiles by BN (ops/convolution.py WGRAD_TILE_M): 64 x 64, 128 x 32, 256 x 16,
// 256 x 8, 256 x 4
template <typename T>
int run(const WgradParams& p, int bn, cudaStream_t s) {
  int rc;
  switch (bn) {
    case 64: rc = launch_tile<T, 16, 16, 4, 4>(p, s); break;
    case 32: rc = launch_tile<T, 32, 8, 4, 4>(p, s); break;
    case 16: rc = launch_tile<T, 64, 4, 4, 4>(p, s); break;
    case 8: rc = launch_tile<T, 128, 2, 2, 4>(p, s); break;
    case 4: rc = launch_tile<T, 256, 1, 1, 4>(p, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || p.chunks == 1) return rc;
  const long long numel = (long long)p.m * p.cb;
  const long long blocks = (numel + kThreads - 1) / kThreads;
  wgrad_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      p.ws, p.chunks, numel, static_cast<T*>(p.out));
  return (int)cudaGetLastError();
}

}  // namespace

// geom (int32[21]): A's D, H, W, C; B's D, H, W, C; kd, kh, kw; strides
// d, h, w; low pads d, h, w; batch; chunks; tile n (bn); chunk rows
// (ops/convolution.py wgrad_plan).
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
  const int batch = g[17];
  p.chunks = g[18];
  const int bn = g[19];
  p.chunk_rows = g[20];
  p.rows = (long long)batch * p.o_d * p.o_h * p.o_w;
  p.m = p.kd * p.kh * p.kw * p.ca;
  if (batch < 1 || p.ca < 1 || p.cb < 1 || p.m < 1 || p.chunks < 1 || p.chunks > 65535 ||
      p.chunk_rows < 1 || (long long)p.chunks * p.chunk_rows < p.rows ||
      (p.chunks > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pmr::kBFloat16) return run<__nv_bfloat16>(p, bn, s);
  if (dtype == pmr::kFloat32) return run<float>(p, bn, s);
  return (int)cudaErrorInvalidValue;
}
