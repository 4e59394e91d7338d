// K1 conv3d and K2 conv3d_transpose for fp32: implicit-GEMM 3D convolution
// on channels-last (NDHWC) tensors, fp32 FMA on the CUDA cores. (bf16 inputs
// take the tensor-core kernel in conv3d_mma.cu; both read one ConvParams,
// conv_params.cuh.)
//
// Replaces: benchmarks/r2_probe_pallas_mxu.py:80 conv_probe (its body `kern`
// at :96), the streaming (1,3,3) SAME conv + bias that built a 9-tap im2col
// in VMEM and ran one deep-K matmul. Here the same im2col is implicit: each
// block gathers its (rows x 16) slice of the virtual im2col matrix straight
// from the NDHWC input into shared memory, so no im2col tensor ever reaches
// device memory. Generalized to every conv of the M1 path: kernels (1,3,3),
// (3,3,3), (1,1,1); strides (1,1,1), (1,2,2), (2,2,2); a list of up to five
// channel parts summed into one output (SplitInputConv); and the TF-convention
// transposed conv (K2).
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
// Why fp32 stays here: the tensor cores' fp32 mode is TF32 (about 1e-3
// relative), which cannot hold the port's fp32 limits (kernel vs twin 2e-4,
// card vs CPU softmax 1e-3). So fp32 runs fp32 FMA from shared-memory tiles
// (no tensor cores, no double buffering), bounded by the FMA rate and by the
// integer work of the implicit gather. Tile shapes follow cout so that narrow
// layers (cout 1..16) do not waste most of each tile.

#include <stdint.h>

#include "common.cuh"
#include "conv_params.cuh"

namespace {

using pmr::ConvParams;
using pmr::kMaxTaps;

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    conv3d_igemm_kernel(const ConvParams p) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile per thread");
  static_assert((BM * kBK) % kThreads == 0, "A tile loads evenly");
  static_assert(kThreads % kBK == 0, "A loader keeps one k column per thread");

  __shared__ float As[kBK][BM + 1];  // +1: the k-major stores hit distinct banks
  __shared__ float Bs[kBK][BN];
  __shared__ int4 row_in[BM];        // (batch or -1, z0, y0, x0)
  __shared__ long long row_out[BM];  // output element offset or -1
  __shared__ signed char taps[kMaxTaps][4];

  const int tid = threadIdx.x;
  const int phase = blockIdx.z;
  const long long m_total = (long long)p.batch * p.g_d * p.g_h * p.g_w;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ntap = p.ntap[phase];

  for (int r = tid; r < BM; r += kThreads) {
    const long long m = m0 + r;
    int4 info = make_int4(-1, 0, 0, 0);
    long long oofs = -1;
    if (m < m_total) {
      long long t = m;
      const int gw = (int)(t % p.g_w);
      t /= p.g_w;
      const int gh = (int)(t % p.g_h);
      t /= p.g_h;
      const int gd = (int)(t % p.g_d);
      const int b = (int)(t / p.g_d);
      info = make_int4(b, gd * p.in_mul[0] + p.in_add[0],
                       gh * p.in_mul[1] + p.in_add[1],
                       gw * p.in_mul[2] + p.in_add[2]);
      const int od = gd * p.out_mul[0] + p.res[phase][0];
      const int oh = gh * p.out_mul[1] + p.res[phase][1];
      const int ow = gw * p.out_mul[2] + p.res[phase][2];
      oofs = ((((long long)b * p.out_d + od) * p.out_h + oh) * p.out_w + ow) *
             p.cout;
    }
    row_in[r] = info;
    row_out[r] = oofs;
  }
  for (int i = tid; i < ntap * 4; i += kThreads) {
    taps[i / 4][i % 4] = p.tap[phase][i / 4][i % 4];
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int a_k = tid % kBK;  // the A loader's fixed k column
  const int a_r = tid / kBK;  // its first row; further rows every kThreads/kBK
  const T* wgt = static_cast<const T*>(p.w);
  const long long w_tap_stride = (long long)p.cin_total * p.cout;

  int ci_base = 0;
  for (int part = 0; part < p.nparts; ++part) {
    const T* xp = static_cast<const T*>(p.x[part]);
    const int cin = p.cin[part];
    const int k_total = ntap * cin;
    for (int k0 = 0; k0 < k_total; k0 += kBK) {
      // A tile: rows x kBK slice of the implicit im2col matrix.
      {
        const int k = k0 + a_k;
        const bool k_ok = k < k_total;
        const int t = k_ok ? k / cin : 0;
        const int ci = k - t * cin;
        const int dz = taps[t][0], dy = taps[t][1], dx = taps[t][2];
#pragma unroll 4
        for (int j = 0; j < (BM * kBK) / kThreads; ++j) {
          const int r = a_r + j * (kThreads / kBK);
          const int4 info = row_in[r];
          float v = 0.f;
          if (k_ok && info.x >= 0) {
            const int z = info.y + dz, yy = info.z + dy, xx = info.w + dx;
            if ((unsigned)z < (unsigned)p.in_d && (unsigned)yy < (unsigned)p.in_h &&
                (unsigned)xx < (unsigned)p.in_w) {
              const size_t off =
                  ((((size_t)info.x * p.in_d + z) * p.in_h + yy) * p.in_w + xx) *
                      cin + ci;
              v = pmr::to_f32<T>(xp[off]);
            }
          }
          As[a_k][r] = v;
        }
      }
      // B tile: kBK x BN slice of the weights.
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int kk = e / BN, n = e % BN;
        const int k = k0 + kk, co = n0 + n;
        float v = 0.f;
        if (k < k_total && co < p.cout) {
          const int t = k / cin;
          const int ci = k - t * cin;
          const long long off = (long long)taps[t][3] * w_tap_stride +
                                (long long)(ci_base + ci) * p.w_ci_stride +
                                (long long)co * p.w_co_stride;
          v = pmr::to_f32<T>(wgt[off]);
        }
        Bs[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    ci_base += cin;
  }

  T* out = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long oofs = row_out[ty * TM + i];
    if (oofs < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < p.cout) {
        const float bias = p.bias != nullptr ? p.bias[co] : 0.f;
        out[oofs + co] = pmr::from_f32<T>(acc[i][j] + bias);
      }
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_tile(const ConvParams& p, cudaStream_t stream) {
  const long long m_total = (long long)p.batch * p.g_d * p.g_h * p.g_w;
  dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((p.cout + BN - 1) / BN),
            (unsigned)p.nphase);
  conv3d_igemm_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
void launch(const ConvParams& p, cudaStream_t stream) {
  if (p.cout <= 8) {
    launch_tile<T, 256, 8, 4, 2>(p, stream);
  } else if (p.cout <= 16) {
    launch_tile<T, 256, 16, 4, 4>(p, stream);
  } else if (p.cout <= 32) {
    launch_tile<T, 128, 32, 4, 4>(p, stream);
  } else {
    launch_tile<T, 128, 64, 8, 4>(p, stream);
  }
}

// Unpacks the wrapper's three host arrays and launches on `stream`.
int run(const void* ptrs, const void* meta, const void* taps, void* stream) {
  ConvParams p;
  const int rc = pmr::unpack_conv_args(ptrs, meta, taps, &p);
  if (rc != 0) return rc;
  if (p.dtype != pmr::kFloat32) return (int)cudaErrorInvalidValue;
  launch<float>(p, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pmr_conv3d(const void* ptrs, const void* meta, const void* taps,
                          void* stream) {
  return run(ptrs, meta, taps, stream);
}

extern "C" int pmr_conv3d_transpose(const void* ptrs, const void* meta,
                                    const void* taps, void* stream) {
  return run(ptrs, meta, taps, stream);
}
