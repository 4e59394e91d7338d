// K3 in_stats and K4 in_apply: instance-norm statistics and the normalizing
// affine (+ optional LeakyReLU(0.1)) on channels-last (NDHWC) tensors.
//
// Replaces: benchmarks/r2_probe_conv.py:198 (the `kern` of main's "pallas"
// section), a flat-lane stream that read once, wrote LReLU once and carried
// per-lane fp32 sum / sum of squares across a sequential grid; and the
// retired ops/pallas/fused_norm.py (git cef1717^: _stats_kernel :47,
// _norm_kernel :70), which split the same work into a statistics kernel and an
// apply kernel. The TPU carried the sums from one grid step to the next; blocks
// on a GPU run in no order, so K3 writes one partial per (batch, chunk,
// channel) and a second launch folds the chunks in a fixed order: no atomics,
// the same bits on every run.
//
// Formulas follow ops/normalization.py of the JAX package: bf16 input takes
// one pass (sum and sum of squares in fp32; var = max(E[x^2] - mean^2, 0));
// fp32 input takes two passes (mean, then the centred sum of squares).
// K4 computes its per-(batch, channel) coefficients in fp32 from K3's output:
// fp32: y = (x - mean) * a + bias; bf16: y = x * a' + b' with a' and b'
// rounded to bf16 first, as the JAX bf16 path does. Both with
// a = rsqrt(var + eps) * scale.
//
// What bounds them on an H100: bytes. Both do a handful of flops per element;
// K3 reads the tensor once (bf16) or twice (fp32) and K4 reads it once and
// writes it once. Their design keeps loads coalesced (consecutive threads read
// consecutive channels of consecutive voxels) and keeps the coefficients in
// shared memory. Fusing the statistics into the producing conv's epilogue, so
// that the tensor is not re-read at all, is later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One block per (chunk, batch). Writes part[b][chunk][0][c] = sum and
// part[b][chunk][1][c] = sum of squares of (x - center) over the chunk's voxels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_partial_kernel(const T* __restrict__ x, const float* __restrict__ center,
                      float* __restrict__ part, int spatial, int channels,
                      int chunk_rows) {
  __shared__ float sh_s[kThreads];
  __shared__ float sh_q[kThreads];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)b * spatial * channels;
  const int row0 = chunk * chunk_rows;
  const int row1 = min(spatial, row0 + chunk_rows);
  float* out = part + ((size_t)b * nchunk + chunk) * 2 * channels;

  if (channels <= kThreads) {
    const int rows_per_pass = kThreads / channels;
    const int c = tid % channels, r = tid / channels;
    float s = 0.f, q = 0.f;
    if (r < rows_per_pass) {
      const float mu = center != nullptr ? center[(size_t)b * 2 * channels + c] : 0.f;
      for (int row = row0 + r; row < row1; row += rows_per_pass) {
        const float v = pmr::to_f32<T>(xb[(size_t)row * channels + c]) - mu;
        s += v;
        q = fmaf(v, v, q);
      }
    }
    sh_s[tid] = s;
    sh_q[tid] = q;
    __syncthreads();
    if (tid < channels) {
      float ts = 0.f, tq = 0.f;
      for (int i = 0; i < rows_per_pass; ++i) {  // fixed order
        ts += sh_s[i * channels + tid];
        tq += sh_q[i * channels + tid];
      }
      out[tid] = ts;
      out[channels + tid] = tq;
    }
  } else {
    for (int c = tid; c < channels; c += kThreads) {
      const float mu = center != nullptr ? center[(size_t)b * 2 * channels + c] : 0.f;
      float s = 0.f, q = 0.f;
      for (int row = row0; row < row1; ++row) {
        const float v = pmr::to_f32<T>(xb[(size_t)row * channels + c]) - mu;
        s += v;
        q = fmaf(v, v, q);
      }
      out[c] = s;
      out[channels + c] = q;
    }
  }
}

// Folds the chunk partials in chunk order. mode 0: one-pass mean and clamped
// variance; mode 1: mean only (first fp32 pass); mode 2: centred variance
// (second fp32 pass). stats is (B, 2, C): mean then var.
__global__ void in_finalize_kernel(const float* __restrict__ part,
                                   float* __restrict__ stats, int batch,
                                   int channels, int nchunk, int spatial,
                                   int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * channels) return;
  const int b = i / channels, c = i % channels;
  float s = 0.f, q = 0.f;
  for (int k = 0; k < nchunk; ++k) {
    const float* pk = part + ((size_t)b * nchunk + k) * 2 * channels;
    s += pk[c];
    q += pk[channels + c];
  }
  const float inv_n = 1.f / (float)spatial;
  float* st = stats + (size_t)b * 2 * channels;
  if (mode == 0) {
    const float mean = s * inv_n;
    st[c] = mean;
    st[channels + c] = fmaxf(q * inv_n - mean * mean, 0.f);
  } else if (mode == 1) {
    st[c] = s * inv_n;
  } else {
    st[channels + c] = q * inv_n;
  }
}

template <typename T>
int stats_impl(const T* x, float* part, float* stats, int batch, int spatial,
               int channels, int nchunk, cudaStream_t stream) {
  const int chunk_rows = (spatial + nchunk - 1) / nchunk;
  const dim3 grid(nchunk, batch);
  const int fin_blocks = (batch * channels + kThreads - 1) / kThreads;
  if (sizeof(T) == 2) {  // bf16: one pass
    in_partial_kernel<T><<<grid, kThreads, 0, stream>>>(x, nullptr, part, spatial,
                                                        channels, chunk_rows);
    in_finalize_kernel<<<fin_blocks, kThreads, 0, stream>>>(part, stats, batch, channels,
                                                            nchunk, spatial, 0);
  } else {  // fp32: mean, then centred variance
    in_partial_kernel<T><<<grid, kThreads, 0, stream>>>(x, nullptr, part, spatial,
                                                        channels, chunk_rows);
    in_finalize_kernel<<<fin_blocks, kThreads, 0, stream>>>(part, stats, batch, channels,
                                                            nchunk, spatial, 1);
    in_partial_kernel<T><<<grid, kThreads, 0, stream>>>(x, stats, part, spatial,
                                                        channels, chunk_rows);
    in_finalize_kernel<<<fin_blocks, kThreads, 0, stream>>>(part, stats, batch, channels,
                                                            nchunk, spatial, 2);
  }
  return (int)cudaGetLastError();
}

// Grid (blocks_per_batch, batch). Each block builds its batch's coefficients
// in shared memory, then streams a strided share of that batch's elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ y, int per_batch, int channels, float eps,
                    int lrelu) {
  extern __shared__ float coef[];  // [3][channels]: center, a, b
  const int b = blockIdx.y;
  const float* st = stats + (size_t)b * 2 * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    const float mean = st[c];
    const float a = rsqrtf(st[channels + c] + eps) * scale[c];
    if (sizeof(T) == 4) {
      coef[c] = mean;
      coef[channels + c] = a;
      coef[2 * channels + c] = bias[c];
    } else {
      const float bb = bias[c] - mean * a;
      coef[c] = 0.f;
      coef[channels + c] = pmr::to_f32<T>(pmr::from_f32<T>(a));
      coef[2 * channels + c] = pmr::to_f32<T>(pmr::from_f32<T>(bb));
    }
  }
  __syncthreads();
  const T* xb = x + (size_t)b * per_batch;
  T* yb = y + (size_t)b * per_batch;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_batch;
       i += gridDim.x * blockDim.x) {
    const int c = i % channels;
    float v = fmaf(pmr::to_f32<T>(xb[i]) - coef[c], coef[channels + c],
                   coef[2 * channels + c]);
    if (lrelu) v = v >= 0.f ? v : 0.1f * v;
    yb[i] = pmr::from_f32<T>(v);
  }
}

template <typename T>
int apply_impl(const T* x, const float* stats, const float* scale, const float* bias,
               T* y, int batch, int per_batch, int channels, float eps, int lrelu,
               cudaStream_t stream) {
  int blocks = (per_batch + kThreads * 8 - 1) / (kThreads * 8);
  blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
  const dim3 grid(blocks, batch);
  const size_t smem = 3 * (size_t)channels * sizeof(float);
  in_apply_kernel<T><<<grid, kThreads, smem, stream>>>(x, stats, scale, bias, y,
                                                       per_batch, channels, eps, lrelu);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, spatial, C) contiguous; part: (B, nchunk, 2, C) fp32 scratch;
// stats: (B, 2, C) fp32 output.
extern "C" int pmr_in_stats(const void* x, void* part, void* stats, int dtype,
                            int batch, int spatial, int channels, int nchunk,
                            void* stream) {
  if (batch < 1 || spatial < 1 || channels < 1 || nchunk < 1 || nchunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pmr::kBFloat16)
    return stats_impl(static_cast<const __nv_bfloat16*>(x), static_cast<float*>(part),
                      static_cast<float*>(stats), batch, spatial, channels, nchunk, s);
  if (dtype == pmr::kFloat32)
    return stats_impl(static_cast<const float*>(x), static_cast<float*>(part),
                      static_cast<float*>(stats), batch, spatial, channels, nchunk, s);
  return (int)cudaErrorInvalidValue;
}

// x, y: (B, per_batch) contiguous with channels fastest; stats (B, 2, C).
extern "C" int pmr_in_apply(const void* x, const void* stats, const void* scale,
                            const void* bias, void* y, int dtype, int batch,
                            int per_batch, int channels, float eps, int lrelu,
                            void* stream) {
  if (batch < 1 || per_batch < 1 || channels < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == pmr::kBFloat16)
    return apply_impl(static_cast<const __nv_bfloat16*>(x), st, sc, bi,
                      static_cast<__nv_bfloat16*>(y), batch, per_batch, channels, eps,
                      lrelu, s);
  if (dtype == pmr::kFloat32)
    return apply_impl(static_cast<const float*>(x), st, sc, bi, static_cast<float*>(y),
                      batch, per_batch, channels, eps, lrelu, s);
  return (int)cudaErrorInvalidValue;
}
