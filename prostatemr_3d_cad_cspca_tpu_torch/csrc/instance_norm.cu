// K3 in_stats and K4 in_apply: instance-norm statistics and the normalizing
// affine (+ optional LeakyReLU(0.1)) on channels-last (NDHWC) tensors.
//
// Replaces: benchmarks/r2_probe_conv.py:198 (the `kern` of main's "pallas"
// section), a flat-lane stream that read once, wrote LReLU once and carried
// per-lane fp32 sum / sum of squares across a sequential grid; and the
// retired ops/pallas/fused_norm.py (git cef1717^: _stats_kernel :47,
// _norm_kernel :70), which split the same work into a statistics kernel and an
// apply kernel. The TPU carried the sums from one grid step to the next;
// blocks on a GPU run in no order, so K3 writes one partial per (batch, chunk,
// channel) and the last block of each sample to finish folds that sample's
// partials in chunk order: no atomics on the sums, the same bits on every run.
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
// writes it once. K4 keeps loads coalesced (consecutive threads read
// consecutive channels of consecutive voxels) and its coefficients in shared
// memory.
//
// K3's design (ops/normalization.py in_stats_plan computes its grid):
//  * 16-byte loads: a lane vector of 8 bf16 or 4 fp32 channels, 8 loads in
//    flight a thread, per-lane fp32 sum and sum-of-squares registers. With
//    C a multiple of the vector (G = C / VEC vectors a voxel) or dividing it
//    (G = 1), a thread whose stride is a multiple of G vectors meets the same
//    channels in every vector. Other widths, and a base that is not 16-byte
//    aligned, take the scalar route (VEC = 1, G = C) through the same code.
//  * A grid sized from the tensor's bytes, not its voxels: each sample's
//    rows (G vectors each) are cut into chunks so that a call gets about two
//    blocks an SM where the tensor is large enough, chunks of at least 4 KB,
//    and at most 16K floats of partials a sample to fold. The deep levels
//    (C 128-256 over 500-4000 voxels, batch 2) therefore spread over 64-128
//    blocks instead of the 2-8 that walked 256-512 rows each in series.
//  * Inside a block a fixed order: xor-shuffles over a warp's rows of the
//    same channels (G a power of two below 32), then shared memory, rows in
//    order.
//  * The fold: each block writes its partial, fences, and takes a ticket of
//    its sample; the block that takes the last ticket folds the sample's
//    chunks (float4 loads of 4 channels, a few lanes each, every lane's
//    chunks in order and the lanes combined in order) and resets the ticket
//    for the next call. No second launch.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte loads in flight a thread

// bf16 -> fp32 is exact: the bf16 bits are the top half of the fp32's.
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[1]) {
  v[0] = pmr::to_f32<T>(__ldg(p));
}

// Per-lane sums of (x - mu) and (x - mu)^2 over vectors v, v + stride, ...
// below v1 (in vectors of VEC elements from xb).
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const T* xb, long long v, long long v1,
                                           long long stride, const float (&mu)[VEC],
                                           float (&s)[VEC], float (&q)[VEC]) {
  for (; v + (kUnroll - 1) * stride < v1; v += kUnroll * stride) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec(xb + (v + u * stride) * VEC, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float d = x[u][l] - mu[l];
        s[l] += d;
        q[l] = fmaf(d, d, q[l]);
      }
  }
  for (; v < v1; v += stride) {
    float x[VEC];
    load_vec(xb + v * VEC, x);
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const float d = x[l] - mu[l];
      s[l] += d;
      q[l] = fmaf(d, d, q[l]);
    }
  }
}

// One sample's fold: stats from the chunk partials pb[k][0 / 1][c], VF
// channels a load (float4 where C % 4 == 0). J lanes a group of VF channels
// each sum chunks j, j + J, ... in order; lanes are then added in order.
// Uses kThreads * VF floats of each scratch array.
template <int VF>
__device__ __forceinline__ void fold_sample(const float* pb, float* st, int C, int nchunk,
                                            int spatial, int mode, float* sh_s, float* sh_q) {
  const int tid = threadIdx.x;
  const int Q = C / VF;
  const int J = Q >= kThreads ? 1 : kThreads / Q;
  const float inv_n = 1.f / (float)spatial;
  for (int q0 = 0; q0 < Q; q0 += kThreads / J) {
    const int qd = q0 + tid / J, j = tid % J;
    float s[VF], q[VF];
#pragma unroll
    for (int v = 0; v < VF; ++v) s[v] = q[v] = 0.f;
    if (qd < Q && tid < (kThreads / J) * J) {
#pragma unroll 4
      for (int k = j; k < nchunk; k += J) {
        const float* pk = pb + (size_t)k * 2 * C + qd * VF;
        if constexpr (VF == 4) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(pk));
          const float4 c = __ldcg(reinterpret_cast<const float4*>(pk + C));
          s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
          q[0] += c.x; q[1] += c.y; q[2] += c.z; q[3] += c.w;
        } else {
          s[0] += __ldcg(pk);
          q[0] += __ldcg(pk + C);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VF; ++v) {
      sh_s[tid * VF + v] = s[v];
      sh_q[tid * VF + v] = q[v];
    }
    __syncthreads();
    if (j == 0 && qd < Q) {
      for (int jj = 1; jj < J; ++jj)  // lane order
#pragma unroll
        for (int v = 0; v < VF; ++v) {
          s[v] += sh_s[(tid + jj) * VF + v];
          q[v] += sh_q[(tid + jj) * VF + v];
        }
#pragma unroll
      for (int v = 0; v < VF; ++v) {
        const int c = qd * VF + v;
        if (mode == 0) {
          const float mean = s[v] * inv_n;
          st[c] = mean;
          st[C + c] = fmaxf(q[v] * inv_n - mean * mean, 0.f);
        } else if (mode == 1) {
          st[c] = s[v] * inv_n;
        } else {
          st[C + c] = q[v] * inv_n;
        }
      }
    }
    __syncthreads();
  }
}

// Grid (nchunk, batch). Block (chunk, b) sums rows [chunk * chunk_rows,
// (chunk + 1) * chunk_rows) of sample b, a row being G vectors of VEC
// elements, into part[b][chunk][0 / 1][c]; the sample's last block folds.
// mode 0: one-pass mean and clamped variance; mode 1: mean only (first fp32
// pass); mode 2: centred variance about center's mean (second fp32 pass).
// stats is (B, 2, C): mean then var; tickets[b] is 0 on entry and on exit.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_stats_kernel(const T* __restrict__ x, const float* __restrict__ center,
                    float* __restrict__ part, float* __restrict__ stats,
                    unsigned int* __restrict__ tickets, int spatial, int channels, int groups,
                    long long rows, int chunk_rows, int mode) {
  __shared__ float sh_s[kThreads * VEC];
  __shared__ float sh_q[kThreads * VEC];
  __shared__ bool is_last;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int C = channels, G = groups;
  const T* xb = x + (size_t)b * spatial * C;
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  float* out = part + ((size_t)b * nchunk + chunk) * 2 * C;
  const float* cb = center != nullptr ? center + (size_t)b * 2 * C : nullptr;

  if (G <= kThreads) {
    const int R = kThreads / G;  // rows a pass
    const int cg = tid % G, r = tid / G;
    float s[VEC], q[VEC], mu[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      s[l] = q[l] = 0.f;
      mu[l] = cb != nullptr ? cb[(cg * VEC + l) % C] : 0.f;
    }
    if (r < R)
      accumulate<T, VEC>(xb, (r0 + r) * G + cg, r1 * G, (long long)R * G, mu, s, q);
    int nrows = R;  // rows of partial sums in shared memory, each G x VEC
    if (G < 32 && 32 % G == 0) {  // a warp's rows of one channel group
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        if (off < G) break;
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          s[l] += __shfl_xor_sync(0xffffffffu, s[l], off);
          q[l] += __shfl_xor_sync(0xffffffffu, q[l], off);
        }
      }
      if (lane < G)
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          sh_s[(warp * G + lane) * VEC + l] = s[l];
          sh_q[(warp * G + lane) * VEC + l] = q[l];
        }
      nrows = kThreads / 32;
    } else if (r < R) {
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        sh_s[tid * VEC + l] = s[l];
        sh_q[tid * VEC + l] = q[l];
      }
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float ts = 0.f, tq = 0.f;
      for (int row = 0; row < nrows; ++row) {
        if (VEC > C) {  // G == 1: lanes c, c + C, ... hold channel c
          for (int l = c; l < VEC; l += C) {
            ts += sh_s[row * VEC + l];
            tq += sh_q[row * VEC + l];
          }
        } else {
          ts += sh_s[(row * G + c / VEC) * VEC + c % VEC];
          tq += sh_q[(row * G + c / VEC) * VEC + c % VEC];
        }
      }
      out[c] = ts;
      out[C + c] = tq;
    }
  } else {  // wider than a block: each thread walks every row of its groups
    for (int cg = tid; cg < G; cg += kThreads) {
      float s[VEC], q[VEC], mu[VEC];
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        s[l] = q[l] = 0.f;
        mu[l] = cb != nullptr ? cb[cg * VEC + l] : 0.f;
      }
      accumulate<T, VEC>(xb, r0 * G + cg, r1 * G, G, mu, s, q);
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        out[cg * VEC + l] = s[l];
        out[C + cg * VEC + l] = q[l];
      }
    }
  }

  // The sample's last block to finish folds its chunks in a fixed order.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[b], 1u) == (unsigned int)nchunk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pb = part + (size_t)b * nchunk * 2 * C;
  float* st = stats + (size_t)b * 2 * C;
  if constexpr (VEC >= 4) {
    if (C % 4 == 0) {
      fold_sample<4>(pb, st, C, nchunk, spatial, mode, sh_s, sh_q);
    } else {
      fold_sample<1>(pb, st, C, nchunk, spatial, mode, sh_s, sh_q);
    }
  } else {
    fold_sample<1>(pb, st, C, nchunk, spatial, mode, sh_s, sh_q);
  }
  if (tid == 0) tickets[b] = 0u;
}

template <typename T, int VEC>
int stats_impl(const T* x, float* part, float* stats, unsigned int* tickets, int batch,
               int spatial, int channels, int chunk_rows, int nchunk, cudaStream_t stream) {
  const int groups = channels % VEC == 0 ? channels / VEC : 1;
  const long long rows = (long long)spatial * channels / VEC / groups;
  if (nchunk != (rows + chunk_rows - 1) / chunk_rows) return (int)cudaErrorInvalidValue;
  const dim3 grid(nchunk, batch);
  if (sizeof(T) == 2) {  // bf16: one pass
    in_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        x, nullptr, part, stats, tickets, spatial, channels, groups, rows, chunk_rows, 0);
  } else {  // fp32: mean, then centred variance
    in_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        x, nullptr, part, stats, tickets, spatial, channels, groups, rows, chunk_rows, 1);
    in_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        x, stats, part, stats, tickets, spatial, channels, groups, rows, chunk_rows, 2);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int stats_route(const void* x, void* part, void* stats, void* tickets, int batch, int spatial,
                int channels, int vec, int chunk_rows, int nchunk, cudaStream_t stream) {
  if (vec == VEC) {
    if (!(channels % VEC == 0 || VEC % channels == 0) ||
        ((long long)spatial * channels) % VEC != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return stats_impl<T, VEC>(static_cast<const T*>(x), static_cast<float*>(part),
                              static_cast<float*>(stats), static_cast<unsigned int*>(tickets),
                              batch, spatial, channels, chunk_rows, nchunk, stream);
  }
  if (vec == 1)
    return stats_impl<T, 1>(static_cast<const T*>(x), static_cast<float*>(part),
                            static_cast<float*>(stats), static_cast<unsigned int*>(tickets),
                            batch, spatial, channels, chunk_rows, nchunk, stream);
  return (int)cudaErrorInvalidValue;
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
// stats: (B, 2, C) fp32 output; tickets: B zeroed counters (left zeroed);
// vec: 1 (scalar route) or 16 bytes of elements; chunk_rows and nchunk from
// ops/normalization.py in_stats_plan.
extern "C" int pmr_in_stats(const void* x, void* part, void* stats, void* tickets, int dtype,
                            int batch, int spatial, int channels, int vec, int chunk_rows,
                            int nchunk, void* stream) {
  if (batch < 1 || batch > 65535 || spatial < 1 || channels < 1 || chunk_rows < 1 ||
      nchunk < 1 || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pmr::kBFloat16)
    return stats_route<__nv_bfloat16, 8>(x, part, stats, tickets, batch, spatial, channels,
                                         vec, chunk_rows, nchunk, s);
  if (dtype == pmr::kFloat32)
    return stats_route<float, 4>(x, part, stats, tickets, batch, spatial, channels, vec,
                                 chunk_rows, nchunk, s);
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
