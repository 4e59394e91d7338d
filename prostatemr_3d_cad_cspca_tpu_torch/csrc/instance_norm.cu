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
// writes it once.
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
//  * ptxas: the fp32 16-byte variant keeps one 32-bit value in an 8-byte
//    stack frame (16 bytes of spill traffic: stored once on entry, loaded
//    three times, each in the fold after the last-block test; the high word
//    of the sign-extended channel count that the 64-bit offsets use). Not
//    register pressure: it uses 48 of 255 registers. Unsigned offsets, 1/n
//    by __frcp_rn, or both, moved the spill (16 bytes either way) but did
//    not remove it, and 1/n from the host made the bf16 variant spill too;
//    it costs a few loads a block, so the code stays as it is.
//
// K4's design (ops/normalization.py in_apply_plan computes its grid): a
// stream at 16 bytes a lane, as K3 reads.
//  * 16-byte loads and stores: a vector of 8 bf16 or 4 fp32 channels,
//    kApplyUnroll vectors in flight a thread; consecutive threads take
//    consecutive vectors. A thread's first loads are issued before it builds
//    its coefficients, so on the small deep shapes (one round a thread) the
//    two latencies overlap.
//  * Fixed channels per thread: each sample's `active` threads are a
//    multiple of G (= C / VEC vectors a voxel, or 1 where C divides VEC), so
//    a thread's stride of `active` vectors keeps it on the same VEC channels
//    in every vector. It builds their coefficients once, in registers,
//    straight from stats, scale and bias: no per-element modulo, no shared
//    table, no __syncthreads.
//    Where C is a multiple of VEC, those channels are whole float4s of
//    stats, scale and bias, read by 16-byte loads (4 or 8 of them a thread
//    instead of 4 VEC scalar loads; on the deep shapes, where each thread
//    streams one round, building the coefficients is most of its time).
//  * Other widths, and a base that is not 16-byte aligned, take the scalar
//    route (VEC = 1, G = C) through the same code.
//  * A grid sized from bytes: about 32 KB in flight an SM where the tensor
//    is large (the level-0 shapes), and only as many blocks as one pass of
//    kApplyUnroll vectors a thread needs on the small deep shapes.
//
// K7 in_backward: the gradient of K3 + K4 (+ LReLU) with respect to x, in two
// launches. Replaces the backward of the retired fused_norm.py (git
// cef1717^, the custom_vjp's _vjp_bwd :181, which XLA ran). With g' the
// output gradient times the LReLU's slope (recomputed from x and the
// statistics exactly as K4 computed the pre-activation: no saved output) and
// xhat = (x - mean) * rstd:
//  * pass 1 (in_bwd_reduce_kernel, K3's grid, its fold and tickets): per
//    (batch, channel) fp32 sums of g' and g' * xhat, folded in chunk order;
//  * pass 2 (in_bwd_apply_kernel, K4's grid): dx = rstd * scale * (g' -
//    mean(g') - xhat * mean(g' xhat)), rounded once to x's type.
// The scale and bias gradients are pass 1's sums added over the batch
// (ops/normalization.py). Bound by bytes: pass 1 reads x and g, pass 2 reads
// them again and writes dx. 16-byte loads as K3 and K4 where the layout
// allows (both x and g aligned), else the scalar route.

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
        } else if (mode == 2) {
          st[C + c] = q[v] * inv_n;
        } else {  // K7's pass 1: the sums themselves
          st[c] = s[v];
          st[C + c] = q[v];
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

// 16-byte (or one-element) stores of VEC fp32 values rounded to T.
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[1]) {
  *p = pmr::from_f32<T>(v[0]);
}

constexpr int kApplyUnroll = 4;  // vectors in flight a thread

// Grid (blocks a sample, batch). Thread i < active of sample b applies the
// coefficients of channels ((i % groups) * VEC + l) % C, l < VEC, to vectors
// i, i + active, ... of the sample (`active` is a multiple of `groups`),
// kApplyUnroll of them a round.
// fp32: y = (x - mean) * a + bias; bf16: y = x * a' + b' (a', b' rounded to
// bf16); a = rsqrt(var + eps) * scale; then LReLU(0.1) on request.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ y, int per_batch, int channels, int groups, int active,
                    float eps, int lrelu, int coef_vec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= active) return;
  const int b = blockIdx.y, C = channels;
  const long long nvec = per_batch / VEC, stride = active;
  const T* xb = x + (size_t)b * per_batch;
  T* yb = y + (size_t)b * per_batch;
  // One round: vectors v + k * stride (k < kApplyUnroll) that lie in the
  // sample. The first round's loads are in flight while the coefficients
  // are built.
  float u[kApplyUnroll][VEC];
  auto load_round = [&](long long v) {
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k)
      if (v + k * stride < nvec) load_vec(xb + (v + k * stride) * VEC, u[k]);
  };
  long long v = i;
  load_round(v);

  const float* st = stats + (size_t)b * 2 * C;
  const int ch0 = (i % groups) * VEC;
  float mean[VEC], var[VEC], sc[VEC], bi[VEC];
  bool loaded = false;
  if constexpr (VEC % 4 == 0) {
    if (coef_vec) {
#pragma unroll
      for (int q = 0; q < VEC; q += 4) {
        load_vec(st + ch0 + q, reinterpret_cast<float(&)[4]>(mean[q]));
        load_vec(st + C + ch0 + q, reinterpret_cast<float(&)[4]>(var[q]));
        load_vec(scale + ch0 + q, reinterpret_cast<float(&)[4]>(sc[q]));
        load_vec(bias + ch0 + q, reinterpret_cast<float(&)[4]>(bi[q]));
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const int ch = (ch0 + l) % C;
      mean[l] = st[ch];
      var[l] = st[C + ch];
      sc[l] = scale[ch];
      bi[l] = bias[ch];
    }
  }
  float center[VEC], a[VEC], c[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    const float av = rsqrtf(var[l] + eps) * sc[l];
    if (sizeof(T) == 4) {
      center[l] = mean[l];
      a[l] = av;
      c[l] = bi[l];
    } else {
      const float bb = bi[l] - mean[l] * av;
      center[l] = 0.f;
      a[l] = pmr::to_f32<T>(pmr::from_f32<T>(av));
      c[l] = pmr::to_f32<T>(pmr::from_f32<T>(bb));
    }
  }
  while (true) {
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) {
      if (v + k * stride >= nvec) continue;
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float r = fmaf(u[k][l] - center[l], a[l], c[l]);
        u[k][l] = lrelu && r < 0.f ? 0.1f * r : r;
      }
      store_vec(yb + (v + k * stride) * VEC, u[k]);
    }
    v += kApplyUnroll * stride;
    if (v >= nvec) break;
    load_round(v);
  }
}

template <typename T, int VEC>
int apply_impl(const void* x, const float* stats, const float* scale, const float* bias,
               void* y, int batch, int per_batch, int channels, float eps, int lrelu,
               int blocks, int active, int coef_vec, cudaStream_t stream) {
  const int groups = channels % VEC == 0 ? channels / VEC : 1;
  if (active < groups || active % groups != 0 || active > blocks * kThreads)
    return (int)cudaErrorInvalidValue;
  in_apply_kernel<T, VEC><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, scale, bias, static_cast<T*>(y), per_batch, channels,
      groups, active, eps, lrelu, coef_vec);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int apply_route(const void* x, const float* stats, const float* scale, const float* bias,
                void* y, int batch, int per_batch, int channels, float eps, int lrelu, int vec,
                int blocks, int active, cudaStream_t stream) {
  if (vec == VEC) {
    if (!(channels % VEC == 0 || VEC % channels == 0) || per_batch % VEC != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    // Coefficients in 16-byte loads where each thread's VEC channels are
    // whole float4s of aligned arrays (C a multiple of VEC).
    const int coef_vec = VEC % 4 == 0 && channels % VEC == 0 &&
                         (reinterpret_cast<uintptr_t>(stats) | reinterpret_cast<uintptr_t>(scale) |
                          reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
    return apply_impl<T, VEC>(x, stats, scale, bias, y, batch, per_batch, channels, eps, lrelu,
                              blocks, active, coef_vec, stream);
  }
  if (vec == 1)
    return apply_impl<T, 1>(x, stats, scale, bias, y, batch, per_batch, channels, eps, lrelu,
                            blocks, active, 0, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- K7
// Per channel of K7: the forward's statistics and, for the LReLU's slope,
// K4's own pre-activation coefficients (r = (x - center) * a + c, as K4).
template <typename T>
__device__ __forceinline__ void bwd_coef(const float* st, const float* scale, const float* bias,
                                         int C, int ch, float eps, float& mean, float& rstd,
                                         float& center, float& a, float& c) {
  mean = st[ch];
  rstd = rsqrtf(st[C + ch] + eps);
  const float av = rstd * scale[ch];
  if (sizeof(T) == 4) {
    center = mean;
    a = av;
    c = bias[ch];
  } else {
    center = 0.f;
    a = pmr::to_f32<T>(pmr::from_f32<T>(av));
    c = pmr::to_f32<T>(pmr::from_f32<T>(bias[ch] - mean * av));
  }
}

// g' = g, times 0.1 where the forward's pre-activation was negative (lrelu).
__device__ __forceinline__ float slope_grad(float g, float x, float center, float a, float c,
                                            int lrelu) {
  return lrelu && fmaf(x - center, a, c) < 0.f ? 0.1f * g : g;
}

constexpr int kBwdUnroll = 4;  // vector pairs (x, g) in flight a thread

// Per-lane sums of g' and g' * xhat over vectors v, v + stride, ... below v1.
template <typename T, int VEC>
__device__ __forceinline__ void accumulate_bwd(const T* xb, const T* gb, long long v,
                                               long long v1, long long stride,
                                               const float (&k)[5][VEC], int lrelu,
                                               float (&s)[VEC], float (&q)[VEC]) {
  for (; v < v1; v += kBwdUnroll * stride) {
    float x[kBwdUnroll][VEC], g[kBwdUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (v + u * stride < v1) {
        load_vec(xb + (v + u * stride) * VEC, x[u]);
        load_vec(gb + (v + u * stride) * VEC, g[u]);
      }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (v + u * stride >= v1) continue;
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float gg = slope_grad(g[u][l], x[u][l], k[2][l], k[3][l], k[4][l], lrelu);
        s[l] += gg;
        q[l] = fmaf(gg, (x[u][l] - k[0][l]) * k[1][l], q[l]);
      }
    }
  }
}

// K7 pass 1, shaped like K3: grid (nchunk, batch); block (chunk, b) sums g'
// and g' * xhat over rows [chunk * chunk_rows, ...) of sample b into
// part[b][chunk][0 / 1][c]; the sample's last block folds the chunks in
// order into sums (B, 2, C). tickets[b] is 0 on entry and on exit.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ stats, const float* __restrict__ scale,
                         const float* __restrict__ bias, float* __restrict__ part,
                         float* __restrict__ sums, unsigned int* __restrict__ tickets,
                         int spatial, int channels, int groups, long long rows, int chunk_rows,
                         float eps, int lrelu) {
  __shared__ float sh_s[kThreads * VEC];
  __shared__ float sh_q[kThreads * VEC];
  __shared__ bool is_last;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x;
  const int C = channels, G = groups;
  const T* xb = x + (size_t)b * spatial * C;
  const T* gb = g + (size_t)b * spatial * C;
  const float* st = stats + (size_t)b * 2 * C;
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  float* out = part + ((size_t)b * nchunk + chunk) * 2 * C;

  // G <= kThreads: column cg = tid % G, its R threads share the rows, then
  // the block adds them up in row order (one pass). Wider: thread columns
  // cg = tid, tid + kThreads, ..., each walking every row in order.
  const int R = G <= kThreads ? kThreads / G : 1;
  for (int cg = G <= kThreads ? tid % G : tid; cg < G; cg += G <= kThreads ? G : kThreads) {
    const int r = G <= kThreads ? tid / G : 0;
    float k[5][VEC], s[VEC], q[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      bwd_coef<T>(st, scale, bias, C, (cg * VEC + l) % C, eps, k[0][l], k[1][l], k[2][l],
                  k[3][l], k[4][l]);
      s[l] = q[l] = 0.f;
    }
    if (r < R)
      accumulate_bwd<T, VEC>(xb, gb, (r0 + r) * G + cg, r1 * G, (long long)R * G, k, lrelu,
                             s, q);
    if (G > kThreads) {
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        out[cg * VEC + l] = s[l];
        out[C + cg * VEC + l] = q[l];
      }
      continue;
    }
    if (r < R)
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        sh_s[tid * VEC + l] = s[l];
        sh_q[tid * VEC + l] = q[l];
      }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {  // rows in order
      float ts = 0.f, tq = 0.f;
      for (int row = 0; row < R; ++row) {
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
    break;  // G <= kThreads: one pass covers every column
  }

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[b], 1u) == (unsigned int)nchunk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pb = part + (size_t)b * nchunk * 2 * C;
  float* sb = sums + (size_t)b * 2 * C;
  if constexpr (VEC >= 4) {
    if (C % 4 == 0) {
      fold_sample<4>(pb, sb, C, nchunk, spatial, 3, sh_s, sh_q);
    } else {
      fold_sample<1>(pb, sb, C, nchunk, spatial, 3, sh_s, sh_q);
    }
  } else {
    fold_sample<1>(pb, sb, C, nchunk, spatial, 3, sh_s, sh_q);
  }
  if (tid == 0) tickets[b] = 0u;
}

// K7 pass 2, shaped like K4: grid (blocks a sample, batch); thread i < active
// of sample b keeps channels ((i % groups) * VEC + l) % C and writes
// dx = rstd * scale * (g' - sum(g') / n - xhat * sum(g' xhat) / n) for
// vectors i, i + active, ... of the sample.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ stats, const float* __restrict__ sums,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ dx, int per_batch, int channels, int groups, int active,
                        float eps, int lrelu) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= active) return;
  const int b = blockIdx.y, C = channels;
  const long long nvec = per_batch / VEC, stride = active;
  const size_t base = (size_t)b * per_batch;
  const float* st = stats + (size_t)b * 2 * C;
  const float* sm = sums + (size_t)b * 2 * C;
  const float inv_n = 1.f / (float)(per_batch / C);
  const int ch0 = (i % groups) * VEC;
  float k[5][VEC], kx[VEC], m1[VEC], m2[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    const int ch = (ch0 + l) % C;
    bwd_coef<T>(st, scale, bias, C, ch, eps, k[0][l], k[1][l], k[2][l], k[3][l], k[4][l]);
    kx[l] = k[1][l] * scale[ch];
    m1[l] = sm[ch] * inv_n;
    m2[l] = sm[C + ch] * inv_n;
  }
  for (long long v = i; v < nvec; v += kApplyUnroll * stride) {
    float xv[kApplyUnroll][VEC], gv[kApplyUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u)
      if (v + u * stride < nvec) {
        load_vec(x + base + (v + u * stride) * VEC, xv[u]);
        load_vec(g + base + (v + u * stride) * VEC, gv[u]);
      }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (v + u * stride >= nvec) continue;
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float gg = slope_grad(gv[u][l], xv[u][l], k[2][l], k[3][l], k[4][l], lrelu);
        const float xh = (xv[u][l] - k[0][l]) * k[1][l];
        gv[u][l] = kx[l] * (gg - m1[l] - xh * m2[l]);
      }
      store_vec(dx + base + (v + u * stride) * VEC, gv[u]);
    }
  }
}

template <typename T, int VEC>
int backward_impl(const void* x, const void* g, const float* stats, const float* scale,
                  const float* bias, float* part, float* sums, unsigned int* tickets, void* dx,
                  int batch, int spatial, int channels, float eps, int lrelu, int chunk_rows,
                  int nchunk, int blocks, int active, cudaStream_t stream) {
  const int groups = channels % VEC == 0 ? channels / VEC : 1;
  const long long rows = (long long)spatial * channels / VEC / groups;
  if (nchunk != (rows + chunk_rows - 1) / chunk_rows || active < groups ||
      active % groups != 0 || active > blocks * kThreads)
    return (int)cudaErrorInvalidValue;
  in_bwd_reduce_kernel<T, VEC><<<dim3(nchunk, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, scale, bias, part, sums,
      tickets, spatial, channels, groups, rows, chunk_rows, eps, lrelu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_bwd_apply_kernel<T, VEC><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, sums, scale, bias,
      static_cast<T*>(dx), spatial * channels, channels, groups, active, eps, lrelu);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int backward_route(const void* x, const void* g, const float* stats, const float* scale,
                   const float* bias, float* part, float* sums, unsigned int* tickets, void* dx,
                   int batch, int spatial, int channels, float eps, int lrelu, int vec,
                   int chunk_rows, int nchunk, int blocks, int active, cudaStream_t stream) {
  if (vec == VEC) {
    if (!(channels % VEC == 0 || VEC % channels == 0) ||
        ((long long)spatial * channels) % VEC != 0 ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
         reinterpret_cast<uintptr_t>(dx)) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return backward_impl<T, VEC>(x, g, stats, scale, bias, part, sums, tickets, dx, batch,
                                 spatial, channels, eps, lrelu, chunk_rows, nchunk, blocks,
                                 active, stream);
  }
  if (vec == 1)
    return backward_impl<T, 1>(x, g, stats, scale, bias, part, sums, tickets, dx, batch,
                               spatial, channels, eps, lrelu, chunk_rows, nchunk, blocks,
                               active, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K7: x, g, dx (B, spatial, C) contiguous; stats (B, 2, C) from K3; scale,
// bias (C,) fp32; part (B, nchunk, 2, C) fp32 scratch; sums (B, 2, C) fp32
// output [sum g', sum g' * xhat]; tickets: B zeroed counters (left zeroed).
// vec, chunk_rows, nchunk from ops/normalization.py in_stats_plan (of x and
// g together); blocks, active from in_apply_plan. Two launches on `stream`.
extern "C" int pmr_in_backward(const void* x, const void* g, const void* stats,
                               const void* scale, const void* bias, void* part, void* sums,
                               void* tickets, void* dx, int dtype, int batch, int spatial,
                               int channels, float eps, int lrelu, int vec, int chunk_rows,
                               int nchunk, int blocks, int active, void* stream) {
  if (batch < 1 || batch > 65535 || spatial < 1 || channels < 1 || chunk_rows < 1 ||
      nchunk < 1 || blocks < 1 || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(part);
  float* su = static_cast<float*>(sums);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  if (dtype == pmr::kBFloat16)
    return backward_route<__nv_bfloat16, 8>(x, g, st, sc, bi, pa, su, tk, dx, batch, spatial,
                                            channels, eps, lrelu, vec, chunk_rows, nchunk,
                                            blocks, active, s);
  if (dtype == pmr::kFloat32)
    return backward_route<float, 4>(x, g, st, sc, bi, pa, su, tk, dx, batch, spatial, channels,
                                    eps, lrelu, vec, chunk_rows, nchunk, blocks, active, s);
  return (int)cudaErrorInvalidValue;
}

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

// x, y: (B, per_batch) contiguous with channels fastest; stats (B, 2, C);
// vec: 1 (scalar route) or 16 bytes of elements; blocks (a sample) and
// active (threads a sample) from ops/normalization.py in_apply_plan.
extern "C" int pmr_in_apply(const void* x, const void* stats, const void* scale,
                            const void* bias, void* y, int dtype, int batch, int per_batch,
                            int channels, float eps, int lrelu, int vec, int blocks,
                            int active, void* stream) {
  if (batch < 1 || per_batch < 1 || channels < 1 || batch > 65535 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == pmr::kBFloat16)
    return apply_route<__nv_bfloat16, 8>(x, st, sc, bi, y, batch, per_batch, channels, eps,
                                         lrelu, vec, blocks, active, s);
  if (dtype == pmr::kFloat32)
    return apply_route<float, 4>(x, st, sc, bi, y, batch, per_batch, channels, eps, lrelu,
                                 vec, blocks, active, s);
  return (int)cudaErrorInvalidValue;
}
