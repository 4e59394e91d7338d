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
//  * pass 1 (in_bwd_reduce_kernel): per (batch, channel) fp32 sums of g' and
//    g' * xhat, each chunk's partials taken in a fixed order (K3's shuffles
//    and rows) and folded in chunk order by the sample's last block (K3's
//    tickets and fold);
//  * pass 2 (in_bwd_apply_kernel): dx = rstd * scale * (g' - mean(g') -
//    xhat * mean(g' xhat)), rounded once to x's type.
// The scale and bias gradients are pass 1's sums added over the batch
// (ops/normalization.py). Bound by bytes: dx needs each (b, c)'s sums, so x
// and g are read twice (where they exceed the 50 MB L2, from HBM the second
// time too) and dx written once.
// K7's design (ops/normalization.py in_backward_plan computes its grid):
//  * Registers: at most 64 a thread (launch bounds of four 256-thread blocks
//    an SM, 32 warps), no spill: a 16-byte stream needs many loads in flight
//    on each SM, and per-lane coefficients with x and g widened to fp32 took
//    146-158 registers, one block an SM. The coefficients live in a
//    per-block shared table built once from stats, scale, bias
//    (and pass 1's sums): three floats a channel for pass 1 (mean, and K4's
//    a, c for the slope test), six for pass 2 (also kx, p, q of dx =
//    fma(kx, g', fma(p, x - mean, q))). A thread reads its float4 of them a
//    row step at a time (volatile shared loads, so the compiler cannot hoist
//    VEC x 6 of them into registers) and applies them to both of its
//    vectors in flight; x and g stay packed as loaded (a bf16 lane is widened
//    where it is used); sum g' * (x - mean) is scaled by rstd once per chunk.
//    The (x - mean) term serves xhat and, in fp32, K4's slope test.
//  * One grid for both passes, (nchunk, batch): about one wave at four
//    blocks an SM, each chunk at least 4 KB and a sample's partials at most
//    16K floats. Threads of a row step: column group cg = tid % G (G = C /
//    VEC vectors a row, 1 where C divides VEC) and row r = tid / G, so a
//    thread keeps its channels and a warp reads consecutive vectors.
//  * Pass 2 re-reads from L2: block (chunk, b) of pass 2 owns the rows of
//    pass 1's chunk and walks them from the last row down, so the rows pass
//    1 read last, still in L2 where x + g exceeds it, are read first; its
//    loads and its dx stores are marked evict-first (ld/st .cs), since K7
//    touches neither again.
//  * 16-byte loads as K3 and K4 where the layout allows (x, g and dx
//    aligned, C a multiple of VEC or dividing it), else the scalar route
//    (VEC = 1, G = C) through the same code; C at most kBwdMaxChannels.
//  * Measured slower on an H100 and not kept: pass 1's loads through a
//    cp.async ring in shared memory (more bytes in flight, no registers),
//    pass 1's chunk heads loaded evict-first, and each thread's first loads
//    issued before the block builds its table (PERF.md, section 6).

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
// each sum chunks j, j + J, ... in order; lanes are then added in order,
// with kFp64Lanes (K7) in fp64 and rounded once: K7's sums are what the
// scale and bias gradients take, and a channel's total can be small beside
// the lanes' sums, whose fp32 rounding it would then carry. Uses kThreads *
// VF floats of each scratch array.
template <int VF, bool kFp64Lanes>
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
      if constexpr (kFp64Lanes) {
#pragma unroll
        for (int v = 0; v < VF; ++v) {
          double ds = s[v], dq = q[v];
          for (int jj = 1; jj < J; ++jj) {  // lane order
            ds += (double)sh_s[(tid + jj) * VF + v];
            dq += (double)sh_q[(tid + jj) * VF + v];
          }
          s[v] = (float)ds;
          q[v] = (float)dq;
        }
      } else {
        for (int jj = 1; jj < J; ++jj)  // lane order
#pragma unroll
          for (int v = 0; v < VF; ++v) {
            s[v] += sh_s[(tid + jj) * VF + v];
            q[v] += sh_q[(tid + jj) * VF + v];
          }
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
      fold_sample<4, false>(pb, st, C, nchunk, spatial, mode, sh_s, sh_q);
    } else {
      fold_sample<1, false>(pb, st, C, nchunk, spatial, mode, sh_s, sh_q);
    }
  } else {
    fold_sample<1, false>(pb, st, C, nchunk, spatial, mode, sh_s, sh_q);
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
constexpr int kBwdMinBlocks = 4;        // blocks an SM: 256 threads at <= 64 registers
constexpr int kBwdUnroll = 2;           // vector pairs (x, g) in flight a thread
constexpr int kBwdMaxChannels = 2048;   // widest coefficient table (pass 2: 6 x 8 KB)
constexpr int kBwdReduceCoefs = 3;      // pass 1's table: mean, a, c
constexpr int kBwdApplyCoefs = 6;       // pass 2's: mean, a, c, kx, p, q

// A vector of VEC elements as loaded, unconverted: 16 bytes as four words,
// or one element's bits.
template <typename T, int VEC>
struct Raw {
  uint32_t w[VEC * sizeof(T) >= 4 ? VEC * sizeof(T) / 4 : 1];
};

// kLast: the last read of these bytes (pass 2), marked evict-first in L2.
template <bool kLast, typename T, int VEC>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, VEC>& r) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint4 u;
    if constexpr (kLast) u = __ldcs(q); else u = __ldg(q);
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
  } else if constexpr (sizeof(T) == 4) {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    if constexpr (kLast) r.w[0] = __ldcs(q); else r.w[0] = __ldg(q);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    if constexpr (kLast) r.w[0] = __ldcs(q); else r.w[0] = __ldg(q);
  }
}

// Lane l of a raw vector in fp32 (exact: bf16 bits are the top half of the
// fp32's). l is a constant after unrolling, so the word is a register.
template <typename T, int VEC>
__device__ __forceinline__ float lane(const Raw<T, VEC>& r, int l) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[l]);
  } else if constexpr (VEC == 1) {
    return __uint_as_float(r.w[0] << 16);
  } else {
    return __uint_as_float(l % 2 ? r.w[l / 2] & 0xffff0000u : r.w[l / 2] << 16);
  }
}

// Lanes h * L .. h * L + L - 1 of r set to o, rounded once to T.
template <typename T, int VEC, int L>
__device__ __forceinline__ void put_lanes(Raw<T, VEC>& r, int h, const float (&o)[L]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < L; ++i) r.w[h * L + i] = __float_as_uint(o[i]);
  } else if constexpr (VEC == 1) {
    r.w[0] = __bfloat16_as_ushort(__float2bfloat16(o[0]));
  } else {
#pragma unroll
    for (int i = 0; i < L; i += 2) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(o[i], o[i + 1]);
      r.w[(h * L + i) / 2] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
}

// Streaming store: dx is not read again by K7.
template <typename T, int VEC>
__device__ __forceinline__ void store_raw(T* p, const Raw<T, VEC>& r) {
  if constexpr (VEC * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]));
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<unsigned int*>(p), r.w[0]);
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p), static_cast<unsigned short>(r.w[0]));
  }
}

// Coefficients from the block's shared table, L floats at p. Volatile so
// that they are read where they are used, a row step at a time: hoisted out
// of the loop they would be VEC x 6 live registers.
__device__ __forceinline__ void lds(const float* p, float (&v)[4]) {
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void lds(const float* p, float (&v)[1]) {
  asm volatile("ld.volatile.shared.f32 %0, [%1];\n"
               : "=f"(v[0])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Lanes a table load covers: a float4 of a 16-byte vector, or the one.
template <int VEC>
constexpr int kTabLanes = VEC >= 4 ? 4 : 1;

// The block's table: ncoef rows of nt = G * VEC floats; lane l of column
// group cg (channel (cg * VEC + l) % C) at ((l / L) * G + cg) * L + l % L,
// so that a quarter-warp's float4 reads of consecutive groups are
// consecutive 16 bytes. Per channel, from the forward's statistics: mean
// and K4's pre-activation coefficients a, c (fp32: r = fmaf(x - mean, a,
// c), c = bias; bf16: r = fmaf(x, a', c') with a', c' rounded to bf16, as
// K4); with sums (pass 2) also dx = fmaf(kx, g', fmaf(p, x - mean, q)),
// kx = rstd * scale, p = -kx * rstd * sum(g' xhat) / n, q = -kx * sum(g') / n.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_table(float* tab, int nt, int G, int C, const float* st,
                                          const float* sm, const float* scale,
                                          const float* bias, float eps, float inv_n) {
  constexpr int L = kTabLanes<VEC>;
  for (int j = threadIdx.x; j < nt; j += kThreads) {
    const int cg = j / VEC, l = j % VEC, ch = j % C;
    const int at = ((l / L) * G + cg) * L + l % L;
    const float mean = st[ch], rstd = rsqrtf(st[C + ch] + eps), av = rstd * scale[ch];
    tab[at] = mean;
    if (sizeof(T) == 4) {
      tab[nt + at] = av;
      tab[2 * nt + at] = bias[ch];
    } else {
      tab[nt + at] = pmr::to_f32<T>(pmr::from_f32<T>(av));
      tab[2 * nt + at] = pmr::to_f32<T>(pmr::from_f32<T>(bias[ch] - mean * av));
    }
    if (sm != nullptr) {
      const float kx = rstd * scale[ch];
      tab[3 * nt + at] = kx;
      tab[4 * nt + at] = -kx * rstd * (sm[C + ch] * inv_n);
      tab[5 * nt + at] = -kx * (sm[ch] * inv_n);
    }
  }
}

// g' = g, times 0.1 where K4's pre-activation was negative (lrelu): fp32
// fmaf(x - mean, a, c), bf16 fmaf(x, a', c'), as K4 computes it.
template <typename T>
__device__ __forceinline__ float slope_grad(float g, float x, float d, float a, float c,
                                            int lrelu) {
  const float r = sizeof(T) == 4 ? fmaf(d, a, c) : fmaf(x, a, c);
  return lrelu && r < 0.f ? 0.1f * g : g;
}

// Pass 1's stream: per-lane sums of g' and g' * (x - mean) over vectors v,
// v + stride, ... below v1 (of VEC elements from xb, gb), column group cg.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_accumulate(const T* xb, const T* gb, const float* tab,
                                               int nt, int G, int cg, int v, int v1, int stride,
                                               int lrelu, float (&s)[VEC], float (&q)[VEC]) {
  constexpr int L = kTabLanes<VEC>;
  for (; v < v1; v += kBwdUnroll * stride) {
    Raw<T, VEC> xr[kBwdUnroll], gr[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (v + u * stride < v1) {
        load_raw<false>(xb + (size_t)(v + u * stride) * VEC, xr[u]);
        load_raw<false>(gb + (size_t)(v + u * stride) * VEC, gr[u]);
      }
#pragma unroll
    for (int h = 0; h < VEC / L; ++h) {
      const float* t = tab + (h * G + cg) * L;
      float mean[L], a[L], c[L];
      lds(t, mean);
      lds(t + nt, a);
      lds(t + 2 * nt, c);
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (v + u * stride >= v1) continue;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int l = h * L + i;
          const float xv = lane(xr[u], l), d = xv - mean[i];
          const float gg = slope_grad<T>(lane(gr[u], l), xv, d, a[i], c[i], lrelu);
          s[l] += gg;
          q[l] = fmaf(gg, d, q[l]);
        }
      }
    }
  }
}

// Pass 2's stream, backwards: dx for vectors v, v - stride, ... down to v0.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_apply(const T* xb, const T* gb, T* dxb, const float* tab,
                                          int nt, int G, int cg, int v, int v0, int stride,
                                          int lrelu) {
  constexpr int L = kTabLanes<VEC>;
  for (; v >= v0; v -= kBwdUnroll * stride) {
    Raw<T, VEC> xr[kBwdUnroll], gr[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (v - u * stride >= v0) {
        load_raw<true>(xb + (size_t)(v - u * stride) * VEC, xr[u]);
        load_raw<true>(gb + (size_t)(v - u * stride) * VEC, gr[u]);
      }
#pragma unroll
    for (int h = 0; h < VEC / L; ++h) {
      const float* t = tab + (h * G + cg) * L;
      float mean[L], a[L], c[L], kx[L], p[L], q[L];
      lds(t, mean);
      lds(t + nt, a);
      lds(t + 2 * nt, c);
      lds(t + 3 * nt, kx);
      lds(t + 4 * nt, p);
      lds(t + 5 * nt, q);
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (v - u * stride < v0) continue;
        float o[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int l = h * L + i;
          const float xv = lane(xr[u], l), d = xv - mean[i];
          const float gg = slope_grad<T>(lane(gr[u], l), xv, d, a[i], c[i], lrelu);
          o[i] = fmaf(kx[i], gg, fmaf(p[i], d, q[i]));
        }
        put_lanes(gr[u], h, o);  // g's lanes h * L.. are spent: dx takes them
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (v - u * stride >= v0) store_raw(dxb + (size_t)(v - u * stride) * VEC, gr[u]);
  }
}

// K7 pass 1: grid (nchunk, batch); block (chunk, b) sums g' and g' * xhat
// over rows [chunk * chunk_rows, ...) of sample b, ascending, into
// part[b][chunk][0 / 1][c]; the sample's last block folds the chunks in
// order into sums (B, 2, C). tickets[b] is 0 on entry and on exit. Dynamic
// shared memory: the table, kBwdReduceCoefs x G x VEC floats.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    in_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ stats, const float* __restrict__ scale,
                         const float* __restrict__ bias, float* __restrict__ part,
                         float* __restrict__ sums, unsigned int* __restrict__ tickets,
                         int spatial, int channels, int groups, int rows, int chunk_rows,
                         float eps, int lrelu) {
  extern __shared__ __align__(16) float tab[];
  __shared__ float sh_s[kThreads * VEC];
  __shared__ float sh_q[kThreads * VEC];
  __shared__ bool is_last;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x, lane_id = tid % 32, warp = tid / 32;
  const int C = channels, G = groups, nt = G * VEC;
  const T* xb = x + (size_t)b * spatial * C;
  const T* gb = g + (size_t)b * spatial * C;
  const float* st = stats + (size_t)b * 2 * C;
  const int r0 = chunk * chunk_rows;
  const int r1 = (int)min((long long)rows, (long long)r0 + chunk_rows);
  float* out = part + ((size_t)b * nchunk + chunk) * 2 * C;
  bwd_table<T, VEC>(tab, nt, G, C, st, nullptr, scale, bias, eps, 0.f);
  __syncthreads();

  if (G <= kThreads) {  // column cg = tid % G; its R threads share the rows
    const int R = kThreads / G, cg = tid % G, r = tid / G;
    float s[VEC], q[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) s[l] = q[l] = 0.f;
    if (r < R)
      bwd_accumulate<T, VEC>(xb, gb, tab, nt, G, cg, (r0 + r) * G + cg, r1 * G, R * G, lrelu,
                             s, q);
    int nrows = R;  // rows of partial sums in shared memory, each G x VEC
    if (G < 32 && 32 % G == 0) {  // a warp's rows of one column group
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        if (off < G) break;
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          s[l] += __shfl_xor_sync(0xffffffffu, s[l], off);
          q[l] += __shfl_xor_sync(0xffffffffu, q[l], off);
        }
      }
      if (lane_id < G)
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          sh_s[(warp * G + lane_id) * VEC + l] = s[l];
          sh_q[(warp * G + lane_id) * VEC + l] = q[l];
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
    for (int c = tid; c < C; c += kThreads) {  // rows in order
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
      out[C + c] = tq * rsqrtf(st[C + c] + eps);  // sum g' (x - mean) * rstd
    }
  } else {  // wider than a block: each thread walks every row of its groups
    for (int cg = tid; cg < G; cg += kThreads) {
      float s[VEC], q[VEC];
#pragma unroll
      for (int l = 0; l < VEC; ++l) s[l] = q[l] = 0.f;
      bwd_accumulate<T, VEC>(xb, gb, tab, nt, G, cg, r0 * G + cg, r1 * G, G, lrelu, s, q);
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const int c = cg * VEC + l;
        out[c] = s[l];
        out[C + c] = q[l] * rsqrtf(st[C + c] + eps);
      }
    }
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
      fold_sample<4, true>(pb, sb, C, nchunk, spatial, 3, sh_s, sh_q);
    } else {
      fold_sample<1, true>(pb, sb, C, nchunk, spatial, 3, sh_s, sh_q);
    }
  } else {
    fold_sample<1, true>(pb, sb, C, nchunk, spatial, 3, sh_s, sh_q);
  }
  if (tid == 0) tickets[b] = 0u;
}

// K7 pass 2: pass 1's grid; block (chunk, b) writes dx over the rows of
// pass 1's chunk, descending from its last row: the rows pass 1 read last,
// still in L2, are read first. Dynamic shared memory: the table,
// kBwdApplyCoefs x G x VEC floats.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ stats, const float* __restrict__ sums,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ dx, int spatial, int channels, int groups, int rows,
                        int chunk_rows, float eps, int lrelu) {
  extern __shared__ __align__(16) float tab[];
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int C = channels, G = groups, nt = G * VEC;
  const size_t base = (size_t)b * spatial * C;
  const int r0 = chunk * chunk_rows;
  const int r1 = (int)min((long long)rows, (long long)r0 + chunk_rows);
  bwd_table<T, VEC>(tab, nt, G, C, stats + (size_t)b * 2 * C, sums + (size_t)b * 2 * C, scale,
                    bias, eps, 1.f / (float)spatial);
  __syncthreads();
  if (G <= kThreads) {  // row step j: rows [r1 - (j + 1) R, r1 - j R), thread r its r-th
    const int R = kThreads / G, cg = tid % G, r = tid / G;
    if (r < R)
      bwd_apply<T, VEC>(x + base, g + base, dx + base, tab, nt, G, cg, (r1 - R + r) * G + cg,
                        r0 * G, R * G, lrelu);
  } else {
    for (int cg = tid; cg < G; cg += kThreads)
      bwd_apply<T, VEC>(x + base, g + base, dx + base, tab, nt, G, cg, (r1 - 1) * G + cg,
                        r0 * G, G, lrelu);
  }
}

template <typename T, int VEC>
int backward_impl(const void* x, const void* g, const float* stats, const float* scale,
                  const float* bias, float* part, float* sums, unsigned int* tickets, void* dx,
                  int batch, int spatial, int channels, float eps, int lrelu, int chunk_rows,
                  int nchunk, cudaStream_t stream) {
  const int groups = channels % VEC == 0 ? channels / VEC : 1;
  const int rows = (int)((long long)spatial * channels / VEC / groups);
  if (nchunk != ((long long)rows + chunk_rows - 1) / chunk_rows) return (int)cudaErrorInvalidValue;
  const size_t table = (size_t)groups * VEC * sizeof(float);
  const dim3 grid(nchunk, batch);
  in_bwd_reduce_kernel<T, VEC><<<grid, kThreads, kBwdReduceCoefs * table, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, scale, bias, part, sums,
      tickets, spatial, channels, groups, rows, chunk_rows, eps, lrelu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_bwd_apply_kernel<T, VEC><<<grid, kThreads, kBwdApplyCoefs * table, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, sums, scale, bias,
      static_cast<T*>(dx), spatial, channels, groups, rows, chunk_rows, eps, lrelu);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int backward_route(const void* x, const void* g, const float* stats, const float* scale,
                   const float* bias, float* part, float* sums, unsigned int* tickets, void* dx,
                   int batch, int spatial, int channels, float eps, int lrelu, int vec,
                   int chunk_rows, int nchunk, cudaStream_t stream) {
  if (vec == VEC) {
    if (!(channels % VEC == 0 || VEC % channels == 0) ||
        ((long long)spatial * channels) % VEC != 0 ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
         reinterpret_cast<uintptr_t>(dx)) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return backward_impl<T, VEC>(x, g, stats, scale, bias, part, sums, tickets, dx, batch,
                                 spatial, channels, eps, lrelu, chunk_rows, nchunk, stream);
  }
  if (vec == 1)
    return backward_impl<T, 1>(x, g, stats, scale, bias, part, sums, tickets, dx, batch,
                               spatial, channels, eps, lrelu, chunk_rows, nchunk, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K7: x, g, dx (B, spatial, C) contiguous; stats (B, 2, C) from K3; scale,
// bias (C,) fp32; part (B, nchunk, 2, C) fp32 scratch; sums (B, 2, C) fp32
// output [sum g', sum g' * xhat]; tickets: B zeroed counters (left zeroed).
// vec, chunk_rows, nchunk from ops/normalization.py in_backward_plan; C at
// most kBwdMaxChannels. Two launches on `stream`, one grid (nchunk, B).
extern "C" int pmr_in_backward(const void* x, const void* g, const void* stats,
                               const void* scale, const void* bias, void* part, void* sums,
                               void* tickets, void* dx, int dtype, int batch, int spatial,
                               int channels, float eps, int lrelu, int vec, int chunk_rows,
                               int nchunk, void* stream) {
  if (batch < 1 || batch > 65535 || spatial < 1 || channels < 1 ||
      channels > kBwdMaxChannels || (long long)spatial * channels >= (1LL << 31) ||
      chunk_rows < 1 || nchunk < 1 || tickets == nullptr)
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
                                            channels, eps, lrelu, vec, chunk_rows, nchunk, s);
  if (dtype == pmr::kFloat32)
    return backward_route<float, 4>(x, g, st, sc, bi, pa, su, tk, dx, batch, spatial, channels,
                                    eps, lrelu, vec, chunk_rows, nchunk, s);
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
