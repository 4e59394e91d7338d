// K8 se_tail: the squeeze-excite tail of an SE block and the MC dropout that
// follows it, on channels-last (NDHWC) tensors, in two launches.
//
// Replaces a chain of torch kernels over the block's output x_ (the
// normalized conv3 output) that no TPU kernel computed (XLA fused it there):
//   mean   = x_.float().mean(spatial)            fp32 copy written, read back
//   s      = sigmoid(conv7(lrelu(conv6(bf16(mean)))))   a few tiny F.linear
//   y      = lrelu((x_ * s) * residual)          three elementwise passes
//   out    = where(u < keep, y / keep_t, 0)      compare, divide, where
// where u is the dropout's fp32 uniform draw of x_'s shape and keep_t is
// keep rounded to x_'s dtype. In bf16 that chain moves 42 bytes an element
// (58 in fp32); these two launches move 16 (24): x_ read once by the sums,
// x_, residual and u read once and the output written once by the apply
// (the draw's 4-byte write stays a torch kernel, and the squeeze's tiny
// F.linear calls stay between the launches).
//
//  * se_sums_kernel: per (b, c), the fp32 sum of x_ over the spatial axes,
//    divided by the voxel count (an IEEE division, the mean torch returns
//    up to the order of the sum). x_ is read in its own dtype with 16-byte
//    loads; no fp32 copy is written. The grid is K3's (ops/normalization.py
//    in_stats_plan: about two blocks an SM where the tensor allows, so level
//    4's 5x10x10x256 blocks at batch 32 spread over 288 blocks), each block
//    summing its chunk of rows in a fixed order (per-lane registers,
//    xor-shuffles over a warp's rows of one channel group, then shared
//    memory rows in order) into a partial; the sample's last block (a
//    ticket, reset on exit) folds the partials in chunk order. No float
//    atomics: the same bits on every run of one shape.
//  * se_apply_kernel: out = where(u < keep, lrelu(r(r(x_ s) res)) / keep_t,
//    0), r() rounding to x_'s dtype after each product and after the LReLU
//    as the torch ops round, the division an IEEE division by keep_t (no
//    reciprocal: the build has no fast-math; where keep_t is a power of two,
//    as at rate 0.5, a multiply by its exact reciprocal, the same bits), so
//    given the same s the apply is bit-identical to the torch chain.
//    Without an active dropout the same launch runs without u. K4's grid
//    (ops/normalization.py in_apply_plan): a thread keeps its VEC channels'
//    s in registers and streams vectors i, i + active, ... of its sample,
//    kApplyUnroll in flight, with 16-byte loads of x_, residual and u (two
//    for a bf16 vector's 8 uniforms) and 16-byte stores.
// Both take the scalar route (VEC = 1, G = C) through the same code where C
// is neither a multiple nor a divisor of the vector, the sample's elements do
// not fill whole vectors, or a base is not 16-byte aligned.
//
// What bounds them on an H100: bytes. A handful of flops an element.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;       // the sums' 16-byte loads in flight a thread
// The apply's vectors in flight a thread. At 4 the bf16 masked variant took
// 125 registers (two blocks an SM) and streamed a cfg1 forward's SE outputs
// at keep 0.5 at 70 % of the bytes bound on an H100; at 2, 76 registers and
// 89 % (fp32 within 1 % either way).
constexpr int kApplyUnroll = 2;

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

__device__ __forceinline__ void load_vec(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[1]) {
  v[0] = pmr::to_f32<T>(__ldg(p));
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

// v rounded to T (round to nearest even, as torch's casts), back in fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return pmr::to_f32<T>(pmr::from_f32<T>(v));
}

// Per-lane sums of vectors v, v + stride, ... below v1 (in vectors of VEC
// elements from xb), kUnroll loads in flight.
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const T* xb, long long v, long long v1,
                                           long long stride, float (&s)[VEC]) {
  for (; v + (kUnroll - 1) * stride < v1; v += kUnroll * stride) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec(xb + (v + u * stride) * VEC, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int l = 0; l < VEC; ++l) s[l] += x[u][l];
  }
  for (; v < v1; v += stride) {
    float x[VEC];
    load_vec(xb + v * VEC, x);
#pragma unroll
    for (int l = 0; l < VEC; ++l) s[l] += x[l];
  }
}

// Grid (nchunk, batch). Block (chunk, b) sums rows [chunk * chunk_rows,
// (chunk + 1) * chunk_rows) of sample b, a row being G vectors of VEC
// elements, into part[b][chunk][c]; the sample's last block folds the
// chunks into mean[b][c] = sum / spatial. tickets[b] is 0 on entry and on
// exit.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    se_sums_kernel(const T* __restrict__ x, float* __restrict__ part,
                   float* __restrict__ mean, unsigned int* __restrict__ tickets, int spatial,
                   int channels, int groups, long long rows, int chunk_rows) {
  __shared__ float sh[kThreads * VEC];
  __shared__ bool is_last;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int C = channels, G = groups;
  const T* xb = x + (size_t)b * spatial * C;
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  float* out = part + ((size_t)b * nchunk + chunk) * C;

  if (G <= kThreads) {
    const int R = kThreads / G;  // rows a pass
    const int cg = tid % G, r = tid / G;
    float s[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) s[l] = 0.f;
    if (r < R) accumulate<T, VEC>(xb, (r0 + r) * G + cg, r1 * G, (long long)R * G, s);
    int nrows = R;  // rows of partial sums in shared memory, each G x VEC
    if (G < 32 && 32 % G == 0) {  // a warp's rows of one channel group
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        if (off < G) break;
#pragma unroll
        for (int l = 0; l < VEC; ++l) s[l] += __shfl_xor_sync(0xffffffffu, s[l], off);
      }
      if (lane < G)
#pragma unroll
        for (int l = 0; l < VEC; ++l) sh[(warp * G + lane) * VEC + l] = s[l];
      nrows = kThreads / 32;
    } else if (r < R) {
#pragma unroll
      for (int l = 0; l < VEC; ++l) sh[tid * VEC + l] = s[l];
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float t = 0.f;
      for (int row = 0; row < nrows; ++row) {
        if (VEC > C) {  // G == 1: lanes c, c + C, ... hold channel c
          for (int l = c; l < VEC; l += C) t += sh[row * VEC + l];
        } else {
          t += sh[(row * G + c / VEC) * VEC + c % VEC];
        }
      }
      out[c] = t;
    }
  } else {  // wider than a block: each thread walks every row of its groups
    for (int cg = tid; cg < G; cg += kThreads) {
      float s[VEC];
#pragma unroll
      for (int l = 0; l < VEC; ++l) s[l] = 0.f;
      accumulate<T, VEC>(xb, r0 * G + cg, r1 * G, G, s);
#pragma unroll
      for (int l = 0; l < VEC; ++l) out[cg * VEC + l] = s[l];
    }
  }

  // The sample's last block to finish folds its chunks in a fixed order:
  // J lanes a channel, lane j summing chunks j, j + J, ... in order, the
  // lanes then added in order.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[b], 1u) == (unsigned int)nchunk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pb = part + (size_t)b * nchunk * C;
  const float n = (float)spatial;
  const int J = C >= kThreads ? 1 : kThreads / C;
  const int per_pass = kThreads / J;
  for (int c0 = 0; c0 < C; c0 += per_pass) {
    const int c = c0 + tid / J, j = tid % J;
    const bool mine = tid < per_pass * J && c < C;
    float t = 0.f;
    if (mine)
      for (int k = j; k < nchunk; k += J) t += __ldcg(pb + (size_t)k * C + c);
    sh[tid] = t;
    __syncthreads();
    if (mine && j == 0) {
      for (int jj = 1; jj < J; ++jj) t += sh[tid + jj];  // lane order
      mean[(size_t)b * C + c] = __fdiv_rn(t, n);
    }
    __syncthreads();
  }
  if (tid == 0) tickets[b] = 0u;
}

// Grid (blocks a sample, batch). Thread i < active of sample b takes the
// channels ((i % groups) * VEC + l) % C, l < VEC, of vectors i, i + active,
// ... of the sample (`active` is a multiple of `groups`), kApplyUnroll of
// them a round: out = lrelu(r(r(x s) res)), then with kMasked where(u <
// keep, r(out / keep_t), 0); r() rounds to T. inv_keep: 1 / keep_t where
// keep_t is a power of two (the product is then the quotient), else 0.
template <typename T, int VEC, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    se_apply_kernel(const T* __restrict__ x, const T* __restrict__ s,
                    const T* __restrict__ res, const float* __restrict__ u,
                    T* __restrict__ y, int per_batch, int channels, int groups, int active,
                    float keep, float keep_t, float inv_keep) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= active) return;
  const int b = blockIdx.y, C = channels;
  const long long nvec = per_batch / VEC, stride = active;
  const size_t base = (size_t)b * per_batch;
  const T* xb = x + base;
  const T* rb = res + base;
  const float* ub = kMasked ? u + base : nullptr;
  T* yb = y + base;

  float xv[kApplyUnroll][VEC], rv[kApplyUnroll][VEC], uv[kMasked ? kApplyUnroll : 1][VEC];
  auto load_round = [&](long long v) {
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) {
      const long long w = v + k * stride;
      if (w < nvec) {
        load_vec(xb + w * VEC, xv[k]);
        load_vec(rb + w * VEC, rv[k]);
        if constexpr (kMasked) load_vec(ub + w * VEC, uv[k]);
      }
    }
  };
  long long v = i;
  load_round(v);  // in flight while the gate is read

  const int ch0 = (i % groups) * VEC;
  float sc[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) sc[l] = pmr::to_f32<T>(s[(size_t)b * C + (ch0 + l) % C]);

  while (true) {
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) {
      const long long w = v + k * stride;
      if (w >= nvec) continue;
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float p = round_to<T>(xv[k][l] * sc[l]);
        const float q = round_to<T>(p * rv[k][l]);
        float o = q > 0.f ? q : round_to<T>(q * 0.1f);
        if constexpr (kMasked) {
          const float d = inv_keep != 0.f ? o * inv_keep : __fdiv_rn(o, keep_t);
          o = uv[k][l] < keep ? round_to<T>(d) : 0.f;
        }
        xv[k][l] = o;
      }
      store_vec(yb + w * VEC, xv[k]);
    }
    v += kApplyUnroll * stride;
    if (v >= nvec) break;
    load_round(v);
  }
}

template <typename T, int VEC>
int sums_impl(const T* x, float* part, float* mean, unsigned int* tickets, int batch,
              int spatial, int channels, int chunk_rows, int nchunk, cudaStream_t stream) {
  const int groups = channels % VEC == 0 ? channels / VEC : 1;
  const long long rows = (long long)spatial * channels / VEC / groups;
  if (nchunk != (rows + chunk_rows - 1) / chunk_rows) return (int)cudaErrorInvalidValue;
  se_sums_kernel<T, VEC><<<dim3(nchunk, batch), kThreads, 0, stream>>>(
      x, part, mean, tickets, spatial, channels, groups, rows, chunk_rows);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int sums_route(const void* x, void* part, void* mean, void* tickets, int batch, int spatial,
               int channels, int vec, int chunk_rows, int nchunk, cudaStream_t stream) {
  float* pa = static_cast<float*>(part);
  float* me = static_cast<float*>(mean);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  if (vec == VEC) {
    if (!(channels % VEC == 0 || VEC % channels == 0) ||
        ((long long)spatial * channels) % VEC != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return sums_impl<T, VEC>(static_cast<const T*>(x), pa, me, tk, batch, spatial, channels,
                             chunk_rows, nchunk, stream);
  }
  if (vec == 1)
    return sums_impl<T, 1>(static_cast<const T*>(x), pa, me, tk, batch, spatial, channels,
                           chunk_rows, nchunk, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
int apply_impl(const void* x, const void* s, const void* res, const float* u, void* y,
               int batch, int per_batch, int channels, float keep, float keep_t,
               float inv_keep, int blocks, int active, cudaStream_t stream) {
  const int groups = channels % VEC == 0 ? channels / VEC : 1;
  if (active < groups || active % groups != 0 || active > blocks * kThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, batch);
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(s);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  if (u != nullptr) {
    se_apply_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        xt, st, rt, u, yt, per_batch, channels, groups, active, keep, keep_t, inv_keep);
  } else {
    se_apply_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        xt, st, rt, nullptr, yt, per_batch, channels, groups, active, keep, keep_t, inv_keep);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int apply_route(const void* x, const void* s, const void* res, const float* u, void* y,
                int batch, int per_batch, int channels, float keep, float keep_t,
                float inv_keep, int vec, int blocks, int active, cudaStream_t stream) {
  if (vec == VEC) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
                            reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(y);
    if (!(channels % VEC == 0 || VEC % channels == 0) || per_batch % VEC != 0 || bases % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return apply_impl<T, VEC>(x, s, res, u, y, batch, per_batch, channels, keep, keep_t,
                              inv_keep, blocks, active, stream);
  }
  if (vec == 1)
    return apply_impl<T, 1>(x, s, res, u, y, batch, per_batch, channels, keep, keep_t,
                            inv_keep, blocks, active, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (B, spatial, C) contiguous; part: (B, nchunk, C) fp32 scratch; mean:
// (B, C) fp32 output; tickets: B zeroed counters (left zeroed); vec: 1 (the
// scalar route) or 16 bytes of elements; chunk_rows and nchunk from
// ops/normalization.py in_stats_plan.
extern "C" int pmr_se_sums(const void* x, void* part, void* mean, void* tickets, int dtype,
                           int batch, int spatial, int channels, int vec, int chunk_rows,
                           int nchunk, void* stream) {
  if (batch < 1 || batch > 65535 || spatial < 1 || channels < 1 || chunk_rows < 1 ||
      nchunk < 1 || tickets == nullptr || (long long)spatial * channels >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pmr::kBFloat16)
    return sums_route<__nv_bfloat16, 8>(x, part, mean, tickets, batch, spatial, channels, vec,
                                        chunk_rows, nchunk, st);
  if (dtype == pmr::kFloat32)
    return sums_route<float, 4>(x, part, mean, tickets, batch, spatial, channels, vec,
                                chunk_rows, nchunk, st);
  return (int)cudaErrorInvalidValue;
}

// x, res, y: (B, per_batch) contiguous with channels fastest, of one dtype;
// s: (B, C) of that dtype; u: (B, per_batch) fp32 uniforms, or null without
// a dropout; keep: the threshold u is compared with, keep_t: keep rounded to
// the dtype, inv_keep: 1 / keep_t where keep_t is a power of two, else 0;
// vec: 1 (the scalar route) or 16 bytes of elements; blocks (a
// sample) and active (threads a sample) from ops/normalization.py
// in_apply_plan.
extern "C" int pmr_se_apply(const void* x, const void* s, const void* res, const void* u,
                            void* y, int dtype, int batch, int per_batch, int channels,
                            float keep, float keep_t, float inv_keep, int vec, int blocks,
                            int active, void* stream) {
  if (batch < 1 || per_batch < 1 || channels < 1 || batch > 65535 || blocks < 1 ||
      per_batch % channels != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  if (dtype == pmr::kBFloat16)
    return apply_route<__nv_bfloat16, 8>(x, s, res, uf, y, batch, per_batch, channels, keep,
                                         keep_t, inv_keep, vec, blocks, active, st);
  if (dtype == pmr::kFloat32)
    return apply_route<float, 4>(x, s, res, uf, y, batch, per_batch, channels, keep, keep_t,
                                 inv_keep, vec, blocks, active, st);
  return (int)cudaErrorInvalidValue;
}
