// The parameters of one implicit-GEMM conv launch (K1 or K2, bf16 or fp32)
// of the tensor-core kernel (conv3d_mma.cu), and their unpacking from the
// wrapper's three host arrays (layout documented in ops/convolution.py,
// _pack_conv_args).
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace pmr {

constexpr int kMaxParts = 5;
constexpr int kMaxPhases = 8;
constexpr int kMaxTaps = 27;

struct ConvParams {
  const void* x[kMaxParts];
  int cin[kMaxParts];
  int nparts;
  int cin_total;
  const void* w;
  const float* bias;  // null when the conv has no bias
  void* y;
  int batch;
  int in_d, in_h, in_w;
  int out_d, out_h, out_w;
  int g_d, g_h, g_w;  // row grid of one phase
  int cout;
  int in_mul[3];   // input coordinate = grid * in_mul + in_add + tap offset
  int in_add[3];
  int out_mul[3];  // output coordinate = grid * out_mul + phase residue
  int w_ci_stride;  // weight (tap, ci, co) sits at
  int w_co_stride;  //   tap * cin_total * cout + ci * w_ci_stride + co * w_co_stride
  int nphase;
  int ntap[kMaxPhases];
  int res[kMaxPhases][3];
  signed char tap[kMaxPhases][kMaxTaps][4];  // dz, dy, dx, weight tap index
  int dtype;  // pmr::DType
  // the schedule (ops/convolution.py, igemm_plan and gather_routes)
  float* ws;        // split-K partials, splits x output elements (fp32)
  int splits;       // K splits per output tile (1: no workspace)
  int a_vec;        // bit p: part p is gathered by 16-byte cp.async
  int b_vec;        // 1: the weights are loaded by 16-byte cp.async
  int transposed;   // 1: K2's (kd, kh, kw, Cout, Cin) kernel
  int bn;           // output-channel tile
};

// Returns 0, or a cudaError_t for arguments out of range.
inline int unpack_conv_args(const void* ptrs_v, const void* meta_v, const void* taps_v,
                            ConvParams* p) {
  const uint64_t* ptrs = static_cast<const uint64_t*>(ptrs_v);
  const int* m = static_cast<const int*>(meta_v);
  const signed char* taps = static_cast<const signed char*>(taps_v);
  p->nparts = m[0];
  if (p->nparts < 1 || p->nparts > kMaxParts) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxParts; ++i) {
    p->x[i] = reinterpret_cast<const void*>(ptrs[i]);
    p->cin[i] = m[1 + i];
  }
  p->w = reinterpret_cast<const void*>(ptrs[5]);
  p->bias = m[63] ? reinterpret_cast<const float*>(ptrs[6]) : nullptr;
  p->y = reinterpret_cast<void*>(ptrs[7]);
  p->ws = reinterpret_cast<float*>(ptrs[8]);
  p->cin_total = m[6];
  p->batch = m[7];
  p->in_d = m[8];
  p->in_h = m[9];
  p->in_w = m[10];
  p->out_d = m[11];
  p->out_h = m[12];
  p->out_w = m[13];
  p->g_d = m[14];
  p->g_h = m[15];
  p->g_w = m[16];
  p->cout = m[17];
  for (int a = 0; a < 3; ++a) {
    p->in_mul[a] = m[18 + a];
    p->in_add[a] = m[21 + a];
    p->out_mul[a] = m[24 + a];
  }
  p->w_ci_stride = m[27];
  p->w_co_stride = m[28];
  p->nphase = m[29];
  if (p->nphase < 1 || p->nphase > kMaxPhases) return (int)cudaErrorInvalidValue;
  for (int ph = 0; ph < kMaxPhases; ++ph) {
    p->ntap[ph] = m[30 + ph];
    if (p->ntap[ph] < 0 || p->ntap[ph] > kMaxTaps) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a) p->res[ph][a] = m[38 + ph * 3 + a];
    for (int t = 0; t < kMaxTaps; ++t)
      for (int c = 0; c < 4; ++c) p->tap[ph][t][c] = taps[(ph * kMaxTaps + t) * 4 + c];
  }
  p->dtype = m[62];
  p->splits = m[64];
  p->a_vec = m[65];
  p->b_vec = m[66];
  p->transposed = m[67];
  p->bn = m[68];
  return 0;
}

}  // namespace pmr
