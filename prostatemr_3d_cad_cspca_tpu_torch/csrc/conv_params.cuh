// The parameters of one implicit-GEMM conv launch (K1 or K2, bf16 or fp32)
// of the tensor-core kernel (conv3d_mma.cu), and their unpacking from the
// wrapper's three host arrays (layout documented in ops/convolution.py,
// _pack_conv_args).
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace pmr {

// a dense-skip ladder's stage-0 stitch has 6 parts; ops/convolution.py MAX_PARTS
constexpr int kMaxParts = 6;
constexpr int kMaxPhases = 8;
constexpr int kMaxTaps = 27;

// nparts sits between x and cin: in this order the bf16 kernels compile to
// the registers they had with five parts (with nparts after cin, the BN-16
// K2 variant took one register fewer)
struct ConvParams {
  const void* x[kMaxParts];
  int nparts;
  int cin[kMaxParts];
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

// Returns 0, or a cudaError_t for arguments out of range. ptrs: the parts,
// then kernel, bias, output, workspace; meta: nparts, the parts' cin, then
// the fields f[] (ops/convolution.py, _pack_conv_args, lists them).
inline int unpack_conv_args(const void* ptrs_v, const void* meta_v, const void* taps_v,
                            ConvParams* p) {
  const uint64_t* ptrs = static_cast<const uint64_t*>(ptrs_v);
  const int* m = static_cast<const int*>(meta_v);
  const int* f = m + 1 + kMaxParts;
  const signed char* taps = static_cast<const signed char*>(taps_v);
  p->nparts = m[0];
  if (p->nparts < 1 || p->nparts > kMaxParts) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxParts; ++i) {
    p->x[i] = reinterpret_cast<const void*>(ptrs[i]);
    p->cin[i] = m[1 + i];
  }
  p->w = reinterpret_cast<const void*>(ptrs[kMaxParts]);
  p->bias = f[57] ? reinterpret_cast<const float*>(ptrs[kMaxParts + 1]) : nullptr;
  p->y = reinterpret_cast<void*>(ptrs[kMaxParts + 2]);
  p->ws = reinterpret_cast<float*>(ptrs[kMaxParts + 3]);
  p->cin_total = f[0];
  p->batch = f[1];
  p->in_d = f[2];
  p->in_h = f[3];
  p->in_w = f[4];
  p->out_d = f[5];
  p->out_h = f[6];
  p->out_w = f[7];
  p->g_d = f[8];
  p->g_h = f[9];
  p->g_w = f[10];
  p->cout = f[11];
  for (int a = 0; a < 3; ++a) {
    p->in_mul[a] = f[12 + a];
    p->in_add[a] = f[15 + a];
    p->out_mul[a] = f[18 + a];
  }
  p->w_ci_stride = f[21];
  p->w_co_stride = f[22];
  p->nphase = f[23];
  if (p->nphase < 1 || p->nphase > kMaxPhases) return (int)cudaErrorInvalidValue;
  for (int ph = 0; ph < kMaxPhases; ++ph) {
    p->ntap[ph] = f[24 + ph];
    if (p->ntap[ph] < 0 || p->ntap[ph] > kMaxTaps) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a) p->res[ph][a] = f[32 + ph * 3 + a];
    for (int t = 0; t < kMaxTaps; ++t)
      for (int c = 0; c < 4; ++c) p->tap[ph][t][c] = taps[(ph * kMaxTaps + t) * 4 + c];
  }
  p->dtype = f[56];
  p->splits = f[58];
  p->a_vec = f[59];
  p->b_vec = f[60];
  p->transposed = f[61];
  p->bn = f[62];
  return 0;
}

}  // namespace pmr
