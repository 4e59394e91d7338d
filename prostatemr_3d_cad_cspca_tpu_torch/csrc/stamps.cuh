// A diagnostic account of where a conv kernel's cycles go, compiled only
// with -DPMR_STAMPS (tools/kernel_times.py --stamps builds a separate
// library with it; the main path never sees it). One thread of each block
// reads clock64 at the end of each phase and adds the cycles since its last
// stamp to that phase's counter; at the end the block adds its counters
// into slot (block % kStampSlots) of the buffer the source's C entry
// installed: kStampPhases - 1 counters and a block count (thread 0's) a
// slot. A kernel may stamp from two threads (a consumer's and the
// producer's). Each source
// that includes this header exports its own C entry that installs the
// buffer (pmr_stamp_install below), since the buffer's pointer is a
// device variable of that source.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace pmr {

// Phases of a stamped kernel (conv3d_wgmma.cu and conv3d_wgrad.cu, both
// dtypes): setup, the consumers' full-barrier waits (A and B; K6: and its
// first named barrier), the ldmatrix (+ fp32's TF32 split) and wgmma issue
// (K6: the fragment loads alone), the wgmma waits (+ fp32's chain
// promotions; K6: and the wgmma issue), the epilogue; by the producer's
// first thread, its empty-barrier waits and its loads (fp32 K1/K2: the
// weight stages' cp.async issue and conversion); and K6's conversion of a
// box's B into the K-major tile (with its second named barrier).
enum StampPhase {
  kStampSetup = 0,
  kStampIssue = 1,
  kStampWait = 2,
  kStampMma = 3,
  kStampEpilogue = 4,
  kStampProducerWait = 5,
  kStampProducerLoad = 6,
  kStampConvert = 7,
  kStampPhases = 9,  // the last counter of a slot counts blocks
};
constexpr int kStampSlots = 4096;

}  // namespace pmr

#ifdef PMR_STAMPS
static __device__ unsigned long long* pmr_stamp_buf = nullptr;  // one a source

#define PMR_STAMP_DECL(who)                                          \
  const bool pmr_stamper = (who);                                    \
  long long pmr_stamp_t = clock64();                                 \
  long long pmr_stamp_acc[pmr::kStampPhases] = {0, 0, 0, 0, 0, 0, 0, 0, 0}
#define PMR_STAMP(ph)                                                \
  do {                                                               \
    if (pmr_stamper) {                                               \
      const long long pmr_now = clock64();                           \
      pmr_stamp_acc[pmr::ph] += pmr_now - pmr_stamp_t;                    \
      pmr_stamp_t = pmr_now;                                         \
    }                                                                \
  } while (0)
#define PMR_STAMP_WRITE()                                                                \
  do {                                                                                   \
    if (pmr_stamper && pmr_stamp_buf != nullptr) {                                       \
      const unsigned slot = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +         \
                             blockIdx.x) % pmr::kStampSlots;                             \
      unsigned long long* s = pmr_stamp_buf + (size_t)slot * pmr::kStampPhases;          \
      for (int i = 0; i < pmr::kStampPhases - 1; ++i)                                    \
        atomicAdd(s + i, (unsigned long long)pmr_stamp_acc[i]);                          \
      if (threadIdx.x == 0) atomicAdd(s + pmr::kStampPhases - 1, 1ull);                  \
    }                                                                                    \
  } while (0)
#else
#define PMR_STAMP_DECL(who) \
  do {                      \
  } while (0)
#define PMR_STAMP(ph) \
  do {                \
  } while (0)
#define PMR_STAMP_WRITE() \
  do {                    \
  } while (0)
#endif

// Installs `buf` (kStampSlots x kStampPhases unsigned 64-bit counters on the
// device, zeroed by the caller) for this source's stamped kernels; without
// PMR_STAMPS it reports cudaErrorNotSupported.
static inline int pmr_stamp_install(void* buf) {
#ifdef PMR_STAMPS
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return (int)cudaMemcpyToSymbol(pmr_stamp_buf, &p, sizeof(p));
#else
  (void)buf;
  return (int)cudaErrorNotSupported;
#endif
}
