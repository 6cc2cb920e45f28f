// Shared declarations of the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).  The Python wrappers (supersonic_tpu_torch/kernels)
// load the shared library with ctypes and raise on a nonzero return.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SS_EXPORT extern "C" __attribute__((visibility("default")))

// Most arrays one launch moves (payloads, LUT lanes); wrappers refuse more.
#define SS_MAX_ARRAYS 32

// A pointer table passed by value in the kernel's parameter space, so a
// launch needs no device-side pointer array and no host-to-device copy.
struct SsArrays {
  const void* src[SS_MAX_ARRAYS];
  void* dst[SS_MAX_ARRAYS];
  int width[SS_MAX_ARRAYS];  // bytes per element: 1, 2, 4 or 8
};

static inline int ss_fill_arrays(SsArrays* a, int count, void* const* src,
                                 void* const* dst, const int* width) {
  if (count < 0 || count > SS_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < count; ++j) {
    int w = width[j];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    a->src[j] = src[j];
    a->dst[j] = dst[j];
    a->width[j] = w;
  }
  return 0;
}

static inline int ss_multiprocessors() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms > 0 ? sms : 132;
}
