// Multi-lane gather from a lookup table: out[l][i] = lut[l][clip(idx[i], 0, K-1)]
// for every lane l, with idx clipped like jnp.take(mode="clip").
//
// Replaces: supersonic_tpu/kernels/lut_gather.py::lut_gather (the Pallas
// kernel that resolves 128-entry LUT blocks with a lane-wise dynamic
// gather over index tiles held in VMEM).
//
// What bounds it on an H100: the latency of dependent random reads.  Each
// index is read once, coalesced; each lane then needs one load at a random
// LUT entry and one coalesced store.  A LUT that fits in shared memory
// answers those loads in a few tens of cycles; a larger one is answered
// from L2 (50 MB) or, past that, from device memory.
//
// Design: one launch serves every lane, so the index is read once for all
// of them.  When K * (sum of lane widths) fits in 200 KB of dynamic shared
// memory, each block first stages the whole LUT there (raising the
// kernel's shared-memory limit with cudaFuncSetAttribute) and the grid is
// sized so each SM holds as many blocks as fit.  Otherwise the kernel reads
// the LUT through the read-only path (__ldg), which keeps hot entries in
// L1 and L2: the row-id probe's 1M-entry, 4 MB lanes take this route.  A
// grid-stride loop over indices keeps every SM busy at any n.  Lanes of 1,
// 2, 4 and 8 bytes move natively.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageMaxBytes = 200 * 1024;

template <typename T, bool kStaged>
__device__ __forceinline__ void copy_one(const void* lut, int k, void* out,
                                         long long i) {
  const T* p = static_cast<const T*>(lut) + k;
  static_cast<T*>(out)[i] = kStaged ? *p : __ldg(p);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ idx, long long n, int K, int nlanes,
              SsArrays a) {
  extern __shared__ __align__(16) unsigned char stage[];
  const void* lut[SS_MAX_ARRAYS];
  if (kStaged) {
    int off = 0;
    for (int l = 0; l < nlanes; ++l) {
      int bytes = K * a.width[l];
      const unsigned char* src = static_cast<const unsigned char*>(a.src[l]);
      unsigned char* dst = stage + off;
      if ((bytes & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
        for (int w = threadIdx.x; w < bytes / 4; w += kThreads)
          reinterpret_cast<uint32_t*>(dst)[w] =
              __ldg(reinterpret_cast<const uint32_t*>(src) + w);
      } else {
        for (int b = threadIdx.x; b < bytes; b += kThreads) dst[b] = src[b];
      }
      lut[l] = dst;
      off += (bytes + 7) & ~7;  // keep every lane 8-byte aligned
    }
    __syncthreads();
  } else {
    for (int l = 0; l < nlanes; ++l) lut[l] = a.src[l];
  }
  long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int k = idx[i];
    k = k < 0 ? 0 : (k >= K ? K - 1 : k);
    for (int l = 0; l < nlanes; ++l) {
      switch (a.width[l]) {
        case 1: copy_one<uint8_t, kStaged>(lut[l], k, a.dst[l], i); break;
        case 2: copy_one<unsigned short, kStaged>(lut[l], k, a.dst[l], i); break;
        case 4: copy_one<unsigned int, kStaged>(lut[l], k, a.dst[l], i); break;
        default: copy_one<unsigned long long, kStaged>(lut[l], k, a.dst[l], i); break;
      }
    }
  }
}

}  // namespace

// Returns 1 when a LUT of K entries with these lane widths is staged in
// shared memory, else 0 (reported by the wrapper; no launch).
SS_EXPORT int ss_lut_gather_staged(int K, int nlanes, const int* width) {
  long long bytes = 0;
  for (int l = 0; l < nlanes; ++l) bytes += ((long long)K * width[l] + 7) & ~7LL;
  return bytes <= kStageMaxBytes ? 1 : 0;
}

SS_EXPORT int ss_lut_gather(const void* idx, long long n, int K, int nlanes,
                            void* const* luts, void* const* outs,
                            const int* width, void* stream) {
  if (n <= 0 || nlanes == 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  SsArrays a;
  int err = ss_fill_arrays(&a, nlanes, luts, outs, width);
  if (err) return err;
  long long bytes = 0;
  for (int l = 0; l < nlanes; ++l) bytes += ((long long)K * width[l] + 7) & ~7LL;
  long long want = (n + kThreads - 1) / kThreads;
  int sms = ss_multiprocessors();
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes <= kStageMaxBytes) {
    int smem = (int)bytes;
    err = (int)cudaFuncSetAttribute(gather_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem);
    if (err) return err;
    int per_sm = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_kernel<true>, kThreads, smem);
    if (err) return err;
    if (per_sm < 1) per_sm = 1;
    long long grid = (long long)sms * per_sm;
    if (grid > want) grid = want;
    gather_kernel<true><<<(unsigned)grid, kThreads, smem, s>>>(
        (const int*)idx, n, K, nlanes, a);
  } else {
    long long grid = (long long)sms * 8;  // 2048 threads per SM in flight
    if (grid > want) grid = want;
    gather_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(
        (const int*)idx, n, K, nlanes, a);
  }
  return (int)cudaGetLastError();
}
