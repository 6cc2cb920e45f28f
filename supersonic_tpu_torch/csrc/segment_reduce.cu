// Fused multi-request segmented reduction into K <= 2048 slots.  Every
// request reduces its own value column over the same segment ids in one
// pass over the rows; ids outside [0, K) are dropped.
//
// Replaces: supersonic_tpu/kernels/segment_reduce.py::segment_reduce_multi
// (the Pallas kernel that matches row tiles against a lane-resident slot
// iota and accumulates in VMEM, with f32 sums as one-hot MXU dots).
//
// What bounds it on an H100: device-memory bandwidth for the rows (4 bytes
// of id plus 4 bytes per request), and, for few groups, contention of the
// shared-memory atomics on the same slots.
//
// Design: two launches, each its own C entry point.
//   (1) partial: a grid-stride loop over rows.  Each block keeps
//       accumulators [replicas][nreq][K] in shared memory; warp w updates
//       replica w % replicas, so with few slots (the headline query's 64)
//       every warp has its own copy and warps do not contend.  Integer
//       sums and counts use atomicAdd (i32 sums wrap mod 2^32, as in the
//       reference), min/max and firstpos use atomicMin/atomicMax, f32
//       min/max compare as order-preserving int32 codes, and f32 sums use
//       the shared-memory float atomicAdd.  At the end the block folds its
//       replicas in replica order and writes one partial row [nreq][K].
//   (2) final: one thread per (request, slot) folds the partial rows in
//       block order.  Counts are summed in int64, so they are exact at any
//       n (the TPU kernel's f32 counts are exact only below 2^24 rows).
// Bit stability: integer results are exact and identical from run to run.
// f32 sums are NOT bit-stable from run to run: the order in which a
// block's float atomics land varies between runs.  The fold across blocks
// runs in a fixed order, so the spread is that of one block's partial sums.
// Init values follow segment_reduce.py:311-316: sum 0, min +inf / INT32_MAX,
// max -inf / INT32_MIN; a slot no row reached keeps its init value.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxReq = 16;
constexpr int kMaxSegments = 2048;
constexpr int kReplicaBytes = 64 * 1024;

// Request modes; the wrapper maps "firstpos" to MIN_I32.
enum Mode : int {
  SUM_F32 = 0, SUM_I32 = 1, COUNT = 2, MIN_I32 = 3, MAX_I32 = 4,
  MIN_F32 = 5, MAX_F32 = 6
};

struct SegArgs {
  const void* vals[kMaxReq];
  void* out[kMaxReq];
  int mode[kMaxReq];
};

// f32 <-> int32 code whose signed order is the float order.
__device__ __forceinline__ int f2ord(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ord2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ unsigned init_bits(int mode) {
  switch (mode) {
    case MIN_I32: return 0x7fffffffu;
    case MAX_I32: return 0x80000000u;
    case MIN_F32: return (unsigned)f2ord(INFINITY);
    case MAX_F32: return (unsigned)f2ord(-INFINITY);
    default: return 0u;  // sums and counts; 0.0f has all bits clear
  }
}

__device__ __forceinline__ unsigned fold(int mode, unsigned x, unsigned y) {
  switch (mode) {
    case SUM_F32: return __float_as_uint(__uint_as_float(x) + __uint_as_float(y));
    case SUM_I32:
    case COUNT: return x + y;
    case MIN_I32:
    case MIN_F32: return (int)x < (int)y ? x : y;
    default: return (int)x > (int)y ? x : y;
  }
}

__global__ void __launch_bounds__(kThreads)
partial_kernel(const int* __restrict__ ids, long long n, int K, int nreq,
               int replicas, SegArgs a, unsigned* __restrict__ partial) {
  extern __shared__ unsigned acc[];  // [replicas][nreq][K]
  int row = nreq * K;
  for (int w = threadIdx.x; w < replicas * row; w += kThreads)
    acc[w] = init_bits(a.mode[(w % row) / K]);
  __syncthreads();
  unsigned* mine = acc + ((threadIdx.x >> 5) % replicas) * row;
  long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int g = ids[i];
    if ((unsigned)g >= (unsigned)K) continue;
    for (int q = 0; q < nreq; ++q) {
      unsigned* slot = mine + q * K + g;
      const void* v = a.vals[q];
      switch (a.mode[q]) {
        case SUM_F32: atomicAdd(reinterpret_cast<float*>(slot), static_cast<const float*>(v)[i]); break;
        case SUM_I32:
        case COUNT: atomicAdd(reinterpret_cast<int*>(slot), static_cast<const int*>(v)[i]); break;
        case MIN_I32: atomicMin(reinterpret_cast<int*>(slot), static_cast<const int*>(v)[i]); break;
        case MAX_I32: atomicMax(reinterpret_cast<int*>(slot), static_cast<const int*>(v)[i]); break;
        case MIN_F32: atomicMin(reinterpret_cast<int*>(slot), f2ord(static_cast<const float*>(v)[i])); break;
        default: atomicMax(reinterpret_cast<int*>(slot), f2ord(static_cast<const float*>(v)[i])); break;
      }
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < row; w += kThreads) {
    int mode = a.mode[w / K];
    unsigned v = acc[w];
    for (int r = 1; r < replicas; ++r) v = fold(mode, v, acc[r * row + w]);
    partial[(long long)blockIdx.x * row + w] = v;
  }
}

__global__ void final_kernel(const unsigned* __restrict__ partial, int nblocks,
                             int K, int nreq, SegArgs a) {
  int row = nreq * K;
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= row) return;
  int q = w / K, k = w % K, mode = a.mode[q];
  if (mode == COUNT) {
    long long c = 0;
    for (int b = 0; b < nblocks; ++b) c += (int)partial[(long long)b * row + w];
    static_cast<long long*>(a.out[q])[k] = c;
    return;
  }
  unsigned v = init_bits(mode);
  for (int b = 0; b < nblocks; ++b) v = fold(mode, v, partial[(long long)b * row + w]);
  if (mode == MIN_F32 || mode == MAX_F32)
    static_cast<float*>(a.out[q])[k] = ord2f((int)v);
  else
    static_cast<unsigned*>(a.out[q])[k] = v;  // f32 sum bits or an int32
}

}  // namespace

SS_EXPORT int ss_segment_reduce_threads() { return kThreads; }

namespace {

int fill_args(SegArgs* a, int K, int nreq, const int* modes,
              void* const* vals, void* const* outs) {
  if (nreq < 1 || nreq > kMaxReq || K < 1 || K > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < nreq; ++q) {
    if (modes[q] < SUM_F32 || modes[q] > MAX_F32) return (int)cudaErrorInvalidValue;
    a->vals[q] = vals ? vals[q] : nullptr;
    a->out[q] = outs ? outs[q] : nullptr;
    a->mode[q] = modes[q];
  }
  return 0;
}

}  // namespace

// Launch (1).  vals[q]: f32 or i32 [n]; partial: uint32[nblocks * nreq * K].
SS_EXPORT int ss_segment_reduce_partial(const void* ids, long long n, int K,
                                        int nreq, const int* modes,
                                        void* const* vals, void* partial,
                                        int nblocks, void* stream) {
  SegArgs a;
  int err = fill_args(&a, K, nreq, modes, vals, nullptr);
  if (err) return err;
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  int row_bytes = nreq * K * 4;
  int replicas = kReplicaBytes / row_bytes;
  if (replicas > kThreads / 32) replicas = kThreads / 32;
  if (replicas < 1) replicas = 1;
  int smem = replicas * row_bytes;
  err = (int)cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  partial_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ids, n, K, nreq, replicas, a, (unsigned*)partial);
  return (int)cudaGetLastError();
}

// Launch (2).  outs[q]: [K] of f32 (SUM_F32, MIN_F32, MAX_F32), int64
// (COUNT) or int32 (the rest).
SS_EXPORT int ss_segment_reduce_final(const void* partial, int nblocks, int K,
                                      int nreq, const int* modes,
                                      void* const* outs, void* stream) {
  SegArgs a;
  int err = fill_args(&a, K, nreq, modes, nullptr, outs);
  if (err) return err;
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  int row = nreq * K;
  final_kernel<<<(row + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const unsigned*)partial, nblocks, K, nreq, a);
  return (int)cudaGetLastError();
}
