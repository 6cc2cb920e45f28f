// Multi-lane gather from a lookup table: out[l][i] = lut[l][clip(idx[i], 0, K-1)]
// for every lane l, with idx clipped like jnp.take(mode="clip").
//
// Replaces: supersonic_tpu/kernels/lut_gather.py::lut_gather (the Pallas
// kernel that resolves 128-entry LUT blocks with a lane-wise dynamic
// gather over index tiles held in VMEM).
//
// What bounds it on an H100: the random LUT reads, not the streams.  The
// index is read once and every lane written once, coalesced (bytes at
// 3.35 TB/s); but each index also needs one read at a random LUT entry per
// lane, and every such read moves a whole 32-byte L2 sector.  A LUT that
// fits in shared memory answers those reads on the SM; a larger one (the
// row-id probe's 1M-entry, 4 MB lanes) is answered from L2 (50 MB), so
// 100M indices cost 100M sector reads per lane.  Measured at 100M x 1M
// (scripts/measure_torch_lut_gather.py): about 0.31 ms with a sequential
// index, 0.83-0.85 with a random one, whatever the load path, cache hint,
// occupancy or loads in flight; index_select is held to the same floor.
//
// Design: one launch serves every lane, so the index is read once for all
// of them.
//   - The lane signatures the joins use are template instances: one, two or
//     three 4-byte lanes, with or without one 1-byte lane (the row-id probe,
//     the CSR (count, start) pair, the fat-LUT probe's value lanes and
//     match flag).  Their lane pointers are compile-time-indexed kernel
//     parameters, so nothing is indexed at run time.  Every other lane set
//     takes a generic kernel that reads each lane's width and pointer once
//     per chunk of 8 indices a thread, not once per element.
//   - A thread of the specialised kernel takes groups of 4 consecutive
//     indices, two groups an iteration: one 16-byte index load per group
//     (four scalar loads when the index pointer is not 16-byte aligned, as
//     for a slice), the clip, all 8 LUT reads of a lane issued before its
//     stores, and one 16-byte store per group for a 4-byte lane (4 bytes
//     for a 1-byte lane).  The wrapper allocates the outputs, so they are
//     aligned; an output that is not takes the generic kernel.  The last
//     n % 4 indices take a scalar loop.
//   - The index and the outputs stream with evict-first hints (__ldcs,
//     __stcs); the LUT is read with an evict-last L2 policy (createpolicy
//     plus ld.global.nc.L2::cache_hint), so the streams do not push it out
//     of L2.  No persisting-L2 window is set on the device.
//   - When K * (sum of lane widths) fits in 200 KB of dynamic shared memory,
//     each block of 1024 threads first stages the whole LUT there (raising
//     the kernel's shared-memory limit with cudaFuncSetAttribute) and the
//     grid holds as many blocks as fit on each SM.  A larger LUT is read
//     from L2 by every kernel.
#include "common.cuh"

// Dynamic shared memory of every kernel here: the staged LUT lanes.
extern __shared__ __align__(16) unsigned char stage[];

namespace {

constexpr int kThreads = 256;         // block of the generic kernel from L2
constexpr int kStageThreads = 1024;   // block of every other launch
constexpr int kStageMaxBytes = 200 * 1024;
constexpr int kRows = 8;              // indices a thread per iteration, generic
constexpr int kGroups = 2;  // groups of 4 indices a thread per iteration

// Where a LUT read is answered: L2 (through the evict-last policy), or
// shared memory, the whole LUT staged there.
enum Route { kL2 = 0, kStaged = 1 };

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// One LUT read: from shared memory when staged, else from global memory
// through the non-coherent path with the evict-last policy.
template <typename T>
__device__ __forceinline__ T global_lut(const T* p, uint64_t pol);
template <>
__device__ __forceinline__ uint8_t global_lut<uint8_t>(const uint8_t* p,
                                                       uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return (uint8_t)v;
}
template <>
__device__ __forceinline__ uint16_t global_lut<uint16_t>(const uint16_t* p,
                                                         uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return (uint16_t)v;
}
template <>
__device__ __forceinline__ uint32_t global_lut<uint32_t>(const uint32_t* p,
                                                         uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
template <>
__device__ __forceinline__ unsigned long long global_lut<unsigned long long>(
    const unsigned long long* p, uint64_t pol) {
  unsigned long long v;
  asm("ld.global.nc.L2::cache_hint.b64 %0, [%1], %2;"
      : "=l"(v) : "l"(p), "l"(pol));
  return v;
}

// A read of entry k of one lane: its staged copy starts `off` bytes into
// shared memory, `lut` is the lane itself.
template <typename T, int kRoute>
__device__ __forceinline__ T read_lut(int off, const T* lut, int k,
                                      uint64_t pol) {
  if (kRoute == kStaged) return reinterpret_cast<const T*>(stage + off)[k];
  return global_lut<T>(lut + k, pol);
}

__device__ __forceinline__ int clip(int k, int K) {
  return k < 0 ? 0 : (k >= K ? K - 1 : k);
}

// Copies `bytes` bytes of a LUT lane into shared memory, block-wide.
__device__ __forceinline__ void stage_lane(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  if ((bytes & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    for (int w = threadIdx.x; w < bytes / 4; w += blockDim.x)
      reinterpret_cast<uint32_t*>(dst)[w] =
          __ldg(reinterpret_cast<const uint32_t*>(src) + w);
  } else {
    for (int b = threadIdx.x; b < bytes; b += blockDim.x) dst[b] = src[b];
  }
}

__device__ __forceinline__ int staged_bytes(int K, int width) {
  return (K * width + 7) & ~7;  // every lane 8-byte aligned
}

// ---- specialised lane signatures -------------------------------------------

// N4 lanes of 4 bytes, then N1 lanes of 1 byte.
template <int N4, int N1>
struct SpecLanes {
  const uint32_t* lut4[N4];
  uint32_t* out4[N4];
  const uint8_t* lut1[N1 > 0 ? N1 : 1];
  uint8_t* out1[N1 > 0 ? N1 : 1];
};

template <bool kIdxVec>
__device__ __forceinline__ void load_group(const int* __restrict__ idx,
                                           long long g, int K, int* k) {
  if (kIdxVec) {
    int4 q = __ldcs(reinterpret_cast<const int4*>(idx) + g);
    k[0] = q.x; k[1] = q.y; k[2] = q.z; k[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = __ldcs(idx + 4 * g + j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) k[j] = clip(k[j], K);
}

template <int N4, int N1, int kRoute, bool kIdxVec>
__global__ void __launch_bounds__(kStageThreads)
gather_spec(const int* __restrict__ idx, long long n, int K,
            SpecLanes<N4, N1> L) {
  constexpr bool kStage = kRoute == kStaged;
  const uint64_t pol = kStage ? 0 : evict_last_policy();
  // offsets of the staged lanes: the 4-byte ones, then the 1-byte ones
  int st4[N4], st1[N1 > 0 ? N1 : 1];
#pragma unroll
  for (int l = 0; l < N4; ++l) st4[l] = kStage ? l * staged_bytes(K, 4) : 0;
#pragma unroll
  for (int l = 0; l < N1; ++l)
    st1[l] = kStage ? N4 * staged_bytes(K, 4) + l * staged_bytes(K, 1) : 0;
  if (kStage) {
#pragma unroll
    for (int l = 0; l < N4; ++l)
      stage_lane(stage + st4[l],
                 reinterpret_cast<const unsigned char*>(L.lut4[l]), K * 4);
#pragma unroll
    for (int l = 0; l < N1; ++l) stage_lane(stage + st1[l], L.lut1[l], K);
    __syncthreads();
  }
  const long long groups = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += kGroups * stride) {
    int k[4 * kGroups];
    bool have[kGroups];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      have[q] = g + q * stride < groups;
      if (have[q]) {
        load_group<kIdxVec>(idx, g + q * stride, K, k + 4 * q);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) k[4 * q + j] = 0;
      }
    }
#pragma unroll
    for (int l = 0; l < N4; ++l) {
      uint32_t v[4 * kGroups];
#pragma unroll
      for (int j = 0; j < 4 * kGroups; ++j)
        v[j] = read_lut<uint32_t, kRoute>(st4[l], L.lut4[l], k[j], pol);
      uint4* o = reinterpret_cast<uint4*>(L.out4[l]);
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
        if (have[q])
          __stcs(o + g + q * stride, make_uint4(v[4 * q], v[4 * q + 1],
                                                v[4 * q + 2], v[4 * q + 3]));
    }
#pragma unroll
    for (int l = 0; l < N1; ++l) {
      uint32_t v[4 * kGroups];
#pragma unroll
      for (int j = 0; j < 4 * kGroups; ++j)
        v[j] = read_lut<uint8_t, kRoute>(st1[l], L.lut1[l], k[j], pol);
      unsigned* o = reinterpret_cast<unsigned*>(L.out1[l]);
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
        if (have[q])
          __stcs(o + g + q * stride, v[4 * q] | (v[4 * q + 1] << 8) |
                                         (v[4 * q + 2] << 16) |
                                         (v[4 * q + 3] << 24));
    }
  }
  // the last n % 4 indices
  if (blockIdx.x == 0 && threadIdx.x < (int)(n & 3)) {
    const long long i = (groups << 2) + threadIdx.x;
    const int k = clip(idx[i], K);
#pragma unroll
    for (int l = 0; l < N4; ++l)
      L.out4[l][i] = read_lut<uint32_t, kRoute>(st4[l], L.lut4[l], k, pol);
#pragma unroll
    for (int l = 0; l < N1; ++l)
      L.out1[l][i] = read_lut<uint8_t, kRoute>(st1[l], L.lut1[l], k, pol);
  }
}

// ---- generic lane sets -----------------------------------------------------

template <typename T, bool kAll>
__device__ __forceinline__ void copy_chunk(int off, const void* lut,
                                           void* out, const int* k,
                                           long long base, long long n,
                                           uint64_t pol) {
  const T* p = static_cast<const T*>(lut);
  T* o = static_cast<T*>(out);
  T v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    v[j] = read_lut<T, kAll ? kStaged : kL2>(off, p, k[j], pol);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long i = base + j * blockDim.x + threadIdx.x;
    if (i < n) __stcs(o + i, v[j]);
  }
}

// kAll: the whole LUT staged in shared memory, else every read from L2.
template <bool kAll>
__global__ void __launch_bounds__(kStageThreads)
gather_generic(const int* __restrict__ idx, long long n, int K, int nlanes,
               SsArrays a) {
  const uint64_t pol = kAll ? 0 : evict_last_policy();
  if (kAll) {
    int off = 0;
    for (int l = 0; l < nlanes; ++l) {
      int w = a.width[l];
      stage_lane(stage + off, static_cast<const unsigned char*>(a.src[l]),
                 K * w);
      off += staged_bytes(K, w);
    }
    __syncthreads();
  }
  const long long chunk = (long long)blockDim.x * kRows;
  for (long long base = blockIdx.x * chunk; base < n;
       base += gridDim.x * chunk) {
    int k[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long i = base + j * blockDim.x + threadIdx.x;
      k[j] = i < n ? clip(__ldcs(idx + i), K) : 0;
    }
    int off = 0;
    for (int l = 0; l < nlanes; ++l) {  // uniform across the block
      const int w = a.width[l];
      const void* lut = a.src[l];
      void* out = a.dst[l];
      switch (w) {
        case 1: copy_chunk<uint8_t, kAll>(off, lut, out, k, base, n, pol); break;
        case 2: copy_chunk<uint16_t, kAll>(off, lut, out, k, base, n, pol); break;
        case 4: copy_chunk<uint32_t, kAll>(off, lut, out, k, base, n, pol); break;
        default: copy_chunk<unsigned long long, kAll>(off, lut, out, k, base, n, pol); break;
      }
      off += staged_bytes(K, w);
    }
  }
}

// ---- launch ----------------------------------------------------------------

long long lut_bytes(int K, int nlanes, const int* width) {
  long long bytes = 0;
  for (int l = 0; l < nlanes; ++l) bytes += ((long long)K * width[l] + 7) & ~7LL;
  return bytes;
}

// Grid of a launch: as many blocks of `threads` as fit on each SM with
// `smem` bytes of dynamic shared memory each, capped by the blocks the work
// needs.
template <typename Kernel>
int grid_of(Kernel kernel, int threads, int smem, long long want, int* grid) {
  int per_sm = 0;
  if (smem > 0) {
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err) return err;
  if (per_sm < 1) per_sm = 1;
  long long g = (long long)ss_multiprocessors() * per_sm;
  if (g > want) g = want;
  *grid = (int)(g < 1 ? 1 : g);
  return 0;
}

// Dynamic shared memory that stages the whole LUT, or 0 when it does not fit
// and every read goes to L2.
int stage_smem(int K, int nlanes, const int* width) {
  const long long all = lut_bytes(K, nlanes, width);
  return all <= kStageMaxBytes ? (int)all : 0;
}

template <int N4, int N1, int kRoute, bool kIdxVec>
int launch_spec(const int* idx, long long n, int K, const SpecLanes<N4, N1>& L,
                int smem, cudaStream_t s) {
  auto kernel = gather_spec<N4, N1, kRoute, kIdxVec>;
  const int threads = kStageThreads;
  long long want = ((n >> 2) + (long long)kGroups * threads - 1) /
                   ((long long)kGroups * threads);
  int grid = 0;
  int err = grid_of(kernel, threads, smem, want, &grid);
  if (err) return err;
  kernel<<<grid, threads, smem, s>>>(idx, n, K, L);
  return (int)cudaGetLastError();
}

template <int N4, int N1, int kRoute>
int launch_route(const int* idx, long long n, int K,
                 const SpecLanes<N4, N1>& L, int smem, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(idx) & 15) == 0)
    return launch_spec<N4, N1, kRoute, true>(idx, n, K, L, smem, s);
  return launch_spec<N4, N1, kRoute, false>(idx, n, K, L, smem, s);
}

// Launches the specialised kernel when the lanes are N4 four-byte lanes and
// N1 one-byte lanes with aligned outputs; returns -1 when they are not.
template <int N4, int N1>
int try_spec(const int* idx, long long n, int K, int nlanes, const SsArrays& a,
             int smem, cudaStream_t s) {
  if (nlanes != N4 + N1) return -1;
  SpecLanes<N4, N1> L;
  int i4 = 0, i1 = 0;
  for (int l = 0; l < nlanes; ++l) {
    uintptr_t out = reinterpret_cast<uintptr_t>(a.dst[l]);
    if (a.width[l] == 4 && i4 < N4 && (out & 15) == 0) {
      L.lut4[i4] = static_cast<const uint32_t*>(a.src[l]);
      L.out4[i4++] = static_cast<uint32_t*>(a.dst[l]);
    } else if (a.width[l] == 1 && i1 < N1 && (out & 3) == 0) {
      L.lut1[i1] = static_cast<const uint8_t*>(a.src[l]);
      L.out1[i1++] = static_cast<uint8_t*>(a.dst[l]);
    } else {
      return -1;
    }
  }
  if (smem > 0) return launch_route<N4, N1, kStaged>(idx, n, K, L, smem, s);
  return launch_route<N4, N1, kL2>(idx, n, K, L, 0, s);
}

}  // namespace

// Returns 1 when a LUT of K entries with these lane widths is staged whole
// in shared memory, else 0 (reported by the wrapper; no launch).
SS_EXPORT int ss_lut_gather_staged(int K, int nlanes, const int* width) {
  return stage_smem(K, nlanes, width) > 0 ? 1 : 0;
}

// Returns 1 when these lanes (widths in bytes, output addresses) take a
// specialised kernel, else 0 (the generic one); no launch.
SS_EXPORT int ss_lut_gather_specialised(int nlanes, const int* width,
                                        void* const* outs) {
  int n4 = 0, n1 = 0;
  for (int l = 0; l < nlanes; ++l) {
    uintptr_t out = reinterpret_cast<uintptr_t>(outs[l]);
    if (width[l] == 4 && (out & 15) == 0) ++n4;
    else if (width[l] == 1 && (out & 3) == 0) ++n1;
    else return 0;
  }
  return n4 >= 1 && n4 <= 3 && n1 <= 1 ? 1 : 0;
}

SS_EXPORT int ss_lut_gather(const void* idx, long long n, int K, int nlanes,
                            void* const* luts, void* const* outs,
                            const int* width, void* stream) {
  if (n <= 0 || nlanes == 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  SsArrays a;
  int err = ss_fill_arrays(&a, nlanes, luts, outs, width);
  if (err) return err;
  const int smem = stage_smem(K, nlanes, width);
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = (cudaStream_t)stream;
  if (ss_lut_gather_specialised(nlanes, width, outs)) {
    int r = try_spec<1, 0>(ix, n, K, nlanes, a, smem, s);
    if (r < 0) r = try_spec<2, 0>(ix, n, K, nlanes, a, smem, s);
    if (r < 0) r = try_spec<3, 0>(ix, n, K, nlanes, a, smem, s);
    if (r < 0) r = try_spec<1, 1>(ix, n, K, nlanes, a, smem, s);
    if (r < 0) r = try_spec<2, 1>(ix, n, K, nlanes, a, smem, s);
    if (r < 0) r = try_spec<3, 1>(ix, n, K, nlanes, a, smem, s);
    if (r >= 0) return r;
  }
  const int threads = smem > 0 ? kStageThreads : kThreads;
  const long long want = (n + (long long)threads * kRows - 1) /
                         ((long long)threads * kRows);
  int grid = 0;
  if (smem > 0) {
    err = grid_of(gather_generic<true>, threads, smem, want, &grid);
    if (err) return err;
    gather_generic<true><<<grid, threads, smem, s>>>(ix, n, K, nlanes, a);
  } else {
    err = grid_of(gather_generic<false>, threads, 0, want, &grid);
    if (err) return err;
    gather_generic<false><<<grid, threads, 0, s>>>(ix, n, K, nlanes, a);
  }
  return (int)cudaGetLastError();
}
