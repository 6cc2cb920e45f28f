// Monotone run expansion ("spread"), the inverse of compaction: output row j
// of every payload takes source i = upper_bound(base, j) - 1, clamped into
// [0, n_src), for j in [0, out_cap).  With base the (nondecreasing) output
// start of each source, source i fills rows [base[i], base[i+1]), and rows at
// or past the last live start hold the last live source.
//
// Replaces: supersonic_tpu/kernels/spread.py::spread_kernel (the Pallas
// kernel that moves each output tile's sources to their in-tile positions
// with a top-down group split, lane shift-doubling and log-pass forward
// fills, because Mosaic cannot gather along sublanes).
//
// What bounds it on an H100: device-memory bandwidth.  Each source's payload
// bytes and base are read once and each output row's payload bytes written
// once.  At the dup8 join's shape (12.5M sources carrying v, d and base, 4
// bytes each, spread to 100M rows of v and d) that is 150 MB read and 800 MB
// written: 0.95 GB at 3.35 TB/s, about 0.28 ms.
//
// Design: two launches.
//   (1) bounds: one thread per output tile of 2048 rows binary-searches base
//       for the source covering the tile's first row (and, for the last
//       entry, the source covering row out_cap - 1), so no block of (2) waits
//       on a 24-step chain of dependent reads from device memory.
//   (2) expand: one block of 256 threads per tile.  The tile's sources are
//       the consecutive run bounds[t] .. bounds[t + 1].  With strictly
//       increasing starts the run holds at most 2050 entries and the block
//       stages it in shared memory; a longer run (repeated starts) is
//       searched where it lies.  Each thread takes 8 rows of the tile, 256
//       apart, finds each row's source by a binary search of the run, then
//       moves every payload for those rows: the reads fall on a contiguous
//       run of sources, the writes are coalesced.
// Payloads of 1, 2, 4 and 8 bytes move natively (no word split).  An int32
// payload may also take its row's index added (the join's build position
// j + d), which saves the caller a pass that writes an index of every row.
// Nothing is written at or past out_cap.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kThreads * kRowsPerThread;  // output rows per block
constexpr int kStage = kTile + 2;                 // bases one block stages

// First index of base[0, n) whose value exceeds `row`.
__device__ __forceinline__ int upper_bound(const int* base, int n,
                                           long long row) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)base[mid] <= row) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// bounds[t]: the source covering row t * kTile for t < ntiles, and the one
// covering row out_cap - 1 for t == ntiles.
__global__ void __launch_bounds__(kThreads)
bounds_kernel(const int* __restrict__ base, int n_src, long long out_cap,
              int ntiles, int* __restrict__ bounds) {
  int t = blockIdx.x * kThreads + threadIdx.x;
  if (t > ntiles) return;
  long long row = t < ntiles ? (long long)t * kTile : out_cap - 1;
  int i = upper_bound(base, n_src, row) - 1;
  bounds[t] = i < 0 ? 0 : i;
}

// kAddRow: the lane is 32-bit and each row also adds its own index j
// (unsigned, so the sum wraps as int32 addition does).
template <typename T, bool kAddRow = false>
__device__ __forceinline__ void move_rows(const void* src, void* dst,
                                          const int (&from)[kRowsPerThread],
                                          long long j0, int live) {
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    long long j = j0 + (long long)k * kThreads;
    if (k < live) d[j] = kAddRow ? (T)(__ldg(s + from[k]) + (T)j)
                                 : __ldg(s + from[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ base, long long out_cap,
              const int* __restrict__ bounds, int npay, unsigned add_row,
              SsArrays a) {
  __shared__ int staged[kStage];
  int lo = bounds[blockIdx.x];
  int run = bounds[blockIdx.x + 1] - lo + 1;
  const int* b = base + lo;
  if (run <= kStage) {  // uniform across the block
    for (int k = threadIdx.x; k < run; k += kThreads) staged[k] = __ldg(b + k);
    __syncthreads();
    b = staged;
  }
  long long j0 = (long long)blockIdx.x * kTile + threadIdx.x;
  int from[kRowsPerThread];
  int live = 0;  // rows k < live lie below out_cap
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    long long j = j0 + (long long)k * kThreads;
    int i = upper_bound(b, run, j) - 1;
    from[k] = lo + (i < 0 ? 0 : i);
    if (j < out_cap) live = k + 1;
  }
  for (int p = 0; p < npay; ++p) {
    if ((add_row >> p) & 1u) {
      move_rows<uint32_t, true>(a.src[p], a.dst[p], from, j0, live);
      continue;
    }
    switch (a.width[p]) {
      case 1: move_rows<uint8_t>(a.src[p], a.dst[p], from, j0, live); break;
      case 2: move_rows<uint16_t>(a.src[p], a.dst[p], from, j0, live); break;
      case 4: move_rows<uint32_t>(a.src[p], a.dst[p], from, j0, live); break;
      default: move_rows<uint64_t>(a.src[p], a.dst[p], from, j0, live); break;
    }
  }
}

}  // namespace

SS_EXPORT int ss_spread_tile_rows() { return kTile; }

// base: int32[n_src], nondecreasing; bounds: int32[ceil(out_cap / 2048) + 1].
SS_EXPORT int ss_spread_bounds(const void* base, int n_src, long long out_cap,
                               void* bounds, void* stream) {
  if (n_src <= 0 || out_cap <= 0) return (int)cudaErrorInvalidValue;
  long long ntiles = (out_cap + kTile - 1) / kTile;
  long long blocks = (ntiles + 1 + kThreads - 1) / kThreads;
  bounds_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)base, n_src, out_cap, (int)ntiles, (int*)bounds);
  return (int)cudaGetLastError();
}

// Payload j is src[j] (n_src rows) -> dst[j] (out_cap rows), width[j] bytes;
// where bit j of add_row is set, payload j is int32 and row r gets its
// source's value plus r (wrapping like int32 addition).
SS_EXPORT int ss_spread_expand(const void* base, long long out_cap,
                               const void* bounds, int npay,
                               unsigned add_row, void* const* src,
                               void* const* dst, const int* width,
                               void* stream) {
  if (out_cap <= 0 || npay == 0) return 0;
  SsArrays a;
  int err = ss_fill_arrays(&a, npay, src, dst, width);
  if (err) return err;
  for (int j = 0; j < npay; ++j)
    if (((add_row >> j) & 1u) && width[j] != 4) return (int)cudaErrorInvalidValue;
  long long ntiles = (out_cap + kTile - 1) / kTile;
  expand_kernel<<<(unsigned)ntiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)base, out_cap, (const int*)bounds, npay, add_row, a);
  return (int)cudaGetLastError();
}
