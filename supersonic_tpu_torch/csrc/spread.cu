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
// What bounds it on an H100: device-memory bandwidth.  Each live source's
// payload bytes and base are read once and each output row's payload bytes
// written once.  At the dup8 join's shape (12.5M sources carrying v, d and
// base, 4 bytes each, spread to 100M rows of v and d) that is 150 MB read
// and 800 MB written: 0.95 GB at 3.35 TB/s, about 0.28 ms.
//
// Design: two launches.
//   (1) bounds: one thread per output tile of 2048 rows binary-searches base
//       for the source covering the tile's first row (and, for the last
//       entry, the source covering row out_cap - 1), so no block of (2) waits
//       on a 24-step chain of dependent reads from device memory.
//   (2) expand: one block of 256 threads per tile.  The tile's sources are
//       the consecutive run bounds[t] .. bounds[t + 1].  With strictly
//       increasing starts the run holds at most 2050 entries, and the block
//       finds every row's source by a scan, not by a search per row (a
//       load-balancing search): it zeroes src_of[2048] in shared memory, the
//       last source of each distinct start marks its first row there (so
//       among repeated starts the largest source wins, as upper_bound - 1
//       takes it), and an inclusive max-scan of src_of (in-thread over 8
//       consecutive rows, warp shuffles, then the warp totals) gives each
//       row its source.  Meanwhile cp.async copies the run's values of
//       every payload into a stage in shared memory (1- and 2-byte payloads
//       by loads and stores), so the block waits on device memory once;
//       payloads that do not fit the stage together go in chunks.  Each
//       thread then writes groups of 4 consecutive rows, 256 groups apart,
//       of every payload from the stage: one 16-byte store for a 4-byte
//       payload (two for 8 bytes, 8 and 4 bytes for 2- and 1-byte ones),
//       with the row index added in registers where asked.  A longer run
//       (repeated starts) is searched where it lies, a binary search a row,
//       and its values read from device memory, in the same kernel.
// Sources are read with element loads only, so a source that is a view at
// any element offset needs no other instance; the wrapper allocates the
// outputs, so the row stores are aligned.  Payloads of 1, 2, 4 and 8 bytes
// move natively (no word split).  An int32 payload may also take its row's
// index added (the join's build position j + d), which saves the caller a
// pass that writes an index of every row.  Nothing is written at or past
// out_cap.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char spread_stage[];

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                       // output rows per block
constexpr int kRowsPerThread = kTile / kThreads;  // 8: the scan's rows
constexpr int kGroups = kRowsPerThread / 4;       // groups of 4 rows written
constexpr int kStage = kTile + 2;                 // sources one block stages
constexpr int kStageBytes = 36 * 1024;  // payload values staged at once
constexpr unsigned kFull = 0xffffffffu;

// Bytes one payload of `width` takes in the stage (16-byte aligned).
__host__ __device__ __forceinline__ int staged_bytes(int width) {
  return (kStage * width + 15) & ~15;
}

// End of the chunk of payloads staged together from payload p0 on
// (`width`: the host's array, or the kernel parameter's, read in place).
template <typename Widths>
__host__ __device__ __forceinline__ int chunk_end(const Widths& width,
                                                  int npay, int p0) {
  int bytes = staged_bytes(width[p0]), p = p0 + 1;
  while (p < npay && bytes + staged_bytes(width[p]) <= kStageBytes)
    bytes += staged_bytes(width[p++]);
  return p;
}

// First index of base[0, n) whose value exceeds `row`.
__device__ __forceinline__ int upper_bound(const int* base, int n,
                                           long long row) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)__ldg(base + mid) <= row) lo = mid + 1; else hi = mid;
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

template <typename E>
__device__ __forceinline__ void copy_async(E* smem, const E* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (sizeof(E) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem)
                 : "memory");
}

// Starts copying the run's values of payloads [p0, p1) into the stage; the
// caller waits (cp.async.wait_all) and then holds the block at a barrier.
__device__ __forceinline__ void stage_chunk(const SsArrays& a, int lo, int run,
                                            int p0, int p1) {
  unsigned char* st = spread_stage;
  for (int p = p0; p < p1; ++p) {  // uniform across the block
    const int w = a.width[p];
    const unsigned char* src = static_cast<const unsigned char*>(a.src[p]);
    if (w == 4) {
      const uint32_t* s = reinterpret_cast<const uint32_t*>(src) + lo;
      uint32_t* d = reinterpret_cast<uint32_t*>(st);
      for (int k = threadIdx.x; k < run; k += kThreads) copy_async(d + k, s + k);
    } else if (w == 8) {
      const unsigned long long* s =
          reinterpret_cast<const unsigned long long*>(src) + lo;
      unsigned long long* d = reinterpret_cast<unsigned long long*>(st);
      for (int k = threadIdx.x; k < run; k += kThreads) copy_async(d + k, s + k);
    } else if (w == 2) {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src) + lo;
      uint16_t* d = reinterpret_cast<uint16_t*>(st);
      for (int k = threadIdx.x; k < run; k += kThreads) d[k] = __ldg(s + k);
    } else {
      const uint8_t* s = src + lo;
      for (int k = threadIdx.x; k < run; k += kThreads) st[k] = __ldg(s + k);
    }
    st += staged_bytes(w);
  }
}

// Four consecutive rows of a W-byte payload at `d` (aligned to 4 W bytes),
// stored streaming: 4, 8, 16 or 2 x 16 bytes.
template <typename E>
__device__ __forceinline__ void store4(E* d, const E (&v)[4]) {
  if constexpr (sizeof(E) == 1) {
    __stcs(reinterpret_cast<unsigned*>(d),
           (unsigned)v[0] | ((unsigned)v[1] << 8) | ((unsigned)v[2] << 16) |
               ((unsigned)v[3] << 24));
  } else if constexpr (sizeof(E) == 2) {
    __stcs(reinterpret_cast<uint2*>(d),
           make_uint2((unsigned)v[0] | ((unsigned)v[1] << 16),
                      (unsigned)v[2] | ((unsigned)v[3] << 16)));
  } else if constexpr (sizeof(E) == 4) {
    __stcs(reinterpret_cast<uint4*>(d), make_uint4(v[0], v[1], v[2], v[3]));
  } else {
    uint4* q = reinterpret_cast<uint4*>(d);
    __stcs(q, make_uint4((unsigned)v[0], (unsigned)(v[0] >> 32),
                         (unsigned)v[1], (unsigned)(v[1] >> 32)));
    __stcs(q + 1, make_uint4((unsigned)v[2], (unsigned)(v[2] >> 32),
                             (unsigned)v[3], (unsigned)(v[3] >> 32)));
  }
}

// Writes this thread's groups of 4 rows (groups threadIdx.x + q kThreads)
// of one payload; `from` holds each row's source relative to the run's
// first, `lo`.  `staged`: the values are at `stage`, else read from device
// memory.  kAddRow: the payload is int32 and each row adds its own index
// (wrapping as int32 addition does).
template <typename E, bool kAddRow>
__device__ __forceinline__ void write_rows(const void* src_v, void* dst_v,
                                           int lo, bool staged,
                                           const void* stage_v,
                                           const int (&from)[kGroups][4],
                                           long long j0, long long out_cap) {
  const E* src = static_cast<const E*>(src_v) + lo;
  const E* stage = static_cast<const E*>(stage_v);
  E* dst = static_cast<E*>(dst_v);
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const long long row = j0 + 4 * (threadIdx.x + q * kThreads);
    if (row >= out_cap) continue;
    E v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = staged ? stage[from[q][e]] : __ldg(src + from[q][e]);
      if (kAddRow) v[e] = (E)(v[e] + (E)(row + e));
    }
    if (row + 4 <= out_cap) {
      store4(dst + row, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row + e < out_cap) dst[row + e] = v[e];
    }
  }
}

__device__ __forceinline__ void write_payload(
    const SsArrays& a, int p, unsigned add_row, int lo, bool staged,
    const void* stage, const int (&from)[kGroups][4], long long j0,
    long long out_cap) {
  const void* s = a.src[p];
  void* d = a.dst[p];
  if ((add_row >> p) & 1u) {
    write_rows<uint32_t, true>(s, d, lo, staged, stage, from, j0, out_cap);
    return;
  }
  switch (a.width[p]) {  // uniform across the block
    case 1: write_rows<uint8_t, false>(s, d, lo, staged, stage, from, j0, out_cap); break;
    case 2: write_rows<uint16_t, false>(s, d, lo, staged, stage, from, j0, out_cap); break;
    case 4: write_rows<uint32_t, false>(s, d, lo, staged, stage, from, j0, out_cap); break;
    default: write_rows<unsigned long long, false>(s, d, lo, staged, stage, from, j0, out_cap); break;
  }
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ base, long long out_cap,
              const int* __restrict__ bounds, int npay, unsigned add_row,
              SsArrays a) {
  __shared__ __align__(16) int src_of[kTile];
  __shared__ int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = bounds[blockIdx.x];
  const int run = bounds[blockIdx.x + 1] - lo + 1;
  const long long j0 = (long long)blockIdx.x * kTile;
  const bool staged = run <= kStage;  // uniform across the block
  int from[kGroups][4];
  int c1 = 0;  // end of the chunk of payloads in the stage
  if (staged) {
    int4* so4 = reinterpret_cast<int4*>(src_of);
    so4[2 * threadIdx.x] = make_int4(0, 0, 0, 0);
    so4[2 * threadIdx.x + 1] = make_int4(0, 0, 0, 0);
    c1 = chunk_end(a.width, npay, 0);
    stage_chunk(a, lo, run, 0, c1);
    __syncthreads();
    // mark: src_of[r] = the last source whose first row is j0 + r (sources
    // that start before the tile count as starting at its row 0)
    const int* b = base + lo;
    for (int k = threadIdx.x; k < run; k += kThreads) {
      const long long p = max((long long)__ldg(b + k) - j0, 0LL);
      const long long next =
          k + 1 < run ? max((long long)__ldg(b + k + 1) - j0, 0LL) : kTile;
      if (p < kTile && p != next) src_of[p] = k;
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // inclusive max-scan: the thread's 8 rows, then the warp, then the
    // block; written back so each thread reads its groups' sources
    const int4 x0 = so4[2 * threadIdx.x], x1 = so4[2 * threadIdx.x + 1];
    int v[kRowsPerThread] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int r = 1; r < kRowsPerThread; ++r) v[r] = max(v[r], v[r - 1]);
    int incl = v[kRowsPerThread - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, t);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = 0;
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
    so4[2 * threadIdx.x] = make_int4(max(v[0], before), max(v[1], before),
                                     max(v[2], before), max(v[3], before));
    so4[2 * threadIdx.x + 1] = make_int4(max(v[4], before), max(v[5], before),
                                         max(v[6], before), max(v[7], before));
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int4 x = so4[threadIdx.x + q * kThreads];
      from[q][0] = x.x; from[q][1] = x.y; from[q][2] = x.z; from[q][3] = x.w;
    }
  } else {
    // a run longer than the stage: a binary search a row, where it lies
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = j0 + 4 * (threadIdx.x + q * kThreads) + e;
        const int i = upper_bound(base + lo, run, row) - 1;
        from[q][e] = i < 0 ? 0 : i;
      }
  }
  for (int p = 0; p < npay;) {  // uniform across the block
    if (!staged) {
      write_payload(a, p++, add_row, lo, false, nullptr, from, j0, out_cap);
      continue;
    }
    if (p > 0) {  // the next chunk, once the last one's readers are done
      __syncthreads();
      c1 = chunk_end(a.width, npay, p);
      stage_chunk(a, lo, run, p, c1);
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
    }
    const unsigned char* st = spread_stage;
    for (; p < c1; ++p) {
      write_payload(a, p, add_row, lo, true, st, from, j0, out_cap);
      st += staged_bytes(a.width[p]);
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
  int smem = 0;  // the largest chunk of payloads staged together
  for (int p = 0; p < npay;) {
    const int end = chunk_end(width, npay, p);
    int bytes = 0;
    for (; p < end; ++p) bytes += staged_bytes(width[p]);
    smem = bytes > smem ? bytes : smem;
  }
  long long ntiles = (out_cap + kTile - 1) / kTile;
  expand_kernel<<<(unsigned)ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)base, out_cap, (const int*)bounds, npay, add_row, a);
  return (int)cudaGetLastError();
}
