// Merge of two sorted streams A and B by a lexicographic key tuple.
//
// Each side has K key lanes (signed int32 or int64, most significant first)
// and payload lanes; side A holds cap_a rows of which the first na are live,
// B cap_b rows of which nb are live (na and nb are device scalars).  The
// merged order is: live rows by (key tuple, side, position), so equal key
// tuples put all of A before all of B, each side in its own order; then A's
// dead rows, then B's, each by position.  Output row r (r < out_cap <=
// cap_a + cap_b) takes the r-th row of that order, in every lane.  Nothing
// is written at or past out_cap.
//
// Replaces: supersonic_tpu/kernels/merge_sorted.py::merge_sorted and
// merge_path_splits (the Pallas kernel that finds each 32768-row tile's
// input windows by a merge-path search, then lays the A window ascending and
// the B window reversed into one bitonic sequence that 15 butterfly stages
// sort, because Mosaic cannot gather along sublanes).
//
// What bounds it on an H100: device-memory bandwidth.  Each distinct input
// lane is read once and each output lane written once; at the source
// configuration (2 x 50M rows, key lanes g and v's DESC code, payloads g
// itself and v, 4 bytes each) that is 1.2 GB read and, with the key lanes
// written, 1.6 GB written: 2.8 GB at 3.35 TB/s, about 0.84 ms.
//
// Design: two launches.
//   (1) splits: one thread per output tile boundary binary-searches its
//       merge-path diagonal d = t * tile for the count of A rows among the
//       first d outputs, with the A-first rule on the whole key tuple
//       (a[i] goes before b[j] iff a[i] <= b[j]), int64 positions.  So a run
//       of equal keys that spans tiles never interleaves A and B.
//   (2) merge: one block of 256 threads per tile.  The block stages its A
//       window and B window of key lanes in shared memory (widened to
//       int64), side by side.  Each thread takes `tile / 256` consecutive
//       outputs, finds where they start by a second diagonal search in
//       shared memory, merges them serially and records each output's
//       source (its index in the staged windows).  Then every lane is
//       copied with writes coalesced on the output: key lanes from shared
//       memory, payloads from the two contiguous input windows.  A side that
//       is empty or exhausted has an empty window, so nothing is read past
//       its data.
// The tile is 2048 rows while K * 8 + 4 bytes per row fit 48 KB of shared
// memory, and halves (down to 256) for wider key tuples.
#include "common.cuh"

#define SS_MAX_KEYS 16
// key lanes, then at most SS_MAX_ARRAYS payloads
#define SS_MAX_LANES (SS_MAX_KEYS + SS_MAX_ARRAYS)

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerThread = 8;
constexpr int kSmemBytes = 48 * 1024;

// Lane j of the launch: A's and B's arrays and the output (null: not
// written).  Lanes [0, nkeys) are the key lanes.
struct MergeArrays {
  const void* a[SS_MAX_LANES];
  const void* b[SS_MAX_LANES];
  void* out[SS_MAX_LANES];
  int width[SS_MAX_LANES];
};

int tile_rows(int nkeys) {
  int r = kMaxRowsPerThread;
  while (r > 1 && (long long)kThreads * r * (nkeys * 8 + 4) > kSmemBytes) r >>= 1;
  return kThreads * r;
}

__device__ __forceinline__ long long key_at(const void* p, int width,
                                            long long i) {
  return width == 4 ? (long long)__ldg(static_cast<const int*>(p) + i)
                    : __ldg(static_cast<const long long*>(p) + i);
}

__device__ __forceinline__ long long clamp_rows(const long long* n,
                                                long long cap) {
  long long v = *n;
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// Whether A's row i goes before B's row j (na, nb: live rows of each side).
__device__ bool a_first_global(const MergeArrays& m, int nkeys, long long i,
                               long long na, long long j, long long nb) {
  if (j >= nb) return true;   // B's row is dead: any A row goes first
  if (i >= na) return false;  // A's row is dead, B's is live
  for (int k = 0; k < nkeys; ++k) {
    long long x = key_at(m.a[k], m.width[k], i);
    long long y = key_at(m.b[k], m.width[k], j);
    if (x != y) return x < y;
  }
  return true;  // equal key tuples: A first
}

// splits[t] = rows of A among the first min(t * tile, out_cap) outputs.
__global__ void __launch_bounds__(kThreads)
splits_kernel(MergeArrays m, int nkeys, const long long* __restrict__ na_p,
              const long long* __restrict__ nb_p, long long cap_a,
              long long cap_b, long long out_cap, int tile, int ntiles,
              long long* __restrict__ splits) {
  int t = blockIdx.x * kThreads + threadIdx.x;
  if (t > ntiles) return;
  long long na = clamp_rows(na_p, cap_a), nb = clamp_rows(nb_p, cap_b);
  long long d = (long long)t * tile;
  if (d > out_cap) d = out_cap;
  long long lo = d - cap_b > 0 ? d - cap_b : 0;
  long long hi = d < cap_a ? d : cap_a;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a_first_global(m, nkeys, mid, na, d - mid - 1, nb)) lo = mid + 1;
    else hi = mid;
  }
  splits[t] = lo;
}

template <typename T>
__device__ __forceinline__ void move_lane(const void* a, const void* b,
                                          void* out, const int* src, int n,
                                          int ka, long long ia0, long long jb0,
                                          long long d0) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    int u = src[r];
    po[d0 + r] = u < ka ? __ldg(pa + ia0 + u) : __ldg(pb + jb0 + (u - ka));
  }
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(MergeArrays m, int nkeys, int narr,
             const long long* __restrict__ na_p,
             const long long* __restrict__ nb_p, long long out_cap, int tile,
             const long long* __restrict__ splits) {
  // [nkeys][tile] staged keys (window A at [0, ka), B at [ka, n)), then
  // int src[tile]
  extern __shared__ __align__(16) long long skey[];
  int* src = reinterpret_cast<int*>(skey + (size_t)nkeys * tile);
  long long d0 = (long long)blockIdx.x * tile;
  int n = (int)(out_cap - d0 < tile ? out_cap - d0 : tile);
  long long ia0 = splits[blockIdx.x];
  long long jb0 = d0 - ia0;
  int ka = (int)(splits[blockIdx.x + 1] - ia0);
  int kb = n - ka;
  // live rows inside each window
  long long la_ = *na_p - ia0, lb_ = *nb_p - jb0;
  int la = (int)(la_ < 0 ? 0 : (la_ > ka ? ka : la_));
  int lb = (int)(lb_ < 0 ? 0 : (lb_ > kb ? kb : lb_));

  for (int k = 0; k < nkeys; ++k) {
    int w = m.width[k];
    long long* s = skey + (size_t)k * tile;
    for (int u = threadIdx.x; u < n; u += kThreads)
      s[u] = u < ka ? key_at(m.a[k], w, ia0 + u)
                    : key_at(m.b[k], w, jb0 + (u - ka));
  }
  __syncthreads();

  // window A's row u before window B's row v
  auto a_first = [&](int u, int v) -> bool {
    if (v >= lb) return true;
    if (u >= la) return false;
    for (int k = 0; k < nkeys; ++k) {
      const long long* s = skey + (size_t)k * tile;
      long long x = s[u], y = s[ka + v];
      if (x != y) return x < y;
    }
    return true;
  };
  int per = tile / kThreads;
  int dd = threadIdx.x * per;
  if (dd > n) dd = n;
  int lo = dd - kb > 0 ? dd - kb : 0;
  int hi = dd < ka ? dd : ka;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a_first(mid, dd - mid - 1)) lo = mid + 1;
    else hi = mid;
  }
  int u = lo, v = dd - lo;
  int end = dd + per < n ? dd + per : n;
  for (int r = dd; r < end; ++r) {
    bool take_a = u < ka && (v >= kb || a_first(u, v));
    src[r] = take_a ? u++ : ka + v++;
  }
  __syncthreads();

  for (int p = 0; p < narr; ++p) {
    void* out = m.out[p];
    if (out == nullptr) continue;
    int w = m.width[p];
    if (p < nkeys) {  // from the staged keys
      const long long* s = skey + (size_t)p * tile;
      for (int r = threadIdx.x; r < n; r += kThreads) {
        long long x = s[src[r]];
        if (w == 4) static_cast<int*>(out)[d0 + r] = (int)x;
        else static_cast<long long*>(out)[d0 + r] = x;
      }
      continue;
    }
    switch (w) {
      case 1: move_lane<uint8_t>(m.a[p], m.b[p], out, src, n, ka, ia0, jb0, d0); break;
      case 2: move_lane<uint16_t>(m.a[p], m.b[p], out, src, n, ka, ia0, jb0, d0); break;
      case 4: move_lane<uint32_t>(m.a[p], m.b[p], out, src, n, ka, ia0, jb0, d0); break;
      default: move_lane<uint64_t>(m.a[p], m.b[p], out, src, n, ka, ia0, jb0, d0); break;
    }
  }
}

int fill(MergeArrays* m, int nkeys, int narr, const void* const* a,
         const void* const* b, void* const* out, const int* width) {
  if (nkeys < 1 || nkeys > SS_MAX_KEYS || narr < nkeys ||
      narr - nkeys > SS_MAX_ARRAYS)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < narr; ++j) {
    int w = width[j];
    if (j < nkeys ? (w != 4 && w != 8)
                  : (w != 1 && w != 2 && w != 4 && w != 8))
      return (int)cudaErrorInvalidValue;
    m->a[j] = a[j];
    m->b[j] = b[j];
    m->out[j] = out == nullptr ? nullptr : out[j];
    m->width[j] = w;
  }
  return 0;
}

}  // namespace

SS_EXPORT int ss_merge_tile_rows(int nkeys) { return tile_rows(nkeys); }

// a_keys/b_keys: nkeys key lanes of each side, key_width 4 or 8 bytes;
// na/nb: int64 device scalars; splits: int64[ceil(out_cap / tile) + 1].
SS_EXPORT int ss_merge_splits(int nkeys, const void* const* a_keys,
                              const void* const* b_keys, const int* key_width,
                              const void* na, const void* nb, long long cap_a,
                              long long cap_b, long long out_cap, void* splits,
                              void* stream) {
  MergeArrays m;
  int err = fill(&m, nkeys, nkeys, a_keys, b_keys, nullptr, key_width);
  if (err) return err;
  if (out_cap <= 0 || out_cap > cap_a + cap_b) return (int)cudaErrorInvalidValue;
  int tile = tile_rows(nkeys);
  long long ntiles = (out_cap + tile - 1) / tile;
  long long blocks = (ntiles + 1 + kThreads - 1) / kThreads;
  splits_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      m, nkeys, (const long long*)na, (const long long*)nb, cap_a, cap_b,
      out_cap, tile, (int)ntiles, (long long*)splits);
  return (int)cudaGetLastError();
}

// Lanes [0, nkeys) are the key lanes the splits were computed from (an
// output pointer of 0 skips writing that lane), then at most 32 payload
// lanes of 1, 2, 4 or 8 bytes.
SS_EXPORT int ss_merge_sorted(int nkeys, int narr, const void* const* a,
                              const void* const* b, void* const* out,
                              const int* width, const void* na, const void* nb,
                              long long out_cap, const void* splits,
                              void* stream) {
  MergeArrays m;
  int err = fill(&m, nkeys, narr, a, b, out, width);
  if (err) return err;
  if (out_cap <= 0) return (int)cudaErrorInvalidValue;
  int tile = tile_rows(nkeys);
  long long ntiles = (out_cap + tile - 1) / tile;
  size_t smem = (size_t)tile * (nkeys * 8 + 4);
  merge_kernel<<<(unsigned)ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      m, nkeys, narr, (const long long*)na, (const long long*)nb, out_cap,
      tile, (const long long*)splits);
  return (int)cudaGetLastError();
}
