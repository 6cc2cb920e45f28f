// Merge of two sorted streams A and B by a key tuple described over their
// raw columns.
//
// Each side has lanes (columns and validity masks, 1, 2, 4 or 8 bytes a
// row); side A holds cap_a rows of which the first na are live, B cap_b rows
// of which nb are live (na and nb are device scalars).  The key tuple is a
// list of compare words, most significant first, each read from a lane of
// either side and coded on the fly exactly as
// kernels/merge_sorted.py::key_words codes it for the plain version:
//   - a null-rank word of a nullable key: its validity lane, valid for ASC,
//     !valid for DESC (NULL first ascending, last descending);
//   - the key's code: int32, int64, bool (as int32) or a STRING/BINARY
//     int32 code, bitwise-not for DESC; float32 or float64 negated for DESC,
//     then NaN made +qNaN and -0.0 made +0.0, then the sign-magnitude flip
//     that orders floats as signed integers; zeroed under NULL.
// Each coded word is mapped to an unsigned integer of the same order, and
// two adjacent 32-bit words share one 64-bit compare unit, so (d)'s (g,
// code of v) compares as one 64-bit integer.  The merged order is: live
// rows by (key tuple, side, position), so equal key tuples put all of A
// before all of B, each side in its own order; then A's dead rows, then
// B's, each by position.  Output row r (r < out_cap <= cap_a + cap_b) takes
// the r-th row of that order, in every lane.  Nothing is written at or past
// out_cap.
//
// Replaces: supersonic_tpu/kernels/merge_sorted.py::merge_sorted and
// merge_path_splits (the Pallas kernel that finds each 32768-row tile's
// input windows by a merge-path search, then lays the A window ascending and
// the B window reversed into one bitonic sequence that 15 butterfly stages
// sort, because Mosaic cannot gather along sublanes), with the key coding
// of supersonic_tpu/ops/merge.py::_sortable_i32 folded in.
//
// What bounds it on an H100: device-memory bandwidth.  Each distinct input
// lane is read once and each output lane written once: at path (d) (2 x 50M
// rows, key columns g INT32 and v FLOAT, which are also the only columns)
// 0.8 GB read and 0.8 GB written, 0.478 ms at 3.35 TB/s.  The key words are
// never materialised in device memory.
//
// Design: two launches.
//   (1) splits: one thread per output tile boundary binary-searches its
//       merge-path diagonal d = t * tile for the count of A rows among the
//       first d outputs, with the A-first rule on the whole key tuple
//       (a[i] goes before b[j] iff a[i] <= b[j]), coding the words it reads,
//       int64 positions.  So a run of equal keys that spans tiles never
//       interleaves A and B.
//   (2) merge: one block of 256 threads per tile.  The block codes its A and
//       B windows' key words into 64-bit compare units in shared memory,
//       each thread issuing the raw loads of 4 rows (both words of a unit
//       and their validity) before it codes any.  Each thread then takes
//       `tile / 256` consecutive outputs, finds where they start by a
//       second diagonal search in shared memory, merges them serially and
//       records each output's source (its index in the windows).  Then
//       every lane is copied, four consecutive output rows a thread at a
//       time (one 16-byte store for a 4-byte lane), gathering from the two
//       contiguous input windows, which the coding pass has just brought
//       into L2 for the key columns.  A side that is empty or exhausted has
//       an empty window, so nothing is read past its data.  The compare
//       units are templated for the key tuples of the driven paths, 1 unit
//       (merge (d)) and 3 (merge (e)), with a generic loop for the others.
// The tile is 2048 rows while units * 8 + 4 bytes per row fit 96 KB of
// shared memory (set with cudaFuncSetAttribute past 48 KB), and halves
// (down to 256) for wider key tuples.  Registers are capped at 40 a thread
// (6 blocks an SM): at path (d) the merge launch took 1.09 ms at 64 and
// 0.90 at 40, and the staging's loads in flight matter less than the
// blocks that overlap one another's phases.
#include "common.cuh"

#define SS_MAX_WORDS 16

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerThread = 8;
constexpr int kSmemBytes = 96 * 1024;
constexpr int kStageRows = 4;  // rows a thread codes per staging iteration
constexpr int kMinBlocks = 6;  // blocks an SM: caps registers at 40

// Kinds of compare words (the wrapper's _KIND): a key's code by its lane's
// type, or the null rank read from a validity lane.
enum WordKind { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kBool = 4, kRank = 5 };

__host__ __device__ __forceinline__ bool wide_kind(int kind) {
  return kind == kI64 || kind == kF64;
}

// The key tuple: compare words in order, grouped into 64-bit units.
struct MergeKeys {
  const void* val[2][SS_MAX_WORDS];     // [side][word]: the lane read
  const uint8_t* ok[2][SS_MAX_WORDS];   // its validity lane, or null
  int kind[SS_MAX_WORDS];
  int desc[SS_MAX_WORDS];
  int first[SS_MAX_WORDS];  // first word of each unit
  int pair[SS_MAX_WORDS];   // 1: the unit holds words first and first + 1
  int nunits;
};

// Lanes moved by one merge launch.
struct MergeLanes {
  const void* a[SS_MAX_ARRAYS];
  const void* b[SS_MAX_ARRAYS];
  void* out[SS_MAX_ARRAYS];
  int width[SS_MAX_ARRAYS];
};

// One compare word of one side, resolved once per loop.
struct Word {
  const void* val;
  const uint8_t* ok;
  int kind;
  bool desc;
};

__device__ __forceinline__ Word word_of(const MergeKeys& K, int side, int w) {
  return Word{K.val[side][w], K.ok[side][w], K.kind[w], K.desc[w] != 0};
}

__device__ __forceinline__ int kind_bytes(int kind) {
  return kind == kI64 || kind == kF64 ? 8 : (kind == kBool || kind == kRank ? 1 : 4);
}

// The code of a word from its raw bits (zero-extended), as an unsigned
// integer of the same order.
__device__ __forceinline__ uint64_t code_of(int kind, bool desc, uint64_t raw,
                                            bool null) {
  switch (kind) {
    case kRank:
      return (uint64_t)((raw != 0) != desc);
    case kI32:
    case kBool: {
      int x = kind == kI32 ? (int)(uint32_t)raw : (int)(raw != 0);
      if (desc) x = ~x;
      if (null) x = 0;
      return (uint32_t)x ^ 0x80000000u;
    }
    case kI64: {
      long long x = (long long)raw;
      if (desc) x = ~x;
      if (null) x = 0;
      return (uint64_t)x ^ 0x8000000000000000ull;
    }
    case kF32: {
      float f = __int_as_float((int)(uint32_t)raw);
      if (desc) f = -f;
      int b = null || f == 0.0f ? 0 : (f != f ? 0x7FC00000 : __float_as_int(f));
      if (b < 0) b ^= 0x7FFFFFFF;
      return (uint32_t)b ^ 0x80000000u;
    }
    default: {  // kF64
      double f = __longlong_as_double((long long)raw);
      if (desc) f = -f;
      long long b = null || f == 0.0
                        ? 0
                        : (f != f ? 0x7FF8000000000000ll : __double_as_longlong(f));
      if (b < 0) b ^= 0x7FFFFFFFFFFFFFFFll;
      return (uint64_t)b ^ 0x8000000000000000ull;
    }
  }
}

// The word's code at row i of its side.
__device__ __forceinline__ uint64_t code(const Word& w, long long i) {
  const bool null = w.ok != nullptr && __ldg(w.ok + i) == 0;
  uint64_t raw;
  switch (kind_bytes(w.kind)) {
    case 1: raw = __ldg(static_cast<const uint8_t*>(w.val) + i); break;
    case 4: raw = __ldg(static_cast<const unsigned*>(w.val) + i); break;
    default: raw = __ldg(static_cast<const unsigned long long*>(w.val) + i); break;
  }
  return code_of(w.kind, w.desc, raw, null);
}

// Raw bits of kStageRows window rows r = base + j * kThreads + threadIdx.x
// of one lane: window row r < ka is A's row ia0 + r, else B's row
// jb0 + r - ka.  All loads are issued before any is used.
template <typename T>
__device__ __forceinline__ void load_rows(const void* a, const void* b,
                                          long long ia0, long long jb0,
                                          int ka, int n, int base,
                                          uint64_t* raw) {
  const T* pa = static_cast<const T*>(a) + ia0;
  const T* pb = static_cast<const T*>(b) + (jb0 - ka);
#pragma unroll
  for (int j = 0; j < kStageRows; ++j) {
    const int r = base + j * kThreads + threadIdx.x;
    raw[j] = r < n ? (uint64_t)__ldg((r < ka ? pa : pb) + r) : 0;
  }
}

__device__ __forceinline__ void load_word(const Word& a, const Word& b,
                                          long long ia0, long long jb0,
                                          int ka, int n, int base,
                                          uint64_t* raw) {
  switch (kind_bytes(a.kind)) {
    case 1: load_rows<uint8_t>(a.val, b.val, ia0, jb0, ka, n, base, raw); break;
    case 4: load_rows<unsigned>(a.val, b.val, ia0, jb0, ka, n, base, raw); break;
    default: load_rows<unsigned long long>(a.val, b.val, ia0, jb0, ka, n, base, raw); break;
  }
}

// Compare unit u of one side at row i, read from device memory.
__device__ __forceinline__ uint64_t unit_at(const MergeKeys& K, int side,
                                            int u, long long i) {
  const int w = K.first[u];
  uint64_t c = code(word_of(K, side, w), i);
  if (K.pair[u]) c = (c << 32) | code(word_of(K, side, w + 1), i);
  return c;
}

__device__ __forceinline__ long long clamp_rows(const long long* n,
                                                long long cap) {
  long long v = *n;
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// Whether A's row i goes before B's row j (na, nb: live rows of each side).
__device__ bool a_first_global(const MergeKeys& K, long long i, long long na,
                               long long j, long long nb) {
  if (j >= nb) return true;   // B's row is dead: any A row goes first
  if (i >= na) return false;  // A's row is dead, B's is live
  for (int u = 0; u < K.nunits; ++u) {
    const uint64_t x = unit_at(K, 0, u, i), y = unit_at(K, 1, u, j);
    if (x != y) return x < y;
  }
  return true;  // equal key tuples: A first
}

// Shared memory of a merge block: nunits unit arrays, then src.
__host__ __device__ __forceinline__ size_t smem_bytes(int nunits, int tile) {
  return (size_t)tile * (nunits * 8 + 4);
}

int tile_rows(int nunits) {
  int r = kMaxRowsPerThread;
  while (r > 1 && smem_bytes(nunits, kThreads * r) > (size_t)kSmemBytes) r >>= 1;
  return kThreads * r;
}

// splits[t] = rows of A among the first min(t * tile, out_cap) outputs.
__global__ void __launch_bounds__(kThreads)
splits_kernel(MergeKeys K, const long long* __restrict__ na_p,
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
    if (a_first_global(K, mid, na, d - mid - 1, nb)) lo = mid + 1;
    else hi = mid;
  }
  splits[t] = lo;
}

// Vector of 4 consecutive rows of a lane of type T.
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> {
  static __device__ __forceinline__ void store(uint8_t* p, const uint8_t* v) {
    __stcs(reinterpret_cast<unsigned*>(p),
           v[0] | (v[1] << 8) | (v[2] << 16) | ((unsigned)v[3] << 24));
  }
};
template <> struct Vec4<uint16_t> {
  static __device__ __forceinline__ void store(uint16_t* p, const uint16_t* v) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(v[0] | ((unsigned)v[1] << 16), v[2] | ((unsigned)v[3] << 16)));
  }
};
template <> struct Vec4<uint32_t> {
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* v) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Vec4<unsigned long long> {
  static __device__ __forceinline__ void store(unsigned long long* p,
                                               const unsigned long long* v) {
    __stcs(reinterpret_cast<ulonglong2*>(p), make_ulonglong2(v[0], v[1]));
    __stcs(reinterpret_cast<ulonglong2*>(p) + 1, make_ulonglong2(v[2], v[3]));
  }
};

// Copies one lane's n output rows of this tile, row r from window index
// src[r] (< ka: A's row ia0 + src, else B's row jb0 + src - ka).
template <typename T>
__device__ __forceinline__ void move_lane(const void* a, const void* b,
                                          void* out, const int* src, int n,
                                          int ka, long long ia0, long long jb0,
                                          long long d0) {
  const T* pa = static_cast<const T*>(a) + ia0;
  const T* pb = static_cast<const T*>(b) + jb0 - ka;
  T* po = static_cast<T*>(out) + d0;
  const bool vec = (reinterpret_cast<uintptr_t>(po) &
                    (sizeof(T) * 4 > 16 ? 15 : sizeof(T) * 4 - 1)) == 0;
  int r0 = 0;
  if (vec) {
    const int ng = n >> 2;
    for (int q = threadIdx.x; q < ng; q += 2 * kThreads) {
      const int q2 = q + kThreads;
      const int4 s = reinterpret_cast<const int4*>(src)[q];
      const int4 s2 = q2 < ng ? reinterpret_cast<const int4*>(src)[q2]
                              : make_int4(0, 0, 0, 0);
      const int u[8] = {s.x, s.y, s.z, s.w, s2.x, s2.y, s2.z, s2.w};
      T v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __ldg((u[j] < ka ? pa : pb) + u[j]);
      Vec4<T>::store(po + 4 * q, v);
      if (q2 < ng) Vec4<T>::store(po + 4 * q2, v + 4);
    }
    r0 = ng << 2;
  }
  for (int r = r0 + threadIdx.x; r < n; r += kThreads) {
    const int u = src[r];
    po[r] = __ldg((u < ka ? pa : pb) + u);
  }
}

// NU > 0: the key tuple has exactly NU compare units; 0: K.nunits of them.
template <int NU>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_kernel(MergeKeys K, MergeLanes L, int nlanes,
             const long long* __restrict__ na_p,
             const long long* __restrict__ nb_p, long long out_cap, int tile,
             const long long* __restrict__ splits) {
  // [nunits][tile] compare units (window A at [0, ka), B at [ka, n)), then
  // int src[tile]
  extern __shared__ __align__(16) unsigned long long sunit[];
  const int nu = NU > 0 ? NU : K.nunits;
  int* src = reinterpret_cast<int*>(sunit + (size_t)nu * tile);
  const long long d0 = (long long)blockIdx.x * tile;
  const int n = (int)(out_cap - d0 < tile ? out_cap - d0 : tile);
  const long long ia0 = splits[blockIdx.x];
  const long long jb0 = d0 - ia0;
  const int ka = (int)(splits[blockIdx.x + 1] - ia0);
  const int kb = n - ka;
  // live rows inside each window
  const long long la_ = *na_p - ia0, lb_ = *nb_p - jb0;
  const int la = (int)(la_ < 0 ? 0 : (la_ > ka ? ka : la_));
  const int lb = (int)(lb_ < 0 ? 0 : (lb_ > kb ? kb : lb_));

  // code the windows' key words into compare units: the raw rows of both
  // words of a unit (and their validity) are loaded before any is coded
  for (int u = 0; u < nu; ++u) {
    const int w = K.first[u];
    const bool pair = K.pair[u] != 0;
    const Word a0 = word_of(K, 0, w), b0 = word_of(K, 1, w);
    const Word a1 = word_of(K, 0, pair ? w + 1 : w);
    const Word b1 = word_of(K, 1, pair ? w + 1 : w);
    unsigned long long* s = sunit + (size_t)u * tile;
    for (int base = 0; base < n; base += kThreads * kStageRows) {
      uint64_t r0[kStageRows], r1[kStageRows], n0[kStageRows], n1[kStageRows];
      load_word(a0, b0, ia0, jb0, ka, n, base, r0);
      if (a0.ok != nullptr)
        load_rows<uint8_t>(a0.ok, b0.ok, ia0, jb0, ka, n, base, n0);
      if (pair) {
        load_word(a1, b1, ia0, jb0, ka, n, base, r1);
        if (a1.ok != nullptr)
          load_rows<uint8_t>(a1.ok, b1.ok, ia0, jb0, ka, n, base, n1);
      }
#pragma unroll
      for (int j = 0; j < kStageRows; ++j) {
        const int r = base + j * kThreads + threadIdx.x;
        if (r < n) {
          uint64_t c = code_of(a0.kind, a0.desc, r0[j],
                               a0.ok != nullptr && n0[j] == 0);
          if (pair)
            c = (c << 32) | code_of(a1.kind, a1.desc, r1[j],
                                    a1.ok != nullptr && n1[j] == 0);
          s[r] = c;
        }
      }
    }
  }
  __syncthreads();

  // window A's row u before window B's row v
  auto a_first = [&](int u, int v) -> bool {
    if (v >= lb) return true;
    if (u >= la) return false;
#pragma unroll
    for (int k = 0; k < (NU > 0 ? NU : SS_MAX_WORDS); ++k) {
      if (NU == 0 && k >= nu) break;
      const unsigned long long x = sunit[(size_t)k * tile + u];
      const unsigned long long y = sunit[(size_t)k * tile + ka + v];
      if (x != y) return x < y;
    }
    return true;
  };
  const int per = tile / kThreads;
  int dd = threadIdx.x * per;
  if (dd > n) dd = n;
  int lo = dd - kb > 0 ? dd - kb : 0;
  int hi = dd < ka ? dd : ka;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_first(mid, dd - mid - 1)) lo = mid + 1;
    else hi = mid;
  }
  int u = lo, v = dd - lo;
  const int end = dd + per < n ? dd + per : n;
  for (int r = dd; r < end; ++r) {
    const bool take_a = u < ka && (v >= kb || a_first(u, v));
    src[r] = take_a ? u++ : ka + v++;
  }
  __syncthreads();

  for (int p = 0; p < nlanes; ++p) {
    switch (L.width[p]) {
      case 1: move_lane<uint8_t>(L.a[p], L.b[p], L.out[p], src, n, ka, ia0, jb0, d0); break;
      case 2: move_lane<uint16_t>(L.a[p], L.b[p], L.out[p], src, n, ka, ia0, jb0, d0); break;
      case 4: move_lane<uint32_t>(L.a[p], L.b[p], L.out[p], src, n, ka, ia0, jb0, d0); break;
      default: move_lane<unsigned long long>(L.a[p], L.b[p], L.out[p], src, n, ka, ia0, jb0, d0); break;
    }
  }
}

// Fills the key tuple from per-word arrays; returns a cudaError_t.
int fill_keys(MergeKeys* K, int nwords, const int* kind, const int* desc,
              const void* const* a_val, const void* const* b_val,
              const void* const* a_ok, const void* const* b_ok) {
  if (nwords < 1 || nwords > SS_MAX_WORDS) return (int)cudaErrorInvalidValue;
  int nu = 0;
  for (int w = 0; w < nwords; ++w) {
    if (kind[w] < kI32 || kind[w] > kRank) return (int)cudaErrorInvalidValue;
    K->val[0][w] = a_val[w];
    K->val[1][w] = b_val[w];
    K->ok[0][w] = static_cast<const uint8_t*>(a_ok[w]);
    K->ok[1][w] = static_cast<const uint8_t*>(b_ok[w]);
    K->kind[w] = kind[w];
    K->desc[w] = desc[w] ? 1 : 0;
  }
  // two adjacent 32-bit words share a unit, the first in the high half
  for (int w = 0; w < nwords; ++nu) {
    K->first[nu] = w;
    K->pair[nu] = w + 1 < nwords && !wide_kind(kind[w]) && !wide_kind(kind[w + 1]);
    w += K->pair[nu] ? 2 : 1;
  }
  K->nunits = nu;
  return 0;
}

int count_units(int nwords, const int* kind) {
  int nu = 0;
  for (int w = 0; w < nwords; ++nu)
    w += (w + 1 < nwords && !wide_kind(kind[w]) && !wide_kind(kind[w + 1])) ? 2 : 1;
  return nu;
}

template <int NU>
int launch_merge(const MergeKeys& K, const MergeLanes& L, int nlanes,
                 const long long* na, const long long* nb, long long out_cap,
                 int tile, const long long* splits, cudaStream_t s) {
  const long long ntiles = (out_cap + tile - 1) / tile;
  const size_t smem = smem_bytes(K.nunits, tile);
  int err = (int)cudaFuncSetAttribute(
      merge_kernel<NU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  merge_kernel<NU><<<(unsigned)ntiles, kThreads, smem, s>>>(
      K, L, nlanes, na, nb, out_cap, tile, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of one merge tile for a key tuple of these compare-word kinds.
SS_EXPORT int ss_merge_tile_rows(int nwords, const int* kind) {
  return tile_rows(count_units(nwords, kind));
}

// The key tuple: nwords compare words, word w of kind kind[w] (WordKind),
// DESC when desc[w], read from a_val[w] / b_val[w] and zeroed where
// a_ok[w] / b_ok[w] (bool lanes; null: no validity) is false.  na/nb: int64
// device scalars; splits: int64[ceil(out_cap / tile) + 1].
SS_EXPORT int ss_merge_splits(int nwords, const int* kind, const int* desc,
                              const void* const* a_val,
                              const void* const* b_val,
                              const void* const* a_ok, const void* const* b_ok,
                              const void* na, const void* nb, long long cap_a,
                              long long cap_b, long long out_cap, void* splits,
                              void* stream) {
  MergeKeys K;
  int err = fill_keys(&K, nwords, kind, desc, a_val, b_val, a_ok, b_ok);
  if (err) return err;
  if (out_cap <= 0 || out_cap > cap_a + cap_b) return (int)cudaErrorInvalidValue;
  const int tile = tile_rows(K.nunits);
  const long long ntiles = (out_cap + tile - 1) / tile;
  const long long blocks = (ntiles + 1 + kThreads - 1) / kThreads;
  splits_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      K, (const long long*)na, (const long long*)nb, cap_a, cap_b, out_cap,
      tile, (int)ntiles, (long long*)splits);
  return (int)cudaGetLastError();
}

// The same key tuple as the splits, then at most 32 lanes of 1, 2, 4 or 8
// bytes to merge: a[p] / b[p] into out[p].
SS_EXPORT int ss_merge_sorted(int nwords, const int* kind, const int* desc,
                              const void* const* a_val,
                              const void* const* b_val,
                              const void* const* a_ok, const void* const* b_ok,
                              int nlanes, const void* const* a,
                              const void* const* b, void* const* out,
                              const int* width, const void* na, const void* nb,
                              long long out_cap, const void* splits,
                              void* stream) {
  MergeKeys K;
  int err = fill_keys(&K, nwords, kind, desc, a_val, b_val, a_ok, b_ok);
  if (err) return err;
  if (out_cap <= 0 || nlanes < 0 || nlanes > SS_MAX_ARRAYS)
    return (int)cudaErrorInvalidValue;
  MergeLanes L;
  for (int p = 0; p < nlanes; ++p) {
    const int w = width[p];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    L.a[p] = a[p];
    L.b[p] = b[p];
    L.out[p] = out[p];
    L.width[p] = w;
  }
  const int tile = tile_rows(K.nunits);
  const long long* pna = (const long long*)na;
  const long long* pnb = (const long long*)nb;
  const long long* sp = (const long long*)splits;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K.nunits) {
    case 1: return launch_merge<1>(K, L, nlanes, pna, pnb, out_cap, tile, sp, s);
    case 3: return launch_merge<3>(K, L, nlanes, pna, pnb, out_cap, tile, sp, s);
    default: return launch_merge<0>(K, L, nlanes, pna, pnb, out_cap, tile, sp, s);
  }
}
