// Fused multi-request segmented reduction into K <= 2048 slots, keyed by up
// to 4 raw group-key lanes, in one launch with deterministic results.
//
// Replaces: supersonic_tpu/kernels/segment_reduce.py::segment_reduce_multi
// and segment_reduce_small (the Pallas kernel that matches row tiles
// against a lane-resident slot iota and accumulates in VMEM, with f32 sums
// as one-hot MXU dots), and the row-scale slot arithmetic of its caller
// supersonic_tpu/ops/aggregate.py::_dense_grouped_aggregate (:504-519).
// The TPU kernel has 32-bit accumulators only (the TPU has no native f64 or
// i64); this one adds 64-bit sum words, so a DOUBLE or INT64 SUM stays on
// the dense route here.
//
// What bounds it on an H100: device-memory bandwidth for the rows (each key
// lane, the keep mask, and each request's values and validity, read once);
// the accumulator updates stay in shared memory.  At the headline's shape it
// runs at 1.8x that bound: its loads and key coding at 24 warps an SM (the
// per-thread f32 words cap the SM at 3 blocks) take the time, the
// accumulator updates about a tenth of it (PERF.md, section 6).  At TPC-H
// Q1's shape (two int32 key lanes of 3 x 2 slots, a row count, five f64
// value lanes summed and a count: 48 bytes a row) the bound is the same
// bytes; the five f64 words of a slot take 10 KB of shared memory, so the
// 6 slots take 62 KB and an SM still holds 3 blocks.  8-byte words cost
// occupancy only through their footprint: 2 KB a slot for each f64 sum
// (per-thread), 64 bytes a slot for each other 64-bit word, twice the
// 32-bit words' bytes.  A 64-bit value lane takes two 16-byte loads a 4-row
// group, so the 64-bit instances prefetch one request with the keys, not
// two, to stay within the 80 registers a thread of 3 blocks an SM.
//
// Key coding: a row is live if row < num_rows and keep[row].  For each key
// dimension d the kernel takes key - kmin_d in 64-bit registers, checks it
// against K_d and folds it into the mixed-radix slot; a live row whose key
// falls outside the domain is dropped and counted (bad_out), so a stale
// planner statistic is flagged, never wrapped into a wrong slot.  Request
// q counts a row only where it is live and valid_q[row] (when given).
//
// Modes (one accumulator word per request and slot):
//   32-bit words: SUM_F32, SUM_I32 (wraps mod 2^32), COUNT (values null: 1
//   a row, else the 0/1 int32 indicators; the final fold is int64, exact at
//   any n), MIN_I32 / MAX_I32 (values null: the row index, i.e. firstpos /
//   lastpos), MIN_F32 / MAX_F32 (-0.0 counts as +0.0, as
//   ops/keys.py::monotone_code; a slot that saw a NaN of either sign gives
//   NaN).
//   64-bit words: SUM_F64 (f64 values, or f32 values widened a row),
//   SUM_I64 (i64 values, or i32 values sign-extended a row; wraps mod
//   2^64).  An f64 sum starts at +0.0, so a NaN or an inf reaches only the
//   slots whose rows hold one, and a slot of -0.0 rows gives +0.0.
// A slot no row reached keeps its init value: 0, +inf / INT32_MAX for min,
// -inf / INT32_MIN for max (segment_reduce.py:311-316).
//
// Determinism: an f32 or f64 sum word is owned by one thread (the
// per-thread instance) or one warp (the per-warp instance), which takes its
// rows in a fixed order; a block owns a fixed contiguous range of rows; the
// grid size depends only on (n, the requests' footprint, the SM count);
// threads, warps and blocks then fold in a fixed tree order.  So float sums
// are bit-identical from run to run; no float atomics are used.  Counts,
// integer sums and min/max are exact in any order.
//
// Design: one launch.
//   * Loads: a thread takes 4-row groups (16-byte key and value vectors: one
//     a 32-bit lane, two a 64-bit lane, two rows each; 4 keep or validity
//     bytes), kUnroll groups a step, blockDim apart.  A step first issues
//     the loads of the keep mask, the first key lane and the first
//     kPrefetch requests (one in the WIDE instances, for registers), then
//     uses them: no instruction that waits on a load sits between two
//     loads, so a step pays one memory latency, not one per load.  A group
//     that runs past the live rows, or a call whose inputs are not 16-byte
//     aligned (the instance the wrapper picks), uses element loads.
//   * Per-thread instance (when its footprint fits in shared memory: 2 KB a
//     slot for each f64 sum, 1 KB for each f32 sum, 64 bytes for each i64
//     sum, 32 bytes for each other request; the headline's count + sum over
//     64 slots take 66 KB, so 3 blocks share an SM): f64 and f32 sums in
//     words [word][thread], so a warp's updates never meet in a bank and
//     need no atomics, folded by one warp a word (8 words a lane, then a
//     shuffle tree); every other request in one replica a warp [warp][word],
//     updated by shared-memory atomics and folded in replica order.
//   * Per-warp instance (larger footprints, up to K = 2048 with 16
//     requests): every request in words [word][warp]; a warp merges its 32
//     rows of a request by slot with ballots and folds each slot's peers in
//     lane order through shuffles; the leader lane updates the warp's word.
//     Requests that do not fit at once are taken in groups (by bytes: a
//     64-bit request takes twice a 32-bit one's), each a pass over the
//     block's rows.
//   * Each block writes one partial row (each request's K words, 64-bit
//     ones first) and its dropped-row count; the last block to finish (a
//     __threadfence, then an atomic ticket, zeroed by a memset before the
//     launch) folds the partial rows in block order, one thread per output
//     word, and writes the outputs.
//   * A call with a 64-bit request runs the WIDE instances; a call of 32-bit
//     requests alone runs the 32-bit instances, whose code is unchanged by
//     the 64-bit words.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks an SM holds at the headline's size
constexpr int kMaxReq = 16;
constexpr int kMaxDims = 4;
constexpr int kMaxSegments = 2048;
constexpr int kUnroll = 2;    // 4-row groups a thread takes per step
constexpr int kPrefetch = 2;  // requests whose loads issue with the keys

// kPrefetch, or one request in the WIDE instances: a prefetched 64-bit
// lane holds 18 registers a thread (two groups of two 16-byte vectors),
// and two of them push the kernel past the 80 registers of 3 blocks an SM
__host__ __device__ constexpr int prefetch_of(bool wide) {
  return wide ? 1 : kPrefetch;
}
constexpr int kSmemBytes = 232448;  // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNaN = 0x7fc00000u;

enum Mode : int {
  SUM_F32 = 0, SUM_I32 = 1, COUNT = 2, MIN_I32 = 3, MAX_I32 = 4,
  MIN_F32 = 5, MAX_F32 = 6, SUM_F64 = 7, SUM_I64 = 8
};

__host__ __device__ __forceinline__ bool is64(int mode) {
  return mode == SUM_F64 || mode == SUM_I64;
}

struct SegArgs {
  const void* key[kMaxDims];
  long long kmin[kMaxDims];
  int kdim[kMaxDims];
  int kwide[kMaxDims];  // 1: int64 lane, 0: int32 lane
  int ndims;
  const unsigned char* keep;   // null: every row below the row count
  const long long* num_rows;   // device row count, or null: row_limit
  long long row_limit;
  long long n;                 // rows of every lane
  int K;
  int nreq;
  const void* vals[kMaxReq];
  const unsigned char* valid[kMaxReq];
  void* out[kMaxReq];
  int mode[kMaxReq];
  int vwide[kMaxReq];  // 1: an 8-byte value lane (64-bit modes only)
  // per-thread instance: request q's first word among the f64-sum words
  // (SUM_F64), the f32-sum words (SUM_F32), the i64 words of a replica
  // (SUM_I64) or the other words of a replica; ndw, nfw, nlw and naw words
  // in all.  Shared memory: [ndw][thread] f64, [nfw][thread] f32, [warp]
  // [naw] 32-bit, [warp][nlw] 64-bit.
  int off[kMaxReq];
  int ndw, nfw, naw, nlw;
  // the end of the request group that starts at q (per-thread: one group)
  int gend[kMaxReq];
  // WIDE instances: per-warp, request q's first 32-bit unit in shared
  // memory; its first 32-bit unit in a partial row, the row's units and
  // the first row's unit in scratch (all 64-bit words on even units)
  int woff[kMaxReq];
  int poff[kMaxReq];
  int pw;
  long long pbase;
  long long* bad_out;
  unsigned* scratch;  // [0] ticket, [1, 1 + grid) dropped rows a block,
                      // then the partial rows [grid][nreq * K] (WIDE:
                      // from pbase, pw units a row)
};

__device__ __forceinline__ unsigned init_bits(int mode) {
  switch (mode) {
    case MIN_I32: return 0x7fffffffu;
    case MAX_I32: return 0x80000000u;
    case MIN_F32: return 0x7f800000u;  // +inf
    case MAX_F32: return 0xff800000u;  // -inf
    default: return 0u;  // sums and counts; 0.0f has all bits clear
  }
}

template <int M>
__device__ __forceinline__ unsigned fold_m(unsigned x, unsigned y) {
  if (M == SUM_F32)
    return __float_as_uint(__uint_as_float(x) + __uint_as_float(y));
  if (M == SUM_I32 || M == COUNT) return x + y;
  if (M == MIN_I32) return (int)x < (int)y ? x : y;
  if (M == MAX_I32) return (int)x > (int)y ? x : y;
  float a = __uint_as_float(x), b = __uint_as_float(y);
  if (a != a || b != b) return kNaN;
  return __float_as_uint(M == MIN_F32 ? fminf(a, b) : fmaxf(a, b));
}

__device__ __forceinline__ unsigned fold(int mode, unsigned x, unsigned y) {
  switch (mode) {
    case SUM_F32: return fold_m<SUM_F32>(x, y);
    case SUM_I32: return fold_m<SUM_I32>(x, y);
    case COUNT: return fold_m<COUNT>(x, y);
    case MIN_I32: return fold_m<MIN_I32>(x, y);
    case MAX_I32: return fold_m<MAX_I32>(x, y);
    case MIN_F32: return fold_m<MIN_F32>(x, y);
    default: return fold_m<MAX_F32>(x, y);
  }
}

// A 64-bit sum word (f64 bits for SUM_F64) plus another; 0 bits are +0.0.
__device__ __forceinline__ u64 fold64(int mode, u64 x, u64 y) {
  if (mode == SUM_F64)
    return __double_as_longlong(__longlong_as_double(x) +
                                __longlong_as_double(y));
  return x + y;
}

// Order-preserving int32 code of an f32 (bits) for the shared-memory
// atomics of MIN_F32 / MAX_F32: a NaN codes as the value that wins.
template <int M>
__device__ __forceinline__ unsigned fcode(unsigned x) {
  if ((x & 0x7fffffffu) > 0x7f800000u) return M == MIN_F32 ? 0x80000000u : 0x7fffffffu;
  return (int)x >= 0 ? x : x ^ 0x7fffffffu;
}

// An atomic word's init value, and its value (f32 bits) back from a code.
__device__ __forceinline__ unsigned atomic_init(int mode) {
  if (mode == MIN_F32) return 0x7f800000u;  // code of +inf
  if (mode == MAX_F32) return 0x807fffffu;  // code of -inf
  return init_bits(mode);
}

__device__ __forceinline__ unsigned atomic_value(int mode, unsigned c) {
  if (mode == MIN_F32) return c == 0x80000000u ? kNaN : ((int)c >= 0 ? c : c ^ 0x7fffffffu);
  if (mode == MAX_F32) return c == 0x7fffffffu ? kNaN : ((int)c >= 0 ? c : c ^ 0x7fffffffu);
  return c;
}

// The raw inputs of one 4-row group, as loaded.  A key lane's words: int32,
// rows 0-3 in lo; int64, rows 0-1 in lo and 2-3 in hi (low word first).
struct KeyRaw {
  uint4 lo, hi;
};

// A request's value words and validity bytes of rows 0-3 (32-bit lanes).
struct ReqRaw {
  uint4 v;
  unsigned vb;
};

// The same in the WIDE instances: an 8-byte lane's rows 0-1 in v and 2-3
// in v2, as a key lane's.
struct ReqRaw64 {
  uint4 v, v2;
  unsigned vb;
};

template <bool WIDE>
using RawOf = typename std::conditional<WIDE, ReqRaw64, ReqRaw>::type;

// Words w0 .. w0 + 3 of a 32-bit lane of nw words (0 past nw): one 16-byte
// load when VEC and the vector lies below nw, else element loads.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const unsigned* p, long long w0,
                                        long long nw) {
  if (VEC && w0 + 4 <= nw) return __ldcs(reinterpret_cast<const uint4*>(p + w0));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (w0 < nw) r.x = p[w0];
  if (w0 + 1 < nw) r.y = p[w0 + 1];
  if (w0 + 2 < nw) r.z = p[w0 + 2];
  if (w0 + 3 < nw) r.w = p[w0 + 3];
  return r;
}

// Bytes r0 .. r0 + 3 of a byte lane of n bytes, as one word (0 past n).
template <bool VEC>
__device__ __forceinline__ unsigned load4(const unsigned char* p, long long r0,
                                          long long n) {
  if (VEC && r0 + 4 <= n) return __ldcs(reinterpret_cast<const unsigned*>(p + r0));
  unsigned r = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (r0 + j < n) r |= (unsigned)p[r0 + j] << (8 * j);
  return r;
}

// One byte a row below n: the live rows when there is no keep mask.
__device__ __forceinline__ unsigned rows_below(long long r0, long long n) {
  unsigned r = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (r0 + j < n) r |= 1u << (8 * j);
  return r;
}

template <bool VEC>
__device__ __forceinline__ KeyRaw load_key(const SegArgs& a, int d, long long g,
                                           long long ge, long long nrows) {
  KeyRaw k;
  k.lo = k.hi = make_uint4(0u, 0u, 0u, 0u);
  if (g >= ge) return k;
  const unsigned* p = static_cast<const unsigned*>(a.key[d]);
  if (a.kwide[d]) {
    k.lo = load16<VEC>(p, 8 * g, 2 * nrows);
    k.hi = load16<VEC>(p, 8 * g + 4, 2 * nrows);
  } else {
    k.lo = load16<VEC>(p, 4 * g, nrows);
  }
  return k;
}

template <bool VEC, bool WIDE>
__device__ __forceinline__ RawOf<WIDE> load_req(const SegArgs& a, int q,
                                                long long g, long long ge,
                                                long long nrows) {
  RawOf<WIDE> r;
  r.v = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (WIDE) r.v2 = make_uint4(0u, 0u, 0u, 0u);
  r.vb = 0x01010101u;
  if (g >= ge) return r;
  if (a.vals[q]) {
    const unsigned* p = static_cast<const unsigned*>(a.vals[q]);
    if constexpr (WIDE) {
      if (a.vwide[q]) {
        r.v = load16<VEC>(p, 8 * g, 2 * nrows);
        r.v2 = load16<VEC>(p, 8 * g + 4, 2 * nrows);
      } else {
        r.v = load16<VEC>(p, 4 * g, nrows);
      }
    } else {
      r.v = load16<VEC>(p, 4 * g, nrows);
    }
  }
  if (a.valid[q]) r.vb = load4<VEC>(a.valid[q], 4 * g, nrows);
  return r;
}

__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Row j's 64-bit value word: an 8-byte lane's bits (VW), or a 4-byte
// lane's value widened (f32 -> f64 for SUM_F64, i32 -> i64 for SUM_I64).
template <int M, bool VW>
__device__ __forceinline__ u64 value64(const ReqRaw64& r, int j) {
  if (VW) {
    const uint4& h = j < 2 ? r.v : r.v2;
    const int i = 2 * (j & 1);
    return ((u64)word(h, i + 1) << 32) | word(h, i);
  }
  const unsigned w = word(r.v, j);
  if (M == SUM_F64) return __double_as_longlong((double)__uint_as_float(w));
  return (u64)(long long)(int)w;
}

// Folds key dimension d of the group's 4 rows into their slots; clears bit
// j of dom where row j's key falls outside [kmin, kmin + K_d).
__device__ __forceinline__ void fold_key(const SegArgs& a, int d,
                                         const KeyRaw& k, unsigned slot[4],
                                         unsigned& dom) {
  const unsigned long long kd = (unsigned)a.kdim[d];
  const unsigned long long lo = (unsigned long long)a.kmin[d];
  const bool wide = a.kwide[d];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4& h = j < 2 ? k.lo : k.hi;
    const int i = 2 * (j & 1);
    long long kv = wide ? (long long)(((unsigned long long)word(h, i + 1) << 32) | word(h, i))
                        : (long long)(int)word(k.lo, j);
    unsigned long long dv = (unsigned long long)kv - lo;  // 64-bit
    if (dv >= kd) dom &= ~(1u << j);
    slot[j] = slot[j] * (unsigned)kd + (unsigned)dv;
  }
}

// A shared-memory reduction of x into *p where on: add for sums and counts,
// signed min / max for the others (f32 as fcode), predicated, no branch.
template <int M>
__device__ __forceinline__ void red_shared(unsigned* p, unsigned x, bool on) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  if (M == SUM_I32 || M == COUNT)
    asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
                 " @q red.shared.add.u32 [%0], %1;\n}"
                 :: "r"(addr), "r"(x), "r"((unsigned)on));
  else if (M == MIN_I32 || M == MIN_F32)
    asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
                 " @q red.shared.min.s32 [%0], %1;\n}"
                 :: "r"(addr), "r"(x), "r"((unsigned)on));
  else
    asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
                 " @q red.shared.max.s32 [%0], %1;\n}"
                 :: "r"(addr), "r"(x), "r"((unsigned)on));
}

// The same for an i64 sum word: a 64-bit add, wrapping.
__device__ __forceinline__ void red_shared64(u64* p, u64 x, bool on) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @q red.shared.add.u64 [%0], %1;\n}"
               :: "r"(addr), "l"(x), "r"((unsigned)on));
}

// One request's rows of a warp (one a lane; slot -1: none) into the warp's
// accumulator words [word][warp]: the lanes of each slot fold in lane order
// and the slot's first lane updates the word.
template <int M>
__device__ __forceinline__ void warp_update(unsigned* acc, int slot,
                                            unsigned x, int lane, int warp) {
  unsigned todo = __ballot_sync(kFull, slot >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int s = __shfl_sync(kFull, slot, leader);
    const unsigned peers = __ballot_sync(kFull, slot == s);
    todo &= ~peers;
    unsigned r = __shfl_sync(kFull, x, leader);
    for (unsigned p = peers & (peers - 1); p; p &= p - 1)
      r = fold_m<M>(r, __shfl_sync(kFull, x, __ffs(p) - 1));
    if (lane == leader) {
      unsigned* w = acc + s * kWarps + warp;
      *w = fold_m<M>(*w, r);
    }
  }
  __syncwarp();
}

// warp_update for a 64-bit sum word.
template <int M>
__device__ __forceinline__ void warp_update64(u64* acc, int slot, u64 x,
                                              int lane, int warp) {
  unsigned todo = __ballot_sync(kFull, slot >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int s = __shfl_sync(kFull, slot, leader);
    const unsigned peers = __ballot_sync(kFull, slot == s);
    todo &= ~peers;
    u64 r = __shfl_sync(kFull, x, leader);
    for (unsigned p = peers & (peers - 1); p; p &= p - 1)
      r = fold64(M, r, __shfl_sync(kFull, x, __ffs(p) - 1));
    if (lane == leader) {
      u64* w = acc + s * kWarps + warp;
      *w = fold64(M, *w, r);
    }
  }
  __syncwarp();
}

// A step's rows of one request into the accumulators: row j of group u
// counts where slot[u][j] >= 0 and its validity byte is set, with value
// word raw[u].v (null values: 1 for COUNT, the row index for the
// positions).  Per-thread instance: f32 sums into facc [word][thread],
// other modes by atomics into the warp's replica of aacc; per-warp
// instance: warp_update into acc [word][warp].
template <int M, bool PER_THREAD, bool WIDE, class Raw>
__device__ __forceinline__ void apply(const SegArgs& a, int q, unsigned* acc,
                                      int off, const int (&slot)[kUnroll][4],
                                      const Raw (&raw)[kUnroll],
                                      long long base, int tid, int lane,
                                      int warp) {
  const bool has_vals = a.vals[q] != nullptr;
  unsigned* facc = acc + (WIDE && PER_THREAD ? 2 * a.ndw * kThreads : 0);
  unsigned* aacc = facc + a.nfw * kThreads + warp * a.naw;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r0 = (base + (long long)u * kThreads + tid) << 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned x = has_vals ? word(raw[u].v, j)
                            : (M == COUNT ? 1u : (unsigned)(r0 + j));
      if ((M == MIN_F32 || M == MAX_F32) && (x << 1) == 0u) x = 0u;  // -0.0
      const bool on = slot[u][j] >= 0 && ((raw[u].vb >> (8 * j)) & 0xffu);
      if (PER_THREAD) {
        if (M == SUM_F32) {
          // where the row does not count, +0.0 into slot 0: a sum that
          // starts at +0.0 is never -0.0, so adding +0.0 changes no bit
          unsigned* p = facc + (off + (on ? slot[u][j] : 0)) * kThreads + tid;
          *p = fold_m<M>(*p, on ? x : 0u);
        } else {
          red_shared<M>(aacc + off + slot[u][j], M == MIN_F32 || M == MAX_F32
                                                     ? fcode<M>(x) : x, on);
        }
      } else {
        warp_update<M>(acc, on ? off + slot[u][j] : -1, x, lane, warp);
      }
    }
  }
}

// apply for a 64-bit sum (WIDE instances): per-thread, an f64 sum into
// its words [word][thread] of acc (+0.0 into slot 0 where a row does not
// count, as an f32 sum), an i64 sum by 64-bit atomics into the warp's
// replica; per-warp, warp_update64 into acc [word][warp].
template <int M, bool PER_THREAD, bool VW>
__device__ __forceinline__ void apply64(const SegArgs& a, unsigned* acc,
                                        int off,
                                        const int (&slot)[kUnroll][4],
                                        const ReqRaw64 (&raw)[kUnroll],
                                        int tid, int lane, int warp) {
  double* dacc = reinterpret_cast<double*>(acc);
  u64* lacc = reinterpret_cast<u64*>(acc + (2 * a.ndw + a.nfw) * kThreads +
                                     kWarps * a.naw) + warp * a.nlw;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u64 x = value64<M, VW>(raw[u], j);
      const bool on = slot[u][j] >= 0 && ((raw[u].vb >> (8 * j)) & 0xffu);
      if (PER_THREAD) {
        if (M == SUM_F64) {
          double* p = dacc + (off + (on ? slot[u][j] : 0)) * kThreads + tid;
          *p = *p + (on ? __longlong_as_double(x) : 0.0);
        } else {
          red_shared64(lacc + off + slot[u][j], x, on);
        }
      } else {
        warp_update64<M>(reinterpret_cast<u64*>(acc),
                         on ? off + slot[u][j] : -1, x, lane, warp);
      }
    }
  }
}

template <bool PER_THREAD, bool WIDE>
__device__ __forceinline__ void apply_any(const SegArgs& a, int q,
                                          unsigned* acc, int off,
                                          const int (&slot)[kUnroll][4],
                                          const RawOf<WIDE> (&raw)[kUnroll],
                                          long long base, int tid, int lane,
                                          int warp) {
  if constexpr (WIDE) {
    const bool vw = a.vwide[q];
    if (a.mode[q] == SUM_F64) {
      if (vw) apply64<SUM_F64, PER_THREAD, true>(a, acc, off, slot, raw, tid, lane, warp);
      else apply64<SUM_F64, PER_THREAD, false>(a, acc, off, slot, raw, tid, lane, warp);
      return;
    }
    if (a.mode[q] == SUM_I64) {
      if (vw) apply64<SUM_I64, PER_THREAD, true>(a, acc, off, slot, raw, tid, lane, warp);
      else apply64<SUM_I64, PER_THREAD, false>(a, acc, off, slot, raw, tid, lane, warp);
      return;
    }
  }
  switch (a.mode[q]) {
    case SUM_F32: apply<SUM_F32, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
    case SUM_I32: apply<SUM_I32, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
    case COUNT: apply<COUNT, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
    case MIN_I32: apply<MIN_I32, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
    case MAX_I32: apply<MAX_I32, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
    case MIN_F32: apply<MIN_F32, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
    default: apply<MAX_F32, PER_THREAD, WIDE>(a, q, acc, off, slot, raw, base, tid, lane, warp); break;
  }
}

// The loads of one step (kUnroll groups a thread): the keep mask, the first
// key lane, and the first kPrefetch requests' values and validity.
template <bool WIDE>
struct Step {
  unsigned kw[kUnroll];
  KeyRaw k0[kUnroll];
  RawOf<WIDE> pre[prefetch_of(WIDE)][kUnroll];
};

template <bool VEC, bool WIDE>
__device__ __forceinline__ void load_step(const SegArgs& a, int q0, int npre,
                                          long long base, long long ge,
                                          long long nrows, int tid,
                                          Step<WIDE>& s) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long g = base + (long long)u * kThreads + tid;
    s.kw[u] = g >= ge ? 0u
              : a.keep ? load4<VEC>(a.keep, 4 * g, nrows)
                       : (VEC && 4 * g + 4 <= nrows ? 0x01010101u
                                                    : rows_below(4 * g, nrows));
    s.k0[u] = load_key<VEC>(a, 0, g, ge, nrows);
#pragma unroll
    for (int p = 0; p < prefetch_of(WIDE); ++p)
      if (p < npre) s.pre[p][u] = load_req<VEC, WIDE>(a, q0 + p, g, ge, nrows);
  }
}

// Codes a step's slots (-1 where a row is dead or out of the key domain,
// counted into bad) and applies every request of [q0, q1) to them.
template <bool VEC, bool PER_THREAD, bool WIDE>
__device__ __forceinline__ void run_step(const SegArgs& a, const Step<WIDE>& s,
                                         int q0, int q1, long long base,
                                         long long ge, long long nrows,
                                         unsigned* acc, unsigned& bad,
                                         int tid, int lane, int warp) {
  int slot[kUnroll][4];
  {
    unsigned sl[kUnroll][4], dom[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dom[u] = 0xfu;
#pragma unroll
      for (int j = 0; j < 4; ++j) sl[u][j] = 0u;
      fold_key(a, 0, s.k0[u], sl[u], dom[u]);
    }
    for (int d = 1; d < a.ndims; ++d) {
      KeyRaw kd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        kd[u] = load_key<VEC>(a, d, base + (long long)u * kThreads + tid, ge,
                              nrows);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold_key(a, d, kd[u], sl[u], dom[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = (s.kw[u] >> (8 * j)) & 0xffu;
        const bool in = (dom[u] >> j) & 1u;
        slot[u][j] = live && in ? (int)sl[u][j] : -1;
        if (live && !in && q0 == 0) ++bad;
      }
    }
  }
  const int K = a.K;
  for (int q = q0; q < q1; ++q) {
    RawOf<WIDE> raw[kUnroll];
    if (q - q0 < prefetch_of(WIDE)) {
#pragma unroll
      for (int p = 0; p < prefetch_of(WIDE); ++p)
        if (q - q0 == p) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) raw[u] = s.pre[p][u];
        }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        raw[u] = load_req<VEC, WIDE>(a, q, base + (long long)u * kThreads + tid,
                                     ge, nrows);
    }
    // per-warp: the WIDE instances place each request of a group at woff
    unsigned* qacc = !PER_THREAD && WIDE ? acc + a.woff[q] : acc;
    const int off = PER_THREAD ? a.off[q] : WIDE ? 0 : (q - q0) * K;
    apply_any<PER_THREAD, WIDE>(a, q, qacc, off, slot, raw, base, tid, lane,
                                warp);
  }
}

template <bool VEC, bool PER_THREAD, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_kernel(const __grid_constant__ SegArgs a) {
  extern __shared__ __align__(16) unsigned acc[];
  __shared__ unsigned s_bad[kWarps];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K;
  const int nacc = a.nreq * K;
  long long nrows = a.num_rows ? *a.num_rows : a.row_limit;
  nrows = nrows < 0 ? 0 : (nrows > a.n ? a.n : nrows);
  // this block's 4-row groups: [g0, g1); those holding a live row: < ge
  const long long groups = (a.n + 3) >> 2;
  const long long per_block = (groups + gridDim.x - 1) / gridDim.x;
  const long long g0 = min(groups, (long long)blockIdx.x * per_block);
  const long long g1 = min(groups, g0 + per_block);
  const long long ge = min(g1, (nrows + 3) >> 2);
  const long long stride = (long long)kThreads * kUnroll;
  unsigned* part = a.scratch + (WIDE ? a.pbase : 1 + gridDim.x);
  const long long pw = WIDE ? a.pw : nacc;  // 32-bit units a partial row
  // per-thread regions (the f64 words only in the WIDE instances)
  double* dacc = reinterpret_cast<double*>(acc);
  unsigned* facc = acc + (WIDE ? 2 * a.ndw * kThreads : 0);
  u64* lacc = reinterpret_cast<u64*>(facc + a.nfw * kThreads + kWarps * a.naw);
  unsigned bad = 0;

  for (int q0 = 0, q1; q0 < a.nreq; q0 = q1) {
    q1 = a.gend[q0];
    if (PER_THREAD) {
      if (WIDE)
        for (int w = 0; w < a.ndw; ++w) dacc[w * kThreads + tid] = 0.0;
      for (int w = 0; w < a.nfw; ++w) facc[w * kThreads + tid] = 0u;  // +0.0f
      for (int q = 0; q < a.nreq; ++q) {
        if (a.mode[q] == SUM_F32 || (WIDE && is64(a.mode[q]))) continue;
        const unsigned init = atomic_init(a.mode[q]);
        for (int i = tid; i < kWarps * K; i += kThreads)
          facc[a.nfw * kThreads + (i / K) * a.naw + a.off[q] + i % K] = init;
      }
      if (WIDE)
        for (int i = tid; i < kWarps * a.nlw; i += kThreads) lacc[i] = 0ull;
    } else if (WIDE) {
      for (int q = q0; q < q1; ++q) {
        if (is64(a.mode[q])) {
          u64* p = reinterpret_cast<u64*>(acc + a.woff[q]);
          for (int i = tid; i < K * kWarps; i += kThreads) p[i] = 0ull;
        } else {
          const unsigned init = init_bits(a.mode[q]);
          for (int i = tid; i < K * kWarps; i += kThreads)
            acc[a.woff[q] + i] = init;
        }
      }
    } else {
      for (int i = tid; i < (q1 - q0) * K * kWarps; i += kThreads)
        acc[i] = init_bits(a.mode[q0 + i / kWarps / K]);
    }
    __syncthreads();
    const int npre = min(prefetch_of(WIDE), q1 - q0);
    for (long long base = g0; base < ge; base += stride) {
      Step<WIDE> st;
      load_step<VEC, WIDE>(a, q0, npre, base, ge, nrows, tid, st);
      run_step<VEC, PER_THREAD, WIDE>(a, st, q0, q1, base, ge, nrows, acc,
                                      bad, tid, lane, warp);
    }
    __syncthreads();
    // the block's partial row for requests [q0, q1)
    unsigned* row = part + (long long)blockIdx.x * pw;
    if (PER_THREAD) {
      for (int w = warp; w < nacc; w += kWarps) {  // float sums: a warp a word
        const int q = w / K, k = w - q * K;
        if (WIDE && a.mode[q] == SUM_F64) {
          const double* col = dacc + (a.off[q] + k) * kThreads;
          double r = col[lane];
#pragma unroll
          for (int j = 1; j < kThreads / 32; ++j) r = r + col[j * 32 + lane];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) r = r + __shfl_xor_sync(kFull, r, o);
          if (lane == 0) reinterpret_cast<double*>(row + a.poff[q])[k] = r;
          continue;
        }
        if (a.mode[q] != SUM_F32) continue;
        const unsigned* col = facc + (a.off[q] + k) * kThreads;
        unsigned r = col[lane];
#pragma unroll
        for (int j = 1; j < kThreads / 32; ++j)
          r = fold_m<SUM_F32>(r, col[j * 32 + lane]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          r = fold_m<SUM_F32>(r, __shfl_xor_sync(kFull, r, o));
        if (lane == 0) row[WIDE ? a.poff[q] + k : w] = r;
      }
      for (int w = tid; w < nacc; w += kThreads) {  // the rest: by replica
        const int q = w / K, k = w - q * K, mode = a.mode[q];
        if (mode == SUM_F32 || (WIDE && mode == SUM_F64)) continue;
        if (WIDE && mode == SUM_I64) {
          const u64* col = lacc + a.off[q] + k;
          u64 r = col[0];
          for (int v = 1; v < kWarps; ++v) r += col[v * a.nlw];
          reinterpret_cast<u64*>(row + a.poff[q])[k] = r;
          continue;
        }
        const unsigned* col = facc + a.nfw * kThreads + a.off[q] + k;
        unsigned r = atomic_value(mode, col[0]);
        for (int v = 1; v < kWarps; ++v)
          r = fold(mode, r, atomic_value(mode, col[v * a.naw]));
        row[WIDE ? a.poff[q] + k : w] = r;
      }
    } else if (WIDE) {
      for (int w = tid; w < (q1 - q0) * K; w += kThreads) {
        const int q = q0 + w / K, k = w % K, mode = a.mode[q];
        if (is64(mode)) {
          const u64* col = reinterpret_cast<const u64*>(acc + a.woff[q]) + k * kWarps;
          u64 r = col[0];
#pragma unroll
          for (int v = 1; v < kWarps; ++v) r = fold64(mode, r, col[v]);
          reinterpret_cast<u64*>(row + a.poff[q])[k] = r;
        } else {
          const unsigned* col = acc + a.woff[q] + k * kWarps;
          unsigned r = col[0];
#pragma unroll
          for (int v = 1; v < kWarps; ++v) r = fold(mode, r, col[v]);
          row[a.poff[q] + k] = r;
        }
      }
    } else {
      for (int w = tid; w < (q1 - q0) * K; w += kThreads) {
        const int mode = a.mode[q0 + w / K];
        unsigned r = acc[w * kWarps];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) r = fold(mode, r, acc[w * kWarps + v]);
        row[q0 * K + w] = r;
      }
    }
    __syncthreads();  // before the next request group reuses acc
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(kFull, bad, o);
  if (lane == 0) s_bad[warp] = bad;
  __syncthreads();
  if (tid == 0) {
    unsigned b = 0;
    for (int w = 0; w < kWarps; ++w) b += s_bad[w];
    a.scratch[1 + blockIdx.x] = b;
  }
  // the last block to finish folds every block's partial row
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.scratch, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int nb = gridDim.x;
  if (warp == 0) {
    long long b = 0;
    for (int i = lane; i < nb; i += 32) b += __ldcg(a.scratch + 1 + i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) b += __shfl_xor_sync(kFull, b, o);
    if (lane == 0) *a.bad_out = b;
  }
  for (int w = tid; w < nacc; w += kThreads) {
    const int q = w / K, k = w - q * K, mode = a.mode[q];
    if (WIDE && is64(mode)) {
      // as the 32-bit words below, in 64-bit words (pw / 2 a row)
      const u64* p = reinterpret_cast<const u64*>(part + a.poff[q]) + k;
      const long long st = pw / 2;
      u64 r[4] = {0ull, 0ull, 0ull, 0ull};
      int b = 0;
      for (; b + 4 <= nb; b += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = fold64(mode, r[i], __ldcg(p + (long long)(b + i) * st));
      }
      for (; b < nb; ++b) r[0] = fold64(mode, r[0], __ldcg(p + (long long)b * st));
      static_cast<u64*>(a.out[q])[k] =
          fold64(mode, fold64(mode, r[0], r[1]), fold64(mode, r[2], r[3]));
      continue;
    }
    const unsigned* p = part + (WIDE ? a.poff[q] + k : w);
    if (mode == COUNT) {
      long long c = 0;
      for (int b = 0; b < nb; ++b) c += __ldcg(p + (long long)b * pw);
      static_cast<long long*>(a.out[q])[k] = c;
      continue;
    }
    // four interleaved chains (block b into chain b % 4; the last
    // nb % 4 blocks into chain 0), then a fixed tree
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = init_bits(mode);
    int b = 0;
    for (; b + 4 <= nb; b += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = fold(mode, r[i], __ldcg(p + (long long)(b + i) * pw));
    }
    for (; b < nb; ++b)
      r[0] = fold(mode, r[0], __ldcg(p + (long long)b * pw));
    static_cast<unsigned*>(a.out[q])[k] =
        fold(mode, fold(mode, r[0], r[1]), fold(mode, r[2], r[3]));
  }
}

int check_modes(int nreq, const int* modes) {
  if (nreq < 1 || nreq > kMaxReq) return (int)cudaErrorInvalidValue;
  for (int q = 0; q < nreq; ++q)
    if (modes[q] < SUM_F32 || modes[q] > SUM_I64) return (int)cudaErrorInvalidValue;
  return 0;
}

// The order the kernel takes the requests in: those that load values or
// validity first, so the loads issued with the keys (kPrefetch) are real
// ones; each output keeps its request.
void launch_order(int nreq, const int* loads, int* order) {
  int m = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int q = 0; q < nreq; ++q)
      if ((loads[q] != 0) == (pass == 0)) order[m++] = q;
}

// Where each request's words lie, for modes m[i] in launch order: shared
// memory (per-thread: off and the region sizes; per-warp: the groups and
// woff), the partial rows (poff, pw) and the dynamic shared memory.
struct Layout {
  bool wide;
  int off[kMaxReq], woff[kMaxReq], gend[kMaxReq], poff[kMaxReq];
  int ndw, nfw, naw, nlw, pw;
  size_t smem;
};

Layout make_layout(int K, int nreq, const int* m, int per_thread) {
  Layout L = {};
  int n64 = 0;
  for (int i = 0; i < nreq; ++i) n64 += is64(m[i]);
  L.wide = n64 > 0;
  int nd = 0, nf = 0, na = 0, nl = 0, p64 = 0, p32 = 0;
  for (int i = 0; i < nreq; ++i) {
    L.off[i] = K * (m[i] == SUM_F64 ? nd++ : m[i] == SUM_F32 ? nf++
                    : m[i] == SUM_I64 ? nl++ : na++);
    L.poff[i] = L.wide ? (is64(m[i]) ? 2 * K * p64++ : 2 * K * n64 + K * p32++)
                       : K * i;
  }
  L.ndw = K * nd; L.nfw = K * nf; L.naw = K * na; L.nlw = K * nl;
  L.pw = L.wide ? (2 * K * n64 + K * (nreq - n64) + 1) & ~1 : K * nreq;
  if (per_thread) {
    L.smem = ((size_t)(2 * nd + nf) * kThreads + (size_t)(na + 2 * nl) * kWarps) *
             K * 4;
    for (int i = 0; i < nreq; ++i) L.gend[i] = nreq;
    return L;
  }
  // per-warp: requests in groups that fit in shared memory, in order
  size_t cur = 0;
  int start = 0;
  L.smem = 0;
  for (int i = 0; i < nreq; ++i) {
    const size_t b = (size_t)K * kWarps * 4 * (is64(m[i]) ? 2 : 1);
    if (cur + b > (size_t)kSmemBytes) {
      L.gend[start] = i;
      start = i;
      cur = 0;
    }
    L.woff[i] = (int)(cur / 4);
    cur += b;
    if (cur > L.smem) L.smem = cur;
  }
  L.gend[start] = nreq;
  return L;
}

template <bool PER_THREAD, bool WIDE>
int configure(size_t smem, int* blocks_per_sm) {
  int err = (int)cudaFuncSetAttribute(
      seg_kernel<true, PER_THREAD, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      seg_kernel<false, PER_THREAD, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  // both instances hold the same shared memory; take the fewer blocks
  int a = 0, b = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, seg_kernel<true, PER_THREAD, WIDE>, kThreads, smem);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, seg_kernel<false, PER_THREAD, WIDE>, kThreads, smem);
  if (err) return err;
  *blocks_per_sm = a < b ? a : b;
  return *blocks_per_sm > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// The first 32-bit unit of the partial rows in scratch (even in the WIDE
// instances, so the 64-bit words are aligned).
long long partial_base(bool wide, int nblocks) {
  return wide ? (nblocks + 2) & ~1 : 1 + nblocks;
}

}  // namespace

SS_EXPORT int ss_segment_reduce_threads() { return kThreads; }

SS_EXPORT int ss_segment_reduce_smem_bytes() { return kSmemBytes; }

// The launch's grid and its scratch: nblocks, then uint32 words of scratch
// (1 ticket + nblocks dropped-row counts + nblocks partial rows).  loads[q]:
// whether request q reads values or validity (its place in launch order).
// The grid depends only on (n, the instance and its footprint, SM count).
SS_EXPORT int ss_segment_reduce_plan(long long n, int K, int nreq,
                                     const int* modes, const int* loads,
                                     int per_thread, int* nblocks,
                                     long long* words) {
  if (n < 0 || K < 1 || K > kMaxSegments) return (int)cudaErrorInvalidValue;
  int err = check_modes(nreq, modes);
  if (err) return err;
  int order[kMaxReq], m[kMaxReq];
  launch_order(nreq, loads, order);
  for (int i = 0; i < nreq; ++i) m[i] = modes[order[i]];
  const Layout L = make_layout(K, nreq, m, per_thread);
  if (L.smem > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  err = per_thread ? (L.wide ? configure<true, true>(L.smem, &per_sm)
                             : configure<true, false>(L.smem, &per_sm))
                   : (L.wide ? configure<false, true>(L.smem, &per_sm)
                             : configure<false, false>(L.smem, &per_sm));
  if (err) return err;
  long long groups = (n + 3) / 4;
  long long want = (groups + (long long)kThreads * kUnroll - 1) /
                   ((long long)kThreads * kUnroll);
  long long cap = (long long)per_sm * ss_multiprocessors();
  long long nb = want < cap ? want : cap;
  if (nb < 1) nb = 1;
  *nblocks = (int)nb;
  *words = partial_base(L.wide, (int)nb) + nb * (long long)L.pw;
  return 0;
}

// One launch (after a 4-byte memset of the ticket).  keys[d]: int32
// (key_wide 0) or int64 [n]; keep: bool [n] or null; num_rows: device int64
// row count or null (then row_limit); vals[q]: f32 / i32 [n], or f64 / i64
// (value_wide 1, 64-bit sums only), or null; valid[q]: bool [n] or null;
// outs[q]: [K] of int64 (COUNT, SUM_I64), f64 (SUM_F64), f32 (SUM_F32,
// MIN_F32, MAX_F32) or int32; bad: device int64, the live rows dropped out
// of the key domain; scratch from ss_segment_reduce_plan.
SS_EXPORT int ss_segment_reduce(int ndims, void* const* keys,
                                const int* key_wide, const long long* kmin,
                                const int* kdim, const void* keep,
                                const void* num_rows, long long row_limit,
                                long long n, int K, int nreq, const int* modes,
                                const int* value_wide, void* const* vals,
                                void* const* valid, void* const* outs,
                                void* bad, void* scratch, int per_thread,
                                int vec, int nblocks, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n < 0 || K < 1 || K > kMaxSegments ||
      nblocks < 1)
    return (int)cudaErrorInvalidValue;
  int err = check_modes(nreq, modes);
  if (err) return err;
  SegArgs a;
  long long domain = 1;
  for (int d = 0; d < ndims; ++d) {
    if (kdim[d] < 1) return (int)cudaErrorInvalidValue;
    a.key[d] = keys[d];
    a.kwide[d] = key_wide[d] ? 1 : 0;
    a.kmin[d] = kmin[d];
    a.kdim[d] = kdim[d];
    domain *= kdim[d];
    if (domain > K) return (int)cudaErrorInvalidValue;
  }
  if (domain != K) return (int)cudaErrorInvalidValue;
  for (int d = ndims; d < kMaxDims; ++d) {
    a.key[d] = nullptr; a.kwide[d] = 0; a.kmin[d] = 0; a.kdim[d] = 1;
  }
  a.ndims = ndims;
  a.keep = static_cast<const unsigned char*>(keep);
  a.num_rows = static_cast<const long long*>(num_rows);
  a.row_limit = row_limit;
  a.n = n;
  a.K = K;
  a.nreq = nreq;
  int loads[kMaxReq], order[kMaxReq], m[kMaxReq];
  for (int q = 0; q < nreq; ++q)
    loads[q] = vals[q] != nullptr || valid[q] != nullptr;
  launch_order(nreq, loads, order);
  for (int i = 0; i < nreq; ++i) m[i] = modes[order[i]];
  const Layout L = make_layout(K, nreq, m, per_thread);
  if (L.smem > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxReq; ++i) {
    bool on = i < nreq;
    int q = on ? order[i] : 0;
    if (on && vals[q] == nullptr &&
        !(modes[q] == COUNT || modes[q] == MIN_I32 || modes[q] == MAX_I32))
      return (int)cudaErrorInvalidValue;
    if (on && value_wide[q] && !is64(modes[q])) return (int)cudaErrorInvalidValue;
    a.vals[i] = on ? vals[q] : nullptr;
    a.valid[i] = on ? static_cast<const unsigned char*>(valid[q]) : nullptr;
    a.out[i] = on ? outs[q] : nullptr;
    a.mode[i] = on ? modes[q] : COUNT;
    a.vwide[i] = on && value_wide[q] ? 1 : 0;
    a.off[i] = on ? L.off[i] : 0;
    a.woff[i] = on ? L.woff[i] : 0;
    a.gend[i] = on ? L.gend[i] : 0;
    a.poff[i] = on ? L.poff[i] : 0;
  }
  a.ndw = L.ndw;
  a.nfw = L.nfw;
  a.naw = L.naw;
  a.nlw = L.nlw;
  a.pw = L.pw;
  a.pbase = partial_base(L.wide, nblocks);
  a.bad_out = static_cast<long long*>(bad);
  a.scratch = static_cast<unsigned*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(scratch, 0, 4, s);
  if (err) return err;
  const size_t smem = L.smem;
  if (L.wide) {
    if (per_thread && vec)
      seg_kernel<true, true, true><<<nblocks, kThreads, smem, s>>>(a);
    else if (per_thread)
      seg_kernel<false, true, true><<<nblocks, kThreads, smem, s>>>(a);
    else if (vec)
      seg_kernel<true, false, true><<<nblocks, kThreads, smem, s>>>(a);
    else
      seg_kernel<false, false, true><<<nblocks, kThreads, smem, s>>>(a);
  } else {
    if (per_thread && vec)
      seg_kernel<true, true, false><<<nblocks, kThreads, smem, s>>>(a);
    else if (per_thread)
      seg_kernel<false, true, false><<<nblocks, kThreads, smem, s>>>(a);
    else if (vec)
      seg_kernel<true, false, false><<<nblocks, kThreads, smem, s>>>(a);
    else
      seg_kernel<false, false, false><<<nblocks, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
