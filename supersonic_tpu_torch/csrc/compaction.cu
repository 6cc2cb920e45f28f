// Stable stream compaction: rows where `mask` is set move, in order, into a
// dense prefix of each payload's output.
//
// Replaces: supersonic_tpu/kernels/compaction.py::compact_kernel (the
// Pallas kernel that shift-doubles survivors within 128-lane rows, merges
// row groups and stitches tiles with a carried DMA row).
//
// What bounds it on an H100: device-memory bandwidth.  Each row's mask byte
// and payload bytes are read once and each kept row's payload bytes written
// once; there is no arithmetic to speak of.
//
// Design: one launch, one pass over the mask (Merrill and Garland's
// single-pass prefix scan with decoupled look-back).
//   - A block of 256 threads takes a tile of 4096 rows; its tile number
//     comes from a global counter (atomicAdd), so a block waits only on
//     tiles that have already started and the look-back always progresses.
//   - Each thread reads its 16 mask bytes as one 16-byte load and keeps
//     them as 16 bits; a block-wide scan of the bit counts gives every row
//     its rank in the tile.  The block publishes its kept count in its
//     64-bit status word at once (flag AGGREGATE), then warp 0 walks back
//     over the status words of the tiles before it, 32 at a time, summing
//     aggregates until it meets an inclusive prefix (flag PREFIX), and
//     publishes its own inclusive prefix.  The flag and the count share one
//     word, written with one store, so no fence orders them.  The status
//     words and the counter are zeroed by a cudaMemsetAsync on the caller's
//     stream before the launch.  The last tile writes min(total, out_cap)
//     into the count: no scan, subtraction or clamp runs outside.
//   - Payloads move one at a time through a stage in shared memory.  Each
//     warp reads its 512 rows of the payload with coalesced 16-byte loads
//     (lane l takes vectors l, l + 32, ...); the owner of a vector's rows
//     hands over its mask bits and rank with one shuffle, and every kept row
//     goes to the stage at its rank.  The block then writes the tile's
//     contiguous output run [offset, offset + kept) with 16-byte stores from
//     the first 16-byte-aligned output row, scalar stores at the head and
//     tail; the stage is shifted so that those stores read aligned vectors.
//   - Kernels are instances per lane width (1, 2, 4, 8 bytes: no per-row
//     switch).  A mask or payload that is not 16-byte aligned (a view at an
//     odd offset) takes the instance with element loads, chosen by the
//     wrapper; the ragged last tile takes element loads too.
// Rows at or past `out_cap` are dropped: a tile whose run starts there moves
// nothing.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char compact_stage[];

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // 4096 rows a block
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32 * kRowsPerThread;    // 512 rows a warp
constexpr unsigned kFull = 0xffffffffu;

// Status word of a tile: a flag in the top two bits, a row count below.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own count
constexpr unsigned long long kPrefix = 2ull << 62;     // rows up to its end
constexpr unsigned long long kCount = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

template <int W> struct Elem;
template <> struct Elem<1> { using T = uint8_t; };
template <> struct Elem<2> { using T = uint16_t; };
template <> struct Elem<4> { using T = uint32_t; };
template <> struct Elem<8> { using T = unsigned long long; };

// Bit r set where row row0 + r (r < 16) is kept.
template <bool kVec>
__device__ __forceinline__ unsigned mask_bits(const uint8_t* __restrict__ mask,
                                              long long row0, long long n) {
  unsigned bits = 0;
  if (kVec && row0 + kRowsPerThread <= n) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(mask + row0));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // one bit a byte at bits 0, 8, 16, 24; the product gathers them
      // into bits 28..31 without carries
      const unsigned b = __vcmpne4(w[k], 0u) & 0x01010101u;
      bits |= ((b * 0x10204080u) >> 28) << (4 * k);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      if (row0 + r < n && __ldg(mask + row0 + r) != 0) bits |= 1u << r;
  }
  return bits;
}

// Moves one payload of W-byte elements: stages the tile's kept rows at
// their ranks, then writes the run [offset, offset + m) of `dst`.
// `pk` is this thread's (exclusive rank in the tile << 16) | mask bits.
template <int W, bool kVec>
__device__ __forceinline__ void move_lane(const void* src_v, void* dst_v,
                                          long long tile_row0, long long n,
                                          bool whole, unsigned pk,
                                          long long offset, int m) {
  using E = typename Elem<W>::T;
  constexpr int V = 16 / W;  // rows a 16-byte vector
  const E* __restrict__ src = static_cast<const E*>(src_v);
  E* __restrict__ dst = static_cast<E*>(dst_v);
  E* stage = reinterpret_cast<E*>(compact_stage);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // stage index of rank 0: output row o sits at stage index o - obase, and
  // obase is a multiple of V, so aligned output vectors read aligned ones
  const int sh = (int)(offset & (V - 1));
  union Vec { uint4 q; E e[V]; };
  Vec v[W];  // W vectors a thread: its warp's vectors lane, lane + 32, ...
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const long long row = tile_row0 + warp * kWarpRows + (k * 32 + lane) * V;
    if (kVec && whole) {
      v[k].q = __ldcs(reinterpret_cast<const uint4*>(src + row));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[k].e[e] = row + e < n ? __ldg(src + row + e) : E(0);
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int r0 = (k * 32 + lane) * V;  // first row of the vector, in the warp
    const unsigned own = __shfl_sync(kFull, pk, r0 >> 4);
    const int rank = (int)(own >> 16);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int b = (r0 & 15) + e;
      if ((own >> b) & 1u)
        stage[sh + rank + __popc(own & ((1u << b) - 1u))] = v[k].e[e];
    }
  }
  __syncthreads();
  const long long obase = offset - sh;
  const long long end = offset + m;
  const int qfirst = sh ? 1 : 0;              // vectors wholly inside the run
  const int qend = (int)((end - obase) / V);
  const uint4* sv = reinterpret_cast<const uint4*>(stage);
  uint4* dv = reinterpret_cast<uint4*>(dst + obase);
  for (int q = qfirst + threadIdx.x; q < qend; q += kThreads) dv[q] = sv[q];
  // the head before the first aligned row and the tail after the last
  const long long head_end = sh ? min(obase + V, end) : offset;
  const long long tail = max(obase + (long long)V * qend, head_end);
  if (threadIdx.x < V) {
    const long long h = offset + threadIdx.x;
    if (h < head_end) dst[h] = stage[h - obase];
    const long long t = tail + threadIdx.x;
    if (t < end) dst[t] = stage[t - obase];
  }
  __syncthreads();  // the next payload reuses the stage
}

// kWide: some payload has 8-byte elements (a larger stage and more
// registers); the other instance moves 1-, 2- and 4-byte payloads.
template <bool kVec, bool kWide>
__global__ void __launch_bounds__(kThreads, 4)
compact_kernel(const uint8_t* __restrict__ mask, long long n,
               long long out_cap, int npay, SsArrays a,
               unsigned long long* __restrict__ status,
               int* __restrict__ tile_counter, long long* __restrict__ count,
               int ntiles) {
  __shared__ int s_tile;
  __shared__ int warp_total[kWarps];
  __shared__ long long s_offset;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long tile_row0 = (long long)tile * kTile;
  const bool whole = tile_row0 + kTile <= n;

  // the mask: 16 rows a thread, their ranks by a block-wide scan
  const unsigned bits =
      mask_bits<kVec>(mask, tile_row0 + threadIdx.x * kRowsPerThread, n);
  const int own = __popc(bits);
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_total[w];
    if (w < warp) before += t;
    total += t;
  }
  const unsigned pk = ((unsigned)(before + incl - own) << 16) | bits;

  // the tile's output offset: decoupled look-back by warp 0
  if (warp == 0) {
    if (lane == 0)
      store_status(status + tile,
                   (tile == 0 ? kPrefix : kAggregate) | (unsigned long long)total);
    long long excl = 0;
    for (int pred = tile - 1; pred >= 0; pred -= 32) {
      const int i = pred - lane;
      unsigned long long s = kPrefix;  // before tile 0: a prefix of 0 rows
      if (i >= 0) {
        do {
          s = load_status(status + i);
        } while ((s >> 62) == 0);
      }
      const unsigned pm = __ballot_sync(kFull, (s >> 62) == 2);
      const int last = pm ? __ffs(pm) - 1 : 31;  // nearest prefix, inclusive
      long long c = lane <= last ? (long long)(s & kCount) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
      excl += c;
      if (pm) break;
    }
    if (lane == 0) {
      if (tile > 0)
        store_status(status + tile,
                     kPrefix | (unsigned long long)(excl + total));
      s_offset = excl;
      if (tile == ntiles - 1) *count = min(excl + total, out_cap);
    }
  }
  __syncthreads();
  const long long offset = s_offset;
  if (npay == 0 || total == 0 || offset >= out_cap) return;  // uniform
  const int m = (int)min((long long)total, out_cap - offset);
  for (int p = 0; p < npay; ++p) {  // uniform across the block
    switch (a.width[p]) {
      case 1: move_lane<1, kVec>(a.src[p], a.dst[p], tile_row0, n, whole, pk, offset, m); break;
      case 2: move_lane<2, kVec>(a.src[p], a.dst[p], tile_row0, n, whole, pk, offset, m); break;
      case 4: move_lane<4, kVec>(a.src[p], a.dst[p], tile_row0, n, whole, pk, offset, m); break;
      default:
        if constexpr (kWide)
          move_lane<8, kVec>(a.src[p], a.dst[p], tile_row0, n, whole, pk, offset, m);
        break;
    }
  }
}

template <bool kVec, bool kWide>
int launch(const uint8_t* mask, long long n, long long out_cap, int npay,
           const SsArrays& a, unsigned long long* status, long long* count,
           int ntiles, cudaStream_t s) {
  const int smem = npay ? kTile * (kWide ? 8 : 4) + 16 : 0;
  compact_kernel<kVec, kWide><<<ntiles, kThreads, smem, s>>>(
      mask, n, out_cap, npay, a, status, reinterpret_cast<int*>(status + ntiles),
      count, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

SS_EXPORT int ss_compact_tile_rows() { return kTile; }

// One launch.  `scratch`: int64[ceil(n / 4096) + 1], the tiles' status
// words and the tile counter, zeroed here on `stream`; `count`: the 0-d
// int64 row count, min(kept, out_cap).  `vec`: 1 when the mask and every
// payload are 16-byte aligned (16-byte loads), 0 for element loads.
SS_EXPORT int ss_compact(const void* mask, long long n, long long out_cap,
                         int vec, int npay, void* const* src, void* const* dst,
                         const int* width, void* count, void* scratch,
                         long long scratch_words, void* stream) {
  if (n <= 0 || out_cap <= 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kTile - 1) / kTile;
  if (scratch_words < ntiles + 1 || ntiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SsArrays a;
  int err = ss_fill_arrays(&a, npay, src, dst, width);
  if (err) return err;
  bool wide = false;
  for (int j = 0; j < npay; ++j) wide = wide || width[j] == 8;
  cudaStream_t s = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(scratch, 0, (ntiles + 1) * 8, s);
  if (err) return err;
  const uint8_t* m = (const uint8_t*)mask;
  unsigned long long* st = (unsigned long long*)scratch;
  long long* c = (long long*)count;
  const int nt = (int)ntiles;
  if (vec) {
    return wide ? launch<true, true>(m, n, out_cap, npay, a, st, c, nt, s)
                : launch<true, false>(m, n, out_cap, npay, a, st, c, nt, s);
  }
  return wide ? launch<false, true>(m, n, out_cap, npay, a, st, c, nt, s)
              : launch<false, false>(m, n, out_cap, npay, a, st, c, nt, s);
}

SS_EXPORT const char* ss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
