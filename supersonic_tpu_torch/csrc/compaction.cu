// Stable stream compaction: rows where `mask` is set move, in order, into a
// dense prefix of each payload's output.
//
// Replaces: supersonic_tpu/kernels/compaction.py::compact_kernel (the
// Pallas kernel that shift-doubles survivors within 128-lane rows, merges
// row groups and stitches tiles with a carried DMA row).
//
// What bounds it on an H100: device-memory bandwidth.  Each row reads its
// mask byte twice and its payload bytes once, and each kept row writes its
// payload bytes once; there is no arithmetic to speak of.
//
// Design: two launches and a scan between them.
//   (1) count: one block of 1024 threads per 1024 rows; __syncthreads_count
//       gives the block's kept count.
//   (2) the exclusive scan of the block counts runs in the wrapper
//       (torch.cumsum over n/1024 values), as the TPU kernel's tile offsets
//       ran outside its kernel too.
//   (3) scatter: the same blocks again.  A warp's __ballot_sync and __popc
//       give each kept row its rank in the warp, one warp scans the 32
//       warp totals in shared memory, and the row writes every payload at
//       block offset + warp offset + rank.  Neighbouring kept rows write
//       neighbouring addresses, so stores stay coalesced.
// Payloads of 1, 2, 4 and 8 bytes move natively (a double moves bit for
// bit; no word split).  Rows at or past `out_cap` are dropped.
#include "common.cuh"

namespace {

constexpr int kRows = 1024;  // rows per block, one per thread

__global__ void __launch_bounds__(kRows)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ counts) {
  long long i = (long long)blockIdx.x * kRows + threadIdx.x;
  int m = (i < n) ? (mask[i] != 0) : 0;
  int c = __syncthreads_count(m);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kRows)
scatter_kernel(const uint8_t* __restrict__ mask, long long n,
               const long long* __restrict__ offsets, long long out_cap,
               int npay, SsArrays a) {
  __shared__ int warp_base[kRows / 32];
  long long i = (long long)blockIdx.x * kRows + threadIdx.x;
  bool m = (i < n) && (mask[i] != 0);
  unsigned lane = threadIdx.x & 31u;
  unsigned warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xffffffffu, m);
  int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int own = warp_base[lane];  // kRows / 32 == 32 warp totals
    int v = own;
    for (int d = 1; d < 32; d <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, v, d);
      if ((int)lane >= d) v += t;
    }
    warp_base[lane] = v - own;  // exclusive prefix
  }
  __syncthreads();
  if (!m) return;
  long long pos = offsets[blockIdx.x] + warp_base[warp] + rank;
  if (pos >= out_cap) return;
  for (int j = 0; j < npay; ++j) ss_move(a.src[j], i, a.dst[j], pos, a.width[j]);
}

}  // namespace

SS_EXPORT int ss_compact_block_rows() { return kRows; }

// counts: int32[ceil(n / 1024)]
SS_EXPORT int ss_compact_count(const void* mask, long long n, void* counts,
                               void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kRows - 1) / kRows;
  count_kernel<<<(unsigned)blocks, kRows, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, (int*)counts);
  return (int)cudaGetLastError();
}

// offsets: int64[ceil(n / 1024)], the exclusive scan of the block counts.
SS_EXPORT int ss_compact_scatter(const void* mask, long long n,
                                 const void* offsets, long long out_cap,
                                 int npay, void* const* src, void* const* dst,
                                 const int* width, void* stream) {
  if (n <= 0 || npay == 0) return 0;
  SsArrays a;
  int err = ss_fill_arrays(&a, npay, src, dst, width);
  if (err) return err;
  long long blocks = (n + kRows - 1) / kRows;
  scatter_kernel<<<(unsigned)blocks, kRows, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, (const long long*)offsets, out_cap, npay, a);
  return (int)cudaGetLastError();
}

SS_EXPORT const char* ss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
