// segment_plan: a CSR view of the rows that count for the PointNet's
// segment max pools, built once per PointNet call and read by its four
// pools (segment_max.cu).
//
// Replaces: no TPU kernel of its own. It stands for the sorted segment ids
// that tdvnet/models/pointnet.py `_segmax` (:19-22) hands XLA's segment max
// (its anchor-sorted form takes `VoxelGrid.order`, a sort of the points),
// made here without a sort: the pools then walk segments, not points.
//
// Output, in one int32 buffer the wrapper allocates:
//   offsets [n_seg + 1]  segment s holds rows[offsets[s] .. offsets[s + 1]);
//   rows    [P]          the counted rows (the first offsets[n_seg] entries;
//                        the rest is left as it was);
//   longs   [1 + cap]    the number of segments of more than kLong rows, then
//                        their ids (cap = P / (kLong + 1) + 1 can hold all);
//   first   [n_work + 1] the pools' work partition: segment s costs 1 + its
//                        rows and starts at offsets[s] + s; first[w] is the
//                        first segment that starts at or past w * kWork
//                        (n_seg past the last), for every w with w * kWork
//                        <= offsets[n_seg] + n_seg, and for the one after
//                        (n_work = (P + n_seg) / kWork + 1 bounds them).
// Scratch, per stream, from the wrapper: counts [n_seg + 1], zero on entry
// and zero again after the placement (no fill), and the scan's tile sums.
// A row counts when it is valid and 0 <= seg < n_seg. The order of the rows
// within a segment, and of the long list, changes from run to run (they are
// placed by integer atomics); a max does not depend on it, so the pools give
// the same bits on every run.
//
// Bound on an H100: bytes. The ids (8 B) and flags (1 B) of every point
// read once, offsets and rows written once: ~2.2 MB at the 52-view scene
// (150528 points, 262145 segments), 0.7 us at 3.35 TB/s; the calls are
// launch-bound at both of the main path's sizes.
//
// Design:
//   histogram  one thread per point; the points of a warp that share a
//              segment (neighbouring pixels of one ref mostly share their
//              anchor) add their count once, by its lowest lane
//              (`__match_any_sync`);
//   scan       exclusive prefix sum over the n_seg + 1 counts (the last one
//              0, so offsets[n_seg] is the total): tile sums, then each
//              tile rescanned with the sum of the tiles before it (a block
//              adds at most a few hundred tile sums itself, so no launch
//              scans them; `block_scan.cuh`). The rescan lists the long
//              segments and writes the work partition;
//   placement  one thread per point; a warp's peers in one segment take
//              their slots with one atomicSub on the segment's count,
//              which leaves the counts zero.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "segment_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 4;                       // counts per thread
constexpr int kScanTile = kThreads * kScanItems;    // counts per block
constexpr int kLong = tdv::kSegmentLong;
constexpr int kWork = tdv::kSegmentWork;
constexpr unsigned kFull = 0xffffffffu;

using tdv::block_exclusive_scan;

// the point's segment if it counts, else -1
__device__ __forceinline__ int counted_segment(const long long* __restrict__ seg,
                                               const uint8_t* __restrict__ valid,
                                               int p, int P, int n_seg) {
  if (p >= P || !valid[p]) return -1;
  const long long s = seg[p];
  return s >= 0 && s < n_seg ? (int)s : -1;
}

__global__ void segment_plan_histogram_kernel(
    const long long* __restrict__ seg, const uint8_t* __restrict__ valid,
    int* __restrict__ counts, int P, int n_seg) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int s = counted_segment(seg, valid, p, P, n_seg);
  const unsigned active = __ballot_sync(kFull, s >= 0);
  if (s < 0) return;
  const unsigned peers = __match_any_sync(active, s);
  if ((threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&counts[s], __popc(peers));
}

// tile sums; also empties the long list before the rescan fills it
__global__ void segment_plan_scan_reduce_kernel(const int* __restrict__ counts,
                                                int* __restrict__ tile_sums,
                                                int* __restrict__ longs,
                                                int n) {
  __shared__ int smem[33];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (base + i < n) s += counts[base + i];
  int total;
  block_exclusive_scan<kThreads>(s, smem, &total);
  if (threadIdx.x == 0) {
    tile_sums[blockIdx.x] = total;
    if (blockIdx.x == 0) longs[0] = 0;
  }
}

// the work partition's entries that segment i (start `at_i`, the segment
// before it starting at `at_prev`, -1 for none) owns
__device__ __forceinline__ void partition(int* __restrict__ first, int i,
                                          long long at_prev, long long at_i) {
  const long long w0 = at_prev < 0 ? 0 : at_prev / kWork + 1;
  for (long long w = w0; w <= at_i / kWork; ++w) first[w] = i;
}

__global__ void segment_plan_scan_apply_kernel(
    const int* __restrict__ counts, const int* __restrict__ tile_sums,
    int* __restrict__ offsets, int* __restrict__ longs,
    int* __restrict__ first, int n) {
  __shared__ int smem[33];
  // the tiles before this one, summed here
  int part = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += kThreads)
    part += tile_sums[t];
  int before;
  block_exclusive_scan<kThreads>(part, smem, &before);
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int c[kScanItems];
  int s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    c[i] = base + i < n ? counts[base + i] : 0;
    s += c[i];
  }
  int total;
  int at = block_exclusive_scan<kThreads>(s, smem, &total) + before;
  // the start (offset + index) of the segment before this thread's first
  long long prev = base == 0 ? -1
                             : (long long)at - counts[base - 1] + base - 1;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int k = base + i;
    if (k >= n) break;
    offsets[k] = at;
    if (c[i] > kLong) longs[1 + atomicAdd(&longs[0], 1)] = k;
    const long long start = (long long)at + k;
    partition(first, k, prev, start);
    if (k == n - 1) first[start / kWork + 1] = k;   // past the last warp
    prev = start;
    at += c[i];
  }
}

__global__ void segment_plan_place_kernel(
    const long long* __restrict__ seg, const uint8_t* __restrict__ valid,
    const int* __restrict__ offsets, int* __restrict__ counts,
    int* __restrict__ rows, int P, int n_seg) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int s = counted_segment(seg, valid, p, P, n_seg);
  const unsigned active = __ballot_sync(kFull, s >= 0);
  if (s < 0) return;
  const unsigned peers = __match_any_sync(active, s);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  const int n = __popc(peers);
  int left = 0;                    // the count before this warp's peers
  if (lane == leader) left = atomicSub(&counts[s], n);
  left = __shfl_sync(peers, left, leader);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  rows[offsets[s] + left - n + rank] = p;
}

inline unsigned blocks_for(long long n, int per) {
  return (unsigned)((n + per - 1) / per);
}

}  // namespace

// The wrapper checks P < 2^31 and n_seg + 1 < 2^31, allocates `buf` with
// (n_seg + 1) + P + (1 + cap) + (n_work + 1) ints and hands the per-stream
// scratch: `counts`, n_seg + 1 zero ints (left zero), and `tile_sums`,
// n_tiles ints.
extern "C" int tdv_segment_plan(const long long* seg, const uint8_t* valid,
                                int* buf, int* counts, int* tile_sums, int P,
                                int n_seg, int cap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = n_seg + 1;
  const int n_tiles = (int)blocks_for(n, kScanTile);
  int* offsets = buf;
  int* rows = offsets + n;
  int* longs = rows + P;
  int* first = longs + 1 + cap;
  if (P > 0)
    segment_plan_histogram_kernel<<<blocks_for(P, kThreads), kThreads, 0,
                                    st>>>(seg, valid, counts, P, n_seg);
  segment_plan_scan_reduce_kernel<<<n_tiles, kThreads, 0, st>>>(
      counts, tile_sums, longs, n);
  segment_plan_scan_apply_kernel<<<n_tiles, kThreads, 0, st>>>(
      counts, tile_sums, offsets, longs, first, n);
  if (P > 0)
    segment_plan_place_kernel<<<blocks_for(P, kThreads), kThreads, 0, st>>>(
        seg, valid, offsets, counts, rows, P, n_seg);
  return (int)cudaGetLastError();
}
