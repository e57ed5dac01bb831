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
// and zero again when the launch ends (no fill); the scan's tile states
// [n_tiles] (uint64) and tile flags [n_tiles] (uint32), which hold the epoch
// of the launch that last wrote them (the wrapper counts epochs up from 1,
// so no reset is needed); ranks [P], used only for the points a thread
// cannot keep in registers. A row counts when it is valid and 0 <= seg <
// n_seg. The order of the rows within a segment, and of the long list,
// changes from run to run (ranks are taken by integer atomics); a max does
// not depend on it, so the pools give the same bits on every run.
//
// Bound on an H100: bytes. The ids (8 B) and flags (1 B) of every point
// read once, offsets and rows written once: ~2.2 MB at the 52-view scene
// (150528 points, 262145 segments), 0.7 us at 3.35 TB/s; far below one
// launch, so the design counts launches and dependent round trips, not
// bytes.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel: a grid no
// larger than the card holds at once, each block looping over its share)
// in three phases, with one grid barrier:
//   histogram  a thread takes kPerThread points where the grid allows (all
//              its loads in flight together); the points of a warp that
//              share a segment (neighbouring pixels of one ref mostly share
//              their anchor) take their ranks with one atomicAdd on the
//              segment's count, by their lowest lane (`__match_any_sync`),
//              every point's atomic issued before the first result is used;
//              a thread keeps up to kPoints segments and ranks in registers
//              (past that, the ranks go to the scratch);
//   (the grid barrier: every count is complete)
//   scan       a block a tile of kScanTile counts, in one pass: the tile's
//              own prefix sum (`block_scan.cuh`), its total published in the
//              tile states, then a decoupled look-back by one warp over the
//              tiles before it, 32 at a time, down to the nearest that holds
//              its inclusive prefix (every block is resident, and a block
//              publishes before it waits), then its own prefix published. It
//              zeroes its counts, writes the offsets (the count past the last
//              segment is 0, so offsets[n_seg] is the total), lists the long
//              segments and writes the work partition (segment k writes the
//              entries segment k + 1 owns, from its own start and count; a
//              long run by the whole block), then raises the tile's flag;
//   placement  every point waits for its segment's tile flag (a block has
//              done its own tiles before it gets here), then writes its row
//              at offsets[s] + rank.
// Data another block wrote is read after an acquire at the device's scope
// (tile states, tile flags) or with __ldcg (L2, never a stale L1 line).
// Measured no faster at the main path's two sizes: a look-back that reads
// 64 to 256 states a round (packed, or a state to a line), a second grid
// barrier after the tiles' totals in place of the look-back, tiles of
// 4096 counts and 1024-thread blocks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "segment_plan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPoints = 4;            // points a thread keeps in registers
constexpr int kPerThread = 1;         // points a thread takes, where it can
constexpr int kScanItems = 2;                       // counts per thread
constexpr int kScanTile = kThreads * kScanItems;    // counts per block
constexpr int kMaxBlocksPerSm = 2;
constexpr int kSpans = 32;            // a tile's long partition runs
constexpr int kSpanMin = 8;           // entries that make a run long
constexpr int kLong = tdv::kSegmentLong;
constexpr int kWork = tdv::kSegmentWork;
constexpr unsigned kFull = 0xffffffffu;

using tdv::block_exclusive_scan;

struct Args {
  const long long* seg;
  const uint8_t* valid;
  int* offsets;
  int* rows;
  int* longs;
  int* first;
  int* counts;
  unsigned long long* tiles;
  unsigned* flags;
  int* ranks;
  int P, n_seg;
  unsigned epoch;
};

// the point's segment if it counts, else -1 (both loads issued at once)
__device__ __forceinline__ int counted_segment(const long long* __restrict__ seg,
                                               const uint8_t* __restrict__ valid,
                                               long long p, int P, int n_seg) {
  if (p >= P) return -1;
  const long long s = __ldg(seg + p);
  const bool ok = __ldg(valid + p);
  return ok && s >= 0 && s < n_seg ? (int)s : -1;
}

// each point's rank within its segment s[j] (-1: none): a warp's points of
// one segment take theirs with one atomicAdd, by the lowest lane
__device__ __forceinline__ void rank_points(const int (&s)[kPoints],
                                            int (&rank)[kPoints],
                                            int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  unsigned peers[kPoints];
  int old[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const unsigned active = __ballot_sync(kFull, s[j] >= 0);
    peers[j] = 0;
    old[j] = 0;
    if (s[j] >= 0) {
      peers[j] = __match_any_sync(active, s[j]);
      if (lane == __ffs(peers[j]) - 1)
        old[j] = atomicAdd(&counts[s[j]], __popc(peers[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    rank[j] = 0;
    if (s[j] < 0) continue;
    rank[j] = __shfl_sync(peers[j], old[j], __ffs(peers[j]) - 1) +
              __popc(peers[j] & ((1u << lane) - 1u));
  }
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

struct TileShared {
  int scan[33];
  int before;           // the counts of the tiles before this one
  int n_spans;
  int3 spans[kSpans];   // (first entry, last entry, segment)
};

// a tile state: its value (bits 0-31), whether that is the tile's inclusive
// prefix or only its own total (bit 32), and the launch's epoch (33-63)
constexpr unsigned long long kPrefix = 1ull << 32;

__device__ __forceinline__ unsigned long long tile_state(unsigned epoch,
                                                         bool prefix, int v) {
  return (unsigned long long)epoch << 33 | (prefix ? kPrefix : 0) |
         (unsigned)v;
}

// warp 0 of tile t: publishes the tile's total, then sums the tiles before
// it from the nearest down, 32 at a time, until one holds its inclusive
// prefix (tile 0 always does); publishes the tile's own prefix and leaves
// the sum before it in sh.before
__device__ void look_back(const Args& a, int t, int total, TileShared& sh) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) publish(a.tiles + t, tile_state(a.epoch, t == 0, total));
  int run = 0;
  for (int top = t - 1; top >= 0; top -= 32) {
    const int k = top - lane;
    unsigned long long v = kPrefix;       // before tile 0: a prefix of 0
    if (k >= 0) {
      do {
        v = acquire(a.tiles + k);
      } while ((unsigned)(v >> 33) != a.epoch);
    }
    const unsigned pm = __ballot_sync(kFull, (v & kPrefix) != 0);
    int x = pm == 0 || lane < __ffs(pm) ? (int)(unsigned)v : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
    run += x;
    if (pm) break;
  }
  if (lane == 0) {
    sh.before = run;
    if (t > 0) publish(a.tiles + t, tile_state(a.epoch, true, run + total));
  }
}

// the work partition's entries in [w0, w1] take segment i: a short run
// here, a long one listed for the whole block
__device__ __forceinline__ void partition(int* __restrict__ first, int i,
                                          long long w0, long long w1,
                                          TileShared& sh) {
  if (w1 - w0 >= kSpanMin) {
    const int slot = atomicAdd(&sh.n_spans, 1);
    if (slot < kSpans) {
      sh.spans[slot] = make_int3((int)w0, (int)w1, i);
      return;
    }
  }
  for (long long w = w0; w <= w1; ++w) first[w] = i;
}

// one tile of the scan: offsets, long segments and work partition of the
// counts [t * kScanTile, (t + 1) * kScanTile); the counts left zero
__device__ void scan_tile(const Args& a, int t, int n, TileShared& sh) {
  const int base = t * kScanTile + threadIdx.x * kScanItems;
  int c[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    c[i] = base + i < n ? __ldcg(a.counts + base + i) : 0;
  if (threadIdx.x == 0) sh.n_spans = 0;
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    sum += c[i];
    if (c[i]) a.counts[base + i] = 0;
  }
  int total;
  int at = block_exclusive_scan<kThreads>(sum, sh.scan, &total);
  if (threadIdx.x < 32) look_back(a, t, total, sh);
  __syncthreads();
  at += sh.before;
  if (base == 0) a.first[0] = 0;            // segment 0 starts at 0
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int k = base + i;
    if (k >= n) break;
    a.offsets[k] = at;
    if (c[i] > kLong) a.longs[1 + atomicAdd(&a.longs[0], 1)] = k;
    // segment k + 1 starts c[i] + 1 past segment k and owns the entries
    // after segment k's up to its own start; the last one past the end
    const long long start = (long long)at + k;
    if (k < n - 1)
      partition(a.first, k + 1, start / kWork + 1,
                (start + c[i] + 1) / kWork, sh);
    else
      a.first[start / kWork + 1] = k;
    at += c[i];
  }
  __syncthreads();
  const int n_spans = min(sh.n_spans, kSpans);
  for (int q = 0; q < n_spans; ++q) {
    const int3 r = sh.spans[q];
    for (int w = r.x + threadIdx.x; w <= r.y; w += kThreads) a.first[w] = r.z;
  }
  __syncthreads();      // the tile's writes done, the shared spans free
  if (threadIdx.x == 0) publish(a.flags + t, a.epoch);
}

__global__ void __launch_bounds__(kThreads)
    segment_plan_fused_kernel(Args a) {
  __shared__ TileShared sh;
  cg::grid_group grid = cg::this_grid();
  const int n = a.n_seg + 1;
  const int n_tiles = (n + kScanTile - 1) / kScanTile;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long chunk = stride * kPoints;
  const long long me = (long long)blockIdx.x * kThreads + threadIdx.x;

  // histogram and ranks; the first chunk's stay in registers
  if (me == 0) a.longs[0] = 0;
  int keep_s[kPoints], keep_r[kPoints];
  for (long long c0 = 0; c0 < a.P; c0 += chunk) {
    int s[kPoints], rank[kPoints];
#pragma unroll
    for (int j = 0; j < kPoints; ++j)
      s[j] = counted_segment(a.seg, a.valid, c0 + j * stride + me, a.P,
                             a.n_seg);
    rank_points(s, rank, a.counts);
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      if (c0 == 0) {
        keep_s[j] = s[j];
        keep_r[j] = rank[j];
      } else if (s[j] >= 0) {
        a.ranks[c0 + j * stride + me] = rank[j];
      }
    }
  }
  grid.sync();

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) scan_tile(a, t, n, sh);

  // placement, each point once its segment's tile is scanned
  for (long long c0 = 0; c0 < a.P; c0 += chunk) {
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const long long p = c0 + j * stride + me;
      int s = keep_s[j], rank = keep_r[j];
      if (c0 > 0) {
        s = counted_segment(a.seg, a.valid, p, a.P, a.n_seg);
        if (s >= 0) rank = __ldcg(a.ranks + p);
      }
      if (s < 0) continue;
      while (acquire(a.flags + s / kScanTile) != a.epoch) {
      }
      a.rows[__ldcg(a.offsets + s) + rank] = (int)p;
    }
  }
}

// the launch floor: the plan's grid, `barriers` grid barriers, no work
__global__ void __launch_bounds__(kThreads)
    segment_plan_floor_kernel(int barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < barriers; ++i) grid.sync();
}

// resident blocks a device holds of the plan kernel, at most
// kMaxBlocksPerSm an SM (once per device)
int resident_blocks() {
  constexpr int kDevices = 64;
  static int cached[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && cached[dev] > 0) return cached[dev];
  int n_sm = 0, per_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segment_plan_fused_kernel, kThreads, 0);
  const int n = (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * n_sm;
  if (dev < kDevices) cached[dev] = n;
  return n;
}

// the plan's blocks for P points and n_seg segments: a block a scan tile,
// and enough threads that none takes more than kPerThread points, within the
// resident blocks
unsigned plan_blocks(int P, int n_seg) {
  const long long tiles = ((long long)n_seg + kScanTile) / kScanTile;
  const long long per = (long long)kThreads * kPerThread;
  long long want = ((long long)P + per - 1) / per;
  if (want < tiles) want = tiles;
  const long long resident = resident_blocks();
  return (unsigned)(want < resident ? want : resident);
}

}  // namespace

// The wrapper checks P + n_seg < 2^31 - 1, allocates `buf` with
// (n_seg + 1) + P + (1 + cap) + (n_work + 1) ints and hands the per-stream
// scratch: `counts`, n_seg + 1 ints, zero (left zero); `tiles` and `flags`,
// n_seg / kScanTile + 1 uint64 (8-byte aligned) and uint32 each, none of
// them equal to this call's `epoch` (epochs count up from 1 per scratch);
// and `ranks`, P ints. The launch is cooperative: it fails with an error,
// and runs nothing, where the card cannot hold its blocks at once (a card
// shared with other work).
extern "C" int tdv_segment_plan(const long long* seg, const uint8_t* valid,
                                int* buf, int* counts,
                                unsigned long long* tiles, unsigned* flags,
                                int* ranks, int P, int n_seg, int cap,
                                unsigned epoch, void* stream) {
  const int n = n_seg + 1;
  int* rows = buf + n;
  int* longs = rows + P;
  Args a{seg,   valid, buf,   rows, longs, longs + 1 + cap, counts,
         tiles, flags, ranks, P,    n_seg, epoch};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segment_plan_fused_kernel),
      dim3(plan_blocks(P, n_seg)), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
}

// The launch floor of a plan call (for timing only): an empty cooperative
// launch at the plan's grid for (P, n_seg), passing `barriers` grid
// barriers.
extern "C" int tdv_segment_plan_floor(int P, int n_seg, int barriers,
                                      void* stream) {
  void* args[] = {&barriers};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segment_plan_floor_kernel),
      dim3(plan_blocks(P, n_seg)), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
}
