// trilinear_sample_backward: the gradient of 8-tap trilinear sampling
// (trilinear_sample.cu) with respect to the dense scene grid.
//
// Replaces: the VJP that JAX derives for tdvnet/ops/sampling.py
// `trilinear_sample` (:199-226) and its oct-packed form
// (`pack_trilinear_octs` / `trilinear_sample_octs`, :232-281), reached
// through tdvnet/models/hypothesis.py `sample_scales` (:122) in training:
// the transpose of the oct gather and of the packing is a scatter-add of
// g * w_tap into each of the 8 taps. The hypothesis points take no
// gradient (`stop_gradient` in `run_pointflow`).
//
// Bound on an H100: bytes (d out [B, Q, C] and the points read once, d grid
// written once: at the finest training scale B = 2, Q = 153664, C = 64,
// 64^3 nodes: 79 MB + 134 MB, ~65 us). A scatter-add straight into device
// memory is bound instead by the L2's atomic units: one 16-byte reduction
// per (point, tap, 4 channels), ~197M an offset pass over the three
// scales, landing dozens to hundreds at a time on the same coarse cells.
//
// Design: owner bricks in shared memory, summed in fixed point
// (fixed_sum.cuh) so that the result is the same bits in every run. The
// grid is cut into bricks of
// 8 x 8 x 8 nodes (4 x 8 x 8 measured 2-6% slower a pass on both point sets
// of PERF.md; partial bricks at the grid's high faces). Each brick owns its
// nodes, so the sum for a node is formed in one block's shared memory and
// leaves it once.
//   bin      a counting sort of (point, brick) entries, written by hand: one
//            entry per brick that a point's in-grid taps touch (a point
//            touches two bricks on an axis only when its anchor lies on a
//            brick's high face: ~1.42 entries a point for bricks of 8).
//            A histogram per brick (each block gathers its entries in a
//            shared histogram first when the bricks fit in 48 KB, 12288 of
//            them, else takes one global atomic per entry), whose last
//            block to finish scans it (entry and chunk offsets), then
//            placement, whose block i then
//            zeroes brick i in the output when the brick's list is longer
//            than one chunk (its chunks add into it; no other byte is
//            zeroed). An entry is 16 bytes, the point's index
//            and its node coordinates: the forward's IEEE division by the
//            cell is done here once, not again per channel group. Binned per
//            call, so per scale: a coarse anchor from its own division need
//            not be the fine anchor halved.
//   amax     the largest finite |d out| (fx::amax_kernel): a term
//            g * w_tap is at most that, and a node takes at most Q terms
//            (one per point of its scene), which sets the call's
//            power-of-two scale;
//   sum      a persistent grid of blocks takes work items (brick, chunk of
//            at most 4096 of its entries, group of 32 channels). A block
//            zeroes an int64 tile of the brick's nodes x 32 channels in
//            dynamic shared memory (128 KB for 8 x 8 x 8, after
//            cudaFuncSetAttribute; one block of 32 warps an SM) and sorts
//            the chunk in shared memory by anchor (a counting sort over the
//            9 x 9 x 9 anchors that touch the brick), keeping per entry the
//            point's index, its three weights and its key. Each warp then
//            walks a contiguous run of the sorted chunk, a lane taking two
//            neighbouring channels (a warp reads a point's 256-byte
//            gradient row in one request; two entries a warp at 32
//            channels), eight rows requested together. Each term g * w_tap
//            is rounded to the call's fixed point in double arithmetic (g
//            2^k times the weight, one fma with 1.5 * 2^52: five
//            conversions an entry where a float-to-int64 conversion a term
//            measured slower); the entries of one
//            anchor (a cell's points: tens to hundreds at the coarse
//            scales) sum their eight taps' integers in registers and add
//            them into the tile once, with 64-bit shared-memory integer
//            atomics; a lane's two channels sit 16 words apart in the tile.
//            Taps outside the grid or in another brick add nothing (that
//            brick's own entry takes them). Measured on the H100 (PERF.md
//            section 6), the float form of this phase was bound by instruction
//            issue and its compare-and-swap loops (float atomics in shared
//            memory are ATOMS.CAST.SPIN on sm_90): a parity-class order,
//            swaps issued together, 512 threads with deeper prefetch, tap
//            weights formed in the sort and an unsorted chunk were all
//            slower.
//   flush    a brick held by one chunk converts its tile to fp32 and stores
//            it with plain 16-byte stores, zeros included: the finest grid
//            needs no zero fill and no global atomic where no brick holds
//            more than a chunk. A brick of several chunks adds its tile
//            into an int64 copy of the brick (`red.global.add.u64`; zeroed
//            by the placement, indexed by the brick's rank among such
//            bricks), and the last of its chunks to finish (a ticket per
//            brick and channel group) converts the copy and stores it.
//   nonfinite a last launch exits at once unless a term was non-finite, and
//            then adds only those terms, as floats, onto the result.
// The bf16 form (tdv_trilinear_sample_backward_bf16; a bf16 model's scene
// grids in training) is the same kernels templated on the storage of
// d out and d grid: a lane reads its two bf16 channels (4 bytes) of a
// point's row and widens them exactly, the terms and sums are the fp32
// form's fixed point (the amax over the bf16 d out), and each node's sum
// is converted to fp32 once and rounded to bf16 where it is stored; a
// non-finite term is added onto the bf16 result by a bf16 atomic. Bound:
// bytes, half the fp32 form's.
// The chunk (entries per work item) is sized from B * Q so that about two
// work items run per resident block: long lists (the coarse scales' few
// bricks) split, short ones (the finest scale's) do not. A point with
// non-finite coordinates or an anchor off the grid takes nothing (its
// forward sample is NaN or zero); bounds are tested on the float before any
// float-to-int conversion. The placement, the in-block sort and the chunks
// take a run-dependent order, but every sum is an integer sum.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "block_scan.cuh"
#include "fixed_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kB = 8;               // brick nodes along each axis
constexpr int kGroup = 32;          // channels of one work item
constexpr int kBinThreads = 1024;
constexpr int kSharedBins = 12288;  // bricks a shared histogram holds (48 KB)
constexpr int kMinChunk = 1024;     // entries: a flush is 8192 reductions
constexpr int kMaxChunk = 4096;     // entries a block sorts (64 KB)
constexpr int kBatch = 8;           // gradient rows a warp requests at once

constexpr int kNodes = kB * kB * kB;

struct Geo {
  int B;
  long long Q;
  int X, Y, Z, C;
  float cell;
  int nbx, nby, nbz;    // bricks along each axis
};

// The forward's node coordinates of point bq of scene b; false when the
// point takes no gradient (coordinates not finite, or an anchor outside
// [-1, n - 1] on some axis, tested on the float).
__device__ __forceinline__ bool node_coords(const float* __restrict__ pts,
                                            const float* __restrict__ c0,
                                            long long bq, int b,
                                            const Geo& g, float& qx,
                                            float& qy, float& qz) {
  qx = (pts[bq * 3 + 0] - c0[b * 3 + 0]) / g.cell;
  qy = (pts[bq * 3 + 1] - c0[b * 3 + 1]) / g.cell;
  qz = (pts[bq * 3 + 2] - c0[b * 3 + 2]) / g.cell;
  if (!(isfinite(qx) && isfinite(qy) && isfinite(qz))) return false;
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  return fx >= -1.f && fx <= (float)(g.X - 1) && fy >= -1.f &&
         fy <= (float)(g.Y - 1) && fz >= -1.f && fz <= (float)(g.Z - 1);
}

// Along one axis of n nodes: the bricks of `bs` nodes that hold the in-grid
// taps of an anchor t0 in [-1, n - 1]; returns how many (1 or 2) and sets
// *first, the lower one.
__device__ __forceinline__ int axis_bricks(int t0, int n, int bs,
                                           int* first) {
  const int lo = t0 < 0 ? 0 : t0;
  const int hi = t0 + 1 > n - 1 ? n - 1 : t0 + 1;
  *first = lo / bs;
  return hi / bs - lo / bs + 1;
}

struct Brick {
  int scene, x0, y0, z0;    // first node
  int ex, ey, ez;           // nodes inside the grid
};

__device__ __forceinline__ Brick brick_at(int id, const Geo& g) {
  Brick k;
  const int bz = id % g.nbz;
  id /= g.nbz;
  const int by = id % g.nby;
  id /= g.nby;
  const int bx = id % g.nbx;
  k.scene = id / g.nbx;
  k.x0 = bx * kB;
  k.y0 = by * kB;
  k.z0 = bz * kB;
  k.ex = min(kB, g.X - k.x0);
  k.ey = min(kB, g.Y - k.y0);
  k.ez = min(kB, g.Z - k.z0);
  return k;
}

template <typename E>
__device__ __forceinline__ typename bf16::Quad<E>::V* node_row(
    E* grid, const Geo& g, const Brick& k, int lx, int ly, int lz) {
  return reinterpret_cast<typename bf16::Quad<E>::V*>(
      grid + ((((size_t)k.scene * g.X + k.x0 + lx) * g.Y + k.y0 + ly) * g.Z +
              k.z0 + lz) * g.C);
}

// The scratch of one call: per brick its entry count (then the placement's
// running offset), a done counter, the entry offsets, the chunk offsets and
// the rank among the bricks of several chunks (n_bricks + 1 each), a ticket
// per brick and channel group, and the fixed point's words (amax |d out|,
// the non-finite flag).
struct Bins {
  int* counts;
  int* done;
  int* offs;
  int* chunk_start;
  int* multi;
  int* tickets;
  unsigned* fx;
};

// A point's bricks: n (0 when it takes no gradient) and the r-th brick's id.
struct PointBricks {
  int n, kz, kyz, base, nby, nbz;
  __device__ __forceinline__ int id(int r) const {
    const int ix = r / kyz, iy = (r - ix * kyz) / kz, iz = r % kz;
    return base + (ix * nby + iy) * nbz + iz;
  }
};

__device__ __forceinline__ PointBricks point_bricks(
    const float* __restrict__ pts, const float* __restrict__ center0,
    long long bq, const Geo& g, float& qx, float& qy, float& qz) {
  PointBricks pb{0, 1, 1, 0, g.nby, g.nbz};
  qx = qy = qz = 0.f;
  if (bq >= (long long)g.B * g.Q) return pb;
  const int b = (int)(bq / g.Q);
  if (!node_coords(pts, center0, bq, b, g, qx, qy, qz)) return pb;
  int fx, fy, fz;
  const int kx = axis_bricks((int)floorf(qx), g.X, kB, &fx);
  const int ky = axis_bricks((int)floorf(qy), g.Y, kB, &fy);
  pb.kz = axis_bricks((int)floorf(qz), g.Z, kB, &fz);
  pb.kyz = ky * pb.kz;
  pb.n = kx * pb.kyz;
  pb.base = ((b * g.nbx + fx) * g.nby + fy) * g.nbz + fz;
  return pb;
}

// bin: kPlace false counts the entries of each brick, and the last block to
// finish scans the counts (offsets, chunks: an empty brick has one chunk,
// its tile of zeros); kPlace true writes each entry at the brick's running
// offset, and block i < n_bricks then zeroes brick i in the output if its
// list has several chunks (they add into it). With `shared_bins` (n_bricks
// <= kSharedBins) a block first gathers its entries per brick in a shared
// histogram and takes one global atomic per brick it touches (the coarse
// scales' few bricks would otherwise serialise ~27k atomics each); without
// it, one global atomic per entry.
template <bool kPlace>
__global__ void __launch_bounds__(kBinThreads)
    trilinear_sample_backward_bin_kernel(
        const float* __restrict__ pts, const float* __restrict__ center0, Geo g,
    Bins bins, float4* __restrict__ entries, long long* __restrict__ multi,
    int n_bricks, int chunk, bool shared_bins) {
  extern __shared__ int sh_bins[];
  const long long bq = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float qx, qy, qz;
  const PointBricks pb = point_bricks(pts, center0, bq, g, qx, qy, qz);
  const float4 entry = make_float4(__int_as_float((int)bq), qx, qy, qz);
  if (shared_bins) {
    for (int i = threadIdx.x; i < n_bricks; i += kBinThreads) sh_bins[i] = 0;
    __syncthreads();
    int rank[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < pb.n) rank[r] = atomicAdd(&sh_bins[pb.id(r)], 1);
    __syncthreads();
    for (int i = threadIdx.x; i < n_bricks; i += kBinThreads) {
      const int c = sh_bins[i];
      if (c == 0) continue;
      const int at = atomicAdd(&bins.counts[i], c);
      if (kPlace) sh_bins[i] = at;
    }
    if (kPlace) {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < pb.n) entries[sh_bins[pb.id(r)] + rank[r]] = entry;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < pb.n) {
        const int at = atomicAdd(&bins.counts[pb.id(r)], 1);
        if (kPlace) entries[at] = entry;
      }
  }
  if (!kPlace) {
    __shared__ int last;
    __shared__ int smem[33];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(bins.done, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    int carry_e = 0, carry_c = 0, carry_m = 0;
    for (int b0 = 0; b0 < n_bricks; b0 += kBinThreads) {
      const int i = b0 + threadIdx.x;
      const int c = i < n_bricks ? __ldcg(bins.counts + i) : 0;
      const int nch = i < n_bricks ? (c > chunk ? 1 + (c - 1) / chunk : 1)
                                   : 0;
      int tot_e, tot_c, tot_m;
      const int ex_e = tdv::block_exclusive_scan<kBinThreads>(c, smem, &tot_e);
      const int ex_c =
          tdv::block_exclusive_scan<kBinThreads>(nch, smem, &tot_c);
      const int ex_m =
          tdv::block_exclusive_scan<kBinThreads>(nch > 1, smem, &tot_m);
      if (i < n_bricks) {
        bins.offs[i] = bins.counts[i] = carry_e + ex_e;
        bins.chunk_start[i] = carry_c + ex_c;
        bins.multi[i] = carry_m + ex_m;
      }
      carry_e += tot_e;
      carry_c += tot_c;
      carry_m += tot_m;
    }
    if (threadIdx.x == 0) {
      bins.offs[n_bricks] = carry_e;
      bins.chunk_start[n_bricks] = carry_c;
      bins.multi[n_bricks] = carry_m;
    }
  } else {
    const int id = blockIdx.x;
    if (id >= n_bricks || bins.offs[id + 1] - bins.offs[id] <= chunk) return;
    longlong2* dst = reinterpret_cast<longlong2*>(
        multi + (size_t)bins.multi[id] * kNodes * g.C);
    for (int i = threadIdx.x; i < kNodes * g.C / 2; i += blockDim.x)
      dst[i] = make_longlong2(0, 0);
  }
}

constexpr int kKeys = (kB + 1) * (kB + 1) * (kB + 1);  // anchors [-1, 7]^3
constexpr int kSumThreads = 1024;
// the int64 tile (w channels), the anchor histogram, the chunk's sorted
// entries and keys
constexpr int sum_smem_bytes(int w) {
  return kNodes * w * 8 + 1024 * 4 + kMaxChunk * (16 + 2);
}

// an entry's sort key: its anchor in brick-local nodes, each in
// [-1, brick - 1]
__device__ __forceinline__ int local_key(const float4& r, const Brick& k) {
  const int ux = (int)floorf(r.y) - k.x0 + 1, uy = (int)floorf(r.z) - k.y0 + 1,
            uz = (int)floorf(r.w) - k.z0 + 1;
  return (ux * (kB + 1) + uy) * (kB + 1) + uz;
}

// Add a run's eight register sums (anchor (cx, cy, cz) in brick-local
// nodes, channels 2j and 2j + 1 of the group) into the tile.
__device__ __forceinline__ void add_run(long long* tile,
                                        const longlong2 (&acc)[8], int key,
                                        const Brick& k, int w, int lane_j) {
  const int cz = key % (kB + 1) - 1, cy = key / (kB + 1) % (kB + 1) - 1,
            cx = key / ((kB + 1) * (kB + 1)) - 1;
  const int half = w >> 1;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int lx = cx + (t >> 2), ly = cy + ((t >> 1) & 1), lz = cz + (t & 1);
    if (lx < 0 || lx >= k.ex || ly < 0 || ly >= k.ey || lz < 0 ||
        lz >= k.ez)
      continue;
    long long* dst = tile + ((lx * kB + ly) * kB + lz) * w + lane_j;
    if (acc[t].x) fx::shared_add(dst, acc[t].x);
    if (acc[t].y) fx::shared_add(dst + half, acc[t].y);
  }
}

// E: the storage of d out and d grid (float, or bf16::bits16)
template <typename E>
__global__ void __launch_bounds__(kSumThreads, 1)
    trilinear_sample_backward_sum_kernel(
        const E* __restrict__ grad, const float4* __restrict__ entries,
        Bins bins, E* __restrict__ grad_grid,
        long long* __restrict__ multi, Geo g, int n_bricks, int chunk,
        int n_groups, int w_max, int log2_terms) {
  constexpr int kThreads = kSumThreads;
  extern __shared__ longlong2 tile2l[];
  long long* tile = reinterpret_cast<long long*>(tile2l);
  int* hist = reinterpret_cast<int*>(tile + kNodes * w_max);
  float4* srec = reinterpret_cast<float4*>(hist + 1024);
  uint16_t* skey = reinterpret_cast<uint16_t*>(srec + kMaxChunk);
  __shared__ int item[4];       // brick, first entry, end, several chunks
  __shared__ int scan_smem[33];
  __shared__ bool last;
  const int n_items = bins.chunk_start[n_bricks] * n_groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // every term |g w| < 2^(e + 1), at most 2^log2_terms of them a node
  // every term |g w| < 2^(e + 1), at most 2^log2_terms of them a node, and
  // below 2^51 after the scale (the rounding below adds 1.5 * 2^52)
  const int e = fx::exp_of(bins.fx[0]);
  const int kx = max(min(fx::scale_exp(e + 1, log2_terms), 50 - e), -120);
  const double scale = (double)fx::pow2(kx);
  const float inv = fx::pow2(-kx);
  unsigned* nf = bins.fx + 1;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int cid = it / n_groups, grp = it - cid * n_groups;
    const int c0 = grp * kGroup;
    const int w = min(kGroup, g.C - c0);        // this group's channels
    if (warp == 0) {
      // the brick that holds chunk cid (the last whose first chunk is at
      // most cid): a 32-way search, one round trip per factor of 32
      int lo = 0, span = n_bricks;
      while (span > 1) {
        const int step = (span + 31) >> 5;
        const int at = lo + lane * step;
        const bool le = at < lo + span && __ldg(bins.chunk_start + at) <= cid;
        const int last = 31 - __clz(__ballot_sync(kFull, le));
        lo += last * step;
        span = min(step, span - last * step);
      }
      if (lane == 0) {
        const int e_end = bins.offs[lo + 1];
        const int e0 = bins.offs[lo] + (cid - bins.chunk_start[lo]) * chunk;
        item[0] = lo;
        item[1] = e0;
        item[2] = e_end - e0 <= chunk ? e_end : e0 + chunk;
        item[3] = e_end - bins.offs[lo] > chunk;
      }
    }
    for (int i = threadIdx.x; i < kNodes * w / 2; i += kThreads)
      tile2l[i] = make_longlong2(0, 0);
    for (int i = threadIdx.x; i < kKeys; i += kThreads) hist[i] = 0;
    __syncthreads();
    const Brick k = brick_at(item[0], g);
    const int e0 = item[1], n = item[2] - item[1];
    const bool several = item[3] != 0;

    // a counting sort of the chunk by anchor: runs of one anchor then sum
    // their taps in registers before they touch the tile. A sorted entry
    // keeps the point's index and its three interpolation weights, its key
    // beside it.
    for (int i = threadIdx.x; i < n; i += kThreads)
      atomicAdd(&hist[local_key(entries[e0 + i], k)], 1);
    __syncthreads();
    for (int base = 0, carry = 0; base < kKeys; base += kThreads) {
      int total;
      const int i = base + threadIdx.x;
      const int v = i < kKeys ? hist[i] : 0;
      const int ex = tdv::block_exclusive_scan<kThreads>(v, scan_smem, &total);
      if (i < kKeys) hist[i] = carry + ex;
      carry += total;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float4 r = entries[e0 + i];
      const int key = local_key(r, k);
      const int at = atomicAdd(&hist[key], 1);
      srec[at] = make_float4(r.x, r.y - floorf(r.y), r.z - floorf(r.z),
                             r.w - floorf(r.w));
      skey[at] = (uint16_t)key;
    }
    __syncthreads();

    // each slot (a warp, or part of one when the group is narrower than 64
    // channels) sums a contiguous run of the sorted chunk, kBatch entries
    // at a time: their gradient rows are requested together, then added
    const int lpe = w >> 1;                     // lanes per entry
    const int epw = 32 / lpe;                   // entries per warp
    const int sub = lane / lpe, lane_j = lane - sub * lpe;
    if (sub < epw) {
      const int n_slots = (kThreads >> 5) * epw;
      const int per = (n + n_slots - 1) / n_slots;
      const int j0 = (warp * epw + sub) * per;
      const int stop = min(j0 + per, n);
      const E* gp = grad + c0 + 2 * lane_j;
      longlong2 acc[8];
      int cur = -1;
      for (int jb = j0; jb < stop; jb += kBatch) {
        float2 gv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (jb + u < stop)
            gv[u] = bf16::load2(
                gp + (size_t)__float_as_int(srec[jb + u].x) * g.C);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (jb + u >= stop) break;
          const int key = skey[jb + u];
          if (key != cur) {
            if (cur >= 0) add_run(tile, acc, cur, k, w, lane_j);
            cur = key;
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[t] = make_longlong2(0, 0);
          }
          const float4 r = srec[jb + u];      // point, wx, wy, wz
          // a term g * w is finite wherever g is (0 <= w <= 1): one test an
          // entry; a non-finite g adds 0 here and raises the flag
          float2 gg = gv[u];
          if (!(isfinite(gg.x) && isfinite(gg.y))) {
            *reinterpret_cast<volatile unsigned*>(nf) = 1u;
            gg = make_float2(isfinite(gg.x) ? gg.x : 0.f,
                             isfinite(gg.y) ? gg.y : 0.f);
          }
          // the terms in double: g 2^k (exact) times the tap's weight
          // (the three fractions' product), rounded once to an integer by
          // an fma with 1.5 * 2^52; five conversions an entry instead of a
          // float-to-int64 conversion a term (the throughput of both is a
          // quarter of the double rate)
          const double g0 = (double)gg.x * scale, g1 = (double)gg.y * scale;
          const double fx1 = r.y, fy1 = r.z, fz1 = r.w;
          const double wxy[4] = {(1.0 - fx1) * (1.0 - fy1), (1.0 - fx1) * fy1,
                                 fx1 * (1.0 - fy1), fx1 * fy1};
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const double wt = wxy[t >> 1] * ((t & 1) ? fz1 : 1.0 - fz1);
            acc[t].x += fx::rint_to_ll(g0, wt);
            acc[t].y += fx::rint_to_ll(g1, wt);
          }
        }
      }
      if (cur >= 0) add_run(tile, acc, cur, k, w, lane_j);
    }
    __syncthreads();

    // the tile leaves once: channel 2j + h of the group sits at h * w / 2 + j
    const int nq = w >> 2;
    long long* copy = several ? multi + (size_t)bins.multi[item[0]] *
                                            kNodes * g.C
                              : nullptr;
    for (int i = threadIdx.x; i < kNodes * nq; i += kThreads) {
      const int node = i / nq, m = i - node * nq;
      const int lz = node % kB, ly = (node / kB) % kB, lx = node / (kB * kB);
      if (lx >= k.ex || ly >= k.ey || lz >= k.ez) continue;
      const longlong2 lo = tile2l[(node * w >> 1) + m];          // 4m, 4m + 2
      const longlong2 hi = tile2l[((node * w + lpe) >> 1) + m];  // 4m + 1, + 3
      if (several) {
        long long* dst = copy + (size_t)node * g.C + c0 + 4 * m;
        if (lo.x) fx::red_add(dst + 0, lo.x);
        if (hi.x) fx::red_add(dst + 1, hi.x);
        if (lo.y) fx::red_add(dst + 2, lo.y);
        if (hi.y) fx::red_add(dst + 3, hi.y);
      } else {
        bf16::store4(
            node_row(grad_grid, g, k, lx, ly, lz) + (c0 >> 2) + m,
            make_float4(fx::dequantize(lo.x, inv), fx::dequantize(hi.x, inv),
                        fx::dequantize(lo.y, inv), fx::dequantize(hi.y, inv)));
      }
    }
    if (several) {
      // the last of the brick's chunks (for this channel group) converts
      // the int64 copy and stores it
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        const int n_ch = bins.chunk_start[item[0] + 1] -
                         bins.chunk_start[item[0]];
        last = atomicAdd(bins.tickets + (size_t)item[0] * n_groups + grp,
                         1) == n_ch - 1;
      }
      __syncthreads();
      if (last) {
        __threadfence();
        for (int i = threadIdx.x; i < kNodes * nq; i += kThreads) {
          const int node = i / nq, m = i - node * nq;
          const int lz = node % kB, ly = (node / kB) % kB,
                    lx = node / (kB * kB);
          if (lx >= k.ex || ly >= k.ey || lz >= k.ez) continue;
          const longlong2* src = reinterpret_cast<const longlong2*>(
              copy + (size_t)node * g.C + c0 + 4 * m);
          const longlong2 a = __ldcg(src), b = __ldcg(src + 1);
          bf16::store4(
              node_row(grad_grid, g, k, lx, ly, lz) + (c0 >> 2) + m,
              make_float4(fx::dequantize(a.x, inv), fx::dequantize(a.y, inv),
                          fx::dequantize(b.x, inv),
                          fx::dequantize(b.y, inv)));
        }
      }
    }
    __syncthreads();
  }
}

// the non-finite terms alone, as float adds onto the finished result: one
// thread per (point, 4 channels), grid-stride; nothing unless the flag is up
template <typename E>
__global__ void trilinear_sample_backward_nonfinite_kernel(
    const E* __restrict__ grad, const float* __restrict__ pts,
    const float* __restrict__ center0, const unsigned* __restrict__ nf,
    E* __restrict__ grad_grid, Geo g) {
  if (*reinterpret_cast<const volatile unsigned*>(nf) == 0u) return;
  const int cq = g.C >> 2;
  const long long n = (long long)g.B * g.Q * cq;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long bq = i / cq;
    const int q = (int)(i - bq * cq), b = (int)(bq / g.Q);
    float qx, qy, qz;
    if (!node_coords(pts, center0, bq, b, g, qx, qy, qz)) continue;
    const float4 gv = bf16::load4_plain(
        reinterpret_cast<const typename bf16::Quad<E>::V*>(grad) + i);
    const float fx0 = floorf(qx), fy0 = floorf(qy), fz0 = floorf(qz);
    const float wx = qx - fx0, wy = qy - fy0, wz = qz - fz0;
    const int ax = (int)fx0, ay = (int)fy0, az = (int)fz0;
    for (int t = 0; t < 8; ++t) {
      const int x = ax + (t >> 2), y = ay + ((t >> 1) & 1), z = az + (t & 1);
      if (x < 0 || x >= g.X || y < 0 || y >= g.Y || z < 0 || z >= g.Z)
        continue;
      const float wt = ((t >> 2) ? wx : 1.f - wx) *
                       (((t >> 1) & 1) ? wy : 1.f - wy) *
                       ((t & 1) ? wz : 1.f - wz);
      E* dst = grad_grid +
                   ((((size_t)b * g.X + x) * g.Y + y) * g.Z + z) * g.C + 4 * q;
      const float v[4] = {gv.x * wt, gv.y * wt, gv.z * wt, gv.w * wt};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!isfinite(v[c])) bf16::add_nonfinite(dst + c, v[c]);
    }
  }
}

// resident blocks of the sum kernel on the current device (the attribute
// and the occupancy query once per device and tile size)
template <typename E>
int sum_blocks(int smem_bytes) {
  constexpr int kDevices = 64;
  static int cached_smem[kDevices], cached_blocks[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && cached_smem[dev] == smem_bytes)
    return cached_blocks[dev];
  int n_sm = 0, per_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(trilinear_sample_backward_sum_kernel<E>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, trilinear_sample_backward_sum_kernel<E>, kSumThreads,
      smem_bytes);
  if (dev < kDevices) {
    cached_smem[dev] = smem_bytes;
    cached_blocks[dev] = per_sm * n_sm;
  }
  return per_sm * n_sm;
}


template <typename E>
int backward(const E* grad, const float* pts, const float* center0,
             E* grad_grid, int* scratch, float* entries, long long* multi,
             int B, long long Q, int X, int Y, int Z, int C, float cell,
             void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0) return 0;
  const Geo g{B, Q, X, Y, Z, C, cell, (X + kB - 1) / kB, (Y + kB - 1) / kB,
              (Z + kB - 1) / kB};
  const int n_bricks = B * g.nbx * g.nby * g.nbz;
  if (C % 4) return (int)cudaErrorInvalidValue;
  const long long n_pts = (long long)B * Q;
  const int n_groups = (C + kGroup - 1) / kGroup;
  const int smem = sum_smem_bytes(min(C, kGroup));
  const int resident = sum_blocks<E>(smem);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  // about two work items per resident block
  const long long want = 3 * n_pts * n_groups / (4LL * resident) + 1;
  const int chunk = (int)(want < kMinChunk   ? kMinChunk
                          : want > kMaxChunk ? kMaxChunk
                                             : want);
  cudaStream_t s = (cudaStream_t)stream;
  float4* ent = reinterpret_cast<float4*>(entries);
  int* tickets = scratch + 4 * n_bricks + 4;
  unsigned* fxw =
      reinterpret_cast<unsigned*>(tickets + (size_t)n_bricks * n_groups);
  const Bins bins{scratch, scratch + n_bricks, scratch + n_bricks + 1,
                  scratch + 2 * n_bricks + 2, scratch + 3 * n_bricks + 3,
                  tickets, fxw};
  cudaMemsetAsync(scratch, 0, (n_bricks + 1) * sizeof(int), s);
  cudaMemsetAsync(tickets, 0,
                  ((size_t)n_bricks * n_groups + 2) * sizeof(int), s);
  fx::amax(grad, n_pts, C, C, fxw, s);
  const long long bin_blocks = (n_pts + kBinThreads - 1) / kBinThreads;
  const bool shared_bins = n_bricks <= kSharedBins;
  const int sh = shared_bins ? n_bricks * (int)sizeof(int) : 0;
  trilinear_sample_backward_bin_kernel<false>
      <<<(unsigned)(bin_blocks > 0 ? bin_blocks : 1), kBinThreads, sh, s>>>(
          pts, center0, g, bins, ent, multi, n_bricks, chunk, shared_bins);
  trilinear_sample_backward_bin_kernel<true>
      <<<(unsigned)(bin_blocks > n_bricks ? bin_blocks : n_bricks),
         kBinThreads, sh, s>>>(pts, center0, g, bins, ent, multi, n_bricks,
                               chunk, shared_bins);
  // at most every brick once plus one chunk per `chunk` entries (8 a point)
  const long long max_items =
      (n_bricks + (8 * n_pts + chunk - 1) / chunk) * (long long)n_groups;
  const int blocks = (int)(max_items < resident ? max_items : resident);
  trilinear_sample_backward_sum_kernel<E><<<blocks, kSumThreads, smem, s>>>(
      grad, ent, bins, grad_grid, multi, g, n_bricks, chunk, n_groups,
      min(C, kGroup), fx::log2_ceil(Q > 0 ? Q : 1));
  trilinear_sample_backward_nonfinite_kernel<E><<<132 * 4, 256, 0, s>>>(
      grad, pts, center0, fxw + 1, grad_grid, g);
  return (int)cudaGetLastError();
}

}  // namespace

// grad [B, Q, C]; grad_grid [B, X, Y, Z, C], uninitialised (every element is
// written); C % 4 == 0; `scratch` scratch_ints(n_bricks, C) ints (the counts,
// a done counter, the entry offsets, the chunk offsets and the ranks, n_bricks
// + 1 each, the tickets, n_bricks * ceil(C / 32), and the fixed point's two
// words) for the n_bricks bricks of 8^3 nodes; `entries` 8 * B * Q float4;
// `multi` int64, 8^3 * C for each brick that can hold several chunks (at
// most min(n_bricks, 8 B Q / 1025 + 1)); B * Q * 8 < 2^31.
extern "C" int tdv_trilinear_sample_backward(
    const float* grad, const float* pts, const float* center0,
    float* grad_grid, int* scratch, float* entries, long long* multi, int B,
    long long Q, int X, int Y, int Z, int C, float cell, void* stream) {
  return backward(grad, pts, center0, grad_grid, scratch, entries, multi, B,
                  Q, X, Y, Z, C, cell, stream);
}

// the same on a bf16 d out and a bf16 d grid
extern "C" int tdv_trilinear_sample_backward_bf16(
    const void* grad, const float* pts, const float* center0,
    void* grad_grid, int* scratch, float* entries, long long* multi, int B,
    long long Q, int X, int Y, int Z, int C, float cell, void* stream) {
  using E = bf16::bits16;
  return backward(static_cast<const E*>(grad), pts, center0,
                  static_cast<E*>(grad_grid), scratch, entries, multi, B, Q,
                  X, Y, Z, C, cell, stream);
}
