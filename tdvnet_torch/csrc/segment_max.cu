// segment_max / gather_concat: the PointNet's per-voxel max pool and its
// concat-back.
//
// Replaces: tdvnet/models/pointnet.py `_segmax` (:19-22) with the masking
// around it (:51, :56) and the gather-back plus concatenate (:53-54). The
// TPU form writes -1e30 into masked rows, runs a sorted-segment max and
// maps results <= -5e29 to 0; the gather-back and the concatenate are two
// more passes over [P, C] and [P, 2C].
//
// Bound on an H100: bytes. The pool reads the counted rows of [P, C] and
// writes [n_seg, C] (n_seg is the anchor capacity plus the dump slot, far
// more rows than points at the whole-scene size, so the output dominates:
// 134 MB against 77 MB of rows at the 52-view scene), plus the plan's
// offsets and row list; the concat reads [P, C] and the pooled rows the
// points name, and writes [P, 2C].
//
// Design of the pool: it walks segments, not points, over the plan that
// segment_plan.cu builds once per PointNet call (a CSR view of the counted
// rows: valid, 0 <= seg < n_seg). The work is balanced over warps by the
// plan's partition: a segment costs 1 + its rows, and a warp takes the
// segments that start in its kWork-wide window, so the empty segments
// (most of them at the whole-scene size, where 3258 of 262145 segments
// hold points) cost one 512-byte store each and the occupied ones share
// the warps with them. A warp walks its rows in the plan's order, which
// runs segment after segment: the lanes cover a row's channels as float4
// (C = 128 on the main path is one row a warp step; C > 128 walks again
// for each slice of 128 channels, C < 128 leaves lanes idle), kUnroll
// rows in flight across segment boundaries (their ids in one load, handed
// out by shuffles), and a segment's row is written when the walk passes
// its end; the segments' offsets are read 32 at a time. Four blocks an SM
// (64 registers): 8 rows in flight at that occupancy measured 1.12x
// faster at the scene than 16 rows at two blocks (PERF.md section 6). The max is taken on the
// order-preserving unsigned image of the float (`encode`), which is exact
// and does not depend on the order of the rows: the pools give the same
// bits on every run, and the parent's atomic form (a zero fill, an atomic
// max of every (point, channel), a decode in place: three passes over the
// output) gave the same bits too. A NaN of either sign maps to the top of
// the image, so a segment holding one reads NaN, as the twin's and the JAX
// package's max do. Every output row is written once: 0 for an empty
// segment and for a maximum at or below -5e29, as the reference has it.
// A segment of more than kLong rows is left to the long path: the n_lb
// blocks at the end of the grid split each listed long segment's rows
// between them, merge their warps in shared memory, add their block's
// maximum into a per-stream scratch row by an integer atomic max, and the
// last block to take its ticket decodes the row into the output and leaves
// the scratch and the ticket zero. On the PointNet's path its only user is
// capacity overflow: the dump slot (index n_anchors) then collects every
// point past the anchor capacity. The main path's clouds never reach it
// (their largest voxel holds 129 points), and the dump slot's pooled row
// feeds only the dump slot's own points and is dropped from the PointNet's
// output; the path keeps that case as fast as the atomic form was. The
// wrapper launches no long blocks where no segment can exceed kLong rows
// (P <= kLong).
// The concat-back writes cat([y, pooled[seg]]) in one pass, one thread a
// (point, 4 channels), optionally through the ReLU that precedes the next
// linear layer, so neither the gathered copy nor the concatenation is
// materialised; it writes a row for every point, invalid ones and ids out
// of range included (clamped to [0, n_seg - 1]).
//
// The bf16 forms (tdv_segment_max_bf16,
// tdv_gather_concat_bf16) are the same kernels templated on the rows'
// storage: four bf16 channels a lane (8 bytes), widened exactly to fp32
// for the order-preserving image, and each maximum narrowed back, which is
// exact (it is one of the rows' values, or 0); the empty-segment threshold
// is NEG / 2 rounded to bf16, as the JAX package compares in bf16. A max
// and a copy round nothing, so both are bit-equal to the JAX package's
// bf16 ops. Bound: bytes, half the fp32 forms'.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "segment_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoolWarps = 8;       // segments a block
constexpr int kUnroll = 8;          // rows in flight a warp
constexpr int kLong = tdv::kSegmentLong;
constexpr int kWork = tdv::kSegmentWork;
constexpr unsigned kFull = 0xffffffffu;

// order-preserving unsigned image: a > b as floats iff encode(a) >
// encode(b); every value maps above 0, which marks an empty segment; NaN
// maps to the top
__device__ __forceinline__ unsigned encode(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float decode(unsigned e) {
  return __uint_as_float((e & 0x80000000u) ? (e ^ 0x80000000u) : ~e);
}

// the rows' storage: E one element, V four (a lane's load)
template <typename E> struct Rows;
template <> struct Rows<float> {
  using V = float4;
  // the reference's threshold NEG / 2
  static __device__ __forceinline__ float neg_half() { return -5e29f; }
  static __device__ __forceinline__ float4 load(const float4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float4 store(float4 v) { return v; }
};
template <> struct Rows<bf16::bits16> {
  using V = uint2;
  // NEG / 2 in bf16 (0xf0ca), as the JAX package compares bf16 rows
  static __device__ __forceinline__ float neg_half() {
    return __uint_as_float(0xf0ca0000u);
  }
  static __device__ __forceinline__ float4 load(const uint2* p) {
    return bf16::widen(__ldg(p));
  }
  static __device__ __forceinline__ uint2 store(float4 v) {
    return bf16::narrow(v);
  }
};

// a segment's maximum as the reference reads it: 0 for an empty segment
// and for a maximum at or below the threshold NEG / 2
template <typename E>
__device__ __forceinline__ float finish(unsigned e) {
  const float v = e ? decode(e) : 0.f;
  return v <= Rows<E>::neg_half() ? 0.f : v;
}

__device__ __forceinline__ void max4(uint4& m, const float4 v) {
  m.x = max(m.x, encode(v.x));
  m.y = max(m.y, encode(v.y));
  m.z = max(m.z, encode(v.z));
  m.w = max(m.w, encode(v.w));
}

// rows [i0, i1) of a row list: the max of their images at the float4
// channel c4 (all 32 lanes call it; a lane that is not `live` loads
// nothing); kUnroll row loads in flight, their ids read in one load and
// handed out by shuffles
template <typename E>
__device__ __forceinline__ uint4 rows_max(const E* __restrict__ y,
                                          const int* __restrict__ rows,
                                          int i0, int i1, int C, int c4,
                                          bool live) {
  using V = typename Rows<E>::V;
  const int lane = threadIdx.x & 31;
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  for (int k = i0; k < i1; k += kUnroll) {
    const int rid = lane < kUnroll && k + lane < i1 ? __ldg(rows + k + lane)
                                                    : 0;
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = __shfl_sync(kFull, rid, u);
      v[u] = live && k + u < i1
                 ? Rows<E>::load(reinterpret_cast<const V*>(
                                     y + (size_t)r * C) + c4)
                 : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (live && k + u < i1) max4(m, v[u]);
  }
  return m;
}

template <typename E>
__device__ __forceinline__ void store_row(E* __restrict__ out, int s,
                                          int C, int c4, uint4 m) {
  reinterpret_cast<typename Rows<E>::V*>(out + (size_t)s * C)[c4] =
      Rows<E>::store(make_float4(finish<E>(m.x), finish<E>(m.y),
                                 finish<E>(m.z), finish<E>(m.w)));
}

// the long path: blocks `lb` of `n_lb` split every listed segment's rows;
// `smem` holds C unsigned
template <typename E>
__device__ void pool_long(const E* __restrict__ y,
                          const int* __restrict__ offsets,
                          const int* __restrict__ rows,
                          const int* __restrict__ longs,
                          unsigned* __restrict__ acc,
                          unsigned* __restrict__ tickets,
                          E* __restrict__ out, int C, int lb, int n_lb,
                          unsigned* smem) {
  const int n_long = longs[0];
  const int cq = C >> 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ int last;
  for (int i = 0; i < n_long; ++i) {
    const int s = longs[1 + i];
    const int b = offsets[s], n = offsets[s + 1] - b;
    const int share = (n + n_lb - 1) / n_lb;
    const int r0 = b + min(n, lb * share), r1 = b + min(n, (lb + 1) * share);
    for (int c = threadIdx.x; c < C; c += blockDim.x) smem[c] = 0u;
    __syncthreads();
    // each warp takes a contiguous part of the block's share, its lanes a
    // row's float4 channels
    const int part = (r1 - r0 + kPoolWarps - 1) / kPoolWarps;
    const int p0 = min(r1, r0 + warp * part), p1 = min(r1, p0 + part);
    for (int cbase = 0; cbase < cq; cbase += 32) {
      const int c4 = cbase + lane;
      const uint4 m = rows_max(y, rows, p0, p1, C, c4, c4 < cq);
      if (c4 < cq) {
        atomicMax(&smem[4 * c4 + 0], m.x);
        atomicMax(&smem[4 * c4 + 1], m.y);
        atomicMax(&smem[4 * c4 + 2], m.z);
        atomicMax(&smem[4 * c4 + 3], m.w);
      }
    }
    __syncthreads();
    unsigned* row = acc + (size_t)i * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      if (smem[c]) atomicMax(&row[c], smem[c]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&tickets[i], 1u) == n_lb - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int c4 = threadIdx.x; c4 < cq; c4 += blockDim.x) {
        const uint4 m = __ldcg(reinterpret_cast<const uint4*>(row) + c4);
        store_row(out, s, C, c4, m);
        reinterpret_cast<uint4*>(row)[c4] = make_uint4(0u, 0u, 0u, 0u);
      }
      if (threadIdx.x == 0) tickets[i] = 0u;
    }
    __syncthreads();
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 4) segment_max_pool_kernel(
    const E* __restrict__ y, const int* __restrict__ offsets,
    const int* __restrict__ rows, const int* __restrict__ longs,
    const int* __restrict__ first, unsigned* __restrict__ acc,
    unsigned* __restrict__ tickets, E* __restrict__ out, int C,
    int n_seg, int work_blocks, int n_lb) {
  using V = typename Rows<E>::V;
  extern __shared__ unsigned smem[];
  if ((int)blockIdx.x >= work_blocks) {
    pool_long(y, offsets, rows, longs, acc, tickets, out, C,
              (int)blockIdx.x - work_blocks, n_lb, smem);
    return;
  }
  // warp w takes the segments that start (offset + index) in
  // [w * kWork, (w + 1) * kWork): the plan's `first` names them
  const long long w = (long long)blockIdx.x * kPoolWarps + (threadIdx.x >> 5);
  if (w * kWork > (long long)offsets[n_seg] + n_seg) return;
  const int s_begin = first[w], s_end = first[w + 1];
  if (s_begin >= s_end) return;
  const int lane = threadIdx.x & 31;
  const int cq = C >> 2;
  const int R1 = offsets[s_end];           // past the warp's last row
  for (int cbase = 0; cbase < cq; cbase += 32) {
    const int c4 = cbase + lane;
    const bool live = c4 < cq;
    // the segments' offsets, 32 at a time: lane j holds offsets[wb + j]
    int wb = s_begin;
    int o = wb + lane <= n_seg ? offsets[wb + lane] : 0;
    auto offset = [&](int i) {
      if (i - wb >= 32) {
        wb = i;
        o = wb + lane <= n_seg ? offsets[wb + lane] : 0;
      }
      return __shfl_sync(kFull, o, i - wb);
    };
    int s = s_begin, b = offset(s), e = offset(s + 1), k = b;
    uint4 m = make_uint4(0u, 0u, 0u, 0u);
    for (;;) {
      // past the segments whose rows are done (an empty one among them),
      // each written once, and past a long one (the long path writes it)
      while (s < s_end && (k >= e || e - b > kLong)) {
        if (e - b <= kLong && live) store_row(out, s, C, c4, m);
        m = make_uint4(0u, 0u, 0u, 0u);
        if (++s == s_end) break;
        b = e;
        e = offset(s + 1);
        k = b;
      }
      if (s >= s_end) break;
      // the next kUnroll rows of the list, across segment boundaries
      const int rid = lane < kUnroll && k + lane < R1
                          ? __ldg(rows + k + lane) : 0;
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = __shfl_sync(kFull, rid, u);
        v[u] = live && k + u < R1
                   ? Rows<E>::load(reinterpret_cast<const V*>(
                                       y + (size_t)r * C) + c4)
                   : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                 -INFINITY);
      }
      bool stop = false;                   // a long segment's rows begin
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (stop || k >= R1) continue;
        while (k >= e) {                   // k < R1: a later segment holds k
          if (live) store_row(out, s, C, c4, m);
          m = make_uint4(0u, 0u, 0u, 0u);
          ++s;
          b = e;
          e = offset(s + 1);
        }
        if (e - b > kLong) {
          stop = true;
        } else {
          max4(m, v[u]);
          ++k;
        }
      }
    }
  }
}

template <typename E>
__global__ void segment_max_gather_concat_kernel(
    const E* __restrict__ y, const E* __restrict__ pooled,
    const long long* __restrict__ seg, E* __restrict__ out, long long P,
    int C, long long n_seg, int relu) {
  using V = typename Rows<E>::V;
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * 2 * cq) return;
  const long long p = t / (2 * cq);
  const int q = (int)(t % (2 * cq));
  float4 v;
  if (q < cq) {
    if constexpr (sizeof(E) == 2)
      v = bf16::widen(reinterpret_cast<const uint2*>(y + p * C)[q]);
    else
      v = reinterpret_cast<const float4*>(y + p * C)[q];
  } else {
    long long s = seg[p];
    s = s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
    v = Rows<E>::load(reinterpret_cast<const V*>(pooled + s * C) + (q - cq));
  }
  if (relu) {                         // a NaN stays a NaN, as in the twin
    v.x = v.x < 0.f ? 0.f : v.x;
    v.y = v.y < 0.f ? 0.f : v.y;
    v.z = v.z < 0.f ? 0.f : v.z;
    v.w = v.w < 0.f ? 0.f : v.w;
  }
  reinterpret_cast<V*>(out + p * 2 * C)[q] = Rows<E>::store(v);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// out [n_seg, C] fp32, C % 4 == 0; the plan from tdv_segment_plan over
// the same ids (`first` sized for P rows: n_work + 1 entries); `acc`
// [cap, C] and `tickets` [cap] uint32 arrive zero and are left zero (cap:
// the plan's long-list capacity).
template <typename E>
int launch_pool(const E* y, const int* offsets, const int* rows,
                const int* longs, const int* first, unsigned* acc,
                unsigned* tickets, E* out, int C, int n_seg, int n_work,
                int n_long_blocks, void* stream) {
  if (n_seg == 0 || C == 0) return 0;
  const int work_blocks = (n_work + kPoolWarps - 1) / kPoolWarps;
  segment_max_pool_kernel<E><<<work_blocks + n_long_blocks, kThreads,
                               C * sizeof(unsigned), (cudaStream_t)stream>>>(
      y, offsets, rows, longs, first, acc, tickets, out, C, n_seg,
      work_blocks, n_long_blocks);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_concat(const E* y, const E* pooled, const long long* seg, E* out,
                  long long P, int C, long long n_seg, int relu,
                  void* stream) {
  const long long total = P * 2 * (C / 4);
  if (total == 0) return 0;
  segment_max_gather_concat_kernel<E><<<blocks_for(total), kThreads, 0,
                                        (cudaStream_t)stream>>>(
      y, pooled, seg, out, P, C, n_seg, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdv_segment_max(const float* y, const int* offsets,
                               const int* rows, const int* longs,
                               const int* first, unsigned* acc,
                               unsigned* tickets, float* out, int C,
                               int n_seg, int n_work, int n_long_blocks,
                               void* stream) {
  return launch_pool(y, offsets, rows, longs, first, acc, tickets, out, C,
                     n_seg, n_work, n_long_blocks, stream);
}

extern "C" int tdv_gather_concat(const float* y, const float* pooled,
                                 const long long* seg, float* out,
                                 long long P, int C, long long n_seg,
                                 int relu, void* stream) {
  return launch_concat(y, pooled, seg, out, P, C, n_seg, relu, stream);
}

// bf16 rows and outputs; the rest as above
extern "C" int tdv_segment_max_bf16(const void* y, const int* offsets,
                                    const int* rows, const int* longs,
                                    const int* first, unsigned* acc,
                                    unsigned* tickets, void* out, int C,
                                    int n_seg, int n_work,
                                    int n_long_blocks, void* stream) {
  using E = bf16::bits16;
  return launch_pool(static_cast<const E*>(y), offsets, rows, longs, first,
                     acc, tickets, static_cast<E*>(out), C, n_seg, n_work,
                     n_long_blocks, stream);
}

extern "C" int tdv_gather_concat_bf16(const void* y, const void* pooled,
                                      const long long* seg, void* out,
                                      long long P, int C, long long n_seg,
                                      int relu, void* stream) {
  using E = bf16::bits16;
  return launch_concat(static_cast<const E*>(y),
                       static_cast<const E*>(pooled), seg,
                       static_cast<E*>(out), P, C, n_seg, relu, stream);
}
