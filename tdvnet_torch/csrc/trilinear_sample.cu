// trilinear_sample: 8-tap trilinear sampling of a dense scene feature grid
// at world points, written into a channel slice of a wider output.
//
// Replaces: tdvnet/models/hypothesis.py `sample_scales` (:122-164) over
// tdvnet/ops/sampling.py `trilinear_sample` (:199-226) and its oct-packed
// form `pack_trilinear_octs`/`trilinear_sample_octs` (:232-281). The oct
// table (8x the grid's bytes) exists because the TPU's gather cost is per
// row; here the kernel reads the [B, X, Y, Z, C] grid directly.
//
// Bound on an H100: bytes. The output [B, Q, C] fp32 is written once, the
// points read once, and of the grid only the nodes the taps touch (the
// hypothesis points lie near surfaces: 1.7-5% of the batch's 64^3 nodes);
// ~2 flops per tap and channel is nothing next to that. The taps
// themselves (8 x C x 4 bytes a query, eight times the output) come from
// L1 and L2: the whole grid fits in the 50 MB L2.
//
// What held the first form of this kernel (one thread per (query, 4
// channels)) at 2.3-3.2x its bound (the ablations in PERF.md section 6, on
// the main path's hypothesis points): every one of the 16-32 threads of a
// query redid its coordinates (6 loads, 3 IEEE divisions, the floors and
// the tests), which took ~53% of a call (coordinates alone, no taps and no
// stores), the taps ~40%, the stores ~8%.
//
// Design: a warp takes a tile of 32 consecutive queries.
//   coordinates  lane i computes query i's node coordinates
//                (pt - center0) / cell in fp32 with an IEEE division, the
//                floors, the in-grid tests on the float coordinates, the
//                anchor's cell index, the tap mask and the fractions, once;
//   sampling     L = C/4 lanes (rounded up to a power of two, at most 32)
//                share a query, 32/L queries at a time; each group of L
//                lanes walks a run of L consecutive queries, taking each
//                query's anchor, tap mask and fractions from its
//                coordinate lane by `__shfl_sync`. Queries arrive in (ref,
//                hypothesis, pixel) order, so neighbours are neighbouring
//                pixels of one row and often share an anchor (59%, 78% and
//                88% of the batch's queries share their predecessor's at
//                scales 1, 2 and 4): a lane keeps the 8 taps it holds and
//                reloads them only when the anchor or the tap set changes
//                (6-13% of a call). An interior anchor loads its 8 taps
//                unpredicated. C > 128 walks the channels in slices of 128.
// Loading the next query's taps before the current query's FMAs (two tap
// sets a lane, 109 registers) measured 3-60% slower than this form (63
// registers), which keeps more warps in flight instead.
// The sum is the first form's, bit for bit: the 8 taps in (dx, dy, dz)
// order, each weight formed as (x-weight * y-weight) * z-weight, summed
// with `fmaf` from +0. A tap outside the grid adds 0 * w (w >= 0 and
// finite), which leaves the sum's bits as skipping it did, so the grid
// backward (trilinear_sample_backward.cu), which recomputes the same taps
// and weights, stays consistent. A non-finite coordinate gives NaN, as in the
// JAX package and the twin. The result goes straight into channels
// [ch_off, ch_off + C) of the [B, Q, out_stride] output, so the scales are
// never concatenated afterwards. Where C, the output's width or the channel
// offset is not a multiple of 4, a lane takes one channel (4-byte loads and
// stores, L = C lanes a query rounded as above, the channels of a query
// past 32 in slices of 32), with the same operations per channel: the
// kernel is templated on a lane's channel group, float4 or float.
//
// The bf16 form (tdv_trilinear_sample_bf16) is the same
// kernel over a bf16 grid and a bf16 output: a lane's group is four bf16
// channels (one 8-byte load a tap, widened exactly to fp32) or one, the
// sum is the fp32 form's, and the result is rounded once to bf16 as it is
// stored. The JAX package sums in bf16 (tdvnet/ops/sampling.py:199-281:
// `out` is zeros of the grid's dtype), each product and partial sum
// rounded; one rounding of the fp32 sum keeps the result within half a
// bf16 ulp of the sum of the fp32 products. Bound: bytes, at bf16 the
// output and the touched nodes are half the fp32 form's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                 // warps a block, a tile each
constexpr unsigned kNaN = 1u << 8;        // a coordinate is not finite
// bits 0-7 of a query's code: which of its 8 taps (dx * 4 + dy * 2 + dz)
// lie in the grid; 0 with kNaN clear: the anchor is out of range

template <typename T> __device__ __forceinline__ T splat(float x);
template <> __device__ __forceinline__ float4 splat<float4>(float x) {
  return make_float4(x, x, x, x);
}
template <> __device__ __forceinline__ float splat<float>(float x) {
  return x;
}

// a lane's channel group M in memory: E its element, A the fp32 values a
// lane holds and sums (float4 or float); load widens, store narrows
template <typename M> struct Group;
template <> struct Group<float4> {
  using E = float;
  using A = float4;
  static __device__ __forceinline__ float4 load(const float4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float4 store(float4 a) { return a; }
};
template <> struct Group<float> {
  using E = float;
  using A = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float store(float a) { return a; }
};
template <> struct Group<uint2> {      // four bf16 channels
  using E = bf16::bits16;
  using A = float4;
  static __device__ __forceinline__ A load(const uint2* p) {
    return bf16::widen(__ldg(p));
  }
  static __device__ __forceinline__ uint2 store(A a) {
    return bf16::narrow(a);
  }
};
template <> struct Group<bf16::bits16> {
  using E = bf16::bits16;
  using A = float;
  static __device__ __forceinline__ A load(const bf16::bits16* p) {
    return bf16::widen(__ldg(p));
  }
  static __device__ __forceinline__ bf16::bits16 store(A a) {
    return bf16::narrow(a);
  }
};
__device__ __forceinline__ void fma_tap(float4& acc, const float4 t,
                                        float w) {
  acc.x = fmaf(t.x, w, acc.x);
  acc.y = fmaf(t.y, w, acc.y);
  acc.z = fmaf(t.z, w, acc.z);
  acc.w = fmaf(t.w, w, acc.w);
}
__device__ __forceinline__ void fma_tap(float& acc, const float t, float w) {
  acc = fmaf(t, w, acc);
}

// the 8 taps of one query and one channel group: in-grid taps from the
// grid, the others 0 (all 8 unpredicated for an interior anchor, the
// common case)
template <typename M, typename A = typename Group<M>::A>
__device__ __forceinline__ void load_taps(A (&t)[8], const M* __restrict__ g,
                                          int base, unsigned mask,
                                          const int (&off)[8], int cq) {
  if (mask == 0xffu) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      t[k] = Group<M>::load(g + (long long)(base + off[k]) * cq);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      t[k] = (mask >> k & 1u)
                 ? Group<M>::load(g + (long long)(base + off[k]) * cq)
                 : splat<A>(0.f);
  }
}

// M: a lane's channel group in memory (float4 or float; uint2 or one bf16);
// cq = C / (its channels), out_stride and ch_off counted in elements
template <typename M>
__global__ void __launch_bounds__(kWarps * 32) trilinear_sample_kernel(
    const typename Group<M>::E* __restrict__ grid,  // [B, X, Y, Z, C]
    const float* __restrict__ pts,      // [B, Q, 3] world points
    const float* __restrict__ center0,  // [B, 3] world position of node 0
    typename Group<M>::E* __restrict__ out,  // [B, Q, out_stride]
    int B, long long Q, int X, int Y, int Z, int cq, float cell,
    int out_stride, int ch_off, int L) {
  using T = typename Group<M>::A;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)B * Q;
  const long long q0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5))
                       * 32;
  if (q0 >= n) return;

  // ---- coordinates: lane i takes query q0 + i
  float wx = 0.f, wy = 0.f, wz = 0.f;
  int base = 0;
  unsigned code = 0;
  if (q0 + lane < n) {
    const long long gq = q0 + lane;
    const int b = (int)(gq / Q);
    const float qx = (pts[gq * 3 + 0] - center0[b * 3 + 0]) / cell;
    const float qy = (pts[gq * 3 + 1] - center0[b * 3 + 1]) / cell;
    const float qz = (pts[gq * 3 + 2] - center0[b * 3 + 2]) / cell;
    const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
    if (!(isfinite(qx) && isfinite(qy) && isfinite(qz))) {
      code = kNaN;
    } else if (fx >= -1.f && fx <= (float)(X - 1) && fy >= -1.f &&
               fy <= (float)(Y - 1) && fz >= -1.f && fz <= (float)(Z - 1)) {
      const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
      wx = qx - fx;
      wy = qy - fy;
      wz = qz - fz;
      base = ((b * X + x0) * Y + y0) * Z + z0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int xi = x0 + (k >> 2), yi = y0 + (k >> 1 & 1),
                  zi = z0 + (k & 1);
        if (xi >= 0 && xi <= X - 1 && yi >= 0 && yi <= Y - 1 && zi >= 0 &&
            zi <= Z - 1)
          code |= 1u << k;
      }
    }
  }

  // ---- sampling: lane group `sub` of L lanes walks queries
  // q0 + sub * L .. q0 + sub * L + L - 1; lane c4 of the group takes the
  // channel groups c4, c4 + 32, ...
  const int sub = lane / L, c4_lane = lane % L;
  const int first = sub * L;             // the group's first coordinate lane
  const int YZ = Y * Z;
  int off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    off[k] = (k >> 2) * YZ + (k >> 1 & 1) * Z + (k & 1);
  const M* g = reinterpret_cast<const M*>(grid);
  for (int cbase = 0; cbase < cq; cbase += 32) {
    const int c4 = cbase + c4_lane;
    const bool live = c4 < cq;
    const M* gc = g + c4;
    T t[8];
    int b_have = 0;
    unsigned k_have = 0;                 // no taps held yet
    for (int i = 0; i < L; ++i) {
      const int src = first + i;
      const int b_cur = __shfl_sync(kFull, base, src);
      const unsigned k_cur = __shfl_sync(kFull, code, src);
      const float x_cur = __shfl_sync(kFull, wx, src);
      const float y_cur = __shfl_sync(kFull, wy, src);
      const float z_cur = __shfl_sync(kFull, wz, src);
      const unsigned mask = live ? k_cur & 0xffu : 0u;
      // a run of one anchor keeps its taps
      if (mask && (b_cur != b_have || mask != k_have)) {
        load_taps(t, gc, b_cur, mask, off, cq);
        b_have = b_cur;
        k_have = mask;
      }
      const long long gq = q0 + src;
      if (live && gq < n) {
        T acc = splat<T>(0.f);
        if (k_cur & kNaN) {
          // the reference's weights q - floor(q) are NaN here
          acc = splat<T>(NAN);
        } else if (mask) {
          const float ax[2] = {1.f - x_cur, x_cur};
          const float ay[2] = {1.f - y_cur, y_cur};
          const float az[2] = {1.f - z_cur, z_cur};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float w = ax[k >> 2] * ay[k >> 1 & 1] * az[k & 1];
            fma_tap(acc, t[k], w);
          }
        }
        reinterpret_cast<M*>(out + gq * out_stride + ch_off)[c4] =
            Group<M>::store(acc);
      }
    }
  }
}

}  // namespace

// B * X * Y * Z < 2^31 (the wrapper checks): cell indices are int
extern "C" int tdv_trilinear_sample(const float* grid, const float* pts,
                                    const float* center0, float* out, int B,
                                    long long Q, int X, int Y, int Z, int C,
                                    float cell, int out_stride, int ch_off,
                                    void* stream) {
  const long long n = (long long)B * Q;
  if (n == 0 || C == 0) return 0;
  const bool quads = C % 4 == 0 && out_stride % 4 == 0 && ch_off % 4 == 0;
  const int cq = quads ? C / 4 : C;
  int L = 1;
  while (L < cq && L < 32) L <<= 1;
  const long long tiles = (n + 31) / 32;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  const auto kernel = quads ? trilinear_sample_kernel<float4>
                            : trilinear_sample_kernel<float>;
  kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      grid, pts, center0, out, B, Q, X, Y, Z, cq, cell, out_stride, ch_off,
      L);
  return (int)cudaGetLastError();
}

// a bf16 grid into a bf16 output (grid and output start on 8 bytes: the
// wrapper checks)
extern "C" int tdv_trilinear_sample_bf16(const void* grid, const float* pts,
                                         const float* center0, void* out,
                                         int B, long long Q, int X, int Y,
                                         int Z, int C, float cell,
                                         int out_stride, int ch_off,
                                         void* stream) {
  const long long n = (long long)B * Q;
  if (n == 0 || C == 0) return 0;
  const bool quads = C % 4 == 0 && out_stride % 4 == 0 && ch_off % 4 == 0;
  const int cq = quads ? C / 4 : C;
  int L = 1;
  while (L < cq && L < 32) L <<= 1;
  const long long tiles = (n + 31) / 32;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  const auto* g = static_cast<const bf16::bits16*>(grid);
  auto* o = static_cast<bf16::bits16*>(out);
  const auto kernel = quads ? trilinear_sample_kernel<uint2>
                            : trilinear_sample_kernel<bf16::bits16>;
  kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      g, pts, center0, o, B, Q, X, Y, Z, cq, cell, out_stride, ch_off, L);
  return (int)cudaGetLastError();
}
