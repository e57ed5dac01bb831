// trilinear_sample_i8: 8-tap trilinear sampling of a per-channel int8 scene
// feature grid at world points, dequantized and rounded once to bf16, written
// into a channel slice of a wider bf16 output (the fast path's scene table).
//
// Replaces: tdvnet/ops/sampling.py `trilinear_sample_octs_scaled` (:306-345)
// over the int8 oct table that `quantize_per_channel_int8` (:288-303) and
// `pack_scales` build (tdvnet/eval/fused_scene.py:322-334), reached from
// tdvnet/models/hypothesis.py `sample_scales` (:145-150). The oct table (8x
// the grid's bytes) exists because the TPU's gather costs per row; here the
// kernel reads the [B, X, Y, Z, C] int8 grid directly.
//
// Bound on an H100: bytes. At full width one chunk pass samples Q = 16 x 7 x
// 3136 = 351232 queries of C = 96 channels: 67 MB of bf16 output, 4.2 MB of
// points and, of the int8 table (23 MB for an (80,80,32) scene grid merged
// and padded to 83x83x35), only the nodes the taps touch: the hypothesis
// points lie near surfaces. The table fits the 50 MB L2, so the taps are
// served from L2 after the first touch.
//
// What held the first form of this kernel (one thread per (query, 4
// channels), the 24 threads of a query each redoing its 6 loads, 3 IEEE
// divisions, floors and tests, then eight 4-byte loads) at 7.3x its bound
// is in PERF.md section 6 (the ablation on the fast path's points).
//
// Design: a warp takes a tile of T consecutive queries (T <= 32).
//   coordinates  lane i computes query i's node coordinates
//                (pt - center0) / cell + cell_offset (an IEEE division, then
//                the add, in that order, as in the JAX package), the floors,
//                the in-range tests on the float coordinates (before any
//                float-to-int conversion), the anchor's cell index, the tap
//                mask, the scene and the fractions, once;
//   sampling     L lanes share a query, each taking VW int8 channels of a
//                cell row in one load (VW = 16 where C and the grid's
//                address allow, else 4: C = 96 is six 16-byte loads, 6
//                lanes a query, 5 queries a warp step, T = 30); G = 32 / L
//                groups of lanes each walk a run of T / G consecutive
//                queries, taking each query's anchor, mask, scene and
//                fractions from its coordinate lane by `__shfl_sync`.
//                Queries arrive in (ref, hypothesis, pixel) order, so
//                neighbours often share an anchor: a lane keeps the 8 taps
//                it holds and reloads them only when the anchor or the tap
//                set changes;
//   convert      each int8 becomes a float exactly without the conversion
//                unit: the byte plus 128 in the mantissa of 2^23, minus
//                2^23 + 128;
//   store        a lane's VW bf16 go out as 16-byte stores where the
//                output's row stride and channel offset allow (the main
//                path's), else as 8-byte ones (`out_stride` and `ch_off`
//                need only be multiples of 4).
// The sum is the first form's, bit for bit: the 8 taps in (dx, dy, dz)
// order, each weight formed as (x-weight * y-weight) * z-weight, each
// product and sum rounded on its own (__fmul_rn, __fadd_rn, so no
// multiply-add is contracted: a fused one would move a sum whose taps
// cancel by more than a bf16 ulp of the small result) from +0; a tap
// outside the grid adds 0 * w = +0 (w >= 0 and finite, and the sum is never
// -0), which leaves the sum's bits as skipping it did. The sum is multiplied
// by the channel's scale once (interpolation is linear, so that is exact)
// and rounded once to bf16, which the decoder reads. An anchor outside
// [-1, dim-1] gives 0, a non-finite coordinate NaN (as the fp32 kernel and
// the twin). The JAX package sums in bf16 where XLA keeps no excess
// precision; the port's sum is the more exact one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                 // warps a block, a tile each
constexpr unsigned kNaN = 1u << 8;        // a coordinate is not finite
constexpr int kSceneShift = 9;            // the query's scene: code >> 9
// bits 0-7 of a query's code: which of its 8 taps (dx * 4 + dy * 2 + dz)
// lie in the grid; 0 with kNaN clear: the anchor is out of range

// byte k of a tap word (the grid's int8 with its sign bit flipped, as
// `load_tap` keeps it: b + 128) as the float b, exactly: b + 128 under the
// exponent of 2^23, minus 2^23 + 128
__device__ __forceinline__ float i8_to_float(unsigned word, int k) {
  const unsigned bits = __byte_perm(word, 0x4b000000u, 0x7540u | (unsigned)k);
  return __fsub_rn(__uint_as_float(bits), 8388736.0f);
}

constexpr unsigned kZeroTap = 0x80808080u;   // four int8 zeros, flipped

template <int W>   // 32-bit words of int8 a lane loads a tap: 4 or 1
struct Taps {
  unsigned w[8][W];
};

template <int W>
__device__ __forceinline__ void load_tap(unsigned (&t)[W],
                                         const int8_t* __restrict__ p) {
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    t[0] = v.x ^ kZeroTap;
    t[1] = v.y ^ kZeroTap;
    t[2] = v.z ^ kZeroTap;
    t[3] = v.w ^ kZeroTap;
  } else {
    t[0] = __ldg(reinterpret_cast<const unsigned*>(p)) ^ kZeroTap;
  }
}

// the 8 taps of one query at a lane's channels: in-grid taps from the grid,
// the others 0 (all 8 unpredicated for an interior anchor, the common case)
template <int W>
__device__ __forceinline__ void load_taps(Taps<W>& t,
                                          const int8_t* __restrict__ g,
                                          int base, unsigned mask,
                                          const int (&off)[8], int C) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (mask == 0xffu || (mask >> k & 1u)) {
      load_tap<W>(t.w[k], g + (long long)(base + off[k]) * C);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) t.w[k][j] = kZeroTap;
    }
  }
}

__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32) trilinear_sample_i8_kernel(
    const int8_t* __restrict__ grid,    // [B, X, Y, Z, C]
    const float* __restrict__ scale,    // [B, C]
    const float* __restrict__ pts,      // [B, Q, 3] world points
    const float* __restrict__ center0,  // [B, 3] world position of node 0
    __nv_bfloat16* __restrict__ out,    // [B, Q, out_stride]
    int B, long long Q, int X, int Y, int Z, int C, float cell,
    float cell_offset, int out_stride, int ch_off, int L, int T,
    int wide_store) {
  constexpr int VW = 4 * W;            // channels a lane
  const int lane = threadIdx.x & 31;
  const long long n = (long long)B * Q;
  const long long q0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5))
                       * T;
  if (q0 >= n) return;

  // ---- coordinates: lane i < T takes query q0 + i
  float wx = 0.f, wy = 0.f, wz = 0.f;
  int base = 0;
  unsigned code = 0;
  if (lane < T && q0 + lane < n) {
    const long long gq = q0 + lane;
    const int b = (int)(gq / Q);
    const float qx = (pts[gq * 3 + 0] - center0[b * 3 + 0]) / cell
                     + cell_offset;
    const float qy = (pts[gq * 3 + 1] - center0[b * 3 + 1]) / cell
                     + cell_offset;
    const float qz = (pts[gq * 3 + 2] - center0[b * 3 + 2]) / cell
                     + cell_offset;
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
      code = (unsigned)b << kSceneShift;
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
  // q0 + sub * R .. q0 + sub * R + R - 1; lane cl of the group takes the
  // VW-channel vectors cl, cl + L, ... of a row
  const int G = 32 / L, R = T / G;
  const int sub = lane / L, cl = lane % L;
  const int cv = C / VW;                 // vectors a row
  const int YZ = Y * Z;
  int off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    off[k] = (k >> 2) * YZ + (k >> 1 & 1) * Z + (k & 1);
  for (int cbase = 0; cbase < cv; cbase += L) {
    const int c = cbase + cl;
    const bool live = sub < G && c < cv;
    const int8_t* gc = grid + c * VW;
    Taps<W> t;
    int b_have = 0;
    unsigned k_have = 0;                 // no taps held yet
    int s_have = -1;                     // the scene whose scales it holds
    float sc[VW];
    for (int i = 0; i < R; ++i) {
      const int src = sub < G ? sub * R + i : 0;
      const int b_cur = __shfl_sync(kFull, base, src);
      const unsigned k_cur = __shfl_sync(kFull, code, src);
      const float x_cur = __shfl_sync(kFull, wx, src);
      const float y_cur = __shfl_sync(kFull, wy, src);
      const float z_cur = __shfl_sync(kFull, wz, src);
      const unsigned mask = live ? k_cur & 0xffu : 0u;
      // a run of one anchor keeps its taps
      if (mask && (b_cur != b_have || mask != k_have)) {
        load_taps<W>(t, gc, b_cur, mask, off, C);
        b_have = b_cur;
        k_have = mask;
      }
      const long long gq = q0 + src;
      if (!live || gq >= n) continue;
      float acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = 0.f;
      if (k_cur & kNaN) {
        // the reference's weights q - floor(q) are NaN here
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] = NAN;
      } else if (mask) {
        const int s = (int)(k_cur >> kSceneShift);
        if (s != s_have) {
          const float4* sp = reinterpret_cast<const float4*>(
              scale + (size_t)s * C + c * VW);
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const float4 v = __ldg(sp + j);
            sc[4 * j] = v.x;
            sc[4 * j + 1] = v.y;
            sc[4 * j + 2] = v.z;
            sc[4 * j + 3] = v.w;
          }
          s_have = s;
        }
        const float ax[2] = {1.f - x_cur, x_cur};
        const float ay[2] = {1.f - y_cur, y_cur};
        const float az[2] = {1.f - z_cur, z_cur};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float w = __fmul_rn(__fmul_rn(ax[k >> 2], ay[k >> 1 & 1]),
                                    az[k & 1]);
#pragma unroll
          for (int j = 0; j < VW; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(
                i8_to_float(t.w[k][j >> 2], j & 3), w));
        }
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] = __fmul_rn(acc[j], sc[j]);
      }
      unsigned h[VW / 2];
#pragma unroll
      for (int j = 0; j < VW / 2; ++j)
        h[j] = bf16_pair(acc[2 * j], acc[2 * j + 1]);
      __nv_bfloat16* o = out + gq * out_stride + ch_off + c * VW;
      bool narrow = true;
      if constexpr (W == 4) {
        if (wide_store) {
#pragma unroll
          for (int j = 0; j < VW / 8; ++j)
            reinterpret_cast<uint4*>(o)[j] = make_uint4(
                h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]);
          narrow = false;
        }
      }
      if (narrow) {
#pragma unroll
        for (int j = 0; j < VW / 4; ++j)
          reinterpret_cast<uint2*>(o)[j] = make_uint2(h[2 * j],
                                                      h[2 * j + 1]);
      }
    }
  }
}

template <int W>
int launch_i8(const int8_t* grid, const float* scale, const float* pts,
              const float* center0, __nv_bfloat16* out, int B, long long Q,
              int X, int Y, int Z, int C, float cell, float cell_offset,
              int out_stride, int ch_off, cudaStream_t stream) {
  const int cv = C / (4 * W);
  const int L = cv < 32 ? cv : 32;
  const int G = 32 / L, T = G * (32 / G);
  const long long n = (long long)B * Q;
  const long long tiles = (n + T - 1) / T;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  // 16-byte stores need the output's rows and the slice to start on 8 bf16
  const int wide = out_stride % 8 == 0 && ch_off % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  trilinear_sample_i8_kernel<W><<<(unsigned)blocks, kWarps * 32, 0,
                                  stream>>>(
      grid, scale, pts, center0, out, B, Q, X, Y, Z, C, cell, cell_offset,
      out_stride, ch_off, L, T, wide);
  return (int)cudaGetLastError();
}

}  // namespace

// B * X * Y * Z < 2^31 and B < 2^23 (the wrapper checks): cell indices are
// int. A lane loads 16 int8 channels a tap where C % 16 == 0 and the grid
// starts on 16 bytes (every C of the main path), else 4 (C % 4 == 0 and a
// 4-byte start: the wrapper's slice rule).
extern "C" int tdv_trilinear_sample_i8(const int8_t* grid, const float* scale,
                                       const float* pts, const float* center0,
                                       __nv_bfloat16* out, int B, long long Q,
                                       int X, int Y, int Z, int C, float cell,
                                       float cell_offset, int out_stride,
                                       int ch_off, void* stream) {
  if ((long long)B * Q == 0 || C == 0) return 0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(grid);
  if (C % 4 != 0 || at % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 16 == 0 && at % 16 == 0)
    return launch_i8<4>(grid, scale, pts, center0, out, B, Q, X, Y, Z, C,
                        cell, cell_offset, out_stride, ch_off, s);
  return launch_i8<1>(grid, scale, pts, center0, out, B, Q, X, Y, Z, C,
                      cell, cell_offset, out_stride, ch_off, s);
}
