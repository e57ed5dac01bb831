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
// points and the 23 MB int8 table of an (80,80,32) scene grid (merged and
// padded to 83x83x35), which fits the 50 MB L2, so the taps are served from
// L2 after the first touch. About 2 flops per tap and channel is nothing next
// to that.
//
// Design: one thread per (query, 4 channels); C/4 neighbouring threads share
// a query, so a tap is one 4-byte char4 load per thread over the contiguous
// C-byte cell. Node coordinates are (pt - center0) / cell + cell_offset: an
// IEEE division, then the add, in that order, as in the JAX package. The
// bounds are tested on the float coordinates before any float-to-int
// conversion; an anchor outside [-1, dim-1] gives zero, a tap outside the
// grid contributes nothing, a non-finite coordinate gives NaN (as the fp32
// kernel and the twin). The 8 taps are summed in fp32 with fp32 weights,
// multiplied by the channel's scale once after the sum (interpolation is
// linear, so that is exact), and rounded once to bf16, which the decoder
// reads. Each product and sum is rounded on its own (__fmul_rn, __fadd_rn)
// in the twin's order, so kernel and twin agree bit for bit: a fused
// multiply-add would move a sum whose taps cancel by more than a bf16 ulp
// of the small result. The JAX package sums in bf16 where XLA keeps no
// excess precision; the port's sum is the more exact one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void trilinear_sample_i8_kernel(
    const int8_t* __restrict__ grid,    // [B, X, Y, Z, C]
    const float* __restrict__ scale,    // [B, C]
    const float* __restrict__ pts,      // [B, Q, 3] world points
    const float* __restrict__ center0,  // [B, 3] world position of node 0
    __nv_bfloat16* __restrict__ out,    // [B, Q, out_stride]
    int B, long long Q, int X, int Y, int Z, int C, float cell,
    float cell_offset, int out_stride, int ch_off) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * Q * cq) return;
  const int q = (int)(t % cq);
  const long long bq = t / cq;
  const int b = (int)(bq / Q);
  const float qx = (pts[bq * 3 + 0] - center0[b * 3 + 0]) / cell + cell_offset;
  const float qy = (pts[bq * 3 + 1] - center0[b * 3 + 1]) / cell + cell_offset;
  const float qz = (pts[bq * 3 + 2] - center0[b * 3 + 2]) / cell + cell_offset;
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!(isfinite(qx) && isfinite(qy) && isfinite(qz))) {
    acc = make_float4(NAN, NAN, NAN, NAN);
  } else if (fx >= -1.f && fx <= (float)(X - 1) && fy >= -1.f &&
             fy <= (float)(Y - 1) && fz >= -1.f && fz <= (float)(Z - 1)) {
    const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
    const float wx = qx - fx, wy = qy - fy, wz = qz - fz;
    const char4* g =
        reinterpret_cast<const char4*>(grid + (size_t)b * X * Y * Z * C) + q;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const int xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
          if (xi < 0 || xi > X - 1 || yi < 0 || yi > Y - 1 || zi < 0 ||
              zi > Z - 1)
            continue;
          const float w = (dx ? wx : 1.f - wx) * (dy ? wy : 1.f - wy) *
                          (dz ? wz : 1.f - wz);
          const char4 v = __ldg(g + (((size_t)xi * Y + yi) * Z + zi) * cq);
          acc.x = __fadd_rn(acc.x, __fmul_rn((float)v.x, w));
          acc.y = __fadd_rn(acc.y, __fmul_rn((float)v.y, w));
          acc.z = __fadd_rn(acc.z, __fmul_rn((float)v.z, w));
          acc.w = __fadd_rn(acc.w, __fmul_rn((float)v.w, w));
        }
      }
    }
    const float4 s =
        __ldg(reinterpret_cast<const float4*>(scale + (size_t)b * C) + q);
    acc.x *= s.x;
    acc.y *= s.y;
    acc.z *= s.z;
    acc.w *= s.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
      out + bq * out_stride + ch_off + 4 * q);
  o[0] = __floats2bfloat162_rn(acc.x, acc.y);
  o[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

}  // namespace

extern "C" int tdv_trilinear_sample_i8(const int8_t* grid, const float* scale,
                                       const float* pts, const float* center0,
                                       __nv_bfloat16* out, int B, long long Q,
                                       int X, int Y, int Z, int C, float cell,
                                       float cell_offset, int out_stride,
                                       int ch_off, void* stream) {
  const long long total = (long long)B * Q * (C / 4);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  trilinear_sample_i8_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      grid, scale, pts, center0, out, B, Q, X, Y, Z, C, cell, cell_offset,
      out_stride, ch_off);
  return (int)cudaGetLastError();
}
