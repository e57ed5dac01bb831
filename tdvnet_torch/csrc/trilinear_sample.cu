// trilinear_sample: 8-tap trilinear sampling of a dense scene feature grid
// at world points, written into a channel slice of a wider output.
//
// Replaces: tdvnet/models/hypothesis.py `sample_scales` (:122-164) over
// tdvnet/ops/sampling.py `trilinear_sample` (:199-226) and its oct-packed
// form `pack_trilinear_octs`/`trilinear_sample_octs` (:232-281). The oct
// table (8x the grid's bytes) exists because the TPU's gather cost is per
// row; here the kernel reads the [B, X, Y, Z, C] grid directly.
//
// Bound on an H100: bytes. The output [B, Q, C] fp32 and the grid are the
// traffic (at full width, finest scale: 79 MB written, 134 MB of grid);
// ~3 flops per tap and channel is nothing next to that.
//
// Design: one thread per (query, 4 channels); C/4 neighbouring threads share
// a query, so each tap is one 16-byte load per thread over a contiguous
// C*4-byte cell. Node coordinates are (pt - (origin + edge/2)) / (s * edge),
// as in the JAX package, computed in fp32 with an IEEE division. A tap
// outside the grid contributes zero; the bounds are tested on the float
// coordinates before any float-to-int conversion. A non-finite coordinate
// gives NaN, as in the JAX package and the twin. The result goes straight
// into channels [ch_off, ch_off + C) of the [B, Q, out_stride] output, so
// the scales are never concatenated afterwards.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void trilinear_sample_kernel(
    const float* __restrict__ grid,     // [B, X, Y, Z, C]
    const float* __restrict__ pts,      // [B, Q, 3] world points
    const float* __restrict__ center0,  // [B, 3] world position of node 0
    float* __restrict__ out,            // [B, Q, out_stride]
    int B, long long Q, int X, int Y, int Z, int C, float cell,
    int out_stride, int ch_off) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * Q * cq) return;
  const int q = (int)(t % cq);
  const long long bq = t / cq;
  const int b = (int)(bq / Q);
  const float qx = (pts[bq * 3 + 0] - center0[b * 3 + 0]) / cell;
  const float qy = (pts[bq * 3 + 1] - center0[b * 3 + 1]) / cell;
  const float qz = (pts[bq * 3 + 2] - center0[b * 3 + 2]) / cell;
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!(isfinite(qx) && isfinite(qy) && isfinite(qz))) {
    // the reference's weights q - floor(q) are NaN here
    acc = make_float4(NAN, NAN, NAN, NAN);
  } else if (fx >= -1.f && fx <= (float)(X - 1) && fy >= -1.f &&
             fy <= (float)(Y - 1) && fz >= -1.f && fz <= (float)(Z - 1)) {
    const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
    const float wx = qx - fx, wy = qy - fy, wz = qz - fz;
    const float4* g =
        reinterpret_cast<const float4*>(grid + (size_t)b * X * Y * Z * C) + q;
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
          const float4 v =
              __ldg(g + (((size_t)xi * Y + yi) * Z + zi) * cq);
          acc.x = fmaf(v.x, w, acc.x);
          acc.y = fmaf(v.y, w, acc.y);
          acc.z = fmaf(v.z, w, acc.z);
          acc.w = fmaf(v.w, w, acc.w);
        }
      }
    }
  }
  reinterpret_cast<float4*>(out + bq * out_stride + ch_off)[q] = acc;
}

}  // namespace

extern "C" int tdv_trilinear_sample(const float* grid, const float* pts,
                                    const float* center0, float* out, int B,
                                    long long Q, int X, int Y, int Z, int C,
                                    float cell, int out_stride, int ch_off,
                                    void* stream) {
  const long long total = (long long)B * Q * (C / 4);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  trilinear_sample_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      grid, pts, center0, out, B, Q, X, Y, Z, C, cell, out_stride, ch_off);
  return (int)cudaGetLastError();
}
