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
// Bound on an H100: bytes in the contract's count (d out [B, Q, C] read
// once, the points, d grid written once: at the finest training scale
// B = 2, Q = 153664, C = 64, 64^3 nodes: 79 MB + 134 MB, ~65 us); in
// practice the atomics: 8 vector reductions per (point, 4 channels), with
// the hypotheses of neighbouring pixels landing on the same nodes.
//
// Design: one thread per (point, 4 channels), C/4 neighbouring threads on
// one point as in the forward, the node coordinates, footprint and weights
// computed as the forward does them (IEEE division by the cell, bounds on
// the float coordinates before any float-to-int conversion); each tap
// inside the grid takes one 16-byte vector reduction
// (`red.global.add.v4.f32`) of g * w. Taps outside the grid take nothing,
// and so does a point whose coordinates are not finite (its forward sample
// is NaN). The sum order changes from run to run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void red_add4(float4* addr, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
#else
  atomicAdd(&addr->x, v.x);
  atomicAdd(&addr->y, v.y);
  atomicAdd(&addr->z, v.z);
  atomicAdd(&addr->w, v.w);
#endif
}

__global__ void trilinear_sample_backward_kernel(
    const float* __restrict__ grad,     // [B, Q, C] d loss / d samples
    const float* __restrict__ pts,      // [B, Q, 3] world points
    const float* __restrict__ center0,  // [B, 3] world position of node 0
    float* __restrict__ grad_grid,      // [B, X, Y, Z, C], zeroed
    int B, long long Q, int X, int Y, int Z, int C, float cell) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * Q * cq) return;
  const int q = (int)(t % cq);
  const long long bq = t / cq;
  const int b = (int)(bq / Q);
  const float qx = (pts[bq * 3 + 0] - center0[b * 3 + 0]) / cell;
  const float qy = (pts[bq * 3 + 1] - center0[b * 3 + 1]) / cell;
  const float qz = (pts[bq * 3 + 2] - center0[b * 3 + 2]) / cell;
  if (!(isfinite(qx) && isfinite(qy) && isfinite(qz))) return;
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  if (!(fx >= -1.f && fx <= (float)(X - 1) && fy >= -1.f &&
        fy <= (float)(Y - 1) && fz >= -1.f && fz <= (float)(Z - 1)))
    return;
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const float wx = qx - fx, wy = qy - fy, wz = qz - fz;
  const float4 g = reinterpret_cast<const float4*>(grad)[bq * cq + q];
  float4* gg =
      reinterpret_cast<float4*>(grad_grid + (size_t)b * X * Y * Z * C) + q;
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
        red_add4(gg + (((size_t)xi * Y + yi) * Z + zi) * cq,
                 make_float4(g.x * w, g.y * w, g.z * w, g.w * w));
      }
    }
  }
}

}  // namespace

// grad [B, Q, C]; grad_grid [B, X, Y, Z, C] zeroed by the caller;
// C % 4 == 0.
extern "C" int tdv_trilinear_sample_backward(
    const float* grad, const float* pts, const float* center0,
    float* grad_grid, int B, long long Q, int X, int Y, int Z, int C,
    float cell, void* stream) {
  const long long total = (long long)B * Q * (C / 4);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  trilinear_sample_backward_kernel<<<(unsigned)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
      grad, pts, center0, grad_grid, B, Q, X, Y, Z, C, cell);
  return (int)cudaGetLastError();
}
