// consistency_fuse: multi-view consistency fusion of depth maps into points,
// one thread per (ref, pixel) of a chunk of refs.
//
// Replaces: tdvnet/ops/fusion.py `_fuse_chunk` (:47-95), the `lax.scan`
// over all views that `fuse_point_cloud` runs per chunk of 16 refs in 3D
// evaluation (`process_depth_3d_metrics`).
//
// Bound on an H100: operations. A chunk of 16 refs against the 48 views of a
// 52-view synthetic scene at 480x640 is 2.4e8 (pixel, source) pairs at about
// 70 flops each (1.6e10 flops, 0.25 ms at the fp32 rate); it reads 59 MB of
// source depth and writes 64 MB of points and keep flags (0.14 GB, 0.04 ms
// at 3.35 TB/s).
//
// Design: a thread owns one ref pixel. It back-projects the pixel at its
// depth once, then loops over all views in order, so the point sum has the
// order of JAX's scan; the count and the sum stay in registers and the
// averaged point and the keep flag are written once. Per view the camera
// table (P = K[R|t] in the order of XLA's CPU einsum, K^-1, R and t) is
// staged in shared memory in tiles of VIEW_TILE views; source depths are
// read with one nearest tap each through L2. The rounding of the JAX
// package on the CPU is kept: every 3-term row is fma(m2, c, fma(m1, b,
// m0 * a)) (+ m3 for a projection), the order of XLA's CPU dot; x / z and
// y / z are true divisions; the nearest tap rounds with rintf (half to even,
// as jnp.round) and is zero outside the map; the average divides by
// (n + 1). Every rounding is explicit so that nvcc contracts nothing else.
// Bounds are tested on the float pixel before any float-to-int conversion.
// Two differences from JAX on the CPU: K^-1 (JAX inverts K in fp32 inside
// the scan; the wrapper inverts it once per view in fp64 and rounds it,
// which gives the same values on pinhole intrinsics), and XLA contracts
// only some output columns of the fused back-projection to fmas, by shape;
// the points then differ by an ulp, never the keep flags in the tests.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VIEW_TILE = 64;
constexpr int CAM = 33;  // P [3,4], K^-1 [3,3], R [3,3], t [3]
constexpr int THREADS = 256;

// fma(m[2], c, fma(m[1], b, m[0] * a)): one 3-term row, XLA's CPU order
__device__ __forceinline__ float row3(const float* m, float a, float b,
                                      float c) {
  return __fmaf_rn(m[2], c, __fmaf_rn(m[1], b, __fmul_rn(m[0], a)));
}

// world = R^T (q), with R row-major: row i of R^T is column i of R
__device__ __forceinline__ void rot_t(const float* R, const float q[3],
                                      float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m[3] = {R[i], R[3 + i], R[6 + i]};
    out[i] = row3(m, q[0], q[1], q[2]);
  }
}

__global__ void consistency_fuse_kernel(
    const float* __restrict__ ref_depth,  // [C, H, W]
    const float* __restrict__ all_depth,  // [N, H, W]
    const float* __restrict__ cams,       // [N, CAM]
    const int64_t* __restrict__ self_idx, // [C]
    const float* __restrict__ gx,         // [W] pixel x of each column
    const float* __restrict__ gy,         // [H] pixel y of each row
    float* __restrict__ pts_out,          // [C, H*W, 3]
    bool* __restrict__ keep_out,          // [C, H*W]
    int C, int N, int H, int W, float z_thresh, int n_consistent) {
  __shared__ float sc[VIEW_TILE * CAM];
  const long long P = (long long)H * W;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gid < (long long)C * P;
  const int c = live ? (int)(gid / P) : 0;
  const long long p = live ? gid % P : 0;
  const int r = (int)self_idx[c];
  const float d_ref = live ? ref_depth[gid] : 0.f;

  // back-project the ref pixel (camera.backproject_grid): K^-1 [x, y, 1]
  // times the depth, then R^T (p - t)
  float pw[3];
  {
    const float* cr = cams + (size_t)r * CAM;
    const float px = gx[p % W], py = gy[p / W];
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      q[i] = __fsub_rn(__fmul_rn(row3(cr + 12 + 3 * i, px, py, 1.f), d_ref),
                       cr[30 + i]);
    rot_t(cr + 21, q, pw);
  }

  int n = 0;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  const float fw = (float)W, fh = (float)H;
  const size_t plane = (size_t)P;
  for (int v0 = 0; v0 < N; v0 += VIEW_TILE) {
    const int nv = min(VIEW_TILE, N - v0);
    __syncthreads();
    for (int e = threadIdx.x; e < nv * CAM; e += blockDim.x)
      sc[e] = cams[(size_t)v0 * CAM + e];
    __syncthreads();
    if (!live) continue;
    for (int vi = 0; vi < nv; ++vi) {
      const int s = v0 + vi;
      const float* cs = sc + CAM * vi;
      const float X = __fadd_rn(row3(cs, pw[0], pw[1], pw[2]), cs[3]);
      const float Y = __fadd_rn(row3(cs + 4, pw[0], pw[1], pw[2]), cs[7]);
      const float z = __fadd_rn(row3(cs + 8, pw[0], pw[1], pw[2]), cs[11]);
      const float x = __fdiv_rn(X, z);
      const float y = __fdiv_rn(Y, z);
      const float xi = rintf(x), yi = rintf(y);
      float zs = 0.f;
      if (xi >= 0.f && xi < fw && yi >= 0.f && yi < fh)
        zs = __ldg(all_depth + (size_t)s * plane + (size_t)yi * W + (int)xi);
      const bool valid = fabsf(__fsub_rn(z, zs)) < z_thresh && x >= 0.f &&
                         x <= wmax && y >= 0.f && y <= hmax && z > 1e-4f &&
                         zs > 0.f && s != r;
      if (!valid) continue;
      // back-project the sampled depth at the reprojected pixel
      float q[3], o[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        q[i] = __fsub_rn(__fmul_rn(row3(cs + 12 + 3 * i, x, y, 1.f), zs),
                         cs[30 + i]);
      rot_t(cs + 21, q, o);
      s0 = __fadd_rn(s0, o[0]);
      s1 = __fadd_rn(s1, o[1]);
      s2 = __fadd_rn(s2, o[2]);
      ++n;
    }
  }
  if (!live) return;
  const float den = (float)(n + 1);
  float* out = pts_out + 3 * gid;
  out[0] = __fdiv_rn(__fadd_rn(pw[0], s0), den);
  out[1] = __fdiv_rn(__fadd_rn(pw[1], s1), den);
  out[2] = __fdiv_rn(__fadd_rn(pw[2], s2), den);
  keep_out[gid] = n >= n_consistent && d_ref > 0.f;
}

}  // namespace

extern "C" int tdv_consistency_fuse(const void* ref_depth,
                                    const void* all_depth, const void* cams,
                                    const void* self_idx, const void* gx,
                                    const void* gy, void* pts_out,
                                    void* keep_out, int C, int N, int H, int W,
                                    float z_thresh, int n_consistent,
                                    void* stream) {
  const long long total = (long long)C * H * W;
  if (total == 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  consistency_fuse_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)ref_depth, (const float*)all_depth, (const float*)cams,
      (const int64_t*)self_idx, (const float*)gx, (const float*)gy,
      (float*)pts_out, (bool*)keep_out, C, N, H, W, z_thresh, n_consistent);
  return (int)cudaGetLastError();
}
