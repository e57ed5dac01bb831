// tsdf_integrate: integrate a batch of depth frames (and their colours) into
// a dense TSDF volume, one thread per voxel.
//
// Replaces: tdvnet/ops/tsdf.py `integrate_frames` (:42-83), the `lax.scan`
// over frames that 3D evaluation (`process_depth_tsdf_metrics`,
// `trim_mesh`) and the synthetic dataset's GT meshes run through
// `fuse_scene`.
//
// Bound on an H100: bytes. A 52-view synthetic scene's eval TSDF (48 frames
// of 480x640, about 7.7M voxels) reads 59 MB of depth and 177 MB of fp32
// colour and writes 154 MB of accumulators: 0.39 GB, 0.12 ms at 3.35 TB/s.
// About 25 flops per voxel and frame (9e9) is 0.14 ms at the fp32 rate, so
// the two are close; the depth and colour reads are gathers at projected
// pixels, which neighbouring voxels share, and go through L2.
//
// Design: a thread owns one voxel and loops over the frames in frame order,
// so every accumulator sums in the order of JAX's scan; the accumulators
// stay in registers and are read once (the carried `init`, when given) and
// written once per launch. The frames' projection matrices are staged in
// shared memory in tiles of FRAME_TILE. The rounding of the JAX package on
// the CPU is kept: the voxel centre is fma(coord, voxel_size, origin), each
// projection row fma(m2, z, fma(m1, y, m0 * x)) + m3 (the order of XLA's CPU
// dot), a true division by the depth (no reciprocal), rintf (half to even,
// as jnp.round) for the pixel, and (d - z) times the fp32 reciprocal of
// trunc (XLA turns the division by the constant into that). Every rounding is
// explicit (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn) so that nvcc
// contracts nothing else. Bounds are tested on the rounded float pixel
// before any float-to-int conversion.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FRAME_TILE = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float dot_row(const float* M, float x, float y,
                                         float z) {
  const float xy = __fmaf_rn(M[1], y, __fmul_rn(M[0], x));
  return __fadd_rn(__fmaf_rn(M[2], z, xy), M[3]);
}

__global__ void tsdf_integrate_kernel(
    const float* __restrict__ depths,   // [N, H, W]
    const float* __restrict__ colors,   // [N, H, W, 3]
    const float* __restrict__ proj,     // [N, 3, 4]
    const float* __restrict__ tsdf_in,  // [V] or null (zeros)
    const float* __restrict__ w_in,     // [V] or null
    const float* __restrict__ c_in,     // [V, 3] or null
    float* __restrict__ tsdf_out, float* __restrict__ w_out,
    float* __restrict__ c_out, int N, int H, int W, int nx, int ny, int nz,
    float ox, float oy, float oz, float voxel, float inv_trunc) {
  __shared__ float sP[FRAME_TILE * 12];
  const long long V = (long long)nx * ny * nz;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = v < V;
  const long long vv = live ? v : 0;
  const int k = (int)(vv % nz);
  const int j = (int)((vv / nz) % ny);
  const int i = (int)(vv / ((long long)nz * ny));
  const float x = __fmaf_rn((float)i, voxel, ox);
  const float y = __fmaf_rn((float)j, voxel, oy);
  const float z = __fmaf_rn((float)k, voxel, oz);

  float t = 0.f, w = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
  if (live && tsdf_in != nullptr) {
    t = tsdf_in[v];
    w = w_in[v];
    cr = c_in[3 * v];
    cg = c_in[3 * v + 1];
    cb = c_in[3 * v + 2];
  }
  const float fw = (float)W, fh = (float)H;
  const size_t plane = (size_t)H * W;
  for (int f0 = 0; f0 < N; f0 += FRAME_TILE) {
    const int nf = min(FRAME_TILE, N - f0);
    __syncthreads();
    for (int e = threadIdx.x; e < nf * 12; e += blockDim.x)
      sP[e] = proj[(size_t)f0 * 12 + e];
    __syncthreads();
    if (!live) continue;
    for (int f = 0; f < nf; ++f) {
      const float* M = sP + 12 * f;
      const float cx = dot_row(M, x, y, z);
      const float cy = dot_row(M + 4, x, y, z);
      const float pz = dot_row(M + 8, x, y, z);
      const float px = rintf(__fdiv_rn(cx, pz));
      const float py = rintf(__fdiv_rn(cy, pz));
      if (!(px >= 0.f && px < fw && py >= 0.f && py < fh && pz > 0.f))
        continue;
      const size_t pix = (size_t)(f0 + f) * plane + (size_t)py * W + (int)px;
      const float d = __ldg(depths + pix);
      if (!(d > 0.f)) continue;
      const float sdf = fminf(__fmul_rn(__fsub_rn(d, pz), inv_trunc), 1.f);
      if (!(sdf > -1.f)) continue;
      t = __fadd_rn(t, sdf);
      w = __fadd_rn(w, 1.f);
      const float* rgb = colors + 3 * pix;
      cr = __fadd_rn(cr, __ldg(rgb));
      cg = __fadd_rn(cg, __ldg(rgb + 1));
      cb = __fadd_rn(cb, __ldg(rgb + 2));
    }
  }
  if (!live) return;
  tsdf_out[v] = t;
  w_out[v] = w;
  c_out[3 * v] = cr;
  c_out[3 * v + 1] = cg;
  c_out[3 * v + 2] = cb;
}

}  // namespace

extern "C" int tdv_tsdf_integrate(const void* depths, const void* colors,
                                  const void* proj, const void* tsdf_in,
                                  const void* w_in, const void* c_in,
                                  void* tsdf_out, void* w_out, void* c_out,
                                  int N, int H, int W, int nx, int ny, int nz,
                                  float ox, float oy, float oz, float voxel,
                                  float inv_trunc, void* stream) {
  const long long V = (long long)nx * ny * nz;
  if (V == 0) return 0;
  const long long blocks = (V + THREADS - 1) / THREADS;
  tsdf_integrate_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const float*)depths, (const float*)colors, (const float*)proj,
      (const float*)tsdf_in, (const float*)w_in, (const float*)c_in,
      (float*)tsdf_out, (float*)w_out, (float*)c_out, N, H, W, nx, ny, nz, ox,
      oy, oz, voxel, inv_trunc);
  return (int)cudaGetLastError();
}
