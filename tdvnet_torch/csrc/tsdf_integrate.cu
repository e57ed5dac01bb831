// tsdf_integrate: integrate a batch of depth frames (and their colours) into
// a dense TSDF volume, a block per 2x8x16 brick of voxels, each brick
// culling the frames that none of its voxels can take.
//
// Replaces: tdvnet/ops/tsdf.py `integrate_frames` (:42-83), the `lax.scan`
// over frames that 3D evaluation (`process_depth_tsdf_metrics`,
// `trim_mesh`) and the synthetic dataset's GT meshes run through
// `fuse_scene`.
//
// Bound on an H100: bytes. A 52-view synthetic scene's eval TSDF (48 frames
// of 480x640 into 176x176x110 = 3,407,360 voxels) reads 59 MB of depth and
// 177 MB of fp32 colour and writes 68 MB of accumulators: 0.30 GB, 0.091
// ms at 3.35 TB/s. With uint8 colour (44 MB) the bytes take 0.051 ms and
// the flops bound: about 25 per (voxel, frame) pair (4.1e9), 0.061 ms at
// the fp32 rate. Most
// pairs lie outside the frame's frustum; over the pairs the cull leaves,
// the bound is little more than the 68 MB of accumulators, 0.020 ms
// (`tools/time_eval3d.py`, `touched_bound_ms`).
//
// Design: a block owns a brick of 2x8x16 voxels (z fastest, so a warp's
// accumulators are 64-byte runs). The brick's voxel centres span the box of
// its corner centres (each centre is fma(index, voxel, origin), monotone in
// the index). A first launch builds, in double, each frame's six
// half-spaces of the cull (`cull_bounds.cuh`): pz <= 0; the rounded pixel
// left of 0, right of W - 1, above 0 or below H - 1 for pz > 0; pz beyond
// the frame's largest depth by more than trunc (sdf <= -1); each with
// margins for the fp32 rounding of the forms, of the division and of the
// rounding to the pixel. Per tile of FRAME_TILE frames, one lane per frame
// tests the brick's box against them and skips the frame where the box lies
// outside one (or the frame has no positive depth); a non-finite box culls
// nothing. A thread owns one voxel and runs the brick's frames in frame
// order, two at a time so that their depth taps are in flight together, the
// projections read through the cache, so every accumulator sums in the
// order of JAX's scan and a skipped pair, which could not be valid, changes
// no bit; the accumulators stay in registers and are read once (the carried
// `init`, when given) and written once per launch. At most 64 registers, so
// four blocks share an SM. The rounding of the JAX package on the CPU is
// kept: the voxel centre is fma(coord, voxel_size, origin), each projection
// row fma(m2, z, fma(m1, y, m0 * x)) + m3 (the order of XLA's CPU dot), a
// true division by the depth (no reciprocal), rintf (half to even, as
// jnp.round) for the pixel, and (d - z) times the fp32 reciprocal of trunc
// (XLA turns the division by the constant into that). Every rounding is
// explicit (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn) so that nvcc
// contracts nothing else. Bounds are tested on the rounded float pixel
// before any float-to-int conversion. Colours are read as fp32 or as uint8,
// which widens exactly (3D evaluation hands over uint8 images).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cull_bounds.cuh"

namespace {

constexpr int BI = 2, BJ = 8, BK = 16;  // brick along x, y, z
constexpr int THREADS = BI * BJ * BK;
constexpr int FRAME_TILE = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot_row(const float* __restrict__ M,
                                         float x, float y, float z) {
  const float xy = __fmaf_rn(__ldg(M + 1), y, __fmul_rn(__ldg(M), x));
  return __fadd_rn(__fmaf_rn(__ldg(M + 2), z, xy), __ldg(M + 3));
}

// The cull's half-spaces of each frame (`kernels/tsdf.py` `tsdf_planes`):
// no voxel centre of a box can take the frame where pz <= 0, or the rounded
// pixel lies left of 0 (the quotient below -0.5), right of W - 1 (above W -
// 0.5), above 0 or below H - 1 for every pz > 0 (each quotient two ulps
// past its edge), or pz exceeds the frame's largest depth by more than
// trunc (with a margin, so sdf <= -1), or the frame has no positive depth.
__global__ void tsdf_integrate_planes_kernel(
    const float* __restrict__ proj, const float* __restrict__ depth_max,
    int N, int W, int H, float inv_trunc, double* __restrict__ planes) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= N) return;
  const double it = inv_trunc;
  const double gap =
      it > 0.0 && it < INFINITY ? (1.0 / it) * (1.0 + 0x1p-20) : NAN;
  cull::build_planes(proj + (size_t)f * 12, 0.0, 0.5 * cull::QUOT + cull::TINY,
                     (W - 0.5) * cull::QUOT + cull::TINY,
                     (H - 0.5) * cull::QUOT + cull::TINY, depth_max[f], gap,
                     planes, f, N);
}

// One pair's projection: pz and the flat index of the rounded pixel (-1
// where it lies outside the map or pz <= 0)
struct Proj {
  float pz;
  int tap;
};

__device__ __forceinline__ Proj project(const float* M, float x, float y,
                                       float z, int W, float fw, float fh) {
  Proj o;
  const float cx = dot_row(M, x, y, z);
  const float cy = dot_row(M + 4, x, y, z);
  o.pz = dot_row(M + 8, x, y, z);
  const float px = rintf(__fdiv_rn(cx, o.pz));
  const float py = rintf(__fdiv_rn(cy, o.pz));
  o.tap = px >= 0.f && px < fw && py >= 0.f && py < fh && o.pz > 0.f
              ? (int)py * W + (int)px
              : -1;
  return o;
}

__device__ __forceinline__ float widen(float c) { return c; }
__device__ __forceinline__ float widen(uint8_t c) { return (float)c; }

template <typename Col>
__global__ void __launch_bounds__(THREADS, 4) tsdf_integrate_kernel(
    const float* __restrict__ depths,   // [N, H, W]
    const Col* __restrict__ colors,     // [N, H, W, 3]
    const float* __restrict__ proj,     // [N, 3, 4]
    const double* __restrict__ planes,  // [RECORDS * RECORD, N]
    const float* __restrict__ tsdf_in,  // [V] or null (zeros)
    const float* __restrict__ w_in,     // [V] or null
    const float* __restrict__ c_in,     // [V, 3] or null
    float* __restrict__ tsdf_out, float* __restrict__ w_out,
    float* __restrict__ c_out, int N, int H, int W, int nx, int ny, int nz,
    int nbj, int nbk, float ox, float oy, float oz, float voxel,
    float inv_trunc) {
  __shared__ unsigned smask[2][FRAME_TILE / 32];  // by the tile's parity
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int i0 = b / (nbj * nbk) * BI, j0 = b / nbk % nbj * BJ,
            k0 = b % nbk * BK;
  const int i = i0 + t / (BJ * BK), j = j0 + t / BK % BJ, k = k0 + t % BK;
  const bool live = i < nx && j < ny && k < nz;
  const long long v = ((long long)i * ny + j) * nz + k;
  const float x = __fmaf_rn((float)i, voxel, ox);
  const float y = __fmaf_rn((float)j, voxel, oy);
  const float z = __fmaf_rn((float)k, voxel, oz);

  // the box of the brick's voxel centres, from its corner centres
  float lo[3], hi[3];
  bool finite = true;
  {
    const int first[3] = {i0, j0, k0};
    const int last[3] = {min(i0 + BI, nx) - 1, min(j0 + BJ, ny) - 1,
                         min(k0 + BK, nz) - 1};
    const float org[3] = {ox, oy, oz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float e0 = __fmaf_rn((float)first[a], voxel, org[a]);
      const float e1 = __fmaf_rn((float)last[a], voxel, org[a]);
      finite &= isfinite(e0) && isfinite(e1);
      lo[a] = fminf(e0, e1);
      hi[a] = fmaxf(e0, e1);
    }
  }

  float t_acc = 0.f, w = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
  if (live && tsdf_in != nullptr) {
    t_acc = tsdf_in[v];
    w = w_in[v];
    cr = c_in[3 * v];
    cg = c_in[3 * v + 1];
    cb = c_in[3 * v + 2];
  }
  const float fw = (float)W, fh = (float)H;
  const size_t plane = (size_t)H * W;
  for (int f0 = 0; f0 < N; f0 += FRAME_TILE) {
    const int nf = min(FRAME_TILE, N - f0);
    unsigned* mask = smask[(f0 / FRAME_TILE) & 1];
    // one lane per frame of the tile
    if (warp < FRAME_TILE / 32) {
      const int fi = warp * 32 + lane;
      bool run = false;
      if (fi < nf)
        run = !finite ||
              !cull::box_culled(cull::make_box(lo, hi), planes, f0 + fi, N);
      const unsigned m = __ballot_sync(FULL, run);
      if (lane == 0) mask[warp] = m;
    }
    __syncthreads();
    if (!live) continue;
    // the brick's frames in order, two at a time so that their depth taps
    // are in flight together; the projections come through the cache
    for (int h = 0; h < FRAME_TILE / 32; ++h) {
      unsigned m = mask[h];
      while (m) {
        const int fa = h * 32 + __ffs(m) - 1;
        m &= m - 1;
        const bool two = m != 0;
        const int fb = two ? h * 32 + __ffs(m) - 1 : fa;
        m &= m - 1;
        const Proj a = project(proj + (size_t)(f0 + fa) * 12, x, y, z, W, fw,
                               fh);
        const Proj b = project(proj + (size_t)(f0 + fb) * 12, x, y, z, W, fw,
                               fh);
        const float* da = depths + (size_t)(f0 + fa) * plane;
        const float* db = depths + (size_t)(f0 + fb) * plane;
        const float dA = a.tap >= 0 ? __ldg(da + a.tap) : 0.f;
        const float dB = two && b.tap >= 0 ? __ldg(db + b.tap) : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const Proj& q = u ? b : a;
          if (q.tap < 0) continue;
          const float d = u ? dB : dA;
          if (!(d > 0.f)) continue;
          const float sdf =
              fminf(__fmul_rn(__fsub_rn(d, q.pz), inv_trunc), 1.f);
          if (!(sdf > -1.f)) continue;
          t_acc = __fadd_rn(t_acc, sdf);
          w = __fadd_rn(w, 1.f);
          const Col* rgb =
              colors + 3 * ((size_t)(f0 + (u ? fb : fa)) * plane + q.tap);
          cr = __fadd_rn(cr, widen(__ldg(rgb)));
          cg = __fadd_rn(cg, widen(__ldg(rgb + 1)));
          cb = __fadd_rn(cb, widen(__ldg(rgb + 2)));
        }
      }
    }
  }
  if (!live) return;
  tsdf_out[v] = t_acc;
  w_out[v] = w;
  c_out[3 * v] = cr;
  c_out[3 * v + 1] = cg;
  c_out[3 * v + 2] = cb;
}

}  // namespace

extern "C" int tdv_tsdf_integrate(const void* depths, const void* colors,
                                  int colors_u8, const void* proj,
                                  const void* depth_max, void* planes,
                                  const void* tsdf_in, const void* w_in,
                                  const void* c_in, void* tsdf_out,
                                  void* w_out, void* c_out, int N, int H,
                                  int W, int nx, int ny, int nz, float ox,
                                  float oy, float oz, float voxel,
                                  float inv_trunc, void* stream) {
  if ((long long)nx * ny * nz == 0) return 0;
  const int nbi = (nx + BI - 1) / BI, nbj = (ny + BJ - 1) / BJ,
            nbk = (nz + BK - 1) / BK;
  const long long blocks = (long long)nbi * nbj * nbk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (N > 0)
    tsdf_integrate_planes_kernel<<<(N + 63) / 64, 64, 0, s>>>(
        (const float*)proj, (const float*)depth_max, N, W, H, inv_trunc,
        (double*)planes);
  if (colors_u8)
    tsdf_integrate_kernel<uint8_t><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float*)depths, (const uint8_t*)colors, (const float*)proj,
        (const double*)planes, (const float*)tsdf_in, (const float*)w_in,
        (const float*)c_in, (float*)tsdf_out, (float*)w_out, (float*)c_out,
        N, H, W, nx, ny, nz, nbj, nbk, ox, oy, oz, voxel, inv_trunc);
  else
    tsdf_integrate_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float*)depths, (const float*)colors, (const float*)proj,
        (const double*)planes, (const float*)tsdf_in, (const float*)w_in,
        (const float*)c_in, (float*)tsdf_out, (float*)w_out, (float*)c_out,
        N, H, W, nx, ny, nz, nbj, nbk, ox, oy, oz, voxel, inv_trunc);
  return (int)cudaGetLastError();
}
