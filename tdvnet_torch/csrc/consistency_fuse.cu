// consistency_fuse: multi-view consistency fusion of depth maps into points,
// a block per 16x32 tile of one ref's pixels, each tile culling the views
// that none of its points can see.
//
// Replaces: tdvnet/ops/fusion.py `_fuse_chunk` (:47-95), the `lax.scan`
// over all views that `fuse_point_cloud` runs per chunk of 16 refs in 3D
// evaluation (`process_depth_3d_metrics`).
//
// Bound on an H100: operations. A chunk of 16 refs against the 48 views of a
// 52-view synthetic scene at 480x640 is 2.36e8 (pixel, view) pairs at 45
// flops each and 25 more for each valid one (about 1.1e10 flops, 0.166 ms
// at the fp32 rate); it reads 59 MB of source depth and writes 64 MB of
// points and keep flags (0.04 ms at 3.35 TB/s). A pair that lies outside
// its view's frustum does no work that counts, so the bound over the pairs
// the cull leaves is lower (`tools/time_eval3d.py`, `touched_bound_ms`).
//
// Design: a block of 256 threads owns a 16x32 tile of one ref's pixels,
// two a thread (rows 8 apart), and back-projects each at its depth once.
// The tile's points fall in two groups: depth > 0 and finite, and the rest
// (a zero depth puts the point at the ref camera, far from the surface);
// the block reduces each group to an axis-aligned box (integer warp min
// and max of the floats' ordered bits) and packs the group-0 pixels before
// the group-1 ones, so that a thread's two pixels share a group (but at the
// seam). A first launch builds, in double, each view's six half-spaces of
// the cull (`cull_bounds.cuh`): z <= 1e-4; x < 0, x > W - 1, y < 0, y >
// H - 1 for z > 1e-4; z >= the view's largest depth + z_thresh; each with
// margins for the fp32 rounding of the forms and of the divisions. Per tile
// of VIEW_TILE views, one lane per (group, view) tests the group's box
// against them and skips the view where the box lies outside one (or the
// view has no positive depth, or is the ref's own); a group with a
// non-finite point culls nothing. Only the cameras of views some group
// runs are staged in shared memory, ten float4 each. A thread then runs
// the views of its pixels' groups in order; one camera read serves both
// pixels and their taps are in flight together. Each pixel keeps the
// arithmetic of the per-pixel form it replaced, so the point sum has the
// order of JAX's scan and a skipped pair, which could not be valid,
// changes no bit: the counts and the sums stay in registers and the
// averaged points and the keep flags are written once. At most 64
// registers, so four blocks share an SM. The rounding of the JAX package
// on the CPU is kept: every 3-term row is fma(m2, c, fma(m1, b, m0 * a))
// (+ m3 for a projection), the order of XLA's CPU dot; x / z and y / z are
// true divisions; the nearest tap rounds with rintf (half to even, as
// jnp.round) and is zero outside the map; the average divides by (n + 1).
// Every rounding is explicit so that nvcc contracts nothing else. Bounds
// are tested on the float pixel before any float-to-int conversion.
// Two differences from JAX on the CPU: K^-1 (JAX inverts K in fp32 inside
// the scan; the wrapper inverts it once per view in fp64 and rounds it,
// which gives the same values on pinhole intrinsics), and XLA contracts
// only some output columns of the fused back-projection to fmas, by shape;
// the points then differ by an ulp, never the keep flags in the tests.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cull_bounds.cuh"

namespace {

constexpr int TILE_H = 16, TILE_W = 32;
constexpr int PIX = TILE_H * TILE_W;
constexpr int THREADS = PIX / 2;
constexpr int WARPS = THREADS / 32;
constexpr int VIEW_TILE = 64;
constexpr int CAM = 33;  // P [3,4], K^-1 [3,3], R [3,3], t [3]
// a staged view: P's rows, K^-1's rows, R's columns (R^T's rows) and t,
// each in a float4, so that a pair reads its camera in ten 16-byte loads
constexpr int QUADS = 10;
constexpr unsigned FULL = 0xffffffffu;

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

// The cull's half-spaces of each view (`kernels/fusion.py` `fuse_planes`):
// no point of a box can make a valid pair where z <= 1e-4, or x < 0, x >
// W - 1, y < 0 or y > H - 1 for every z > 1e-4 (each quotient two ulps past
// its edge, and past the least normal for underflow), or z >= the view's
// largest depth + z_thresh, or the view has no positive depth.
__global__ void consistency_fuse_planes_kernel(
    const float* __restrict__ cams, const float* __restrict__ depth_max,
    int N, int W, int H, float z_thresh, double* __restrict__ planes) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= N) return;
  cull::build_planes(cams + (size_t)s * CAM, (double)1e-4f, cull::TINY,
                     (W - 1) * cull::QUOT + cull::TINY,
                     (H - 1) * cull::QUOT + cull::TINY, depth_max[s],
                     (double)z_thresh, planes, s, N);
}

// One pair's reprojection: x = X / z, y = Y / z and the flat index of the
// nearest tap (-1 outside the map)
struct Reproj {
  float x, y, z;
  int tap;
};

// the float4 of the staged camera: component c of quad q, from the view's
// row of the camera table (-1: padding)
__device__ __forceinline__ int quad_source(int q, int c) {
  if (q < 3) return 4 * q + c;
  if (c == 3) return -1;
  if (q < 6) return 12 + 3 * (q - 3) + c;  // K^-1 row q - 3
  if (q < 9) return 21 + (q - 6) + 3 * c;  // R column q - 6
  return 30 + c;                           // t
}

// fma(m.z, c, fma(m.y, b, m.x * a)): row3 of a staged row
__device__ __forceinline__ float row3q(float4 m, float a, float b, float c) {
  return __fmaf_rn(m.z, c, __fmaf_rn(m.y, b, __fmul_rn(m.x, a)));
}

__device__ __forceinline__ Reproj reproject(const float4* cq, float p0,
                                            float p1, float p2, int W,
                                            float fw, float fh) {
  Reproj o;
  const float4 r0 = cq[0], r1 = cq[1], r2 = cq[2];
  const float X = __fadd_rn(row3q(r0, p0, p1, p2), r0.w);
  const float Y = __fadd_rn(row3q(r1, p0, p1, p2), r1.w);
  o.z = __fadd_rn(row3q(r2, p0, p1, p2), r2.w);
  o.x = __fdiv_rn(X, o.z);
  o.y = __fdiv_rn(Y, o.z);
  const float xi = rintf(o.x), yi = rintf(o.y);
  o.tap = (xi >= 0.f && xi < fw && yi >= 0.f && yi < fh)
              ? (int)yi * W + (int)xi
              : -1;
  return o;
}

// A float as an int of the same order (for the warp's integer min and
// max), and back
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__global__ void __launch_bounds__(THREADS, 4) consistency_fuse_kernel(
    const float* __restrict__ ref_depth,  // [C, H, W]
    const float* __restrict__ all_depth,  // [N, H, W]
    const float* __restrict__ cams,       // [N, CAM]
    const double* __restrict__ planes,    // [RECORDS * RECORD, N]
    const int64_t* __restrict__ self_idx, // [C]
    const float* __restrict__ gx,         // [W] pixel x of each column
    const float* __restrict__ gy,         // [H] pixel y of each row
    float* __restrict__ pts_out,          // [C, H*W, 3]
    bool* __restrict__ keep_out,          // [C, H*W]
    int N, int H, int W, int tiles_x, float z_thresh, int n_consistent) {
  __shared__ float4 sc[VIEW_TILE * QUADS];
  __shared__ float spw[3][PIX];
  __shared__ float sd[PIX];
  __shared__ short sorder[PIX];           // slot -> tile pixel
  __shared__ float wbox[WARPS][2][6];     // per warp and group: lo, hi
  __shared__ int wcount[WARPS][2], wbad[WARPS][2];
  __shared__ float sbox[2][6];
  __shared__ int scount[2], sbad[2];
  __shared__ unsigned smask[2][VIEW_TILE / 32];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * TILE_W;
  const long long P = (long long)H * W;
  const long long base = (long long)c * P;
  const int r = (int)self_idx[c];
  const float* cr = cams + (size_t)r * CAM;

  // a thread's two pixels: t and t + THREADS of the tile (rows 8 apart)
  int g[2];
  bool fin[2];
  float pw[2][3];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int lp = t + u * THREADS;
    const int y = ty0 + lp / TILE_W, x = tx0 + lp % TILE_W;
    const bool live = y < H && x < W;
    const float d_ref = live ? ref_depth[base + (long long)y * W + x] : 0.f;
    // back-project the ref pixel (camera.backproject_grid): K^-1 [x, y, 1]
    // times the depth, then R^T (p - t)
    const float px = gx[live ? x : 0], py = gy[live ? y : 0];
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      q[i] = __fsub_rn(__fmul_rn(row3(cr + 12 + 3 * i, px, py, 1.f), d_ref),
                       cr[30 + i]);
    rot_t(cr + 21, q, pw[u]);
    spw[0][lp] = pw[u][0];
    spw[1][lp] = pw[u][1];
    spw[2][lp] = pw[u][2];
    sd[lp] = d_ref;
    g[u] = !live ? 2 : (d_ref > 0.f && d_ref < INFINITY) ? 0 : 1;
    fin[u] = isfinite(pw[u][0]) && isfinite(pw[u][1]) && isfinite(pw[u][2]);
  }

  // the two groups' boxes, member counts and non-finite flags; a warp's
  // pixels pack in (lane, pixel) order
  const unsigned lt = (1u << lane) - 1u;
  int rank[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned ma = __ballot_sync(FULL, g[0] == k);
    const unsigned mb = __ballot_sync(FULL, g[1] == k);
    const unsigned bad = __ballot_sync(
        FULL, (g[0] == k && !fin[0]) || (g[1] == k && !fin[1]));
    const int below = __popc(ma & lt) + __popc(mb & lt);
    if (g[0] == k) rank[0] = below;
    if (g[1] == k) rank[1] = below + (g[0] == k);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bool ia = g[0] == k && fin[0], ib = g[1] == k && fin[1];
      const float lo2 = fminf(ia ? pw[0][i] : INFINITY,
                              ib ? pw[1][i] : INFINITY);
      const float hi2 = fmaxf(ia ? pw[0][i] : -INFINITY,
                              ib ? pw[1][i] : -INFINITY);
      const float lo = unordered(__reduce_min_sync(FULL, ordered(lo2)));
      const float hi = unordered(__reduce_max_sync(FULL, ordered(hi2)));
      if (lane == 0) {
        wbox[warp][k][i] = lo;
        wbox[warp][k][3 + i] = hi;
      }
    }
    if (lane == 0) {
      wcount[warp][k] = __popc(ma) + __popc(mb);
      wbad[warp][k] = bad != 0;
    }
  }
  __syncthreads();
  if (t < 12) {
    const int k = t / 6, i = t % 6;
    float v = wbox[0][k][i];
    for (int w = 1; w < WARPS; ++w)
      v = i < 3 ? fminf(v, wbox[w][k][i]) : fmaxf(v, wbox[w][k][i]);
    sbox[k][i] = v;
  } else if (t < 14) {
    const int k = t - 12;
    int n = 0, bad = 0;
    for (int w = 0; w < WARPS; ++w) {
      n += wcount[w][k];
      bad |= wbad[w][k];
    }
    scount[k] = n;
    sbad[k] = bad;
  }
  // pack: the group-0 pixels first, then the group-1 pixels
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (g[u] == 2) continue;
    int slot = rank[u];
    for (int w = 0; w < warp; ++w) slot += wcount[w][g[u]];
    if (g[u] == 1)
      for (int w = 0; w < WARPS; ++w) slot += wcount[w][0];
    sorder[slot] = (short)(t + u * THREADS);
  }
  __syncthreads();

  // a worker's two slots
  const int n0 = scount[0], n_live = n0 + scount[1];
  bool work[2];
  int mg[2], lp[2];
  float p[2][3], d_own[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int slot = 2 * t + u;
    work[u] = slot < n_live;
    mg[u] = slot < n0 ? 0 : 1;
    lp[u] = work[u] ? sorder[slot] : 0;
    p[u][0] = spw[0][lp[u]];
    p[u][1] = spw[1][lp[u]];
    p[u][2] = spw[2][lp[u]];
    d_own[u] = sd[lp[u]];
  }

  int n[2] = {0, 0};
  float s[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  const float fw = (float)W, fh = (float)H;
  const size_t plane = (size_t)P;
  for (int v0 = 0; v0 < N; v0 += VIEW_TILE) {
    const int nv = min(VIEW_TILE, N - v0);
    __syncthreads();
    // one lane per (group, view): warps 0-1 group 0, warps 2-3 group 1
    if (warp < 2 * (VIEW_TILE / 32)) {
      const int k = warp / (VIEW_TILE / 32);
      const int vi = (warp % (VIEW_TILE / 32)) * 32 + lane;
      const int sv = v0 + vi;
      bool run = false;
      if (vi < nv && scount[k] > 0 && sv != r)
        run = sbad[k] ||
              !cull::box_culled(cull::make_box(sbox[k], sbox[k] + 3),
                                planes, sv, N);
      const unsigned m = __ballot_sync(FULL, run);
      if (lane == 0) smask[k][warp % (VIEW_TILE / 32)] = m;
    }
    __syncthreads();
    // stage the cameras of the views either group runs
    for (int e = t; e < VIEW_TILE * QUADS; e += THREADS) {
      const int vi = e / QUADS, q = e % QUADS;
      if (!((smask[0][vi >> 5] | smask[1][vi >> 5]) >> (vi & 31) & 1))
        continue;
      const float* src = cams + (size_t)(v0 + vi) * CAM;
      float v[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = quad_source(q, cc);
        v[cc] = i < 0 ? 0.f : src[i];
      }
      sc[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    if (!work[0]) continue;
    // the views of either pixel's group in order; one camera read serves
    // both pixels, and their taps are in flight together
    const float* dv = all_depth + (size_t)v0 * plane;
    for (int h = 0; h < VIEW_TILE / 32; ++h) {
      const unsigned m0 = smask[mg[0]][h];
      const unsigned m1 = work[1] ? smask[mg[1]][h] : 0u;
      unsigned m = m0 | m1;
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int vi = h * 32 + j;
        const bool run[2] = {(m0 >> j & 1) != 0, (m1 >> j & 1) != 0};
        const float4* cq = sc + QUADS * vi;
        Reproj rp[2];
        float zs[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          rp[u] = reproject(cq, p[u][0], p[u][1], p[u][2], W, fw, fh);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          zs[u] = run[u] && rp[u].tap >= 0
                      ? __ldg(dv + (size_t)vi * plane + rp[u].tap)
                      : 0.f;
        const int sv = v0 + vi;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const Reproj& q = rp[u];
          const bool valid = run[u] &&
                             fabsf(__fsub_rn(q.z, zs[u])) < z_thresh &&
                             q.x >= 0.f && q.x <= wmax && q.y >= 0.f &&
                             q.y <= hmax && q.z > 1e-4f && zs[u] > 0.f &&
                             sv != r;
          if (!valid) continue;
          // back-project the sampled depth at the reprojected pixel:
          // K^-1 [x, y, 1] zs - t, then R^T
          const float4 tq = cq[9];
          const float t3[3] = {tq.x, tq.y, tq.z};
          float qq[3];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            qq[i] = __fsub_rn(
                __fmul_rn(row3q(cq[3 + i], q.x, q.y, 1.f), zs[u]), t3[i]);
          s[u][0] = __fadd_rn(s[u][0], row3q(cq[6], qq[0], qq[1], qq[2]));
          s[u][1] = __fadd_rn(s[u][1], row3q(cq[7], qq[0], qq[1], qq[2]));
          s[u][2] = __fadd_rn(s[u][2], row3q(cq[8], qq[0], qq[1], qq[2]));
          ++n[u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!work[u]) continue;
    const long long gid = base + (long long)(ty0 + lp[u] / TILE_W) * W +
                          tx0 + lp[u] % TILE_W;
    const float den = (float)(n[u] + 1);
    float* out = pts_out + 3 * gid;
    out[0] = __fdiv_rn(__fadd_rn(p[u][0], s[u][0]), den);
    out[1] = __fdiv_rn(__fadd_rn(p[u][1], s[u][1]), den);
    out[2] = __fdiv_rn(__fadd_rn(p[u][2], s[u][2]), den);
    keep_out[gid] = n[u] >= n_consistent && d_own[u] > 0.f;
  }
}

}  // namespace

extern "C" int tdv_consistency_fuse(const void* ref_depth,
                                    const void* all_depth, const void* cams,
                                    const void* depth_max, void* planes,
                                    const void* self_idx, const void* gx,
                                    const void* gy, void* pts_out,
                                    void* keep_out, int C, int N, int H, int W,
                                    float z_thresh, int n_consistent,
                                    void* stream) {
  if ((long long)C * H * W == 0) return 0;
  if (C > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0)
    consistency_fuse_planes_kernel<<<(N + 63) / 64, 64, 0, st>>>(
        (const float*)cams, (const float*)depth_max, N, W, H, z_thresh,
        (double*)planes);
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const long long tiles = (long long)tiles_x * ((H + TILE_H - 1) / TILE_H);
  consistency_fuse_kernel<<<dim3((unsigned)tiles, (unsigned)C), THREADS, 0,
                            st>>>(
      (const float*)ref_depth, (const float*)all_depth, (const float*)cams,
      (const double*)planes, (const int64_t*)self_idx, (const float*)gx,
      (const float*)gy, (float*)pts_out, (bool*)keep_out, N, H, W, tiles_x,
      z_thresh, n_consistent);
  return (int)cudaGetLastError();
}
