// patch_fan_variance: masked image-feature variance over each ref view's
// sources of every depth hypothesis of a pixel, each hypothesis sampled from
// one 4x4 patch per (pixel, source) around the centre hypothesis (the fast
// path's PointFlow variance).
//
// Replaces: tdvnet/ops/costvolume.py `hypothesis_patch_variance` (:180-230)
// over tdvnet/ops/sampling.py `pack_bilinear_patches` and
// `patch_sample_hypotheses` (:117-196), reached from
// tdvnet/models/threedvnet.py `run_pointflow` (:195-202). The 16C-wide patch
// table exists because the TPU's gather costs per row; here the kernel reads
// the unpacked [N, Hf, Wf, C] feature maps directly, which gives the same
// taps.
//
// Bound on an H100: bytes. At full width one chunk pass writes [16, 7, 3136,
// 32] fp32 (45 MB) and reads 4.2 MB of hypothesis points; the feature maps
// (20 x 64 x 80 x 32 fp32, 13 MB) stay in the 50 MB L2. About 30 flops per
// hypothesis, channel and source is far below the fp32 rate.
//
// Design: one warp per (ref, pixel), one lane per channel (C = 32 at full
// width; a wider C loops, a narrower one idles lanes), so each tap is one
// warp-wide contiguous load. Per source the warp projects every hypothesis,
// loads the 4x4 patch around the centre hypothesis's anchor once into
// registers, interpolates every hypothesis from it, and keeps the sum and
// the sum of squares per hypothesis in registers; per-source samples are
// never written. The JAX package's rules are kept exactly: local coordinates
// clamp to [0, PATCH_K - 1 - 1e-4] and the cell to [0, PATCH_K - 2], so a
// hypothesis beyond +-1 texel of the centre reads the patch's edge; a
// hypothesis is masked by its own anchor rule; the whole fan is zero for a
// source where the centre's anchor is out of bounds; var = s2/n - mean^2
// with n = max(sum(mask), 1). The projection is written with explicit
// roundings (__fmul_rn, __fmaf_rn, __fadd_rn) in the twin's order, which is
// also the order of XLA's CPU dot in the JAX package, so the coordinates, the
// patch's anchor and every clamp equal the twin's bit for bit (a floor that
// flips between the two would move a whole fan). Bounds
// are tested on the float coordinates before any float-to-int conversion; a
// non-finite coordinate gives NaN (the centre's: the whole fan), even for a
// padding source, as in `source_variance`.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HH_MAX = 8;  // hypotheses per pixel (7 on the main path)
constexpr int PK = 4;      // patch side, the JAX package's PATCH_K

// fma(m2, z, fma(m1, y, m0 * x)) + m3: the order of XLA's CPU dot and of
// the twin, with every rounding explicit so that nvcc contracts nothing else
__device__ __forceinline__ float dot_row(const float* M, float px, float py,
                                         float pz) {
  const float xy = __fmaf_rn(M[1], py, __fmul_rn(M[0], px));
  return __fadd_rn(__fmaf_rn(M[2], pz, xy), M[3]);
}

__global__ void patch_fan_variance_kernel(
    const float* __restrict__ feats,      // [N, Hf, Wf, C]
    const float* __restrict__ pts,        // [R, Hh, P, 3]
    const int64_t* __restrict__ src_idx,  // [R, S]
    const float* __restrict__ src_w,      // [R, S]: 1 real source, 0 padding
    const float* __restrict__ proj,       // [N, 3, 4]
    float* __restrict__ out,              // [R, Hh, P, C]
    int R, int Hh, long long P, int S, int Hf, int Wf, int C, float sx,
    float sy) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)R * P) return;
  const int r = (int)(warp / P);
  const long long p = warp % P;
  const int hc = Hh / 2;
  const float wmax = (float)(Wf - 1);
  const float hmax = (float)(Hf - 1);

  float hx[HH_MAX], hy[HH_MAX], hz[HH_MAX];
#pragma unroll
  for (int h = 0; h < HH_MAX; ++h) {
    if (h < Hh) {
      const float* pt = pts + (((size_t)r * Hh + h) * P + p) * 3;
      hx[h] = pt[0];
      hy[h] = pt[1];
      hz[h] = pt[2];
    }
  }

  for (int c = lane; c < C; c += 32) {
    float acc[HH_MAX], acc2[HH_MAX];
#pragma unroll
    for (int h = 0; h < HH_MAX; ++h) acc[h] = acc2[h] = 0.f;
    float cnt = 0.f;
    for (int s = 0; s < S; ++s) {
      const float m = src_w[r * S + s];
      cnt += m;
      const long long n = src_idx[r * S + s];
      const float* M = proj + n * 12;
      float x[HH_MAX], y[HH_MAX];
      bool finite[HH_MAX];
#pragma unroll
      for (int h = 0; h < HH_MAX; ++h) {
        if (h < Hh) {
          const float X = dot_row(M, hx[h], hy[h], hz[h]);
          const float Y = dot_row(M + 4, hx[h], hy[h], hz[h]);
          const float Z = dot_row(M + 8, hx[h], hy[h], hz[h]);
          const float den = __fadd_rn(fabsf(Z), 1e-8f);
          x[h] = __fmul_rn(__fdiv_rn(X, den), sx);
          y[h] = __fmul_rn(__fdiv_rn(Y, den), sy);
          finite[h] = isfinite(x[h]) && isfinite(y[h]);
        }
      }
      // centre hypothesis (dynamic index: pick it with an unrolled select)
      float xc = 0.f, yc = 0.f;
      bool fc = true;
#pragma unroll
      for (int h = 0; h < HH_MAX; ++h)
        if (h == hc) { xc = x[h]; yc = y[h]; fc = finite[h]; }
      bool any_bad = !fc;
#pragma unroll
      for (int h = 0; h < HH_MAX; ++h) {
        if (h < Hh && (!fc || !finite[h])) {
          acc[h] = acc2[h] = NAN;
        }
      }
      if (any_bad || m == 0.f) continue;
      const float xc0f = floorf(xc), yc0f = floorf(yc);
      // the centre's 2x2 footprint misses the map: the whole fan is zero
      if (!(xc0f >= -1.f && xc0f <= wmax && yc0f >= -1.f && yc0f <= hmax))
        continue;
      const int xc0 = (int)xc0f, yc0 = (int)yc0f;
      const float* fm = feats + (size_t)n * Hf * Wf * C + c;
      float pv[PK][PK];
#pragma unroll
      for (int dy = 0; dy < PK; ++dy) {
        const int yy = yc0 - 1 + dy;
#pragma unroll
        for (int dx = 0; dx < PK; ++dx) {
          const int xx = xc0 - 1 + dx;
          pv[dy][dx] = (yy >= 0 && yy < Hf && xx >= 0 && xx < Wf)
                           ? __ldg(fm + ((size_t)yy * Wf + xx) * C)
                           : 0.f;
        }
      }
      const float ox = xc0f - 1.f, oy = yc0f - 1.f;  // the patch's origin
#pragma unroll
      for (int h = 0; h < HH_MAX; ++h) {
        if (h >= Hh || !finite[h]) continue;
        const float xh0 = floorf(x[h]), yh0 = floorf(y[h]);
        if (!(xh0 >= -1.f && xh0 <= wmax && yh0 >= -1.f && yh0 <= hmax))
          continue;
        const float lx = fminf(fmaxf(x[h] - ox, 0.f), (float)PK - 1.f - 1e-4f);
        const float ly = fminf(fmaxf(y[h] - oy, 0.f), (float)PK - 1.f - 1e-4f);
        const float ixf = fminf(fmaxf(floorf(lx), 0.f), (float)(PK - 2));
        const float iyf = fminf(fmaxf(floorf(ly), 0.f), (float)(PK - 2));
        const float fx = lx - ixf, fy = ly - iyf;
        const int ix = (int)ixf, iy = (int)iyf;
        float f = 0.f;
#pragma unroll
        for (int dy = 0; dy < PK; ++dy) {
          const float wy = dy == iy ? 1.f - fy : (dy == iy + 1 ? fy : 0.f);
          float t = 0.f;
#pragma unroll
          for (int dx = 0; dx < PK; ++dx) {
            const float wx = dx == ix ? 1.f - fx : (dx == ix + 1 ? fx : 0.f);
            t = fmaf(wx, pv[dy][dx], t);
          }
          f = fmaf(wy, t, f);
        }
        acc[h] = fmaf(f, m, acc[h]);
        acc2[h] = fmaf(f * f, m, acc2[h]);
      }
    }
    const float cn = fmaxf(cnt, 1.f);
#pragma unroll
    for (int h = 0; h < HH_MAX; ++h) {
      if (h < Hh) {
        const float mu = acc[h] / cn;
        out[(((size_t)r * Hh + h) * P + p) * C + c] = acc2[h] / cn - mu * mu;
      }
    }
  }
}

}  // namespace

extern "C" int tdv_patch_fan_variance(const float* feats, const float* pts,
                                      const int64_t* src_idx,
                                      const float* src_w, const float* proj,
                                      float* out, int R, int Hh, long long P,
                                      int S, int Hf, int Wf, int C, float sx,
                                      float sy, void* stream) {
  if (Hh < 1 || Hh > HH_MAX) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)R * P;
  if (warps == 0 || C == 0) return 0;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  patch_fan_variance_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      feats, pts, src_idx, src_w, proj, out, R, Hh, P, S, Hf, Wf, C, sx, sy);
  return (int)cudaGetLastError();
}
