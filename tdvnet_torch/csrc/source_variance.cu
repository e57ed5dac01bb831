// source_variance: masked per-point feature variance over each ref view's
// source views (the plane-sweep cost volume and the per-point variance of
// the scene point cloud and of the PointFlow hypotheses).
//
// Replaces: tdvnet/ops/costvolume.py `_source_variance` (:36-97), reached by
// `plane_sweep_cost_volume(mode="gather")` (:127-139) and
// `hypothesis_point_variance` (:162-177), with its quad-packed gather table
// (tdvnet/ops/sampling.py `pack_bilinear_quads`/`bilinear_sample_quads`).
// The quad packing exists because the TPU's gather cost is per row; Hopper
// gathers through L1/L2 by cache line, so this kernel reads the unpacked
// [N, Hf, Wf, C] feature maps directly.
//
// Bound on an H100: in the contract's count, bytes: each output element is
// one 4-byte store (540 MB at the cost-volume call, ~0.16 ms at 3.35 TB/s)
// and ~11 flops per active source, far below the 67 TFLOP/s fp32 rate; the
// feature maps (2.9 MB at full width) stay in the 50 MB L2. Measured
// (PERF.md, section 6): the kernel is bound by the instructions and the
// latency of each thread's chain per source (projection, four tap loads,
// sums) and its IEEE divisions, not by its stores (a form without them runs
// as long), HBM or L2-to-SM traffic (tiles that cut that traffic ~30x
// gained nothing; taps that all hit one texel in L1 gain little).
//
// Design: one thread per (point, 4 channels), so C/4 neighbouring threads
// share one point and each bilinear tap is one 16-byte load per thread
// (C/4 threads cover one contiguous C*4-byte pixel). Where those threads
// sit in one warp, each projects one source of their point (sv::project,
// with the source's projection read as three 16-byte loads) and passes its
// footprint record (anchor, fractions, skip / sample / NaN) to the others
// by warp shuffles, so a point's projection is computed once, not once per
// channel group. Blocks take a tile of points of one ref (grid x) and up to
// 256 channel groups (grid y), so no thread divides 64-bit indices, and the
// launch bound leaves six blocks an SM. The sums over sources stay in
// registers, in source order, with the same roundings as the twin's order
// of sums, so the result equals the one-thread-per-projection form's bit for
// bit; per-source samples are never written. Bounds are tested on the float
// coordinates before the float-to-int conversion: a point near or behind a
// camera projects to a huge coordinate, and (int) of such a float is
// undefined. A non-finite coordinate gives NaN, as in the JAX package and
// the twin. In training the kernel also writes the per-point mean over the
// sources, which the backward (source_variance_backward.cu, through the
// same sv::project, sv::footprint and sv::sample4) reads instead of
// reducing over the sources again.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "source_variance.cuh"

namespace {

// a source's footprint record
constexpr int SKIP = 0;    // adds nothing (padding source, off the map)
constexpr int SAMPLE = 1;  // sampled from its four taps
constexpr int POISON = 2;  // a non-finite coordinate: the result is NaN
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS, 6) source_variance_kernel(
    const float* __restrict__ feats,      // [N, Hf, Wf, C]
    const float* __restrict__ pts,        // [R, P, 3]
    const int64_t* __restrict__ src_idx,  // [R, S]
    const float* __restrict__ src_w,      // [R, S]: 1 real source, 0 padding
    const float* __restrict__ proj,       // [N, 3, 4]
    float* __restrict__ out,              // [R, P, C]
    float* __restrict__ mean_out,         // [R, P, C] or null
    long long P, int tiles, int S, int Hf, int Wf, int C, float sx,
    float sy) {
  const int cq = C >> 2;
  const int cs = min(cq, THREADS);  // channel groups a block
  const int t = threadIdx.x;
  const int r = blockIdx.x / tiles;
  const long long p =
      (long long)(blockIdx.x - r * tiles) * (blockDim.x / cs) + t / cs;
  const int q = blockIdx.y * cs + t % cs;
  const bool live = p < P && q < cq;
  // idle lanes (past the last point or channel group) still shuffle
  const size_t rp = (size_t)r * P + (p < P ? p : P - 1);
  const int qc = q < cq ? q : cq - 1;
  // the lanes of a warp that share this point: lane `mine` of them projects
  // sources mine, mine + gw, ...
  const int lane = t & 31;
  const int gw = (32 % cs == 0) ? cs : ((cs % 32 == 0) ? 32 : 1);
  const int base = lane & ~(gw - 1), mine = lane & (gw - 1);
  const float px = pts[rp * 3 + 0];
  const float py = pts[rp * 3 + 1];
  const float pz = pts[rp * 3 + 2];
  const int64_t* node = src_idx + (size_t)r * S;
  const float* wgt = src_w + (size_t)r * S;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc2 = make_float4(0.f, 0.f, 0.f, 0.f);
  float cnt = 0.f;
  for (int s0 = 0; s0 < S; s0 += gw) {
    sv::Footprint mfp;
    mfp.x0 = mfp.y0 = 0;
    mfp.wx = mfp.wy = 0.f;
    int flag = SKIP;
    const int s = s0 + mine;
    if (s < S) {
      const float4* M4 =
          reinterpret_cast<const float4*>(proj + node[s] * 12);
      const float4 a = __ldg(M4), b = __ldg(M4 + 1), c = __ldg(M4 + 2);
      const float M[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, c.x, c.y, c.z, c.w};
      float x, y;
      sv::project(M, px, py, pz, sx, sy, x, y);
      // a non-finite coordinate (a point at infinity, or a NaN input)
      // makes every bilinear weight NaN in the reference, and its f * mask
      // poisons the sums even for a padding source: the result is NaN, as
      // there. A footprint wholly off the map adds nothing to either sum.
      if (!(isfinite(x) && isfinite(y)))
        flag = POISON;
      else if (wgt[s] != 0.f && sv::footprint(x, y, Hf, Wf, mfp))
        flag = SAMPLE;
    }
    const int n = min(gw, S - s0);
    for (int k = 0; k < n; ++k) {
      const int from = base + k;
      sv::Footprint fp;
      fp.x0 = __shfl_sync(0xffffffffu, mfp.x0, from);
      fp.y0 = __shfl_sync(0xffffffffu, mfp.y0, from);
      fp.wx = __shfl_sync(0xffffffffu, mfp.wx, from);
      fp.wy = __shfl_sync(0xffffffffu, mfp.wy, from);
      const int f_flag = __shfl_sync(0xffffffffu, flag, from);
      const float m = wgt[s0 + k];
      cnt += m;
      if (f_flag == POISON) {
        acc = acc2 = make_float4(NAN, NAN, NAN, NAN);
      } else if (f_flag == SAMPLE) {
        fp.xin0 = fp.x0 >= 0;
        fp.xin1 = fp.x0 + 1 <= Wf - 1;
        fp.yin0 = fp.y0 >= 0;
        fp.yin1 = fp.y0 + 1 <= Hf - 1;
        const float4* fm =
            reinterpret_cast<const float4*>(
                feats + (size_t)node[s0 + k] * Hf * Wf * C) +
            qc;
        const float4 f = sv::sample4(fm, fp, Wf, cq);
        sv::fma4(acc, f, m);
        acc2.x = fmaf(f.x * f.x, m, acc2.x);
        acc2.y = fmaf(f.y * f.y, m, acc2.y);
        acc2.z = fmaf(f.z * f.z, m, acc2.z);
        acc2.w = fmaf(f.w * f.w, m, acc2.w);
      }
    }
  }
  if (!live) return;
  const float c = fmaxf(cnt, 1.f);
  float4 v, mu;
  mu.x = acc.x / c; v.x = acc2.x / c - mu.x * mu.x;
  mu.y = acc.y / c; v.y = acc2.y / c - mu.y * mu.y;
  mu.z = acc.z / c; v.z = acc2.z / c - mu.z * mu.z;
  mu.w = acc.w / c; v.w = acc2.w / c - mu.w * mu.w;
  const size_t o = rp * cq + q;
  reinterpret_cast<float4*>(out)[o] = v;
  if (mean_out) reinterpret_cast<float4*>(mean_out)[o] = mu;
}

}  // namespace

extern "C" int tdv_source_variance(const float* feats, const float* pts,
                                   const int64_t* src_idx, const float* src_w,
                                   const float* proj, float* out,
                                   float* mean_out, int R, long long P, int S,
                                   int Hf, int Wf, int C, float sx, float sy,
                                   void* stream) {
  const int cq = C / 4;
  if ((long long)R * P * cq == 0) return 0;
  const int cs = cq < THREADS ? cq : THREADS;
  const int ppb = THREADS / cs;  // points a block
  const long long tiles = (P + ppb - 1) / ppb;
  if (tiles * R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * R), (unsigned)((cq + cs - 1) / cs));
  source_variance_kernel<<<grid, ppb * cs, 0, (cudaStream_t)stream>>>(
      feats, pts, src_idx, src_w, proj, out, mean_out, P, (int)tiles, S, Hf,
      Wf, C, sx, sy);
  return (int)cudaGetLastError();
}
