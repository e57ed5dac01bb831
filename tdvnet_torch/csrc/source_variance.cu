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
// Bound on an H100: bytes. Each output element costs one 4-byte store and
// ~11 flops per active source, far below the 67 TFLOP/s fp32 rate; the
// output [R, P, C] fp32 dominates the traffic (540 MB at the cost-volume
// call, a bound of ~0.16 ms at 3.35 TB/s). The feature maps (2.9 MB at
// full width) stay in the 50 MB L2.
//
// Design: one thread per (point, 4 channels), so C/4 neighbouring threads
// share one point and each bilinear tap is one 16-byte load per thread
// (C/4 threads cover one contiguous C*4-byte pixel). The projection is
// recomputed by each of those threads (24 flops, cheaper than sharing it).
// The sums over sources stay in registers; per-source samples are never
// written. Bounds are tested on the float coordinates before the
// float-to-int conversion: a point near or behind a camera projects to a
// huge coordinate, and (int) of such a float is undefined. A non-finite
// coordinate gives NaN, as in the JAX package and the twin. In training the
// kernel also writes the per-point mean over the sources, which the
// backward (source_variance_backward.cu) reads instead of reducing over the
// sources again.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "source_variance.cuh"

namespace {

__global__ void source_variance_kernel(
    const float* __restrict__ feats,      // [N, Hf, Wf, C]
    const float* __restrict__ pts,        // [R, P, 3]
    const int64_t* __restrict__ src_idx,  // [R, S]
    const float* __restrict__ src_w,      // [R, S]: 1 real source, 0 padding
    const float* __restrict__ proj,       // [N, 3, 4]
    float* __restrict__ out,              // [R, P, C]
    float* __restrict__ mean_out,         // [R, P, C] or null
    int R, long long P, int S, int Hf, int Wf, int C, float sx, float sy) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)R * P * cq) return;
  const int q = (int)(t % cq);
  const long long rp = t / cq;
  const int r = (int)(rp / P);
  const float px = pts[rp * 3 + 0];
  const float py = pts[rp * 3 + 1];
  const float pz = pts[rp * 3 + 2];

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc2 = make_float4(0.f, 0.f, 0.f, 0.f);
  float cnt = 0.f;
  for (int s = 0; s < S; ++s) {
    const float m = src_w[r * S + s];
    cnt += m;
    const long long n = src_idx[r * S + s];
    float x, y;
    sv::project(proj + n * 12, px, py, pz, sx, sy, x, y);
    // a non-finite coordinate (a point at infinity, or a NaN input) makes
    // every bilinear weight NaN in the reference, and its f * mask poisons
    // the sums even for a padding source: the result is NaN, as there
    if (!(isfinite(x) && isfinite(y))) {
      acc = acc2 = make_float4(NAN, NAN, NAN, NAN);
      continue;
    }
    if (m == 0.f) continue;
    sv::Footprint fp;
    // the whole 2x2 footprint is outside the map: the sample is zero and
    // adds nothing to either sum
    if (!sv::footprint(x, y, Hf, Wf, fp)) continue;
    const float4* fm =
        reinterpret_cast<const float4*>(feats + (size_t)n * Hf * Wf * C) + q;
    const float4 f = sv::sample4(fm, fp, Wf, cq);
    sv::fma4(acc, f, m);
    acc2.x = fmaf(f.x * f.x, m, acc2.x);
    acc2.y = fmaf(f.y * f.y, m, acc2.y);
    acc2.z = fmaf(f.z * f.z, m, acc2.z);
    acc2.w = fmaf(f.w * f.w, m, acc2.w);
  }
  const float c = fmaxf(cnt, 1.f);
  float4 v, mu;
  mu.x = acc.x / c; v.x = acc2.x / c - mu.x * mu.x;
  mu.y = acc.y / c; v.y = acc2.y / c - mu.y * mu.y;
  mu.z = acc.z / c; v.z = acc2.z / c - mu.z * mu.z;
  mu.w = acc.w / c; v.w = acc2.w / c - mu.w * mu.w;
  reinterpret_cast<float4*>(out)[rp * cq + q] = v;
  if (mean_out) reinterpret_cast<float4*>(mean_out)[rp * cq + q] = mu;
}

}  // namespace

extern "C" int tdv_source_variance(const float* feats, const float* pts,
                                   const int64_t* src_idx, const float* src_w,
                                   const float* proj, float* out,
                                   float* mean_out, int R, long long P, int S,
                                   int Hf, int Wf, int C, float sx, float sy,
                                   void* stream) {
  const long long total = (long long)R * P * (C / 4);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  source_variance_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      feats, pts, src_idx, src_w, proj, out, mean_out, R, P, S, Hf, Wf, C, sx,
      sy);
  return (int)cudaGetLastError();
}
