// source_variance_backward: the gradient of the masked per-point feature
// variance (source_variance.cu) with respect to the feature maps.
//
// Replaces: the VJP that JAX derives for tdvnet/ops/costvolume.py
// `_source_variance` (:36-97) with respect to `feats`, through its
// rematerialised source scan and the quad-packed bilinear gathers
// (tdvnet/ops/sampling.py `bilinear_sample_quads`, :80-106). The points and
// projections take no gradient there: the plane-sweep points derive from
// the cameras only, and the scene and hypothesis points are
// `stop_gradient`ed (tdvnet/models/threedvnet.py:81, :192).
//
// Math: var = sum_s m_s f_s^2 / cnt - mean^2 with mean = sum_s m_s f_s / cnt,
// so d var / d f_s = 2 m_s (f_s - mean) / cnt, and the sample f_s is a
// bilinear blend of four taps of feats[src_idx[r, s]]. Each tap receives
// g * 2 m_s (f_s - mean) / cnt times its bilinear weight.
//
// Bound on an H100: bytes in the contract's count (grad_var and mean read
// once, 1.08 GB at the full-width cost volume, plus feats and grad_feats,
// ~0.33 ms at 3.35 TB/s); in practice the atomics: the full-width cost
// volume scatters ~1.6e9 values into 2.9 M, ~550 adds per element, and
// neighbouring points land on the same taps.
//
// Design: one thread per (point, 4 channels), as the forward, so that C/4
// neighbouring threads share one point and each tap is one 16-byte vector
// reduction (`red.global.add.v4.f32`, sm_90) per thread on one contiguous
// pixel. The sample f_s is recomputed from the taps with the forward's own
// projection, footprint and blend (source_variance.cuh); the mean comes
// from the forward. The sum order of the atomics changes from run to run.
// A point whose projection is not finite has a NaN variance in the forward
// and scatters nothing here.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "source_variance.cuh"

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

__device__ __forceinline__ float4 scale4(const float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

__global__ void source_variance_backward_kernel(
    const float* __restrict__ grad,       // [R, P, C] d loss / d var
    const float* __restrict__ mean,       // [R, P, C] from the forward
    const float* __restrict__ feats,      // [N, Hf, Wf, C]
    const float* __restrict__ pts,        // [R, P, 3]
    const int64_t* __restrict__ src_idx,  // [R, S]
    const float* __restrict__ src_w,      // [R, S]
    const float* __restrict__ proj,       // [N, 3, 4]
    float* __restrict__ grad_feats,       // [N, Hf, Wf, C], zeroed
    int R, long long P, int S, int Hf, int Wf, int C, float sx, float sy) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)R * P * cq) return;
  const int q = (int)(t % cq);
  const long long rp = t / cq;
  const int r = (int)(rp / P);
  const float4 g = reinterpret_cast<const float4*>(grad)[rp * cq + q];
  const float4 mu = reinterpret_cast<const float4*>(mean)[rp * cq + q];
  const float px = pts[rp * 3 + 0];
  const float py = pts[rp * 3 + 1];
  const float pz = pts[rp * 3 + 2];
  float cnt = 0.f;
  for (int s = 0; s < S; ++s) cnt += src_w[r * S + s];
  const float c = fmaxf(cnt, 1.f);

  for (int s = 0; s < S; ++s) {
    const float m = src_w[r * S + s];
    if (m == 0.f) continue;
    const long long n = src_idx[r * S + s];
    float x, y;
    sv::project(proj + n * 12, px, py, pz, sx, sy, x, y);
    if (!(isfinite(x) && isfinite(y))) continue;
    sv::Footprint fp;
    if (!sv::footprint(x, y, Hf, Wf, fp)) continue;
    const size_t base = (size_t)n * Hf * Wf * cq + q;
    const float4* fm = reinterpret_cast<const float4*>(feats) + base;
    const float4 f = sv::sample4(fm, fp, Wf, cq);
    const float k = 2.f * m / c;
    const float4 d = make_float4(g.x * k * (f.x - mu.x), g.y * k * (f.y - mu.y),
                                 g.z * k * (f.z - mu.z), g.w * k * (f.w - mu.w));
    float4* gm = reinterpret_cast<float4*>(grad_feats) + base;
    const int x0 = fp.x0, y0 = fp.y0;
    const float wx = fp.wx, wy = fp.wy;
    if (fp.yin0 && fp.xin0)
      red_add4(gm + ((size_t)y0 * Wf + x0) * cq,
               scale4(d, (1.f - wx) * (1.f - wy)));
    if (fp.yin0 && fp.xin1)
      red_add4(gm + ((size_t)y0 * Wf + x0 + 1) * cq,
               scale4(d, wx * (1.f - wy)));
    if (fp.yin1 && fp.xin0)
      red_add4(gm + ((size_t)(y0 + 1) * Wf + x0) * cq,
               scale4(d, (1.f - wx) * wy));
    if (fp.yin1 && fp.xin1)
      red_add4(gm + ((size_t)(y0 + 1) * Wf + x0 + 1) * cq, scale4(d, wx * wy));
  }
}

}  // namespace

extern "C" int tdv_source_variance_backward(
    const float* grad, const float* mean, const float* feats, const float* pts,
    const int64_t* src_idx, const float* src_w, const float* proj,
    float* grad_feats, int R, long long P, int S, int Hf, int Wf, int C,
    float sx, float sy, void* stream) {
  const long long total = (long long)R * P * (C / 4);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  source_variance_backward_kernel<<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
      grad, mean, feats, pts, src_idx, src_w, proj, grad_feats, R, P, S, Hf,
      Wf, C, sx, sy);
  return (int)cudaGetLastError();
}
