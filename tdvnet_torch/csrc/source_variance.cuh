// Shared by source_variance.cu and source_variance_backward.cu: the
// projection of a world point into a source's feature grid and its bilinear
// footprint, so that the backward scatters into exactly the taps, with
// exactly the weights, that the forward read.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "bf16.cuh"

namespace sv {

__device__ __forceinline__ void fma4(float4& acc, const float4 v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

// Feature-grid coordinates of world point (px, py, pz) under the source's
// projection M [3, 4] (full-image pixel units), scaled by (sx, sy).
__device__ __forceinline__ void project(const float* M, float px, float py,
                                        float pz, float sx, float sy,
                                        float& x, float& y) {
  const float X = M[0] * px + M[1] * py + M[2] * pz + M[3];
  const float Y = M[4] * px + M[5] * py + M[6] * pz + M[7];
  const float Z = M[8] * px + M[9] * py + M[10] * pz + M[11];
  const float den = fabsf(Z) + 1e-8f;
  x = (X / den) * sx;
  y = (Y / den) * sy;
}

// The bilinear footprint of a finite coordinate: the anchor (x0, y0), the
// fractions and which of the four taps lie on the map. False when the whole
// 2x2 footprint lies outside it (the anchor outside [-1, W-1] x [-1, H-1]):
// the sample is zero. Bounds are tested on the float coordinates before
// the float-to-int conversion, which is undefined for huge values.
struct Footprint {
  int x0, y0;
  float wx, wy;
  bool xin0, xin1, yin0, yin1;
};

__device__ __forceinline__ bool footprint(float x, float y, int Hf, int Wf,
                                          Footprint& fp) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  if (!(x0f >= -1.f && x0f <= (float)(Wf - 1) && y0f >= -1.f &&
        y0f <= (float)(Hf - 1)))
    return false;
  fp.x0 = (int)x0f;
  fp.y0 = (int)y0f;
  fp.wx = x - x0f;
  fp.wy = y - y0f;
  fp.xin0 = fp.x0 >= 0;
  fp.xin1 = fp.x0 + 1 <= Wf - 1;
  fp.yin0 = fp.y0 >= 0;
  fp.yin1 = fp.y0 + 1 <= Hf - 1;
  return true;
}

// one 4-channel group of a pixel: fp32, or bf16 widened exactly
__device__ __forceinline__ float4 load4(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float4 load4(const uint2* p) {
  return bf16::widen(__ldg(p));
}

// The bilinear sample of one 4-channel group, in fp32; fm points at the
// group's channels of pixel (0, 0), cq = C / 4 groups per pixel (float4,
// or uint2 for four bf16).
template <typename V>
__device__ __forceinline__ float4 sample4(const V* fm, const Footprint& fp,
                                          int Wf, int cq) {
  const int x0 = fp.x0, y0 = fp.y0;
  const float wx = fp.wx, wy = fp.wy;
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  if (fp.yin0 && fp.xin0)
    fma4(f, load4(fm + ((size_t)y0 * Wf + x0) * cq), (1.f - wx) * (1.f - wy));
  if (fp.yin0 && fp.xin1)
    fma4(f, load4(fm + ((size_t)y0 * Wf + x0 + 1) * cq), wx * (1.f - wy));
  if (fp.yin1 && fp.xin0)
    fma4(f, load4(fm + ((size_t)(y0 + 1) * Wf + x0) * cq), (1.f - wx) * wy);
  if (fp.yin1 && fp.xin1)
    fma4(f, load4(fm + ((size_t)(y0 + 1) * Wf + x0 + 1) * cq), wx * wy);
  return f;
}

}  // namespace sv
