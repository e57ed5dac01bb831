// bf16 storage for the kernels' bf16 forms (a bf16 model's forwards and
// backwards): values are held as their 16 bits (unsigned short, or four in
// a uint2 for one 8-byte access), widened to fp32 exactly for the
// arithmetic, and rounded to the nearest even bf16 once where a result is
// stored, as torch's `.to(bf16)` rounds. `load4` / `store4` / `store1` /
// `add_nonfinite` take either storage, so that a kernel templated on it
// keeps the fp32 form's loads, stores and arithmetic as they were.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bf16 {

using bits16 = unsigned short;

__device__ __forceinline__ float widen(bits16 u) {
  return __uint_as_float((unsigned)u << 16);
}

// four bf16 values, element 0 in the low half of .x
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ bits16 narrow(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint2 narrow(float4 f) {
  return make_uint2((unsigned)narrow(f.x) | ((unsigned)narrow(f.y) << 16),
                    (unsigned)narrow(f.z) | ((unsigned)narrow(f.w) << 16));
}

// f rounded to bf16 and widened back: the value a bf16 store keeps
__device__ __forceinline__ float round(float f) { return widen(narrow(f)); }

__device__ __forceinline__ float4 round(float4 f) {
  return make_float4(round(f.x), round(f.y), round(f.z), round(f.w));
}

// four channels: float4 storage, or four bf16 in a uint2
template <typename T> struct Quad { using V = float4; };
template <> struct Quad<bits16> { using V = uint2; };

__device__ __forceinline__ float4 load4(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float4 load4(const uint2* p) {
  return widen(__ldg(p));
}
// a plain (not read-only path) load, for data the kernel also writes
__device__ __forceinline__ float4 load4_plain(const float4* p) { return *p; }
__device__ __forceinline__ float4 load4_plain(const uint2* p) {
  return widen(*p);
}
__device__ __forceinline__ void store4(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void store4(uint2* p, float4 v) { *p = narrow(v); }

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bits16* p) {
  return widen(__ldg(p));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bits16* p, float v) { *p = narrow(v); }

// two neighbouring channels
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const bits16* p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// a non-finite term added onto a stored result (the backward kernels' last
// pass; Inf and NaN sums do not depend on the order or the precision)
__device__ __forceinline__ void add_nonfinite(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void add_nonfinite(bits16* p, float v) {
  atomicAdd(reinterpret_cast<__nv_bfloat16*>(p), __float2bfloat16_rn(v));
}

}  // namespace bf16
