// bf16 storage for the kernels' bf16 forms (inference only): values are
// held as their 16 bits (unsigned short, or four in a uint2 for one 8-byte
// access), widened to fp32 exactly for the arithmetic, and rounded to the
// nearest even bf16 once where a result is stored, as torch's `.to(bf16)`
// rounds.
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

}  // namespace bf16
