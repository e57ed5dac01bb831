// Order-free sums for the backward kernels (source_variance_backward.cu,
// trilinear_sample_backward.cu, segment_max_backward.cu).
//
// A float sum formed by atomics depends on the order in which the adds
// land, which changes from run to run, so a train step would not repeat.
// Here every term is rounded once to a fixed-point integer,
// q = rint(v * 2^k), and the terms of an element are summed as 64-bit
// integers (in shared memory as two 32-bit atomics, `shared_add`; in global
// memory `red.global.add.u64`; or in registers). Integer addition is
// associative, so the sum, and the fp32 value it is converted back to once
// (`dequantize`), are the same bits in every order.
//
// The power-of-two scale 2^k is set per call on the device, with no host
// sync, from a bound that rules out overflow: the caller's kernels first
// take the largest finite magnitude of each input that bounds a term
// (`amax_kernel`, an order-free atomicMax on the bit pattern), then
// `scale_exp` chooses k so that (the bound on one term) x (the most terms
// an element can receive) stays below 2^62. Every partial sum, in any
// order, then fits. With the element's terms counted at the most the call
// could give it (not the few hundred it does give), the quantum still lies
// some 2^-30 below the largest term, far below an fp32 ulp of any element
// within 1e-6 of the largest.
//
// Non-finite terms cannot travel through an integer sum. `quantize` turns
// one into 0 and raises the call's flag; the caller then runs a pass that
// adds only the non-finite terms, as floats, onto the converted result:
// x + Inf = Inf, Inf + -Inf = NaN and NaN + anything = NaN in any order, so
// an element comes out non-finite exactly where the float sum's would, and
// the pass costs one early exit when the flag is down.
//
// The amax pass reads fp32 or bf16 storage (`bf16::bits16`, the bf16
// backward forms'): a bf16 value widens to fp32 exactly.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {
namespace fx {

constexpr int kAmaxThreads = 256;
constexpr int kAmaxUnroll = 4;

// |v|'s bit pattern where v is finite, else 0: the bit patterns of
// non-negative floats order as their values, so an integer max is a max
// of magnitudes
__device__ __forceinline__ unsigned finite_abs_bits(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b < 0x7f800000u ? b : 0u;
}

__device__ __forceinline__ unsigned max4(float4 v, unsigned m) {
  m = max(m, finite_abs_bits(v.x));
  m = max(m, finite_abs_bits(v.y));
  m = max(m, finite_abs_bits(v.z));
  m = max(m, finite_abs_bits(v.w));
  return m;
}

template <typename T>
__device__ __forceinline__ float4 load_at(const T* __restrict__ a,
                                          long long j, int cq,
                                          long long stride) {
  using V = typename bf16::Quad<T>::V;
  if (stride == 4LL * cq)   // contiguous rows: no division
    return bf16::load4(reinterpret_cast<const V*>(a) + j);
  const long long r = j / cq;
  return bf16::load4(reinterpret_cast<const V*>(a + r * stride) +
                     (j - r * cq));
}

// *out = max(*out, the finite |a[r, c]| bit patterns) over rows r < rows,
// columns c < cols (cols % 4 == 0, rows `stride` elements apart, aligned
// to four of them); a grid-stride loop with kAmaxUnroll loads in flight
template <typename T>
__global__ void __launch_bounds__(kAmaxThreads) amax_kernel(
    const T* __restrict__ a, long long rows, int cols, long long stride,
    unsigned* __restrict__ out) {
  const int cq = cols >> 2;
  const long long n = rows * cq;
  const long long step = (long long)gridDim.x * kAmaxThreads;
  unsigned m = 0u;
  long long i = (long long)blockIdx.x * kAmaxThreads + threadIdx.x;
  for (; i + (kAmaxUnroll - 1) * step < n; i += kAmaxUnroll * step) {
    float4 v[kAmaxUnroll];
#pragma unroll
    for (int u = 0; u < kAmaxUnroll; ++u)
      v[u] = load_at(a, i + u * step, cq, stride);
#pragma unroll
    for (int u = 0; u < kAmaxUnroll; ++u) m = max4(v[u], m);
  }
  for (; i < n; i += step) m = max4(load_at(a, i, cq, stride), m);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
  __shared__ unsigned warp_max[kAmaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kAmaxThreads / 32; ++w) m = max(m, warp_max[w]);
    if (m) atomicMax(out, m);
  }
}

// launch amax_kernel on at most ~4 blocks an SM's worth of a 132-SM card
template <typename T>
inline void amax(const T* a, long long rows, int cols, long long stride,
                 unsigned* out, cudaStream_t s) {
  const long long n = rows * (cols / 4);
  if (n <= 0) return;
  long long blocks = (n + kAmaxThreads - 1) / kAmaxThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  amax_kernel<T><<<(unsigned)blocks, kAmaxThreads, 0, s>>>(a, rows, cols,
                                                           stride, out);
}

// e with |v| < 2^(e + 1) for an amax bit pattern (0 when the maximum is 0:
// every term is then 0 and any scale will do)
__device__ __forceinline__ int exp_of(unsigned bits) {
  const int e = (int)(bits >> 23) - 127;
  return e < -126 ? -126 : e;
}

// k such that sum |q| < 2^62 when every term is below 2^e_term and an
// element receives at most 2^log2_terms of them: each |q| < 2^(e_term + k)
// + 1/2, so k = 61 - e_term - log2_terms leaves a factor of two for the
// rounding. Clamped so that 2^k and 2^-k are normal floats; a bound past
// the clamp only costs precision on terms below ~2^-60 of an fp32's range.
__device__ __forceinline__ int scale_exp(int e_term, int log2_terms) {
  const int k = 61 - e_term - log2_terms;
  return k < -120 ? -120 : (k > 120 ? 120 : k);
}

__device__ __forceinline__ float pow2(int k) {
  return __uint_as_float((unsigned)(k + 127) << 23);
}

// one term rounded to the fixed point of scale `scale` (= 2^k); a
// non-finite term adds 0 and raises *nf (the float pass adds it later)
__device__ __forceinline__ long long quantize(float v, float scale,
                                              unsigned* nf) {
  if (!isfinite(v)) {
    *reinterpret_cast<volatile unsigned*>(nf) = 1u;
    return 0;
  }
  return __float2ll_rn(v * scale);
}

// rint(a * b) for |a * b| < 2^51, by one fma with 1.5 * 2^52: the sum
// lands in [2^52, 2^53), where a double's unit is 1, and its bits less the
// constant's are the integer (double arithmetic, not a conversion)
__device__ __forceinline__ long long rint_to_ll(double a, double b) {
  constexpr double kMagic = 6755399441055744.0;
  return __double_as_longlong(fma(a, b, kMagic)) -
         __double_as_longlong(kMagic);
}

// the sum back in fp32: one rounding of the integer, then an exact power of
// two (inv_scale = 2^-k)
__device__ __forceinline__ float dequantize(long long s, float inv_scale) {
  return __ll2float_rn(s) * inv_scale;
}

__device__ __forceinline__ void red_add(long long* addr, long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(addr), "l"(v)
               : "memory");
}

// A 64-bit add into shared memory as two native 32-bit atomics: sm_90 has
// no 64-bit shared-memory integer add (`atom.shared.add.u64` compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN.64, which retries under the
// contention a merging tile has). The low word's add returns its old value,
// which gives its carry; the high word then takes the addend's high word
// plus the carry, and is left alone when that is 0 (a small term of either
// sign that does not wrap the low word). The carries count exactly the
// low word's wraps, so the pair holds the exact sum mod 2^64 in any order.
__device__ __forceinline__ void shared_add(unsigned* lo_word,
                                           unsigned* hi_word, long long v) {
  const unsigned lo = (unsigned)(unsigned long long)v;
  const unsigned hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(lo_word, lo);
  const unsigned up = hi + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(hi_word, up);
}
// the same into an int64 in shared memory (its two words side by side)
__device__ __forceinline__ void shared_add(long long* addr, long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(addr);
  shared_add(w, w + 1, v);
}

// ceil(log2(n)) for n >= 1, on the host and on the device
inline int log2_ceil(long long n) {
  int b = 0;
  while ((1LL << b) < n && b < 62) ++b;
  return b;
}
__device__ __forceinline__ int log2_ceil_dev(long long n) {
  return n <= 1 ? 0 : 64 - __clzll(n - 1);
}

}  // namespace fx
}  // namespace
