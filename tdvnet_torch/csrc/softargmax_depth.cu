// softargmax_depth: depth = sum_d softmax_d(-cost) * depth_vals[d], with a
// max-subtracted softmax over the plane axis.
//
// Replaces: the Pallas kernel `softargmax_depth` of the JAX package's round
// 1 (tdvnet/kernels/depthops_pallas.py:31-63 before commit 2df7997,
// `pallas_call` at :51) and its XLA form on today's main path,
// tdvnet/models/mvsnet.py:89-93.
//
// Bound on an H100: bytes. It reads the [R, D, h, w] cost volume once
// (16.9 MB at full width) and writes [R, h, w]; ~5 flops per cost element.
//
// Design: the volume is read from HBM once, with all of a block's loads in
// flight together. A block owns a strip of 32 * VEC consecutive pixels of
// one ref over all D planes (VEC = 2, two pixels a lane in one 8-byte load,
// where the map's pixel count is even; else 1); its 8 warps (32 where
// D > 96) take bands of at most 12 planes, and a lane loads its band at once
// into registers, one coalesced row of the strip a plane. Each pixel's
// maximum of -cost is taken over the bands' maxima through shared memory (a
// maximum is exact in any order); each lane writes its band's
// expf(-cost - max) to shared memory ([D][32 * VEC] floats, 24 KB at
// D = 96), and one thread a pixel sums its D exponentials in plane order
// with the operations of one thread walking the planes (den += e;
// num = fmaf(e, depth_vals[d], num)), so the output has that form's bits.
// Staging the costs themselves in shared memory read the volume at half
// this rate: each store waited on its load.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBand = 12;        // a warp's planes, held in registers
constexpr int kMaxWarps = 32;

template <int VEC> struct Pack;
template <> struct Pack<1> { using T = float; };
template <> struct Pack<2> { using T = float2; };

template <typename T>
__device__ __forceinline__ float& at(T& a, int j) {
  return reinterpret_cast<float*>(&a)[j];
}

// WARPS is 8 for D <= 96 and 32 above: a block's warp count fixed at
// compile time kept the batch's call at 46 registers a thread and 7.4 us
// on an H100, where a count read at run time took 48 registers and a
// spill, and 8.05 us.
template <int VEC, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    softargmax_depth_kernel(const float* __restrict__ cost,
                            const float* __restrict__ dvals,
                            float* __restrict__ out, int D, long long HW,
                            long long strips, int band) {
  using T = typename Pack<VEC>::T;
  constexpr int kStrip = 32 * VEC;
  // [D][kStrip] exponentials, [WARPS][kStrip] band maxima, [D] depths
  extern __shared__ float s[];
  float* smax = s + (size_t)D * kStrip;
  float* sdv = smax + WARPS * kStrip;
  for (int d = threadIdx.x; d < D; d += blockDim.x) sdv[d] = dvals[d];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long r = blockIdx.x / strips;
  const long long base = (blockIdx.x % strips) * kStrip;
  const long long p = base + lane * VEC;  // VEC = 2 only where HW is even
  const bool live = p < HW;
  const float* c = cost + r * D * HW + p;
  const int d0 = warp * band, d1 = min(d0 + band, D);
  T v[kBand], m;
#pragma unroll
  for (int j = 0; j < VEC; ++j) at(m, j) = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    if (live && d0 + i < d1) {
      v[i] = *reinterpret_cast<const T*>(c + (d0 + i) * HW);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) at(v[i], j) = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kBand; ++i)
    if (d0 + i < d1)
#pragma unroll
      for (int j = 0; j < VEC; ++j) at(m, j) = fmaxf(at(m, j), -at(v[i], j));
  *reinterpret_cast<T*>(smax + warp * kStrip + lane * VEC) = m;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VEC; ++j) at(m, j) = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    T q = *reinterpret_cast<const T*>(smax + w * kStrip + lane * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) at(m, j) = fmaxf(at(m, j), at(q, j));
  }
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    if (d0 + i < d1) {
      T e;
#pragma unroll
      for (int j = 0; j < VEC; ++j) at(e, j) = expf(-at(v[i], j) - at(m, j));
      *reinterpret_cast<T*>(s + (d0 + i) * kStrip + lane * VEC) = e;
    }
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q >= kStrip || base + q >= HW) return;
  float den = 0.f, num = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float e = s[d * kStrip + q];
    den += e;
    num = fmaf(e, sdv[d], num);
  }
  out[r * HW + base + q] = num / den;
}

template <int VEC, int WARPS>
int launch_warps(const float* cost, const float* dvals, float* out, int R, int D,
           long long HW, cudaStream_t stream) {
  constexpr int kStrip = 32 * VEC;
  const auto kernel = softargmax_depth_kernel<VEC, WARPS>;
  const size_t smem = ((size_t)(D + WARPS) * kStrip + D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long strips = (HW + kStrip - 1) / kStrip;
  const int band = (D + WARPS - 1) / WARPS;   // at most kBand planes
  kernel<<<(unsigned)(R * strips), 32 * WARPS, smem, stream>>>(
      cost, dvals, out, D, HW, strips, band);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch(const float* cost, const float* dvals, float* out, int R, int D,
           long long HW, cudaStream_t stream) {
  return D <= 8 * kBand
             ? launch_warps<VEC, 8>(cost, dvals, out, R, D, HW, stream)
             : launch_warps<VEC, kMaxWarps>(cost, dvals, out, R, D, HW,
                                            stream);
}

}  // namespace

// The largest plane count a block takes: its warps' bands in registers.
extern "C" int tdv_softargmax_depth_max_planes() {
  return kMaxWarps * kBand;
}

extern "C" int tdv_softargmax_depth(const float* cost, const float* dvals,
                                    float* out, int R, int D, long long HW,
                                    void* stream) {
  if ((long long)R * HW == 0) return 0;
  if (D > tdv_softargmax_depth_max_planes()) return (int)cudaErrorInvalidValue;
  // D = 0 loads nothing and writes 0 / 0
  const bool pairs = HW % 2 == 0 && (uintptr_t)cost % 8 == 0;
  return pairs ? launch<2>(cost, dvals, out, R, D, HW, (cudaStream_t)stream)
               : launch<1>(cost, dvals, out, R, D, HW, (cudaStream_t)stream);
}
