// softargmax_depth_backward: the gradient of the soft-argmax depth
// (softargmax_depth.cu) with respect to the cost volume.
//
// Replaces: the VJP that JAX derives for the soft-argmax tail of
// tdvnet/models/mvsnet.py `predict_depth` (:89-93), the XLA form of the
// round-1 Pallas kernel `softargmax_depth`
// (tdvnet/kernels/depthops_pallas.py:31-63 before commit 2df7997).
//
// Math: depth = sum_d p_d v_d with p = softmax_d(-cost), so
// d depth / d cost_d = -p_d (v_d - depth).
//
// Bound on an H100: bytes. It reads the cost volume and writes its
// gradient (2 x 16.9 MB at full width, ~10 us at 3.35 TB/s); ~8 flops per
// element.
//
// Design: one read of the volume and one write of its gradient, laid out
// as the forward's: a block owns a strip of 32 * VEC consecutive pixels of
// one ref over all D planes (VEC = 2, two pixels a lane in one 8-byte load,
// where the map's pixel count is even and the pointers 8-byte aligned; else
// 1); its 8 warps (32 where D > 96) take bands of at most 12 planes, and a
// lane loads its band at once into registers, one coalesced row of the
// strip a plane. Each pixel's maximum of -cost is taken over the bands'
// maxima through shared memory (a maximum is exact in any order); a lane
// turns its band into exponentials expf(-cost - max), keeps them in its
// registers and writes them to shared memory, where one thread a pixel sums
// its D exponentials in plane order (den += e, the denominator of one
// thread walking the planes) and hands the sum back; then every lane writes
// its band's gradients (-g * (e / den)) * (v_d - depth) from its registers,
// one coalesced row a plane. Each output element takes the operations of
// the one-thread-a-pixel form (IEEE division, no sum split), so the bits
// are that form's. With 8 warps a block holds 4 blocks an SM (registers
// capped at 64 a thread, no spill): a cap of 40 for 6 blocks, which would
// take the batch's 686 strips in one wave, spilled the band and measured
// slower, and caps of 51 and none no faster.
//
// Past 32 bands (D > 384 planes) a second form takes any D: one thread a
// pixel, 128 consecutive pixels a block (each plane's row of a block one
// coalesced access). Read 1 takes the maximum of -cost, read 2 sums the
// denominator in plane order (den += expf(-cost - max)), read 3 recomputes
// each exponential and writes (-g * (e / den)) * (v_d - depth) with IEEE
// division: the register form's operations, so its bits where both run.
// Three reads of the volume (the later ones mostly from L2) and one write
// of its gradient; large D is off the main path.
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

template <int WARPS> struct Residency { static constexpr int kBlocks = 1; };
template <> struct Residency<8> { static constexpr int kBlocks = 4; };

template <int VEC, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, Residency<WARPS>::kBlocks)
    softargmax_depth_backward_kernel(const float* __restrict__ grad,
                                     const float* __restrict__ cost,
                                     const float* __restrict__ dvals,
                                     const float* __restrict__ depth,
                                     float* __restrict__ grad_cost, int D,
                                     long long HW, long long strips,
                                     int band) {
  using T = typename Pack<VEC>::T;
  constexpr int kStrip = 32 * VEC;
  // [D][kStrip] exponentials, [WARPS][kStrip] band maxima, [kStrip]
  // denominators, [D] depths
  extern __shared__ float s[];
  float* smax = s + (size_t)D * kStrip;
  float* sden = smax + WARPS * kStrip;
  float* sdv = sden + kStrip;
  for (int d = threadIdx.x; d < D; d += blockDim.x) sdv[d] = dvals[d];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long r = blockIdx.x / strips;
  const long long base = (blockIdx.x % strips) * kStrip;
  const long long p = base + lane * VEC;  // VEC = 2 only where HW is even
  const bool live = p < HW;
  const float* c = cost + r * D * HW + p;
  const int d0 = warp * band, d1 = min(d0 + band, D);
  T v[kBand], m, g, dep;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    at(m, j) = -INFINITY;
    at(g, j) = 0.f;
    at(dep, j) = 0.f;
  }
  if (live) {
    g = *reinterpret_cast<const T*>(grad + r * HW + p);
    dep = *reinterpret_cast<const T*>(depth + r * HW + p);
  }
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
  // the band's exponentials replace its costs in the registers
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    if (d0 + i < d1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        at(v[i], j) = expf(-at(v[i], j) - at(m, j));
      *reinterpret_cast<T*>(s + (d0 + i) * kStrip + lane * VEC) = v[i];
    }
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < kStrip && base + q < HW) {
    float den = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) den += s[d * kStrip + q];
    sden[q] = den;
  }
  __syncthreads();
  if (!live) return;
  T den = *reinterpret_cast<const T*>(sden + lane * VEC);
  float* gc = grad_cost + r * D * HW + p;
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    if (d0 + i < d1) {
      const float dv = sdv[d0 + i];
      T out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        at(out, j) = (-at(g, j) * (at(v[i], j) / at(den, j)))
                     * (dv - at(dep, j));
      *reinterpret_cast<T*>(gc + (d0 + i) * HW) = out;
    }
  }
}

template <int VEC, int WARPS>
int launch_warps(const float* grad, const float* cost, const float* dvals,
                 const float* depth, float* grad_cost, int R, int D,
                 long long HW, cudaStream_t stream) {
  constexpr int kStrip = 32 * VEC;
  const auto kernel = softargmax_depth_backward_kernel<VEC, WARPS>;
  const size_t smem =
      ((size_t)(D + WARPS + 1) * kStrip + D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long strips = (HW + kStrip - 1) / kStrip;
  const int band = (D + WARPS - 1) / WARPS;   // at most kBand planes
  kernel<<<(unsigned)(R * strips), 32 * WARPS, smem, stream>>>(
      grad, cost, dvals, depth, grad_cost, D, HW, strips, band);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch(const float* grad, const float* cost, const float* dvals,
           const float* depth, float* grad_cost, int R, int D, long long HW,
           cudaStream_t stream) {
  return D <= 8 * kBand
             ? launch_warps<VEC, 8>(grad, cost, dvals, depth, grad_cost, R,
                                    D, HW, stream)
             : launch_warps<VEC, kMaxWarps>(grad, cost, dvals, depth,
                                            grad_cost, R, D, HW, stream);
}

inline bool aligned8(const void* ptr) { return (uintptr_t)ptr % 8 == 0; }

constexpr int kLongThreads = 128;   // pixels a block of the any-D form

__global__ void __launch_bounds__(kLongThreads)
    softargmax_depth_backward_long_kernel(const float* __restrict__ grad,
                                          const float* __restrict__ cost,
                                          const float* __restrict__ dvals,
                                          const float* __restrict__ depth,
                                          float* __restrict__ grad_cost,
                                          int D, long long HW,
                                          long long strips) {
  const long long r = blockIdx.x / strips;
  const long long p = (blockIdx.x % strips) * kLongThreads + threadIdx.x;
  if (p >= HW) return;
  const float* c = cost + r * D * HW + p;
  float m = -INFINITY;
#pragma unroll 32
  for (int d = 0; d < D; ++d) m = fmaxf(m, -__ldg(c + d * HW));
  float den = 0.f;
#pragma unroll 32
  for (int d = 0; d < D; ++d) den += expf(-__ldg(c + d * HW) - m);
  const float g = grad[r * HW + p], dep = depth[r * HW + p];
  float* gc = grad_cost + r * D * HW + p;
#pragma unroll 32
  for (int d = 0; d < D; ++d) {
    const float e = expf(-__ldg(c + d * HW) - m);
    gc[d * HW] = (-g * (e / den)) * (__ldg(dvals + d) - dep);
  }
}

}  // namespace

// D is at most tdv_softargmax_depth_max_planes() (softargmax_depth.cu), the
// same register bands as the forward's; past it the wrapper launches
// tdv_softargmax_depth_backward_long.
extern "C" int tdv_softargmax_depth_backward(const float* grad,
                                             const float* cost,
                                             const float* dvals,
                                             const float* depth,
                                             float* grad_cost, int R, int D,
                                             long long HW, void* stream) {
  if ((long long)R * HW == 0 || D == 0) return 0;
  if (D > kMaxWarps * kBand) return (int)cudaErrorInvalidValue;
  const bool pairs = HW % 2 == 0 && aligned8(grad) && aligned8(cost) &&
                     aligned8(depth) && aligned8(grad_cost);
  cudaStream_t st = (cudaStream_t)stream;
  return pairs ? launch<2>(grad, cost, dvals, depth, grad_cost, R, D, HW, st)
               : launch<1>(grad, cost, dvals, depth, grad_cost, R, D, HW,
                           st);
}

// The form for any D (the wrapper's choice past the register form's
// planes; at most planes a test compares the two forms' bits).
extern "C" int tdv_softargmax_depth_backward_long(
    const float* grad, const float* cost, const float* dvals,
    const float* depth, float* grad_cost, int R, int D, long long HW,
    void* stream) {
  if ((long long)R * HW == 0 || D == 0) return 0;
  const long long strips = (HW + kLongThreads - 1) / kLongThreads;
  softargmax_depth_backward_long_kernel<<<(unsigned)(R * strips),
                                          kLongThreads, 0,
                                          (cudaStream_t)stream>>>(
      grad, cost, dvals, depth, grad_cost, D, HW, strips);
  return (int)cudaGetLastError();
}
