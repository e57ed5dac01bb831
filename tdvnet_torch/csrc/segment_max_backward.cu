// segment_max_backward: the gradients of the PointNet's per-voxel max pool
// and of its concat-back (segment_max.cu).
//
// Replaces: the VJPs that JAX derives for tdvnet/models/pointnet.py
// `_segmax` (:19-22, `jax.ops.segment_max` and the masking around it at
// :51, :56) and for the gather-back, concatenate and ReLU (:53-55,
// `pooled.at[point2anchor].get`).
//
// Math, pool: d y[p, c] = d pooled[s, c] / n[s, c] where row p is valid and
// y[p, c] equals its segment s's maximum, n[s, c] the number of such tied
// rows (JAX's scatter-max JVP and torch's `scatter_reduce("amax")` both
// split the gradient evenly over ties); 0 elsewhere. A valid row never
// equals the 0 that an empty segment (or one whose maximum is at or below
// -5e29) reads, so those segments pass nothing on.
// Math, concat-back: out = relu(cat([y, pooled[seg]])), so with
// g' = g where out > 0 (else 0), d y = g'[:, :C] and d pooled[s] =
// sum over the rows p of segment s of g'[p, C:].
//
// Bound on an H100: bytes. Pool: reads y, seg, valid, pooled[seg] and
// d pooled[seg], writes d y ([P, C] each; at the train step P = 43904,
// C = 128: ~68 MB, 20 us); the tie counts are an int scratch of
// [n_seg, C]. Concat-back: reads g [P, 2C], y, pooled[seg], writes d y and
// the touched rows of d pooled.
//
// Design: points arrive in input order (no sort: VoxelGrid.order is None on
// the card), one thread per (point, 4 channels) in both kernels.
//   pool     a first pass counts ties per (segment, channel) with integer
//            atomics (exact, order-free); a second writes each row's share
//            with an IEEE division, so the result is deterministic and
//            bit-equal to the twin;
//   concat   the y half is a masked copy; the pooled half is a segment sum
//            into d pooled by one 16-byte vector reduction
//            (`red.global.add.v4.f32`) per thread. Atomics rather than a
//            per-anchor gather over a CSR of K3's ranks: a CSR needs a
//            count, a prefix sum and a fill over the points (three more
//            passes and an index array) to replace adds that meet few
//            others (at the train step ~3 points per occupied anchor), so
//            it would cost more than the contention it avoids. The sum
//            order of a segment's few rows changes from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void segment_max_backward_count_kernel(
    const float* __restrict__ y, const long long* __restrict__ seg,
    const uint8_t* __restrict__ valid, const float* __restrict__ pooled,
    int* __restrict__ ties, long long P, int C, long long n_seg) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * cq) return;
  const long long p = t / cq;
  const int q = (int)(t % cq);
  if (!valid[p]) return;
  const long long s = seg[p];
  if (s < 0 || s >= n_seg) return;
  const float4 v = reinterpret_cast<const float4*>(y + p * C)[q];
  const float4 m = __ldg(reinterpret_cast<const float4*>(pooled + s * C) + q);
  int* n = ties + s * C + 4 * q;
  if (v.x == m.x) atomicAdd(n + 0, 1);
  if (v.y == m.y) atomicAdd(n + 1, 1);
  if (v.z == m.z) atomicAdd(n + 2, 1);
  if (v.w == m.w) atomicAdd(n + 3, 1);
}

__device__ __forceinline__ float share(float y, float m, float g, int n) {
  return y == m ? g / (float)n : 0.f;
}

__global__ void segment_max_backward_kernel(
    const float* __restrict__ grad, const float* __restrict__ y,
    const long long* __restrict__ seg, const uint8_t* __restrict__ valid,
    const float* __restrict__ pooled, const int* __restrict__ ties,
    float* __restrict__ grad_y, long long P, int C, long long n_seg) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * cq) return;
  const long long p = t / cq;
  const int q = (int)(t % cq);
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long s = seg[p];
  if (valid[p] && s >= 0 && s < n_seg) {
    const float4 v = reinterpret_cast<const float4*>(y + p * C)[q];
    const float4 m =
        __ldg(reinterpret_cast<const float4*>(pooled + s * C) + q);
    const float4 g = __ldg(reinterpret_cast<const float4*>(grad + s * C) + q);
    const int4 n = __ldg(reinterpret_cast<const int4*>(ties + s * C) + q);
    out.x = share(v.x, m.x, g.x, n.x);
    out.y = share(v.y, m.y, g.y, n.y);
    out.z = share(v.z, m.z, g.z, n.z);
    out.w = share(v.w, m.w, g.w, n.w);
  }
  reinterpret_cast<float4*>(grad_y + p * C)[q] = out;
}

__device__ __forceinline__ float pass(float g, float v, int relu) {
  return (!relu || v > 0.f) ? g : 0.f;
}

__global__ void segment_max_backward_concat_kernel(
    const float* __restrict__ grad, const float* __restrict__ y,
    const float* __restrict__ pooled, const long long* __restrict__ seg,
    float* __restrict__ grad_y, float* __restrict__ grad_pooled, long long P,
    int C, long long n_seg, int relu) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * cq) return;
  const long long p = t / cq;
  const int q = (int)(t % cq);
  const float4* g = reinterpret_cast<const float4*>(grad + p * 2 * C);
  const float4 gy = g[q], gp = g[cq + q];
  const float4 v = reinterpret_cast<const float4*>(y + p * C)[q];
  reinterpret_cast<float4*>(grad_y + p * C)[q] =
      make_float4(pass(gy.x, v.x, relu), pass(gy.y, v.y, relu),
                  pass(gy.z, v.z, relu), pass(gy.w, v.w, relu));
  long long s = seg[p];        // the forward's clamp
  s = s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
  const float4 m = __ldg(reinterpret_cast<const float4*>(pooled + s * C) + q);
  red_add4(reinterpret_cast<float4*>(grad_pooled + s * C) + q,
           make_float4(pass(gp.x, m.x, relu), pass(gp.y, m.y, relu),
                       pass(gp.z, m.z, relu), pass(gp.w, m.w, relu)));
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// grad, pooled [n_seg, C]; y, grad_y [P, C]; ties [n_seg, C] int32 scratch
// (zeroed here); C % 4 == 0.
extern "C" int tdv_segment_max_backward(
    const float* grad, const float* y, const long long* seg,
    const uint8_t* valid, const float* pooled, int* ties, float* grad_y,
    long long P, int C, long long n_seg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = P * (C / 4);
  if (total == 0) return 0;
  cudaError_t err =
      cudaMemsetAsync(ties, 0, sizeof(int) * (size_t)n_seg * C, s);
  if (err != cudaSuccess) return (int)err;
  segment_max_backward_count_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      y, seg, valid, pooled, ties, P, C, n_seg);
  segment_max_backward_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      grad, y, seg, valid, pooled, ties, grad_y, P, C, n_seg);
  return (int)cudaGetLastError();
}

// grad [P, 2C]; y, grad_y [P, C]; pooled, grad_pooled [n_seg, C] (the
// latter zeroed here); C % 4 == 0.
extern "C" int tdv_gather_concat_backward(
    const float* grad, const float* y, const float* pooled,
    const long long* seg, float* grad_y, float* grad_pooled, long long P,
    int C, long long n_seg, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(grad_pooled, 0,
                                    sizeof(float) * (size_t)n_seg * C, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = P * (C / 4);
  if (total == 0) return 0;
  segment_max_backward_concat_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      grad, y, pooled, seg, grad_y, grad_pooled, P, C, n_seg, relu);
  return (int)cudaGetLastError();
}
