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
// Design: one thread per pixel, looping over the D planes twice (max, then
// exp-sum and weighted sum). Neighbouring threads take neighbouring pixels,
// so each plane is read coalesced; the second pass finds the volume in L2.
// Nothing of the [R, D, h, w] softmax is written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void softargmax_depth_kernel(const float* __restrict__ cost,
                                        const float* __restrict__ dvals,
                                        float* __restrict__ out, int R, int D,
                                        long long HW) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)R * HW) return;
  const long long r = t / HW;
  const long long p = t % HW;
  const float* c = cost + r * D * HW + p;
  float m = -INFINITY;
  for (int d = 0; d < D; ++d) m = fmaxf(m, -c[d * HW]);
  float den = 0.f, num = 0.f;
  for (int d = 0; d < D; ++d) {
    const float e = expf(-c[d * HW] - m);
    den += e;
    num = fmaf(e, dvals[d], num);
  }
  out[t] = num / den;
}

}  // namespace

extern "C" int tdv_softargmax_depth(const float* cost, const float* dvals,
                                    float* out, int R, int D, long long HW,
                                    void* stream) {
  const long long total = (long long)R * HW;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  softargmax_depth_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(cost, dvals, out, R, D,
                                                    HW);
  return (int)cudaGetLastError();
}
