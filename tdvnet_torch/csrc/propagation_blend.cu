// propagation_blend: softmax over 9 neighbour logits times the
// edge-replicated 3x3 depth neighbourhood, per pixel.
//
// Replaces: the Pallas kernel `propagation_blend` of the JAX package's
// round 1 (tdvnet/kernels/depthops_pallas.py:67-100 before commit 2df7997,
// `pallas_call` at :91) and its XLA form on today's main path,
// tdvnet/models/upsampling.py `unfold3x3` + softmax blend (:17-27, :44-45).
//
// Bound on an H100: bytes. Per pixel it reads 9 logits and 1 depth (the
// 3x3 neighbourhood re-reads hit L1/L2) and writes 1 depth: 44 bytes for
// ~40 flops.
//
// Design: one thread per pixel; neighbouring threads take neighbouring x,
// so every logit plane and the depth rows are read coalesced. The logits
// come in with explicit element strides (n, y, x, k): the caller hands the
// NCHW output of its last convolution as an [N, H, W, 9] view without a
// copy. The unfolded neighbourhood is never materialised: the edge
// replication is a clamp of the neighbour's row and column.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void propagation_blend_kernel(
    const float* __restrict__ logits,  // [N, H, W, 9] with strides below
    const float* __restrict__ depth,   // [N, H, W] contiguous
    float* __restrict__ out,           // [N, H, W] contiguous
    int N, int H, int W, long long sn, long long sh, long long sw,
    long long sk) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * H * W) return;
  const int x = (int)(t % W);
  const int y = (int)((t / W) % H);
  const long long n = t / ((long long)W * H);
  const float* L = logits + n * sn + y * sh + x * sw;
  float l[9];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    l[k] = L[k * sk];
    m = fmaxf(m, l[k]);
  }
  const float* D = depth + n * H * W;
  float den = 0.f, acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = min(max(y + dy - 1, 0), H - 1);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = min(max(x + dx - 1, 0), W - 1);
      const float e = expf(l[3 * dy + dx] - m);
      den += e;
      acc = fmaf(e, D[(long long)yy * W + xx], acc);
    }
  }
  out[t] = acc / den;
}

}  // namespace

extern "C" int tdv_propagation_blend(const float* logits, const float* depth,
                                     float* out, int N, int H, int W,
                                     long long sn, long long sh, long long sw,
                                     long long sk, void* stream) {
  const long long total = (long long)N * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  propagation_blend_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(logits, depth, out, N, H,
                                                     W, sn, sh, sw, sk);
  return (int)cudaGetLastError();
}
