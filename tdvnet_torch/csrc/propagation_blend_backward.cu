// propagation_blend_backward: the gradients of the learned 3x3 neighbour
// blend (propagation_blend.cu) with respect to its logits and its depth.
//
// Replaces: the VJP that JAX derives for the blend tail of
// tdvnet/models/upsampling.py `PropagationNet` (:44-45) through the
// edge-replicated `unfold3x3` (:17-28), the XLA form of the round-1 Pallas
// kernel `propagation_blend` (tdvnet/kernels/depthops_pallas.py:67-100
// before commit 2df7997).
//
// Math: out = sum_k w_k u_k with w = softmax(logits) and u_k the depth at
// the edge-clamped neighbour k, so d out / d logit_k = w_k (u_k - out), and
// each depth pixel receives g * w_k from every (pixel, k) whose clamped
// neighbour it is: up to 9 pairs inside the map, more at the borders,
// where several taps of one pixel clamp onto the same source pixel.
//
// Bound on an H100: bytes. Per pixel it reads 9 logits, the depth, the
// output and its gradient and writes 9 logit gradients and one depth
// gradient (~85 MB at 256 x 320 x 14, ~25 us at 3.35 TB/s).
//
// Design: two passes, in gather form so that the depth gradient is summed
// in a fixed order (deterministic, no atomics). Pass 1, one thread per
// pixel: the softmax, the logit gradients (written through the logits'
// own strides, so that the permuted view the caller handed in gets back a
// gradient of its layout) and g * w_k into a [N, 9, H, W] scratch. Pass 2,
// one thread per depth pixel: the sum of the scratch over the (pixel, k)
// pairs whose clamped neighbour it is, found from the clamp rule per axis
// (at most three (row, dy) pairs and three (column, dx) pairs).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void propagation_blend_backward_logits_kernel(
    const float* __restrict__ grad,    // [N, H, W] d loss / d out
    const float* __restrict__ logits,  // [N, H, W, 9] with strides below
    const float* __restrict__ depth,   // [N, H, W]
    const float* __restrict__ out,     // [N, H, W] the forward's output
    float* __restrict__ grad_logits,   // [N, H, W, 9] with strides below
    float* __restrict__ gw,            // [N, 9, H, W] scratch
    int N, int H, int W, long long sn, long long sh, long long sw,
    long long sk, long long gn, long long gh, long long gwx, long long gk) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long HW = (long long)H * W;
  if (t >= (long long)N * HW) return;
  const int x = (int)(t % W);
  const int y = (int)((t / W) % H);
  const long long n = t / HW;
  const float* L = logits + n * sn + y * sh + x * sw;
  float l[9];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    l[k] = L[k * sk];
    m = fmaxf(m, l[k]);
  }
  float e[9];
  float den = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    e[k] = expf(l[k] - m);
    den += e[k];
  }
  const float g = grad[t];
  const float o = out[t];
  const float* D = depth + n * HW;
  float* GL = grad_logits + n * gn + y * gh + x * gwx;
  float* S = gw + n * 9 * HW + (long long)y * W + x;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = min(max(y + dy - 1, 0), H - 1);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = min(max(x + dx - 1, 0), W - 1);
      const int k = 3 * dy + dx;
      const float w = e[k] / den;
      GL[k * gk] = g * w * (D[(long long)yy * W + xx] - o);
      S[k * HW] = g * w;
    }
  }
}

// The (source row, tap row) pairs whose clamped neighbour row is `t` in a
// map of `n` rows; returns their count (at most 3).
__device__ __forceinline__ int clamp_preimage(int t, int n, int* src,
                                              int* tap) {
  int c = 0;
  for (int d = 0; d < 3; ++d) {
    const int s = t + 1 - d;          // s + d - 1 == t, inside the map
    if (s >= 0 && s < n) { src[c] = s; tap[c] = d; ++c; }
  }
  if (t == 0) { src[c] = 0; tap[c] = 0; ++c; }                 // clamped up
  if (t == n - 1) { src[c] = n - 1; tap[c] = 2; ++c; }         // clamped down
  return c;
}

__global__ void propagation_blend_backward_depth_kernel(
    const float* __restrict__ gw,  // [N, 9, H, W]
    float* __restrict__ grad_depth,  // [N, H, W]
    int N, int H, int W) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long HW = (long long)H * W;
  if (t >= (long long)N * HW) return;
  const int x = (int)(t % W);
  const int y = (int)((t / W) % H);
  const long long n = t / HW;
  int ys[3], dys[3], xs[3], dxs[3];
  const int ny = clamp_preimage(y, H, ys, dys);
  const int nx = clamp_preimage(x, W, xs, dxs);
  const float* S = gw + n * 9 * HW;
  float acc = 0.f;
  for (int i = 0; i < ny; ++i)
    for (int j = 0; j < nx; ++j)
      acc += S[(3 * dys[i] + dxs[j]) * HW + (long long)ys[i] * W + xs[j]];
  grad_depth[t] = acc;
}

}  // namespace

extern "C" int tdv_propagation_blend_backward(
    const float* grad, const float* logits, const float* depth,
    const float* out, float* grad_logits, float* gw, float* grad_depth, int N,
    int H, int W, long long sn, long long sh, long long sw, long long sk,
    long long gn, long long gh, long long gwx, long long gk, void* stream) {
  const long long total = (long long)N * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  propagation_blend_backward_logits_kernel<<<(unsigned)blocks, threads, 0,
                                             (cudaStream_t)stream>>>(
      grad, logits, depth, out, grad_logits, gw, N, H, W, sn, sh, sw, sk, gn,
      gh, gwx, gk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  propagation_blend_backward_depth_kernel<<<(unsigned)blocks, threads, 0,
                                            (cudaStream_t)stream>>>(
      gw, grad_depth, N, H, W);
  return (int)cudaGetLastError();
}
