// masked_group_norm_backward: the gradients of the masked GroupNorm with
// its fused tails (masked_group_norm.cu) for x, weight, bias and skip.
//
// Replaces: the VJP that JAX derives for tdvnet/models/layers.py
// `masked_group_norm` (:106-144) with the scene U-Net's tails around it
// (tdvnet/models/scene_unet.py: `relu(gn) * mask`, `relu(gn + skip) *
// mask`).
//
// Math, per (b, g) with the forward's mean, rstd = rsqrt(max(var, 0) + eps)
// and count n (its `stats`), xn = (x - mean) * rstd, the mask m in {0, 1}:
//   g'  = g * m                      (mode 0: y = (xn w + b) m)
//       = g * m * [out > 0]          (modes 1, 2: the ReLU, seen in the
//                                     forward's output)
//   d skip = g'; d bias[c] = sum_{b, v} g'; d weight[c] = sum_{b, v} g' xn
//   A = sum_{c in g, v} w[c] g', Bx = sum_{c in g, v} w[c] g' xn
//   d x = rstd (w[c] g' - m (A + xn Bx [var >= 0]) / n)
// (the mean and variance take their gradient from the active voxels only;
// the clamp at 0 passes none below it).
//
// Bound on an H100: bytes. g, x, the output and the mask are read (twice:
// the reductions, then the apply), d x and d skip written; at the finest
// U-Net level [2, 64, 64^3] that is ~270 MB per call in the contract's
// count (each input once, each output once), ~80 us.
//
// Design, NCDHW as the forward:
//   reduce    grid (chunks of V, B*C): a block sums g' and g' xn over its
//             chunk of one channel; partials go to a [B*C, chunks, 2]
//             scratch;
//   channel   one warp per (b, c) adds the partials in a fixed order;
//   finalize  one block: per channel d weight, d bias over b; per (b, g)
//             A / n and Bx [var >= 0] / n over the group's channels, in a
//             fixed order (no float atomics: repeatable run to run);
//   apply     one thread per 4 voxels of a channel (16-byte accesses) when
//             V % 4 == 0, else per voxel: d x and, in mode 2, d skip.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

// g' of one element: the gradient reaching (xn w + b)
__device__ __forceinline__ float gprime(float g, float m, float out,
                                        int mode) {
  const float gm = g * m;
  return (mode == 0 || out > 0.f) ? gm : 0.f;
}

__global__ void masked_group_norm_backward_reduce_kernel(
    const float* __restrict__ grad, const float* __restrict__ x,
    const float* __restrict__ mask, const float* __restrict__ out,
    const float* __restrict__ stats, float* __restrict__ partial, int C,
    int G, long long V, int chunk, int n_chunks, int mode) {
  __shared__ float smem[2][kThreads / 32];
  const int bc = blockIdx.y;
  const int b = bc / C, c = bc % C;
  const int bg = b * G + c / (C / G);
  const float mean = stats[bg * 4], rstd = stats[bg * 4 + 1];
  const long long v0 = (long long)blockIdx.x * chunk;
  const long long v1 = v0 + chunk < V ? v0 + chunk : V;
  const long long row = (long long)bc * V;
  const float* m = mask + (long long)b * V;
  float sg = 0.f, sgx = 0.f;
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
    const float gp = gprime(grad[row + v], m[v], out[row + v], mode);
    sg += gp;
    sgx += gp * ((x[row + v] - mean) * rstd);
  }
  sg = warp_sum(sg);
  sgx = warp_sum(sgx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smem[0][warp] = sg;
    smem[1][warp] = sgx;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += smem[threadIdx.x][w];
    partial[((long long)bc * n_chunks + blockIdx.x) * 2 + threadIdx.x] = t;
  }
}

// one warp per (b, c): chan[bc] = (sum g', sum g' xn)
__global__ void masked_group_norm_backward_channel_kernel(
    const float* __restrict__ partial, float* __restrict__ chan,
    int n_chunks) {
  const int bc = blockIdx.x;
  const int lane = threadIdx.x;
  float sg = 0.f, sgx = 0.f;
  for (int i = lane; i < n_chunks; i += 32) {
    const float* p = partial + ((long long)bc * n_chunks + i) * 2;
    sg += p[0];
    sgx += p[1];
  }
  sg = warp_sum(sg);
  sgx = warp_sum(sgx);
  if (lane == 0) {
    chan[bc * 2 + 0] = sg;
    chan[bc * 2 + 1] = sgx;
  }
}

// one block: d weight and d bias per channel; per (b, g) the coefficients
// coef[bg] = (A / n, Bx [var >= 0] / n) of the apply
__global__ void masked_group_norm_backward_finalize_kernel(
    const float* __restrict__ chan, const float* __restrict__ weight,
    const float* __restrict__ stats, float* __restrict__ grad_w,
    float* __restrict__ grad_b, float* __restrict__ coef, int B, int C,
    int G) {
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int b = 0; b < B; ++b) {
      sb += chan[(b * C + c) * 2 + 0];
      sw += chan[(b * C + c) * 2 + 1];
    }
    grad_w[c] = sw;
    grad_b[c] = sb;
  }
  for (int bg = threadIdx.x; bg < B * G; bg += blockDim.x) {
    const int b = bg / G, g = bg % G;
    float a = 0.f, bx = 0.f;
    for (int k = 0; k < cg; ++k) {
      const int c = g * cg + k;
      a += weight[c] * chan[(b * C + c) * 2 + 0];
      bx += weight[c] * chan[(b * C + c) * 2 + 1];
    }
    const float n = stats[bg * 4 + 2];
    coef[bg * 2 + 0] = a / n;
    coef[bg * 2 + 1] = stats[bg * 4 + 3] != 0.f ? bx / n : 0.f;
  }
}

__device__ __forceinline__ void apply_one(float g, float x, float m,
                                          float out, float mean, float rstd,
                                          float w, float a, float bx,
                                          int mode, float& dx, float& ds) {
  const float gp = gprime(g, m, out, mode);
  const float xn = (x - mean) * rstd;
  dx = rstd * (w * gp - m * (a + xn * bx));
  ds = gp;
}

template <int VEC>
__global__ void masked_group_norm_backward_apply_kernel(
    const float* __restrict__ grad, const float* __restrict__ x,
    const float* __restrict__ mask, const float* __restrict__ out,
    const float* __restrict__ weight, const float* __restrict__ stats,
    const float* __restrict__ coef, float* __restrict__ grad_x,
    float* __restrict__ grad_skip, int B, int C, int G, long long V,
    int mode) {
  const long long vq = V / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * C * vq) return;
  const long long v = (t % vq) * VEC;
  const long long bc = t / vq;
  const int c = (int)(bc % C), b = (int)(bc / C);
  const int bg = b * G + c / (C / G);
  const float mean = stats[bg * 4], rstd = stats[bg * 4 + 1];
  const float a = coef[bg * 2], bx = coef[bg * 2 + 1];
  const float w = weight[c];
  const long long xi = bc * V + v, mi = (long long)b * V + v;
  if (VEC == 4) {
    const float4 gv = *reinterpret_cast<const float4*>(grad + xi);
    const float4 xv = *reinterpret_cast<const float4*>(x + xi);
    const float4 mv = *reinterpret_cast<const float4*>(mask + mi);
    const float4 ov = *reinterpret_cast<const float4*>(out + xi);
    float4 dx, ds;
    apply_one(gv.x, xv.x, mv.x, ov.x, mean, rstd, w, a, bx, mode, dx.x, ds.x);
    apply_one(gv.y, xv.y, mv.y, ov.y, mean, rstd, w, a, bx, mode, dx.y, ds.y);
    apply_one(gv.z, xv.z, mv.z, ov.z, mean, rstd, w, a, bx, mode, dx.z, ds.z);
    apply_one(gv.w, xv.w, mv.w, ov.w, mean, rstd, w, a, bx, mode, dx.w, ds.w);
    *reinterpret_cast<float4*>(grad_x + xi) = dx;
    if (mode == 2) *reinterpret_cast<float4*>(grad_skip + xi) = ds;
  } else {
    float dx, ds;
    apply_one(grad[xi], x[xi], mask[mi], out[xi], mean, rstd, w, a, bx, mode,
              dx, ds);
    grad_x[xi] = dx;
    if (mode == 2) grad_skip[xi] = ds;
  }
}

}  // namespace

// grad, x, out, grad_x, grad_skip [B, C, V]; mask [B, V]; stats [B*G, 4]
// from the forward; partial [B*C, n_chunks, 2], chan [B*C, 2] and coef
// [B*G, 2] scratch; n_chunks = ceil(V / chunk). grad_skip is written only
// in mode 2.
extern "C" int tdv_masked_group_norm_backward(
    const float* grad, const float* x, const float* mask, const float* out,
    const float* weight, const float* stats, float* grad_x, float* grad_w,
    float* grad_b, float* grad_skip, float* partial, float* chan,
    float* coef, int B, int C, int G, long long V, int mode, int chunk,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * C * V == 0) return 0;
  const int n_chunks = (int)((V + chunk - 1) / chunk);
  masked_group_norm_backward_reduce_kernel<<<dim3(n_chunks, B * C), kThreads,
                                             0, s>>>(
      grad, x, mask, out, stats, partial, C, G, V, chunk, n_chunks, mode);
  masked_group_norm_backward_channel_kernel<<<B * C, 32, 0, s>>>(
      partial, chan, n_chunks);
  masked_group_norm_backward_finalize_kernel<<<1, kThreads, 0, s>>>(
      chan, weight, stats, grad_w, grad_b, coef, B, C, G);
  if (V % 4 == 0) {
    const long long total = (long long)B * C * (V / 4);
    masked_group_norm_backward_apply_kernel<4>
        <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            grad, x, mask, out, weight, stats, coef, grad_x, grad_skip, B, C,
            G, V, mode);
  } else {
    const long long total = (long long)B * C * V;
    masked_group_norm_backward_apply_kernel<1>
        <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            grad, x, mask, out, weight, stats, coef, grad_x, grad_skip, B, C,
            G, V, mode);
  }
  return (int)cudaGetLastError();
}
