// masked_group_norm: GroupNorm whose statistics run over the active voxels
// only, with the affine, the mask and the U-Net's ReLU / residual tail in
// the same pass.
//
// Replaces: tdvnet/models/layers.py `masked_group_norm` (:106-144) and the
// elementwise tails around it in tdvnet/models/scene_unet.py
// (`relu(gn) * mask`, `relu(gn + skip) * mask`). On the TPU these are about
// ten XLA elementwise and reduction ops that the compiler fuses; in eager
// PyTorch each is a pass over the [B, C, V] volume.
//
// Bound on an H100: bytes. The volume is read twice (statistics, then
// apply) and written once; the skip, where there is one, is read once; the
// mask is V floats per batch element. About 6 flops per element.
//
// Design, NCDHW so that a channel is contiguous over the V voxels:
//   stats     grid (chunks of V, B*G): a block sums x*m, x*x*m and m over
//             its chunk for the group's channels in float64, mask read once
//             per voxel; block partials go to a [B*G, chunks, 3] float64
//             scratch. The reference's one-pass formula (below) loses up to
//             ~1e-3 of the variance in fp32 where a group's mean is large
//             against its spread, and the scene stages' gradients with it;
//             float64 sums keep it exact to fp32 at no extra pass (the
//             kernel is bound by its fp32 reads, not by the adds);
//   finalize  one warp per (b, g) adds the partials in a fixed order (the
//             result repeats from run to run; no float atomics), then in
//             float64 count = sum(m) * C/G clamped to 1, mean = s1 / count,
//             var = s2 / count - mean^2 clamped at 0, rstd = 1 / sqrt(var +
//             eps), each rounded once to fp32;
//             stats[b, g] = (mean, rstd, count, 1 if var >= 0 else 0),
//             which masked_group_norm_backward.cu reads;
//   apply     one thread per 4 voxels of a channel (16-byte accesses) when
//             V is a multiple of 4, else per voxel:
//             y = ((x - mean) * rstd * w[c] + b[c]) * m, then by mode
//             0: y   1: relu(y) * m   2: relu(y + skip) * m.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

__global__ void masked_group_norm_stats_kernel(
    const float* __restrict__ x, const float* __restrict__ mask,
    double* __restrict__ partial, int C, int G, long long V, int chunk,
    int n_chunks) {
  __shared__ double smem[3][kThreads / 32];
  const int cg = C / G;
  const int b = blockIdx.y / G, g = blockIdx.y % G;
  const long long v0 = (long long)blockIdx.x * chunk;
  const long long v1 = v0 + chunk < V ? v0 + chunk : V;
  const float* m = mask + (long long)b * V;
  const float* xg = x + ((long long)b * C + (long long)g * cg) * V;
  double s1 = 0.0, s2 = 0.0, cnt = 0.0;
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
    const double mv = m[v];
    cnt += mv;
    for (int c = 0; c < cg; ++c) {
      const double xv = xg[(long long)c * V + v];
      s1 += xv * mv;
      s2 += xv * xv * mv;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  cnt = warp_sum(cnt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smem[0][warp] = s1;
    smem[1][warp] = s2;
    smem[2][warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += smem[threadIdx.x][w];
    partial[((long long)blockIdx.y * n_chunks + blockIdx.x) * 3 +
            threadIdx.x] = t;
  }
}

// one warp per (b, g): stats[bg] = (mean, rstd, count, var >= 0)
__global__ void masked_group_norm_finalize_kernel(
    const double* __restrict__ partial, float* __restrict__ stats, int C,
    int G, int n_chunks, float eps) {
  const int bg = blockIdx.x;
  const int lane = threadIdx.x;
  double s1 = 0.0, s2 = 0.0, cnt = 0.0;
  for (int i = lane; i < n_chunks; i += 32) {
    const double* p = partial + ((long long)bg * n_chunks + i) * 3;
    s1 += p[0];
    s2 += p[1];
    cnt += p[2];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    const double n = fmax(cnt * (double)(C / G), 1.0);
    const double mean = s1 / n;
    const double var = s2 / n - mean * mean;
    stats[bg * 4 + 0] = (float)mean;
    stats[bg * 4 + 1] = (float)(1.0 / sqrt(fmax(var, 0.0) + (double)eps));
    stats[bg * 4 + 2] = (float)n;
    stats[bg * 4 + 3] = var >= 0.0 ? 1.f : 0.f;
  }
}

__device__ __forceinline__ float apply_one(float x, float mean, float rstd,
                                           float w, float b, float m,
                                           float skip, int mode) {
  float y = ((x - mean) * rstd * w + b) * m;
  if (mode == 1) y = (y < 0.f ? 0.f : y) * m;
  if (mode == 2) {
    y += skip;
    y = (y < 0.f ? 0.f : y) * m;
  }
  return y;
}

template <int VEC>
__global__ void masked_group_norm_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ stats, const float* __restrict__ skip,
    float* __restrict__ out, int B, int C, int G, long long V, int mode) {
  const long long vq = V / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * C * vq) return;
  const long long v = (t % vq) * VEC;
  const long long bc = t / vq;
  const int c = (int)(bc % C), b = (int)(bc / C);
  const int bg = b * G + c / (C / G);
  const float mean = stats[bg * 4], rstd = stats[bg * 4 + 1];
  const float w = weight[c], bi = bias[c];
  const long long xi = bc * V + v, mi = (long long)b * V + v;
  if (VEC == 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + xi);
    const float4 mv = *reinterpret_cast<const float4*>(mask + mi);
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mode == 2) sv = *reinterpret_cast<const float4*>(skip + xi);
    float4 y;
    y.x = apply_one(xv.x, mean, rstd, w, bi, mv.x, sv.x, mode);
    y.y = apply_one(xv.y, mean, rstd, w, bi, mv.y, sv.y, mode);
    y.z = apply_one(xv.z, mean, rstd, w, bi, mv.z, sv.z, mode);
    y.w = apply_one(xv.w, mean, rstd, w, bi, mv.w, sv.w, mode);
    *reinterpret_cast<float4*>(out + xi) = y;
  } else {
    out[xi] = apply_one(x[xi], mean, rstd, w, bi, mask[mi],
                        mode == 2 ? skip[xi] : 0.f, mode);
  }
}

}  // namespace

// x, out, skip [B, C, V]; mask [B, V]; partial [B*G, n_chunks, 3] float64;
// stats [B*G, 4]; n_chunks = ceil(V / chunk). skip is read only in mode 2.
extern "C" int tdv_masked_group_norm(
    const float* x, const float* mask, const float* weight,
    const float* bias, const float* skip, float* out, double* partial,
    float* stats, int B, int C, int G, long long V, float eps, int mode,
    int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * C * V == 0) return 0;
  const int n_chunks = (int)((V + chunk - 1) / chunk);
  masked_group_norm_stats_kernel<<<dim3(n_chunks, B * G), kThreads, 0, s>>>(
      x, mask, partial, C, G, V, chunk, n_chunks);
  masked_group_norm_finalize_kernel<<<B * G, 32, 0, s>>>(partial, stats, C,
                                                         G, n_chunks, eps);
  if (V % 4 == 0) {
    const long long total = (long long)B * C * (V / 4);
    masked_group_norm_apply_kernel<4>
        <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            x, mask, weight, bias, stats, skip, out, B, C, G, V, mode);
  } else {
    const long long total = (long long)B * C * V;
    masked_group_norm_apply_kernel<1>
        <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            x, mask, weight, bias, stats, skip, out, B, C, G, V, mode);
  }
  return (int)cudaGetLastError();
}
