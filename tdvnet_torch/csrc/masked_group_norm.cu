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
// Bound on an H100: bytes. The volume is read once and the output written
// once, the skip (where there is one) read once, the mask (V floats per
// batch element) read once; about 6 flops per element. The kernels read
// the volume twice (statistics, then apply): at the scene U-Net's levels
// and the batch's levels 1-2 the tensor fits in the 50 MB L2, so the
// second read comes from there; the batch's level 0 (134 MB) reads it from
// HBM twice.
//
// What held the first form of this kernel (a statistics grid of chunks of
// 4096 voxels x B*G, a finalize kernel, the apply) at 2.7x its bound over
// a batch and 8x over a scene (the profiler's kernel times in PERF.md
// section 6): its statistics grid scaled with the voxels alone (8 blocks
// at the scene's level 2, 24 at level 1, on a card of 132 SMs), and each
// thread walked its voxels and, inside, the group's channels one scalar
// load at a time into one float64 chain; statistics took 41-80% of a
// call's device time. The finalize was a launch of its own (1.6 us of one
// warp's work), and the apply divided 64-bit indices three times a
// thread.
//
// Design, NCDHW so that a channel is contiguous over the V voxels; two
// launches:
//   stats  a grid of (voxel blocks x channel chunks, B*G) blocks: a block
//          sums STATS_VOXELS voxels of one (b, g) slice over a chunk of
//          the group's C/G channels, the chunk halved (from C/G) until
//          the grid holds 4 blocks an SM (`stats_blocks` in
//          kernels/groupnorm.py), so that the coarse levels fill the card.
//          A thread takes 4 voxels (one float4), reads and widens their
//          mask once, then the chunk's channels, 4 float4 loads in flight
//          before their float64 adds: s1 += x m, s2 += x^2 m (exact
//          products for a mask in {0, 1}), and m over the voxels where the
//          chunk is the first (each voxel counts once). The reference's
//          one-pass formula loses up to ~1e-3 of the variance in fp32
//          where a group's mean is large against its spread, and the scene
//          stages' gradients with it; float64 sums keep it exact to fp32.
//          Each block writes its partial sums; the last block of a slice
//          to finish (a ticket taken after __threadfence, the tickets kept
//          zero between calls: the last block puts its own back) adds the
//          slice's partials in index order (the result repeats from run to
//          run; no float atomics), then in float64 count = sum(m) * C/G
//          clamped to 1, mean = s1 / count, var = s2 / count - mean^2
//          clamped at 0, rstd = 1 / sqrt(var + eps), each rounded once to
//          fp32; stats[b, g] = (mean, rstd, count, 1 if var >= 0 else 0),
//          which masked_group_norm_backward.cu reads;
//   apply  a grid of (voxel blocks, rows): one thread per 4 voxels of a
//          (b, c) row (16-byte accesses) when V is a multiple of 4, else
//          per voxel: y = ((x - mean) * rstd * w[c] + b[c]) * m, then by
//          mode 0: y   1: relu(y) * m   2: relu(y + skip) * m.
// A single cooperative launch (stats, grid barrier, apply) was not built:
// at levels 1-2 a kernel's fixed cost is ~1.6 us of a 6-12 us call, which
// is all that fusing the two would save.
//
// The bf16 form (tdv_masked_group_norm_bf16) reads a bf16
// x, mask and skip and writes a bf16 output, both kernels templated on the
// storage: the statistics are the same float64 sums of the (exactly
// widened) bf16 values; the apply rounds to bf16 where the JAX package's
// separate bf16 ops store (tdvnet/models/layers.py:126-144 and the U-Net's
// tails): xn = bf16((x - mean) * rstd), then bf16(xn * bf16(w)),
// bf16(+ bf16(b)), times the mask, and after a skip bf16(y + skip). Bound:
// bytes, at bf16 half the fp32 form's reads and writes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // vectors a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float lane_of(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(float v, int) { return v; }

// VEC consecutive elements from storage E (float, or bf16 widened)
template <int VEC, typename E> struct Load;
template <> struct Load<4, float> {
  static __device__ __forceinline__ float4 at(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};
template <> struct Load<1, float> {
  static __device__ __forceinline__ float at(const float* p) {
    return __ldg(p);
  }
};
template <> struct Load<4, bf16::bits16> {
  static __device__ __forceinline__ float4 at(const bf16::bits16* p) {
    return bf16::widen(__ldg(reinterpret_cast<const uint2*>(p)));
  }
};
template <> struct Load<1, bf16::bits16> {
  static __device__ __forceinline__ float at(const bf16::bits16* p) {
    return bf16::widen(__ldg(p));
  }
};

// grid (voxel blocks x channel chunks, B*G). A (b, g) slice is the group's
// C/G channels of batch element b, each V contiguous floats. Block
// (vb, cc) sums x m and x^2 m over voxels [vb * Vb, (vb + 1) * Vb) of the
// slice's channels [cc * CC, (cc + 1) * CC), and m over those voxels when
// cc == 0 (each voxel's mask counts once); a thread takes VEC voxels, reads
// and widens their mask once, then their CC channels, kUnroll loads in
// flight before the float64 adds (x m and x^2 m are exact for a mask in
// {0, 1}). The last block of a slice to finish (a ticket taken after
// __threadfence) adds the slice's partials in index order and writes its
// statistics, then puts the ticket back to 0 for the next call.
template <int VEC, typename E>
__global__ void __launch_bounds__(kThreads) masked_group_norm_stats_kernel(
    const E* __restrict__ x, const E* __restrict__ mask,
    double* __restrict__ partial, unsigned* __restrict__ tickets,
    float* __restrict__ stats, int C, int G, long long V, long long Vb,
    int CC, float eps) {
  using T = typename Vec<VEC>::T;
  __shared__ double smem[3][kThreads / 32];
  __shared__ bool last;
  const int cg = C / G;
  const int n_cc = cg / CC;
  const int bg = blockIdx.y, b = bg / G;
  const int vb = blockIdx.x / n_cc, cc = blockIdx.x - vb * n_cc;
  const long long v0 = vb * Vb;
  const long long v1 = v0 + Vb < V ? v0 + Vb : V;
  const E* xs = x + ((long long)bg * cg + (long long)cc * CC) * V;
  const E* m = mask + (long long)b * V;
  double s1 = 0.0, s2 = 0.0, cnt = 0.0;
  for (long long v = v0 + threadIdx.x * VEC; v < v1; v += VEC * kThreads) {
    const T mt = Load<VEC, E>::at(m + v);
    double md[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      md[j] = (double)lane_of(mt, j);
      if (cc == 0) cnt += md[j];
    }
    for (int c = 0; c < CC; c += kUnroll) {
      T xv[kUnroll];
      // the round's loads first, then its float64 adds
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c + u < CC)
          xv[u] = Load<VEC, E>::at(xs + (c + u) * V + v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u < CC) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const double xd = (double)lane_of(xv[u], j);
            const double xm = xd * md[j];
            s1 += xm;
            s2 = fma(xd, xm, s2);
          }
        }
      }
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
  const int n_blk = gridDim.x;
  if (threadIdx.x < 3) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += smem[threadIdx.x][w];
    partial[((long long)bg * n_blk + blockIdx.x) * 3 + threadIdx.x] = t;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + bg, 1u) == (unsigned)(n_blk - 1);
  __syncthreads();
  if (!last || warp != 0) return;
  // the slice's partials in index order, as one warp: the result repeats
  // from run to run whichever block came last
  __threadfence();
  s1 = s2 = cnt = 0.0;
  for (int i = lane; i < n_blk; i += 32) {
    const double* p = partial + ((long long)bg * n_blk + i) * 3;
    s1 += __ldcg(p);
    s2 += __ldcg(p + 1);
    cnt += __ldcg(p + 2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    const double n = fmax(cnt * (double)cg, 1.0);
    const double mean = s1 / n;
    const double var = s2 / n - mean * mean;
    stats[bg * 4 + 0] = (float)mean;
    stats[bg * 4 + 1] = (float)(1.0 / sqrt(fmax(var, 0.0) + (double)eps));
    stats[bg * 4 + 2] = (float)n;
    stats[bg * 4 + 3] = var >= 0.0 ? 1.f : 0.f;
    tickets[bg] = 0u;
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

// the bf16 form's tail: w and b arrive rounded to bf16; a bf16 store after
// each of the JAX package's bf16 ops (the mask is 0 or 1: exact)
__device__ __forceinline__ float apply_one_bf16(float x, float mean,
                                                float rstd, float w, float b,
                                                float m, float skip,
                                                int mode) {
  const float xn = bf16::round((x - mean) * rstd);
  float y = bf16::round(bf16::round(xn * w) + b) * m;
  if (mode == 1) y = (y < 0.f ? 0.f : y) * m;
  if (mode == 2) {
    y = bf16::round(y + skip);
    y = (y < 0.f ? 0.f : y) * m;
  }
  return y;
}

template <typename E>
__device__ __forceinline__ float apply_as(float x, float mean, float rstd,
                                          float w, float b, float m,
                                          float skip, int mode) {
  if constexpr (sizeof(E) == 2)
    return apply_one_bf16(x, mean, rstd, w, b, m, skip, mode);
  else
    return apply_one(x, mean, rstd, w, b, m, skip, mode);
}

__device__ __forceinline__ void store4(float* p, float4 y) {
  *reinterpret_cast<float4*>(p) = y;
}
__device__ __forceinline__ void store4(bf16::bits16* p, float4 y) {
  *reinterpret_cast<uint2*>(p) = bf16::narrow(y);
}
__device__ __forceinline__ void store1(float* p, float y) { *p = y; }
__device__ __forceinline__ void store1(bf16::bits16* p, float y) {
  *p = bf16::narrow(y);
}

// grid (vectors of a channel row / kThreads, rows): one thread per VEC
// voxels of one (b, c) row, rows strided by gridDim.y
template <int VEC, typename E>
__global__ void __launch_bounds__(kThreads) masked_group_norm_apply_kernel(
    const E* __restrict__ x, const E* __restrict__ mask,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ stats, const E* __restrict__ skip,
    E* __restrict__ out, int B, int C, int G, long long V, int mode) {
  const long long v = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (v >= V) return;
  const int cg = C / G;
  for (int bc = blockIdx.y; bc < B * C; bc += gridDim.y) {
    const int b = bc / C, c = bc - b * C;
    const int bg = b * G + c / cg;
    const float mean = stats[bg * 4], rstd = stats[bg * 4 + 1];
    float w = weight[c], bi = bias[c];
    if constexpr (sizeof(E) == 2) {
      w = bf16::round(w);
      bi = bf16::round(bi);
    }
    const long long xi = (long long)bc * V + v, mi = (long long)b * V + v;
    if constexpr (VEC == 4) {
      const float4 xv = Load<4, E>::at(x + xi);
      const float4 mv = Load<4, E>::at(mask + mi);
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mode == 2) sv = Load<4, E>::at(skip + xi);
      float4 y;
      y.x = apply_as<E>(xv.x, mean, rstd, w, bi, mv.x, sv.x, mode);
      y.y = apply_as<E>(xv.y, mean, rstd, w, bi, mv.y, sv.y, mode);
      y.z = apply_as<E>(xv.z, mean, rstd, w, bi, mv.z, sv.z, mode);
      y.w = apply_as<E>(xv.w, mean, rstd, w, bi, mv.w, sv.w, mode);
      store4(out + xi, y);
    } else {
      store1(out + xi,
             apply_as<E>(Load<1, E>::at(x + xi), mean, rstd, w, bi,
                         Load<1, E>::at(mask + mi),
                         mode == 2 ? Load<1, E>::at(skip + xi) : 0.f, mode));
    }
  }
}

// the two launches: statistics, then the apply
template <int VEC, typename E>
void launch(const E* x, const E* mask, const float* weight,
            const float* bias, const E* skip, E* out,
            double* partial, unsigned* tickets, float* stats, int B, int C,
            int G, long long V, float eps, int mode, long long Vb, int CC,
            cudaStream_t s) {
  const unsigned n_blk =
      (unsigned)((V + Vb - 1) / Vb) * (unsigned)(C / G / CC);
  masked_group_norm_stats_kernel<VEC, E>
      <<<dim3(n_blk, B * G), kThreads, 0, s>>>(
          x, mask, partial, tickets, stats, C, G, V, Vb, CC, eps);
  const unsigned rows = B * C < 65535 ? B * C : 65535;
  const long long blocks = (V / VEC + kThreads - 1) / kThreads;
  masked_group_norm_apply_kernel<VEC, E>
      <<<dim3((unsigned)blocks, rows), kThreads, 0, s>>>(
          x, mask, weight, bias, stats, skip, out, B, C, G, V, mode);
}

template <typename E>
int launch_any(const E* x, const E* mask, const float* weight,
               const float* bias, const E* skip, E* out, double* partial,
               unsigned* tickets, float* stats, int B, int C, int G,
               long long V, float eps, int mode, long long Vb, int CC,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * C * V == 0) return 0;
  if (V % 4 == 0)
    launch<4, E>(x, mask, weight, bias, skip, out, partial, tickets, stats, B,
                 C, G, V, eps, mode, Vb, CC, s);
  else
    launch<1, E>(x, mask, weight, bias, skip, out, partial, tickets, stats, B,
                 C, G, V, eps, mode, Vb, CC, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out, skip [B, C, V]; mask [B, V]; partial
// [B*G, ceil(V / Vb) * C/G/CC, 3] float64; tickets [B*G] uint32, all 0 (the
// kernel leaves them 0); stats [B*G, 4]. A statistics block sums Vb voxels
// (a multiple of 1024) of CC channels (a divisor of C/G); the wrapper sizes
// both from the shape and the SM count. skip is read only in mode 2.
extern "C" int tdv_masked_group_norm(
    const float* x, const float* mask, const float* weight,
    const float* bias, const float* skip, float* out, double* partial,
    unsigned* tickets, float* stats, int B, int C, int G, long long V,
    float eps, int mode, long long Vb, int CC, void* stream) {
  return launch_any(x, mask, weight, bias, skip, out, partial, tickets,
                    stats, B, C, G, V, eps, mode, Vb, CC, stream);
}

// x, mask, skip and out bf16; the rest as above
extern "C" int tdv_masked_group_norm_bf16(
    const void* x, const void* mask, const float* weight, const float* bias,
    const void* skip, void* out, double* partial, unsigned* tickets,
    float* stats, int B, int C, int G, long long V, float eps, int mode,
    long long Vb, int CC, void* stream) {
  using E = bf16::bits16;
  return launch_any(static_cast<const E*>(x), static_cast<const E*>(mask),
                    weight, bias, static_cast<const E*>(skip),
                    static_cast<E*>(out), partial, tickets, stats, B, C, G,
                    V, eps, mode, Vb, CC, stream);
}
