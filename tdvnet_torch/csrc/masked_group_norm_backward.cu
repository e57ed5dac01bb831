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
//       = g * m * [y > 0]            (mode 1: the ReLU, y recomputed)
//       = g * m * [out > 0]          (mode 2: the ReLU after the skip, seen
//                                     in the forward's output)
//   d skip = g'; d bias[c] = sum_{b, v} g'; d weight[c] = sum_{b, v} g' xn
//   A = sum_{c in g, v} w[c] g', Bx = sum_{c in g, v} w[c] g' xn
//   d x = rstd (w[c] g' - m (A + xn Bx [var >= 0]) / n)
// (the mean and variance take their gradient from the active voxels only;
// the clamp at 0 passes none below it).
//
// Bound on an H100: bytes. g, x, the mask and (mode 2) the output read
// once, d x and d skip written once: at the finest U-Net level of a train
// step [2, 64, 64^3] ~270 MB (ReLU tail) to ~540 MB (skip tail) a call,
// 80-160 us.
//
// What held the first form (PERF.md section 6: 3.04 ms of an n_iters=1
// step over 24 calls, 2.0x its bound): four launches a call
// (reduce with one channel a block, a per-channel pass, a one-block
// finalize, the apply); g, x and the output read twice from device memory
// at the finest level (reduce, then apply: 137 + 169 us of a ReLU call);
// the output read only to see where the ReLU passed; and at levels 1-2 a
// host path of ~55 us a call against ~13 us on the device.
//
// Design, NCDHW as the forward, one cooperative launch a call: at most
// as many blocks as the card holds at once, which the launch guarantees
// are all resident (it fails, rather than hang, when they cannot be), each
// taking the work items blockIdx.x, blockIdx.x + gridDim.x, ... in turn.
// Items run (b, g) slice by slice, and a slice holds at most half the
// resident blocks' items, so that a block waiting for its slice (below)
// only waits for items that other blocks are sure to reach: every item
// before it in its blocks' turns lies in an earlier slice.
//   reduce   an item is VB voxels of a chunk of CC of a (b, g) slice's
//            channels (CC from the group's size down until the items fill
//            the card, VB up until a slice's items fit in half the
//            resident blocks), and sums g' and g' xn per channel; the
//            mode-1 ReLU is seen by recomputing the forward's y from x (its
//            sign, bit for bit), not by reading the output;
//   finalize the last item of a slice (a ticket) adds the slice's
//            partials in index order, forms the (b, g) coefficients
//            A / n and Bx [var >= 0] / n and publishes them with the call's
//            epoch; the last slice of a group adds d weight and d bias over
//            the batch in order. No float atomics: the same bits on every
//            launch;
//   apply    every item of the slice waits for its coefficients, then
//            walks its voxels and channels again, in reverse, so that the
//            data it read last (still in L2) comes first: d x and, in mode
//            2, d skip.
// Per-stream scratch (kernels/groupnorm.py `_BACKWARD_SCRATCH`): the
// partials, per-(b, c) sums and coefficients, and the counters (zeroed
// once; each launch leaves them zero: the last item of a slice and of a
// group put theirs back).
//
// The bf16 form (tdv_masked_group_norm_backward_bf16; a bf16 model's scene
// U-Net in training) is the same kernel templated on the storage of g, x,
// the mask, the output, d x and d skip: bf16 loads widened exactly, the
// arithmetic in fp32 as above with the forward's statistics, the weight
// cast to bf16 as the bf16 forward multiplies by it; d x and d skip rounded
// once to bf16 where stored; d weight and d bias, the gradients of the
// bf16-cast affine, rounded once to bf16 values and stored in fp32 (the
// cast's gradient widens them to the fp32 parameters). Every tail sees the
// ReLU in the bf16 output (the bf16 forward's y is not the fp32 form's
// expression). Its block shape is its own
// (tdv_masked_group_norm_backward_shape_bf16: its own resident blocks).
// Bound: bytes, half the fp32 form's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCC = 32;                 // channels a block sums at most
constexpr int kMaxGroup = 256;             // channels a group holds at most
constexpr unsigned kFull = 0xffffffffu;

// E: an element's storage (float, or bf16::bits16); T: VEC of them; W: the
// same widened (float4 or float)
template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using T = float4;
  using W = float4;
};
template <>
struct Vec<float, 1> {
  using T = float;
  using W = float;
};
template <>
struct Vec<bf16::bits16, 4> {
  using T = uint2;
  using W = float4;
};
template <>
struct Vec<bf16::bits16, 1> {
  using T = bf16::bits16;
  using W = float;
};

__device__ __forceinline__ float4 wide(float4 v) { return v; }
__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float4 wide(uint2 v) { return bf16::widen(v); }
__device__ __forceinline__ float wide(bf16::bits16 v) {
  return bf16::widen(v);
}
__device__ __forceinline__ void put(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint2* p, float4 v) {
  *p = bf16::narrow(v);
}
__device__ __forceinline__ void put(bf16::bits16* p, float v) {
  *p = bf16::narrow(v);
}

// the weight as the form multiplies by it: fp32, or cast to bf16
template <typename E>
__device__ __forceinline__ float weight_of(const float* w, int c) {
  return sizeof(E) == 2 ? bf16::round(w[c]) : w[c];
}
// d weight, d bias as stored: fp32, or rounded to a bf16 value
template <typename E>
__device__ __forceinline__ float affine_grad(float v) {
  return sizeof(E) == 2 ? bf16::round(v) : v;
}

__device__ __forceinline__ float lane_of(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ void set_lane(float4& v, int j, float a) {
  if (j == 0) v.x = a;
  else if (j == 1) v.y = a;
  else if (j == 2) v.z = a;
  else v.w = a;
}
__device__ __forceinline__ void set_lane(float& v, int, float a) { v = a; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

struct Args {
  // [B, C, V] or [B, V] of E
  const void *grad, *x, *mask, *out;
  const float *weight, *bias, *stats;
  void* grad_x;                       // [B, C, V] of E
  float *grad_w, *grad_b;
  void* grad_skip;                    // [B, C, V] of E
  float *partial, *chan, *coef;       // [B*G, n_vb, cg, 2], [B*C, 2], [B*G, 2]
  unsigned* sync;                     // counters (see `Sync`), zero
  unsigned* ready;                    // [B*G] the epoch each slice is at
  unsigned epoch;
  int B, C, G, CC, mode;
  long long V, Vb;
};

// the counters, all zero between calls: per slice its arrivals, per group
// its finished slices; and, apart (they keep their last epoch), per slice
// its ready epoch
struct Sync {
  unsigned *arrive, *group_done, *ready;
  __device__ Sync(unsigned* s, unsigned* r, int BG)
      : arrive(s), group_done(s + BG), ready(r) {}
};

// g' of one element: the gradient reaching (xn w + b). In mode 1 the
// forward's y = ((x - mean) * rstd * w + b) * m is recomputed (the same
// expression, so the same bits) to see the ReLU; mode 2 reads the output.
__device__ __forceinline__ float gprime(float g, float x, float m, float out,
                                        float mean, float rstd, float w,
                                        float bi, int mode) {
  const float gm = g * m;
  if (mode == 0) return gm;
  if (mode == 1) {
    const float y = ((x - mean) * rstd * w + bi) * m;
    return y > 0.f ? gm : 0.f;
  }
  return out > 0.f ? gm : 0.f;
}

template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) masked_group_norm_backward_kernel(
    Args p) {
  using T = typename Vec<E, VEC>::T;
  using W = typename Vec<E, VEC>::W;
  __shared__ float smem[2][kMaxCC][kThreads / 32];
  __shared__ float csum[2][kMaxGroup];
  __shared__ bool last_s, group_last;
  const E* grad = static_cast<const E*>(p.grad);
  const E* xs = static_cast<const E*>(p.x);
  const E* outs = static_cast<const E*>(p.out);
  E* grad_x = static_cast<E*>(p.grad_x);
  E* grad_skip = static_cast<E*>(p.grad_skip);
  const int BG = p.B * p.G;
  Sync sy(p.sync, p.ready, BG);
  const int cg = p.C / p.G, n_cc = cg / p.CC;
  const long long n_vb = (p.V + p.Vb - 1) / p.Vb;
  const long long n_blk = n_vb * n_cc;              // items of a slice
  const long long n_items = (long long)BG * n_blk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the bf16 form sees every ReLU in the output
  const int gmode = sizeof(E) == 2 && p.mode == 1 ? 2 : p.mode;
  const bool read_out = gmode == 2;

  for (long long blk = blockIdx.x; blk < n_items; blk += gridDim.x) {
    const int bg = (int)(blk / n_blk);
    const long long i = blk - (long long)bg * n_blk;
    const int vb = (int)(i / n_cc), cc = (int)(i - (long long)vb * n_cc);
    const int b = bg / p.G, g = bg - b * p.G;
    const float mean = p.stats[bg * 4], rstd = p.stats[bg * 4 + 1];
    const int c0 = g * cg + cc * p.CC;
    const long long v0 = (long long)vb * p.Vb;
    const long long v1 = v0 + p.Vb < p.V ? v0 + p.Vb : p.V;
    const E* m = static_cast<const E*>(p.mask) + (long long)b * p.V;

    // reduce: per channel of the chunk, sum g' and g' xn over the voxels
    for (int k = 0; k < p.CC; ++k) {
      const int c = c0 + k;
      const long long row = ((long long)b * p.C + c) * p.V;
      const float w = p.weight[c], bi = gmode == 1 ? p.bias[c] : 0.f;
      float sg = 0.f, sgx = 0.f;
      for (long long v = v0 + t * VEC; v < v1; v += VEC * kThreads) {
        const W gv = wide(__ldg(reinterpret_cast<const T*>(grad + row + v)));
        const W xv = wide(__ldg(reinterpret_cast<const T*>(xs + row + v)));
        const W mv = wide(__ldg(reinterpret_cast<const T*>(m + v)));
        W ov = gv;
        if (read_out)
          ov = wide(__ldg(reinterpret_cast<const T*>(outs + row + v)));
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xj = lane_of(xv, j);
          const float gp = gprime(lane_of(gv, j), xj, lane_of(mv, j),
                                  lane_of(ov, j), mean, rstd, w, bi, gmode);
          sg += gp;
          sgx += gp * ((xj - mean) * rstd);
        }
      }
      sg = warp_sum(sg);
      sgx = warp_sum(sgx);
      if (lane == 0) {
        smem[0][k][warp] = sg;
        smem[1][k][warp] = sgx;
      }
    }
    __syncthreads();
    const long long prow = ((long long)bg * n_vb + vb) * cg + cc * p.CC;
    if (t < 2 * p.CC) {
      const int k = t >> 1, which = t & 1;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += smem[which][k][w];
      p.partial[(prow + k) * 2 + which] = s;
      __threadfence();
    }
    __syncthreads();
    if (t == 0)
      last_s = atomicAdd(sy.arrive + bg, 1u) == (unsigned)(n_blk - 1);
    __syncthreads();

    if (last_s) {
      // finalize the slice: per (channel, sum) pair a warp adds the n_vb
      // partials lane-strided then by a fixed shuffle tree
      __threadfence();
      for (int pair = warp; pair < 2 * cg; pair += kThreads / 32) {
        const int k = pair >> 1, which = pair & 1;
        float s = 0.f;
        for (long long j = lane; j < n_vb; j += 32)
          s += __ldcg(p.partial + ((((long long)bg * n_vb + j) * cg + k) * 2 +
                                   which));
        s = warp_sum(s);
        if (lane == 0) {
          csum[which][k] = s;
          p.chan[((long long)b * p.C + g * cg + k) * 2 + which] = s;
        }
      }
      __threadfence();
      __syncthreads();
      if (warp == 0) {
        // the coefficients: lanes over the group's channels, a fixed tree
        float a = 0.f, bx = 0.f;
        for (int k = lane; k < cg; k += 32) {
          a += weight_of<E>(p.weight, g * cg + k) * csum[0][k];
          bx += weight_of<E>(p.weight, g * cg + k) * csum[1][k];
        }
        a = warp_sum(a);
        bx = warp_sum(bx);
        if (lane == 0) {
          const float n = p.stats[bg * 4 + 2];
          p.coef[bg * 2 + 0] = a / n;
          p.coef[bg * 2 + 1] = p.stats[bg * 4 + 3] != 0.f ? bx / n : 0.f;
          sy.arrive[bg] = 0u;
          __threadfence();
          atomicExch(sy.ready + bg, p.epoch);
          group_last =
              atomicAdd(sy.group_done + g, 1u) == (unsigned)(p.B - 1);
        }
        __syncwarp();
        // the last slice of group g: d weight and d bias over the batch
        if (group_last) {
          __threadfence();
          for (int k = lane; k < cg; k += 32) {
            const int c = g * cg + k;
            float sw = 0.f, sb = 0.f;
            for (int bb = 0; bb < p.B; ++bb) {
              sb += __ldcg(p.chan + ((long long)bb * p.C + c) * 2);
              sw += __ldcg(p.chan + ((long long)bb * p.C + c) * 2 + 1);
            }
            p.grad_w[c] = affine_grad<E>(sw);
            p.grad_b[c] = affine_grad<E>(sb);
          }
          if (lane == 0) sy.group_done[g] = 0u;
        }
      }
    }

    // wait for the slice's coefficients (every item of the slice is on a
    // resident block and reaches its reduce; see the header)
    if (t == 0) {
      while (*reinterpret_cast<volatile unsigned*>(sy.ready + bg) != p.epoch)
        __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    const float a = __ldcg(p.coef + bg * 2), bx = __ldcg(p.coef + bg * 2 + 1);

    // apply, in reverse: the data read last comes first
    for (int k = p.CC - 1; k >= 0; --k) {
      const int c = c0 + k;
      const long long row = ((long long)b * p.C + c) * p.V;
      const float w = weight_of<E>(p.weight, c),
                  bi = gmode == 1 ? p.bias[c] : 0.f;
      const long long n_v = (v1 - v0 + VEC * kThreads - 1) / (VEC * kThreads);
      for (long long s = n_v - 1; s >= 0; --s) {
        const long long v = v0 + (s * kThreads + t) * VEC;
        if (v >= v1) continue;
        const W gv = wide(__ldg(reinterpret_cast<const T*>(grad + row + v)));
        const W xv = wide(__ldg(reinterpret_cast<const T*>(xs + row + v)));
        const W mv = wide(__ldg(reinterpret_cast<const T*>(m + v)));
        W ov = gv;
        if (read_out)
          ov = wide(__ldg(reinterpret_cast<const T*>(outs + row + v)));
        W dx = gv, ds = gv;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xj = lane_of(xv, j), mj = lane_of(mv, j);
          const float gp = gprime(lane_of(gv, j), xj, mj, lane_of(ov, j),
                                  mean, rstd, w, bi, gmode);
          const float xn = (xj - mean) * rstd;
          set_lane(dx, j, rstd * (w * gp - mj * (a + xn * bx)));
          set_lane(ds, j, gp);
        }
        put(reinterpret_cast<T*>(grad_x + row + v), dx);
        if (p.mode == 2) put(reinterpret_cast<T*>(grad_skip + row + v), ds);
      }
    }
    __syncthreads();     // the shared sums and flags of the next item
  }
}

// resident blocks of the kernel on the current device (once per device)
template <typename E, int VEC>
int resident_blocks() {
  constexpr int kDevices = 64;
  static int cached[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && cached[dev] > 0) return cached[dev];
  int n_sm = 0, per_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, masked_group_norm_backward_kernel<E, VEC>, kThreads, 0);
  const int n = per_sm * n_sm;
  if (dev < kDevices) cached[dev] = n;
  return n;
}

template <typename E>
int backward_shape(int B, int C, int G, long long V, long long* shape) {
  const int vec = V % 4 == 0 ? 4 : 1;
  const int resident =
      vec == 4 ? resident_blocks<E, 4>() : resident_blocks<E, 1>();
  const int half = resident / 2;
  int n_sm = 0, dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const int cg = C / G;
  if (half < 1 || n_sm < 1 || cg > kMaxGroup)
    return (int)cudaErrorInvalidConfiguration;
  long long Vb = (long long)vec * kThreads;
  int CC = cg;
  while (CC > kMaxCC && CC % 2 == 0) CC /= 2;
  if (CC > kMaxCC) return (int)cudaErrorInvalidValue;
  auto items = [&](long long vb, int cc) {    // a slice's items
    return (V + vb - 1) / vb * (cg / cc);
  };
  // the channel chunk halved until the items number 4 an SM (small levels
  // fill the card; smaller chunks measured slower at level 1), then the
  // voxel blocks grown, then the channel chunks, until a slice's items fit
  // in half the resident blocks
  while (CC % 2 == 0 && (long long)B * G * items(Vb, CC) < 4LL * n_sm)
    CC /= 2;
  while (items(Vb, CC) > half && Vb < V) Vb *= 2;
  while (items(Vb, CC) > half && CC < kMaxCC && (cg / CC) % 2 == 0) CC *= 2;
  if (items(Vb, CC) > half) return (int)cudaErrorInvalidConfiguration;
  shape[0] = CC;
  shape[1] = Vb;
  shape[2] = (V + Vb - 1) / Vb;
  return 0;
}

template <typename E>
int backward(const void* grad, const void* x, const void* mask,
             const void* out, const float* weight, const float* bias,
             const float* stats, void* grad_x, float* grad_w, float* grad_b,
             void* grad_skip, float* partial, float* chan, float* coef,
             unsigned* sync, unsigned* ready, int B, int C, int G,
             long long V, int mode, int CC, long long Vb, unsigned epoch,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * C * V == 0) return 0;
  Args a{grad, x, mask, out, weight, bias, stats, grad_x, grad_w, grad_b,
         grad_skip, partial, chan, coef, sync, ready, epoch, B, C, G, CC,
         mode, V, Vb};
  const long long items =
      (long long)B * G * ((V + Vb - 1) / Vb) * (C / G / CC);
  const bool v4 = V % 4 == 0;
  const long long resident =
      v4 ? resident_blocks<E, 4>() : resident_blocks<E, 1>();
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  void* args[] = {&a};
  const void* fn =
      v4 ? reinterpret_cast<const void*>(
               masked_group_norm_backward_kernel<E, 4>)
         : reinterpret_cast<const void*>(
               masked_group_norm_backward_kernel<E, 1>);
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads),
                                          args, 0, s);
}

}  // namespace

// The block shape of a call: CC channels (a divisor of C/G, at most 32)
// and VB voxels (a multiple of 4 * 256) an item, chosen here from the
// shape and the card: CC is halved from C/G until the items number 4 an
// SM, then VB doubled until a slice's items fit in half the resident
// blocks (the items of a slice wait for each other; see the kernel's
// header). Writes (CC, VB, n_vb) to `shape` for the wrapper's scratch.
extern "C" int tdv_masked_group_norm_backward_shape(int B, int C, int G,
                                                    long long V,
                                                    long long* shape) {
  return backward_shape<float>(B, C, G, V, shape);
}

// the same for the bf16 form (its own resident blocks)
extern "C" int tdv_masked_group_norm_backward_shape_bf16(int B, int C, int G,
                                                         long long V,
                                                         long long* shape) {
  return backward_shape<bf16::bits16>(B, C, G, V, shape);
}

// grad, x, out, grad_x, grad_skip [B, C, V]; mask [B, V]; stats [B*G, 4]
// from the forward; bias [C] (read in mode 1); out read in mode 2 only;
// partial [B*G, n_vb, C/G, 2], chan [B*C, 2], coef [B*G, 2] float scratch;
// sync B*G + G uint32, zero before the first call (every call leaves them
// zero); ready B*G uint32, never equal to `epoch` before the call (epochs
// count up per scratch, from 1); (CC, Vb) from
// tdv_masked_group_norm_backward_shape. grad_skip is written only in mode
// 2. The launch is cooperative: it fails with an error, and runs nothing,
// where the card cannot hold its blocks at once (a card shared with other
// work).
extern "C" int tdv_masked_group_norm_backward(
    const float* grad, const float* x, const float* mask, const float* out,
    const float* weight, const float* bias, const float* stats, float* grad_x,
    float* grad_w, float* grad_b, float* grad_skip, float* partial,
    float* chan, float* coef, unsigned* sync, unsigned* ready, int B, int C,
    int G, long long V, int mode, int CC, long long Vb, unsigned epoch,
    void* stream) {
  return backward<float>(grad, x, mask, out, weight, bias, stats, grad_x,
                         grad_w, grad_b, grad_skip, partial, chan, coef, sync,
                         ready, B, C, G, V, mode, CC, Vb, epoch, stream);
}

// the bf16 form: grad, x, mask, out, grad_x and grad_skip bf16 (out read
// in modes 1 and 2), weight, bias, stats, grad_w and grad_b fp32, (CC, Vb)
// from tdv_masked_group_norm_backward_shape_bf16; the rest as above
extern "C" int tdv_masked_group_norm_backward_bf16(
    const void* grad, const void* x, const void* mask, const void* out,
    const float* weight, const float* bias, const float* stats, void* grad_x,
    float* grad_w, float* grad_b, void* grad_skip, float* partial,
    float* chan, float* coef, unsigned* sync, unsigned* ready, int B, int C,
    int G, long long V, int mode, int CC, long long Vb, unsigned epoch,
    void* stream) {
  return backward<bf16::bits16>(grad, x, mask, out, weight, bias, stats,
                                grad_x, grad_w, grad_b, grad_skip, partial,
                                chan, coef, sync, ready, B, C, G, V, mode, CC,
                                Vb, epoch, stream);
}
