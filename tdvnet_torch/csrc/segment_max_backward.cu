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
// the card).
//   pool     one thread per (point, 4 channels); a first pass counts ties
//            per (segment, channel) with integer atomics (exact,
//            order-free); a second writes each row's share with an IEEE
//            division, so the result is deterministic and bit-equal to the
//            twin;
//   concat   a warp takes 16 channels of 8 consecutive rows (64 bytes of
//            each). The y half is a masked copy; the pooled half is a
//            segment sum into d pooled, in fixed point (fixed_sum.cuh): the
//            largest finite |g| of the pooled half (fx::amax_kernel) and
//            the P rows that a segment can hold at most set the call's
//            scale, each row's 4 terms are rounded, the lanes of a warp
//            whose rows share a segment at the same 4 channels
//            (__match_any_sync) add theirs by shuffles, and one lane of
//            each such set adds the 4 sums into an int64 [n_seg, C] with
//            `red.global.add.u64`; a last pass converts the sums to fp32.
//            The result is the same bits whatever order the rows land in.
//            The merge matters where many rows share a segment: with one
//            row a warp, the slot that the rows past the anchors' capacity
//            are clamped into took one atomic per row and channel on one
//            address (PERF.md section 6). Atomics rather than a per-anchor
//            gather over a CSR of K3's ranks: a CSR needs a count, a prefix
//            sum and a fill over the points (three more passes and an index
//            array) to replace adds that meet few others (at the train step
//            ~3 points per occupied anchor). A non-finite term adds 0 there
//            and raises a flag; the kernel's second launch then adds those
//            terms alone, as floats, onto the result (non-finite sums do not
//            depend on the order).
//
// The bf16 forms (tdv_segment_max_backward_bf16,
// tdv_gather_concat_backward_bf16; a bf16 model's PointNet in training)
// are the same kernels templated on the rows' storage: four bf16 channels
// (8 bytes) a thread, widened exactly. The pool compares the widened values
// (a tie is a tie in any type), forms the share g / n in fp32 and rounds it
// once to bf16; the concat-back's y half is a masked copy, its segment sum
// the same fixed point (the amax over the bf16 gradient), converted to fp32
// once and rounded to bf16 where it is stored; a non-finite term is added
// onto the bf16 result by a bf16 atomic. Bound: half the fp32 forms' bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "fixed_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// E: a row element's storage (float, or bf16::bits16); V: four of them
template <typename E>
__global__ void segment_max_backward_count_kernel(
    const E* __restrict__ y, const long long* __restrict__ seg,
    const uint8_t* __restrict__ valid, const E* __restrict__ pooled,
    int* __restrict__ ties, long long P, int C, long long n_seg) {
  using V = typename bf16::Quad<E>::V;
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * cq) return;
  const long long p = t / cq;
  const int q = (int)(t % cq);
  if (!valid[p]) return;
  const long long s = seg[p];
  if (s < 0 || s >= n_seg) return;
  const float4 v = bf16::load4_plain(reinterpret_cast<const V*>(y + p * C) + q);
  const float4 m = bf16::load4(reinterpret_cast<const V*>(pooled + s * C) + q);
  int* n = ties + s * C + 4 * q;
  if (v.x == m.x) atomicAdd(n + 0, 1);
  if (v.y == m.y) atomicAdd(n + 1, 1);
  if (v.z == m.z) atomicAdd(n + 2, 1);
  if (v.w == m.w) atomicAdd(n + 3, 1);
}

__device__ __forceinline__ float share(float y, float m, float g, int n) {
  return y == m ? g / (float)n : 0.f;
}

template <typename E>
__global__ void segment_max_backward_kernel(
    const E* __restrict__ grad, const E* __restrict__ y,
    const long long* __restrict__ seg, const uint8_t* __restrict__ valid,
    const E* __restrict__ pooled, const int* __restrict__ ties,
    E* __restrict__ grad_y, long long P, int C, long long n_seg) {
  using V = typename bf16::Quad<E>::V;
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * cq) return;
  const long long p = t / cq;
  const int q = (int)(t % cq);
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long s = seg[p];
  if (valid[p] && s >= 0 && s < n_seg) {
    const float4 v =
        bf16::load4_plain(reinterpret_cast<const V*>(y + p * C) + q);
    const float4 m =
        bf16::load4(reinterpret_cast<const V*>(pooled + s * C) + q);
    const float4 g = bf16::load4(reinterpret_cast<const V*>(grad + s * C) + q);
    const int4 n = __ldg(reinterpret_cast<const int4*>(ties + s * C) + q);
    out.x = share(v.x, m.x, g.x, n.x);
    out.y = share(v.y, m.y, g.y, n.y);
    out.z = share(v.z, m.z, g.z, n.z);
    out.w = share(v.w, m.w, g.w, n.w);
  }
  bf16::store4(reinterpret_cast<V*>(grad_y + p * C) + q, out);
}

__device__ __forceinline__ float pass(float g, float v, int relu) {
  return (!relu || v > 0.f) ? g : 0.f;
}

// fx words: amax |g| of the pooled half, the non-finite flag
// NF false: the y half, and the pooled half's fixed-point sums into `acc`;
// NF true: only the pooled half's non-finite terms, as float adds into
// grad_pooled (nothing unless the flag is up)
// A warp is 8 consecutive rows at 16 channels: lane 4 r + i takes row
// 8 (warp / n4) + r at channels 4 (4 (warp % n4) + i) + 0..3, n4 =
// ceil(C / 16), so that a warp reads 64 contiguous bytes of each row (32
// in bf16).
template <typename E, bool NF>
__global__ void segment_max_backward_concat_kernel(
    const E* __restrict__ grad, const E* __restrict__ y,
    const E* __restrict__ pooled, const long long* __restrict__ seg,
    E* __restrict__ grad_y, E* __restrict__ grad_pooled,
    long long* __restrict__ acc, unsigned* __restrict__ fxw, long long P,
    int C, long long n_seg, int relu) {
  using V = typename bf16::Quad<E>::V;
  if (NF && *reinterpret_cast<volatile unsigned*>(fxw + 1) == 0u) return;
  const int cq = C >> 2, n4 = (cq + 3) >> 2;
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = (w / n4) * 8 + (lane >> 2);
  const int q = (int)(w % n4) * 4 + (lane & 3);
  if ((w / n4) * 8 >= P) return;             // uniform over the warp
  const bool row = p < P && q < cq;
  long long s = -1;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if (row) {
    const V* g = reinterpret_cast<const V*>(grad + p * 2 * C);
    const float4 gp = bf16::load4_plain(g + cq + q);
    if (!NF) {
      const float4 gy = bf16::load4_plain(g + q);
      const float4 v =
          bf16::load4_plain(reinterpret_cast<const V*>(y + p * C) + q);
      bf16::store4(reinterpret_cast<V*>(grad_y + p * C) + q,
                   make_float4(pass(gy.x, v.x, relu), pass(gy.y, v.y, relu),
                               pass(gy.z, v.z, relu),
                               pass(gy.w, v.w, relu)));
    }
    s = seg[p];                  // the forward's clamp
    s = s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
    const float4 m =
        bf16::load4(reinterpret_cast<const V*>(pooled + s * C) + q);
    d[0] = pass(gp.x, m.x, relu);
    d[1] = pass(gp.y, m.y, relu);
    d[2] = pass(gp.z, m.z, relu);
    d[3] = pass(gp.w, m.w, relu);
  }
  if (NF) {
    if (row) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!isfinite(d[c]))
          bf16::add_nonfinite(grad_pooled + s * C + 4 * q + c, d[c]);
    }
    return;
  }
  // every term |g| < 2^(e + 1), at most P of them a segment
  const float scale =
      fx::pow2(fx::scale_exp(fx::exp_of(fxw[0]) + 1, fx::log2_ceil_dev(P)));
  long long v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = row ? fx::quantize(d[c], scale, fxw + 1) : 0;
  // the lanes whose rows share a segment, at the same channels, sum their
  // terms (integers: in any order), and the lowest of them adds the sums
  const unsigned peers =
      __match_any_sync(kFull, row ? s * 4 + (lane & 3) : -1 - lane);
  if (__popc(peers) > 1) {
    long long sum[4] = {0, 0, 0, 0};
    for (unsigned rest = peers; rest; rest &= rest - 1) {
      const int from = __ffs(rest) - 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += __shfl_sync(peers, v[c], from);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = sum[c];
  }
  if (!row || lane != __ffs(peers) - 1) return;
  long long* a = acc + s * C + 4 * q;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (v[c]) fx::red_add(a + c, v[c]);
}

// grad_pooled = acc * 2^-k, 4 elements a thread (rounded to bf16 where the
// storage is)
template <typename E>
__global__ void segment_max_backward_convert_kernel(
    const long long* __restrict__ acc, E* __restrict__ out, long long n4,
    const unsigned* __restrict__ fxw, long long P) {
  using V = typename bf16::Quad<E>::V;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float inv = fx::pow2(
      -fx::scale_exp(fx::exp_of(fxw[0]) + 1, fx::log2_ceil_dev(P)));
  const longlong2 a = reinterpret_cast<const longlong2*>(acc)[2 * i];
  const longlong2 b = reinterpret_cast<const longlong2*>(acc)[2 * i + 1];
  bf16::store4(reinterpret_cast<V*>(out) + i,
               make_float4(fx::dequantize(a.x, inv), fx::dequantize(a.y, inv),
                           fx::dequantize(b.x, inv),
                           fx::dequantize(b.y, inv)));
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename E>
int pool_backward(const E* grad, const E* y, const long long* seg,
                  const uint8_t* valid, const E* pooled, int* ties,
                  E* grad_y, long long P, int C, long long n_seg,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = P * (C / 4);
  if (total == 0) return 0;
  cudaError_t err =
      cudaMemsetAsync(ties, 0, sizeof(int) * (size_t)n_seg * C, s);
  if (err != cudaSuccess) return (int)err;
  segment_max_backward_count_kernel<E>
      <<<blocks_for(total), kThreads, 0, s>>>(y, seg, valid, pooled, ties, P,
                                              C, n_seg);
  segment_max_backward_kernel<E><<<blocks_for(total), kThreads, 0, s>>>(
      grad, y, seg, valid, pooled, ties, grad_y, P, C, n_seg);
  return (int)cudaGetLastError();
}

template <typename E>
int concat_backward(const E* grad, const E* y, const E* pooled,
                    const long long* seg, E* grad_y, E* grad_pooled,
                    long long* acc, unsigned* fxw, long long P, int C,
                    long long n_seg, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(acc, 0, sizeof(long long) * (size_t)n_seg * C, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(fxw, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  // a warp per 8 rows and 16 channels
  const long long total = (P + 7) / 8 * ((C / 4 + 3) / 4) * 32;
  if (total > 0) {
    fx::amax(grad + C, P, C, 2LL * C, fxw, s);
    segment_max_backward_concat_kernel<E, false>
        <<<blocks_for(total), kThreads, 0, s>>>(grad, y, pooled, seg, grad_y,
                                                grad_pooled, acc, fxw, P, C,
                                                n_seg, relu);
  }
  const long long n4 = n_seg * (C / 4);
  if (n4 > 0)
    segment_max_backward_convert_kernel<E>
        <<<blocks_for(n4), kThreads, 0, s>>>(acc, grad_pooled, n4, fxw, P);
  if (total > 0)
    segment_max_backward_concat_kernel<E, true>
        <<<blocks_for(total), kThreads, 0, s>>>(grad, y, pooled, seg, grad_y,
                                                grad_pooled, acc, fxw, P, C,
                                                n_seg, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// grad, pooled [n_seg, C]; y, grad_y [P, C]; ties [n_seg, C] int32 scratch
// (zeroed here); C % 4 == 0.
extern "C" int tdv_segment_max_backward(
    const float* grad, const float* y, const long long* seg,
    const uint8_t* valid, const float* pooled, int* ties, float* grad_y,
    long long P, int C, long long n_seg, void* stream) {
  return pool_backward(grad, y, seg, valid, pooled, ties, grad_y, P, C,
                       n_seg, stream);
}

// grad [P, 2C]; y, grad_y [P, C]; pooled, grad_pooled [n_seg, C]; acc
// [n_seg, C] int64 and fxw 2 uint32 scratch (set here); C % 4 == 0.
extern "C" int tdv_gather_concat_backward(
    const float* grad, const float* y, const float* pooled,
    const long long* seg, float* grad_y, float* grad_pooled, long long* acc,
    unsigned* fxw, long long P, int C, long long n_seg, int relu,
    void* stream) {
  return concat_backward(grad, y, pooled, seg, grad_y, grad_pooled, acc, fxw,
                         P, C, n_seg, relu, stream);
}

// the same two on bf16 rows, gradients and results
extern "C" int tdv_segment_max_backward_bf16(
    const void* grad, const void* y, const long long* seg,
    const uint8_t* valid, const void* pooled, int* ties, void* grad_y,
    long long P, int C, long long n_seg, void* stream) {
  using E = bf16::bits16;
  return pool_backward(static_cast<const E*>(grad), static_cast<const E*>(y),
                       seg, valid, static_cast<const E*>(pooled), ties,
                       static_cast<E*>(grad_y), P, C, n_seg, stream);
}

extern "C" int tdv_gather_concat_backward_bf16(
    const void* grad, const void* y, const void* pooled,
    const long long* seg, void* grad_y, void* grad_pooled, long long* acc,
    unsigned* fxw, long long P, int C, long long n_seg, int relu,
    void* stream) {
  using E = bf16::bits16;
  return concat_backward(static_cast<const E*>(grad),
                         static_cast<const E*>(y),
                         static_cast<const E*>(pooled), seg,
                         static_cast<E*>(grad_y),
                         static_cast<E*>(grad_pooled), acc, fxw, P, C, n_seg,
                         relu, stream);
}
