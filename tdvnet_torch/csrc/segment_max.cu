// segment_max / gather_concat: the PointNet's per-voxel max pool and its
// concat-back.
//
// Replaces: tdvnet/models/pointnet.py `_segmax` (:19-22) with the masking
// around it (:51, :56) and the gather-back plus concatenate (:53-54). The
// TPU form writes -1e30 into masked rows, runs a sorted-segment max and
// maps results <= -5e29 to 0; the gather-back and the concatenate are two
// more passes over [P, C] and [P, 2C].
//
// Bound on an H100: bytes. The pool reads [P, C] and writes [n_seg, C]
// (n_seg is the anchor capacity plus the dump slot, far more rows than
// points at the whole-scene size, so the output dominates); the concat
// reads [P, C] twice and writes [P, 2C].
//
// Design: points stay in their input order (no sort precedes this kernel),
// so the pool is an atomic max, one thread per (point, channel), on the
// order-preserving unsigned image of the float. That max is exact and does
// not depend on the order of arrival: the kernel equals the plain twin bit
// for bit. The image of every real value is non-zero, so a zero-filled
// buffer marks empty segments; a racy read skips the atomic when the slot
// already holds a value at least as large (slots only grow). A last pass
// decodes in place, with 0 for an empty segment and for a maximum at or
// below -5e29 as the reference has it. A sorted-segment design (one warp
// per anchor over contiguous rows) would need the sort this port dropped.
// The concat-back writes cat([y, pooled[seg]]) in one pass, optionally
// through the ReLU that precedes the next linear layer, so neither the
// gathered copy nor the concatenation is materialised.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned encode(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float decode(unsigned e) {
  return __uint_as_float((e & 0x80000000u) ? (e ^ 0x80000000u) : ~e);
}

__global__ void segment_max_fill_kernel(uint4* __restrict__ buf,
                                        long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) buf[i] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void segment_max_atomic_kernel(
    const float* __restrict__ y, const long long* __restrict__ seg,
    const uint8_t* __restrict__ valid, unsigned* __restrict__ buf,
    long long P, int C, long long n_seg) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * C) return;
  const long long p = t / C;
  const int c = (int)(t % C);
  if (!valid[p]) return;
  const long long s = seg[p];
  if (s < 0 || s >= n_seg) return;
  const unsigned e = encode(y[t]);
  unsigned* slot = buf + s * C + c;
  if (*reinterpret_cast<volatile unsigned*>(slot) < e) atomicMax(slot, e);
}

__global__ void segment_max_decode_kernel(unsigned* buf, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const uint4 e = reinterpret_cast<const uint4*>(buf)[i];
  float4 v;
  // -5e29 is the reference's threshold NEG / 2
  v.x = e.x ? decode(e.x) : 0.f;  v.x = v.x <= -5e29f ? 0.f : v.x;
  v.y = e.y ? decode(e.y) : 0.f;  v.y = v.y <= -5e29f ? 0.f : v.y;
  v.z = e.z ? decode(e.z) : 0.f;  v.z = v.z <= -5e29f ? 0.f : v.z;
  v.w = e.w ? decode(e.w) : 0.f;  v.w = v.w <= -5e29f ? 0.f : v.w;
  reinterpret_cast<float4*>(buf)[i] = v;
}

__global__ void segment_max_gather_concat_kernel(
    const float* __restrict__ y, const float* __restrict__ pooled,
    const long long* __restrict__ seg, float* __restrict__ out, long long P,
    int C, long long n_seg, int relu) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * 2 * cq) return;
  const long long p = t / (2 * cq);
  const int q = (int)(t % (2 * cq));
  float4 v;
  if (q < cq) {
    v = reinterpret_cast<const float4*>(y + p * C)[q];
  } else {
    long long s = seg[p];
    s = s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
    v = __ldg(reinterpret_cast<const float4*>(pooled + s * C) + (q - cq));
  }
  if (relu) {                         // a NaN stays a NaN, as in the twin
    v.x = v.x < 0.f ? 0.f : v.x;
    v.y = v.y < 0.f ? 0.f : v.y;
    v.z = v.z < 0.f ? 0.f : v.z;
    v.w = v.w < 0.f ? 0.f : v.w;
  }
  reinterpret_cast<float4*>(out + p * 2 * C)[q] = v;
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// out [n_seg, C] fp32 doubles as the unsigned max buffer; C % 4 == 0.
extern "C" int tdv_segment_max(const float* y, const long long* seg,
                               const uint8_t* valid, float* out, long long P,
                               int C, long long n_seg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n4 = n_seg * C / 4;
  if (n4 == 0) return 0;
  unsigned* buf = reinterpret_cast<unsigned*>(out);
  segment_max_fill_kernel<<<blocks_for(n4), kThreads, 0, s>>>(
      reinterpret_cast<uint4*>(buf), n4);
  if (P > 0)
    segment_max_atomic_kernel<<<blocks_for(P * C), kThreads, 0, s>>>(
        y, seg, valid, buf, P, C, n_seg);
  segment_max_decode_kernel<<<blocks_for(n4), kThreads, 0, s>>>(buf, n4);
  return (int)cudaGetLastError();
}

extern "C" int tdv_gather_concat(const float* y, const float* pooled,
                                 const long long* seg, float* out,
                                 long long P, int C, long long n_seg,
                                 int relu, void* stream) {
  const long long total = P * 2 * (C / 4);
  if (total == 0) return 0;
  segment_max_gather_concat_kernel<<<blocks_for(total), kThreads, 0,
                                     (cudaStream_t)stream>>>(
      y, pooled, seg, out, P, C, n_seg, relu);
  return (int)cudaGetLastError();
}
