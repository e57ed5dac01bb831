// batched_dot: a batch of small matrix products in bf16 with fp32 sums and
// one rounding to bf16, O[b] = bf16(W[b] @ F[b]).
//
// Replaces: the Mosaic probe kernels of tools/probe_mosaic_batched_dot.py,
// `pallas_batched2` (:119-133, an in-cell batched dot_general with
// preferred_element_type=float32 then astype(bfloat16)) and `pallas_loop`
// (:147-161, the same contraction as a fori_loop of dots over x), which
// equal each other in real arithmetic; `pallas_batched` (:96-110, defined
// but never timed by the tool) asks for a bf16 result type and is the same
// contraction. The probe's shape: NB=432 cells x X=80 products of
// [56, 64] @ [64, 32] (the pass-1 products of the two-pass warp).
//
// Bound on an H100: bytes. W, F and O are 513 MB at the probe's shape
// (~0.15 ms at 3.35 TB/s); its 7.9 GFLOP are far under the bf16 tensor-core
// peak.
//
// Design: one block per product b. The block stages W[b] and F[b] in
// shared memory as fp32 (22 KB at the probe's shape), and each thread
// computes output elements o = tid, tid + blockDim, ... with an fp32 fma
// chain over k in order; one warp covers 32 consecutive columns of one row,
// so W's element is a shared-memory broadcast and F's row is read without
// bank conflicts. No tensor cores: mma.sync or wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void batched_dot_kernel(const __nv_bfloat16* __restrict__ Wm,
                                   const __nv_bfloat16* __restrict__ Fm,
                                   __nv_bfloat16* __restrict__ O, int Q, int Y,
                                   int C) {
  extern __shared__ float smem[];
  float* Ws = smem;           // [Q, Y]
  float* Fs = smem + Q * Y;   // [Y, C]
  const long long b = blockIdx.x;
  const __nv_bfloat16* Wb = Wm + b * Q * Y;
  const __nv_bfloat16* Fb = Fm + b * Y * C;
  for (int i = threadIdx.x; i < Q * Y; i += blockDim.x)
    Ws[i] = __bfloat162float(Wb[i]);
  for (int i = threadIdx.x; i < Y * C; i += blockDim.x)
    Fs[i] = __bfloat162float(Fb[i]);
  __syncthreads();
  __nv_bfloat16* Ob = O + b * Q * C;
  for (int o = threadIdx.x; o < Q * C; o += blockDim.x) {
    const int q = o / C;
    const int c = o % C;
    const float* wr = Ws + q * Y;
    float acc = 0.f;
    for (int k = 0; k < Y; ++k) acc = fmaf(wr[k], Fs[k * C + c], acc);
    Ob[o] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

extern "C" int tdv_batched_dot(const void* Wm, const void* Fm, void* O,
                               long long B, int Q, int Y, int C,
                               void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)(Q * Y + Y * C) * sizeof(float);
  batched_dot_kernel<<<(unsigned)B, 256, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)Wm, (const __nv_bfloat16*)Fm, (__nv_bfloat16*)O,
      Q, Y, C);
  return (int)cudaGetLastError();
}
