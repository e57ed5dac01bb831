// block_exclusive_scan: the exclusive prefix sum of one int per thread over
// a block of NT threads (a multiple of 32, at most 1024), shared by the
// kernels that rank cells (voxelize.cu) and bin points into bricks
// (trilinear_sample_backward.cu).
#pragma once

namespace tdv {

// Exclusive scan of `v` over the block; `*total` gets the block's sum.
// `smem` holds 33 ints and is free again when the call returns.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem,
                                                    int* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(full, inc, d);
    if (lane >= d) inc += n;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NT / 32 ? smem[lane] : 0;
    int winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(full, winc, d);
      if (lane >= d) winc += n;
    }
    if (lane < NT / 32) smem[lane] = winc - w;
    if (lane == 31) smem[32] = winc;
  }
  __syncthreads();
  const int out = inc - v + smem[warp];
  *total = smem[32];
  __syncthreads();
  return out;
}

}  // namespace tdv
