// take_along_axis: out[i, j] = values[k, j] (axis 0) or values[i, k]
// (axis 1) with k = idx[i, j], fp32 values and int32 indices, by
// jnp.take_along_axis's rule: an index in [-n, 0) counts from the end
// (k + n, n the values' extent along the axis) and one outside [-n, n)
// gives NaN.
//
// Replaces: the Mosaic probe kernels of tools/probe_mosaic_gather.py,
// `try_kernel` (:49-59) over `taa1` (:62-63, jnp.take_along_axis axis=1)
// and `taa0` (:66-67, axis=0), at the tool's cases: (8,128), (32,128),
// (8,384) and (14336,128) along axis 1; (8,128), (80,128) and 80 index rows
// into 5120 value rows along axis 0. On the TPU the shuffle had to stay
// inside one (8, 128) tile, and every case that crossed a tile failed to
// compile; on Hopper a gather is a load from any address.
//
// Bound on an H100: bytes (indices and output once, at most one value per
// index). Six of the seven cases move under 0.5 MB, so a call's time is
// its launch and the wrapper's host work: the wrapper used to check the
// index range with two reductions copied to the host (two syncs a call,
// 0.775 ms over the seven cases against torch.take_along_dim's 0.213 ms,
// H100 80GB HBM3 at 700 W). The range rule now lives here, so the wrapper
// checks only shapes and types and never waits for the card, and the
// shared launch path takes the raw current stream and leaves the device
// alone when it is current already.
//
// Design: each thread takes four consecutive columns of one index row
// when the row length is a multiple of 4 and the indices are 16-byte
// aligned (one int4 index load and one float4 store), else one element;
// neighbouring threads take neighbouring columns, so the index and output
// rows move coalesced, and along axis 0 the gathered values too (one value
// row per index row, column by column). Along axis 1 a row of values is
// read from L1/L2 by the row's threads.
//
// Measured (chip_smoke.py phase 10, H100 80GB HBM3, 700 W): the seven
// cases 0.127 ms against torch.take_along_dim's 0.178 ms in the same run
// (0.72x; its int64 index copy made outside its timing), still host-bound
// at 0.053 of the byte bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int AXIS>
__device__ __forceinline__ float gather(const float* __restrict__ values,
                                        int vcols, int n, int i, int j,
                                        int k) {
  if (k < 0) k += n;
  if ((unsigned)k >= (unsigned)n) return NAN;
  return AXIS == 0 ? __ldg(values + (long long)k * vcols + j)
                   : __ldg(values + (long long)i * vcols + k);
}

template <int AXIS>
__global__ void take_along_axis_vec4(const float* __restrict__ values,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int vcols,
                                     int n, int rows, int cols) {
  const int quads = cols >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * quads) return;
  const int i = (int)(t / quads);
  const int j = (int)(t - (long long)i * quads) << 2;
  const int4 k = __ldg(reinterpret_cast<const int4*>(idx) + t);
  float4 o;
  o.x = gather<AXIS>(values, vcols, n, i, j, k.x);
  o.y = gather<AXIS>(values, vcols, n, i, j + 1, k.y);
  o.z = gather<AXIS>(values, vcols, n, i, j + 2, k.z);
  o.w = gather<AXIS>(values, vcols, n, i, j + 3, k.w);
  reinterpret_cast<float4*>(out)[t] = o;
}

template <int AXIS>
__global__ void take_along_axis_scalar(const float* __restrict__ values,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int vcols,
                                       int n, int rows, int cols) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * cols) return;
  const int i = (int)(t / cols);
  const int j = (int)(t - (long long)i * cols);
  out[t] = gather<AXIS>(values, vcols, n, i, j, __ldg(idx + t));
}

}  // namespace

// vec: cols % 4 == 0 and idx 16-byte aligned (out is a fresh allocation)
extern "C" int tdv_take_along_axis(const float* values, const int32_t* idx,
                                   float* out, int vrows, int vcols, int rows,
                                   int cols, int axis, int vec,
                                   void* stream) {
  const long long items = (long long)rows * (vec ? cols / 4 : cols);
  if (items == 0) return 0;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  const int n = axis == 0 ? vrows : vcols;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (axis == 0)
      take_along_axis_vec4<0><<<blocks, threads, 0, s>>>(values, idx, out,
                                                         vcols, n, rows, cols);
    else
      take_along_axis_vec4<1><<<blocks, threads, 0, s>>>(values, idx, out,
                                                         vcols, n, rows, cols);
  } else {
    if (axis == 0)
      take_along_axis_scalar<0><<<blocks, threads, 0, s>>>(
          values, idx, out, vcols, n, rows, cols);
    else
      take_along_axis_scalar<1><<<blocks, threads, 0, s>>>(
          values, idx, out, vcols, n, rows, cols);
  }
  return (int)cudaGetLastError();
}
