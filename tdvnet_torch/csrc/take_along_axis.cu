// take_along_axis: out[i, j] = values[idx[i, j], j] (axis 0) or
// values[i, idx[i, j]] (axis 1), fp32 values and int32 indices.
//
// Replaces: the Mosaic probe kernels of tools/probe_mosaic_gather.py,
// `try_kernel` (:49-59) over `taa1` (:62-63, jnp.take_along_axis axis=1)
// and `taa0` (:66-67, axis=0), at the tool's cases: (8,128), (32,128),
// (8,384) and (14336,128) along axis 1; (8,128), (80,128) and 80 index rows
// into 5120 value rows along axis 0. On the TPU the shuffle had to stay
// inside one (8, 128) tile, and every case that crossed a tile failed to
// compile; on Hopper a gather is a load from any address.
//
// Bound on an H100: bytes (indices and output once, the values once); the
// probe's shapes are small, so its times are launch-bound.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring columns: the index and output rows are read and written
// coalesced, and along axis 0 the gathered values too (one row of
// values per index row, column by column). The wrapper checks the indices'
// range on the host; an index the check did not see gives NaN here rather
// than a read out of bounds.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void take_along_axis_kernel(const float* __restrict__ values,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int vrows,
                                       int vcols, int rows, int cols,
                                       int axis) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * cols) return;
  const int i = (int)(t / cols);
  const int j = (int)(t % cols);
  const int k = idx[t];
  const int n = axis == 0 ? vrows : vcols;
  if (k < 0 || k >= n) {
    out[t] = NAN;
    return;
  }
  out[t] = axis == 0 ? values[(long long)k * vcols + j]
                     : values[(long long)i * vcols + k];
}

}  // namespace

extern "C" int tdv_take_along_axis(const float* values, const int32_t* idx,
                                   float* out, int vrows, int vcols, int rows,
                                   int cols, int axis, void* stream) {
  const long long total = (long long)rows * cols;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  take_along_axis_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(values, idx, out, vrows,
                                                   vcols, rows, cols, axis);
  return (int)cudaGetLastError();
}
