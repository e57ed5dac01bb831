// scatter_dense_backward: the gradient of the scatter of anchor rows into
// the dense scene grid (voxelize.cu's scatter) with respect to the anchor
// features.
//
// Replaces: the VJP that JAX derives for tdvnet/ops/voxelize.py
// `scatter_anchors_to_dense` (:124-151): the transpose of its
// `segment_sum` over unique cell keys is a gather of the grid's gradient at
// each anchor's cell, with the dump row (invalid anchors) sliced off.
// Occupancy takes no gradient.
//
// Bound on an H100: bytes. At the train step's shape (A = 16384 anchors,
// C = 64, a [2, 64, 64, 64, 64] grid) it reads the A rows it needs
// (4 MB) and the anchor table, and writes [A, C] (4 MB): ~2.5 us at
// 3.35 TB/s. The grid's other cells are never read.
//
// Design: one thread per (anchor, 4 channels), C/4 neighbouring threads on
// one anchor, so each thread moves one 16-byte vector from its cell's
// contiguous row; an invalid anchor writes zeros. Keys are unique, so
// there is nothing to sum: deterministic, and bit-equal to the twin.
//
// The bf16 form (tdv_scatter_dense_backward_bf16, a bf16 model's grid in
// training) is the same kernel on bf16 storage, four channels (8 bytes) a
// thread: a copy, bit-equal to its twin. Bound: half the fp32 form's bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;

// V: four channels of the rows (float4, or uint2 for four bf16)
template <typename V>
__global__ void scatter_dense_backward_kernel(
    const V* __restrict__ grad_dense,           // [B, gx, gy, gz, C]
    const long long* __restrict__ anchor_idx3,  // [A, 3]
    const long long* __restrict__ anchor_scene, // [A]
    const uint8_t* __restrict__ anchor_valid,   // [A]
    V* __restrict__ grad_feats,                 // [A, C]
    int A, int C, int gx, int gy, int gz) {
  const int cq = C >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)A * cq) return;
  const int a = (int)(t / cq), q = (int)(t % cq);
  V v{};
  if (anchor_valid[a]) {
    const long long seg =
        anchor_scene[a] * ((long long)gx * gy * gz) +
        (anchor_idx3[a * 3LL] * gy + anchor_idx3[a * 3LL + 1]) * gz +
        anchor_idx3[a * 3LL + 2];
    v = __ldg(grad_dense + seg * cq + q);
  }
  grad_feats[(long long)a * cq + q] = v;
}

template <typename V>
int scatter_dense_backward(const V* grad_dense, const long long* anchor_idx3,
                           const long long* anchor_scene,
                           const uint8_t* anchor_valid, V* grad_feats, int A,
                           int C, int gx, int gy, int gz, void* stream) {
  const long long total = (long long)A * (C / 4);
  if (total == 0) return 0;
  scatter_dense_backward_kernel<V><<<(unsigned)((total + kThreads - 1) /
                                                kThreads),
                                     kThreads, 0, (cudaStream_t)stream>>>(
      grad_dense, anchor_idx3, anchor_scene, anchor_valid, grad_feats, A, C,
      gx, gy, gz);
  return (int)cudaGetLastError();
}

}  // namespace

// grad_feats [A, C] is written whole; C % 4 == 0.
extern "C" int tdv_scatter_dense_backward(
    const float* grad_dense, const long long* anchor_idx3,
    const long long* anchor_scene, const uint8_t* anchor_valid,
    float* grad_feats, int A, int C, int gx, int gy, int gz, void* stream) {
  return scatter_dense_backward(
      reinterpret_cast<const float4*>(grad_dense), anchor_idx3, anchor_scene,
      anchor_valid, reinterpret_cast<float4*>(grad_feats), A, C, gx, gy, gz,
      stream);
}

// the same on a bf16 grid gradient and bf16 anchor rows
extern "C" int tdv_scatter_dense_backward_bf16(
    const void* grad_dense, const long long* anchor_idx3,
    const long long* anchor_scene, const uint8_t* anchor_valid,
    void* grad_feats, int A, int C, int gx, int gy, int gz, void* stream) {
  return scatter_dense_backward(
      static_cast<const uint2*>(grad_dense), anchor_idx3, anchor_scene,
      anchor_valid, static_cast<uint2*>(grad_feats), A, C, gx, gy, gz,
      stream);
}
