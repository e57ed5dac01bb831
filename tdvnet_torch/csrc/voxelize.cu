// voxelize: quantize a batched point cloud into per-scene voxel grids,
// number the occupied cells as compact anchors, and scatter anchor rows
// into the dense grid.
//
// Replaces: tdvnet/ops/voxelize.py `scene_origins` (:51-57), `voxelize`
// (:60-121) and `scatter_anchors_to_dense` (:124-151). The TPU op sorts the
// point keys because XLA needs static shapes and sorted segments. Anchors
// are numbered in ascending key order, and the key space is the dense grid
// itself (at most B*gx*gy*gz cells), so here the rank of a cell among the
// occupied cells IS its anchor id: mark, prefix-sum, look up. No sort, and
// points stay in their input order.
//
// Bound on an H100: bytes. The points (12 B each) and the per-point outputs
// (9 B) are small; the traffic is the cell array (4 B per cell, zeroed,
// marked, scanned in two passes) and the anchor table (61 B per anchor).
// The scatter's bound is its dense output: `dense` and `occ` written once
// (4 (C + 1) B per cell: 136 MB for two 64^3 grids of 64 channels, 0.041 ms
// at 3.35 TB/s) beside the anchor rows read once (4 MB).
//
// Design:
//   origins   atomic min on the order-preserving integer image of each
//             coordinate, one atomic per warp and axis when the warp's
//             points share a scene (they do: a ref's points are contiguous);
//   cells     one thread per point: IEEE subtraction and division, floor,
//             bounds tested on the float before any float-to-int conversion
//             (a NaN coordinate fails them and is invalid), key stored per
//             point, cell marked; out-of-grid points counted per warp;
//   scan      exclusive prefix sum over the marks, written by hand: tile
//             sums, one block scanning the tile sums, tiles rescanned with
//             their offset. The rescan writes each occupied cell's rank in
//             place and, for ranks below the capacity, the anchor's cell
//             coordinates, scene, centre and validity;
//   tail      anchors past the number of occupied cells get the reference's
//             defaults (cell 0 of scene 0, invalid);
//   assign    one thread per point: anchor id = rank of its cell, or the
//             dump slot when the point is invalid or the rank reaches the
//             capacity; overflowing points counted per warp;
//   scatter   writes every byte of `dense` and `occ` once, into
//             uninitialised outputs: a cell -> anchor map (4 B a cell) that
//             each valid anchor writes once (keys are unique, so no store
//             competes), then one streaming pass over (cell, 4 channels)
//             that stores the anchor's row or zeros, the occupancy in the
//             same pass. The map is never filled: a cell takes the anchor
//             its entry names only if that anchor is valid and lies in this
//             cell (a sparse set), so whatever the memory held before reads
//             as "no anchor" unless it names the right one. No zero fill of
//             the grid or the map, no second write of the occupied rows;
//             nothing assumes the anchor table's order.
// Every float result uses explicit round-to-nearest intrinsics so that no
// multiply-add is contracted: origins, centres and the anchor set equal the
// plain PyTorch twin bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 4;                       // cells per thread
constexpr int kScanTile = kThreads * kScanItems;    // cells per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

__device__ __forceinline__ int float_to_ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// ------------------------------------------------------------------ origins
__global__ void voxelize_origin_init_kernel(int* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = float_to_ordered(kBig);
}

__global__ void voxelize_origin_min_kernel(
    const float* __restrict__ pts, const long long* __restrict__ pt_scene,
    const uint8_t* __restrict__ pt_valid, int* __restrict__ keys,
    long long P, int B) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long sc = -1;
  bool v = false;
  if (p < P) {
    sc = pt_scene[p];
    v = pt_valid[p] != 0 && sc >= 0 && sc < B;
  }
  int k[3] = {INT_MAX, INT_MAX, INT_MAX};
  if (v) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = pts[p * 3 + a];
      // a NaN coordinate makes the minimum NaN in the reference, which then
      // falls back to 0: INT_MIN decodes to a NaN
      k[a] = isnan(x) ? INT_MIN : float_to_ordered(x);
    }
  }
  const unsigned has = __ballot_sync(kFull, v);
  if (has == 0) return;
  const long long sc0 = __shfl_sync(kFull, sc, __ffs(has) - 1);
  const bool uniform = __all_sync(kFull, !v || sc == sc0);
  if (uniform) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int m = __reduce_min_sync(kFull, k[a]);
      if ((threadIdx.x & 31) == 0) atomicMin(&keys[sc0 * 3 + a], m);
    }
  } else if (v) {
#pragma unroll
    for (int a = 0; a < 3; ++a) atomicMin(&keys[sc * 3 + a], k[a]);
  }
}

__global__ void voxelize_origin_final_kernel(const int* __restrict__ keys,
                                             float* __restrict__ origins,
                                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float m = ordered_to_float(keys[i]);
  origins[i] = (isfinite(m) && m < kBig) ? m : 0.f;
}

// -------------------------------------------------------------------- cells
__global__ void voxelize_cell_kernel(
    const float* __restrict__ pts, const long long* __restrict__ pt_scene,
    const uint8_t* __restrict__ pt_valid, const float* __restrict__ origins,
    int* __restrict__ cell, int* __restrict__ pkey,
    uint8_t* __restrict__ point_valid, unsigned long long* __restrict__ counters,
    long long P, int B, int gx, int gy, int gz, float edge) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool out_of_grid = false;
  if (p < P) {
    const long long sc = pt_scene[p];
    const bool v_in = pt_valid[p] != 0;
    bool in_grid = false;
    int key = -1;
    if (sc >= 0 && sc < B) {
      const float fx = floorf(__fdiv_rn(
          __fsub_rn(pts[p * 3 + 0], origins[sc * 3 + 0]), edge));
      const float fy = floorf(__fdiv_rn(
          __fsub_rn(pts[p * 3 + 1], origins[sc * 3 + 1]), edge));
      const float fz = floorf(__fdiv_rn(
          __fsub_rn(pts[p * 3 + 2], origins[sc * 3 + 2]), edge));
      in_grid = fx >= 0.f && fx < (float)gx && fy >= 0.f && fy < (float)gy &&
                fz >= 0.f && fz < (float)gz;
      if (in_grid && v_in)
        key = (int)sc * (gx * gy * gz) + ((int)fx * gy + (int)fy) * gz +
              (int)fz;
    }
    pkey[p] = key;
    point_valid[p] = key >= 0;
    if (key >= 0) cell[key] = 1;      // every writer stores the same value
    out_of_grid = v_in && !in_grid;
  }
  const unsigned n = __popc(__ballot_sync(kFull, out_of_grid));
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&counters[0], n);
}

// --------------------------------------------------------------------- scan
using tdv::block_exclusive_scan;

__global__ void voxelize_scan_reduce_kernel(const int* __restrict__ cell,
                                            int* __restrict__ tile_sums,
                                            int n_cells_all) {
  __shared__ int smem[33];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (base + i < n_cells_all) s += cell[base + i];
  int total;
  block_exclusive_scan<kThreads>(s, smem, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: tile_sums[0..n_tiles) -> exclusive offsets in place, the
// number of occupied cells in tile_sums[n_tiles]
__global__ void voxelize_scan_sums_kernel(int* __restrict__ tile_sums,
                                          int n_tiles) {
  __shared__ int smem[33];
  int carry = 0;
  for (int base = 0; base < n_tiles; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? tile_sums[i] : 0;
    int total;
    const int ex = block_exclusive_scan<1024>(v, smem, &total);
    if (i < n_tiles) tile_sums[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) tile_sums[n_tiles] = carry;
}

__global__ void voxelize_scan_apply_kernel(
    int* __restrict__ cell, const int* __restrict__ tile_sums,
    const float* __restrict__ origins, long long* __restrict__ anchor_idx3,
    long long* __restrict__ anchor_scene, float* __restrict__ anchor_center,
    uint8_t* __restrict__ anchor_valid, int n_cells_all, int gx, int gy,
    int gz, float edge, int max_anchors) {
  __shared__ int smem[33];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int f[kScanItems];
  int s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    f[i] = base + i < n_cells_all ? cell[base + i] : 0;
    s += f[i];
  }
  int total;
  int rank = block_exclusive_scan<kThreads>(s, smem, &total) +
             tile_sums[blockIdx.x];
  const int n_cells = gx * gy * gz;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (!f[i]) continue;
    const int key = base + i;
    cell[key] = rank;
    if (rank < max_anchors) {
      const int sc = key / n_cells, flat = key % n_cells;
      const int idx[3] = {flat / (gy * gz), (flat / gz) % gy, flat % gz};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        anchor_idx3[(long long)rank * 3 + a] = idx[a];
        anchor_center[(long long)rank * 3 + a] = __fadd_rn(
            origins[sc * 3 + a],
            __fmul_rn(__fadd_rn((float)idx[a], 0.5f), edge));
      }
      anchor_scene[rank] = sc;
      anchor_valid[rank] = 1;
    }
    ++rank;
  }
}

__global__ void voxelize_anchor_tail_kernel(
    const int* __restrict__ n_occupied, const float* __restrict__ origins,
    long long* __restrict__ anchor_idx3, long long* __restrict__ anchor_scene,
    float* __restrict__ anchor_center, uint8_t* __restrict__ anchor_valid,
    float edge, int max_anchors) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= max_anchors || a < *n_occupied) return;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    anchor_idx3[(long long)a * 3 + i] = 0;
    anchor_center[(long long)a * 3 + i] =
        __fadd_rn(origins[i], __fmul_rn(0.5f, edge));
  }
  anchor_scene[a] = 0;
  anchor_valid[a] = 0;
}

// ------------------------------------------------------------------- assign
__global__ void voxelize_assign_kernel(
    const int* __restrict__ pkey, const int* __restrict__ cell,
    long long* __restrict__ point2anchor,
    unsigned long long* __restrict__ counters, long long P,
    int max_anchors) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool overflow = false;
  if (p < P) {
    const int key = pkey[p];
    int a = max_anchors;
    if (key >= 0) {
      const int r = cell[key];
      if (r < max_anchors) a = r;
      else overflow = true;
    }
    point2anchor[p] = a;
  }
  const unsigned n = __popc(__ballot_sync(kFull, overflow));
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&counters[1], n);
}

// ------------------------------------------------------------------ scatter
__global__ void voxelize_scatter_map_kernel(
    const long long* __restrict__ anchor_idx3,
    const long long* __restrict__ anchor_scene,
    const uint8_t* __restrict__ anchor_valid, int* __restrict__ cell_anchor,
    int A, int gx, int gy, int gz) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A || !anchor_valid[a]) return;
  const long long seg =
      anchor_scene[a] * ((long long)gx * gy * gz) +
      (anchor_idx3[a * 3LL] * gy + anchor_idx3[a * 3LL + 1]) * gz +
      anchor_idx3[a * 3LL + 2];
  cell_anchor[seg] = a;
}

// one thread per (cell, 4 channels), consecutive items on neighbouring
// threads (a warp's stores cover one contiguous stretch of `dense`, and the
// blocks sweep the output in order); streaming stores (the output is not
// read again here); 32-bit indices: n_cells * C / 4 < 2^31. Measured
// against variants on the H100 (PERF.md, PR 8): several items a thread, a
// grid-stride loop or plain stores were 10-45% slower.
// V: four channels of the grid (float4, or uint2 for four bf16); O: an
// occupancy element (float, or the bits of a bf16). The bf16 form is a
// copy too: bit-equal to the JAX package's bf16 `segment_sum` (each cell
// takes at most one anchor row), with half the fp32 form's bytes.
template <typename V> __device__ __forceinline__ V zero4();
template <> __device__ __forceinline__ float4 zero4<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ uint2 zero4<uint2>() {
  return make_uint2(0u, 0u);
}
__device__ __forceinline__ float one_if(bool hit, float*) {
  return hit ? 1.f : 0.f;
}
__device__ __forceinline__ unsigned short one_if(bool hit,
                                                 unsigned short*) {
  return hit ? (unsigned short)0x3f80u : (unsigned short)0u;  // bf16 1.0
}

template <typename V, typename O>
__global__ void __launch_bounds__(kThreads) voxelize_scatter_stream_kernel(
    const V* __restrict__ feats, const int* __restrict__ cell_anchor,
    const long long* __restrict__ anchor_idx3,
    const long long* __restrict__ anchor_scene,
    const uint8_t* __restrict__ anchor_valid, V* __restrict__ dense,
    O* __restrict__ occ, unsigned n, unsigned cq, int A, int gx, int gy,
    int gz) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const unsigned cell = t / cq, q = t - cell * cq;
  const int a = __ldg(cell_anchor + cell);
  bool hit = false;
  if (a >= 0 && a < A && __ldg(anchor_valid + a))
    hit = __ldg(anchor_scene + a) * ((long long)gx * gy * gz) +
              (__ldg(anchor_idx3 + 3LL * a) * gy +
               __ldg(anchor_idx3 + 3LL * a + 1)) * gz +
              __ldg(anchor_idx3 + 3LL * a + 2) ==
          (long long)cell;
  const V v = hit ? __ldg(feats + (size_t)a * cq + q) : zero4<V>();
  __stcs(dense + t, v);
  if (q == 0) __stcs(occ + cell, one_if(hit, occ));
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int tdv_scene_origins(const float* pts, const long long* pt_scene,
                                 const uint8_t* pt_valid, int* keys,
                                 float* origins, long long P, int B,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = 3 * B;
  if (n == 0) return 0;
  voxelize_origin_init_kernel<<<blocks_for(n), kThreads, 0, s>>>(keys, n);
  if (P > 0)
    voxelize_origin_min_kernel<<<blocks_for(P), kThreads, 0, s>>>(
        pts, pt_scene, pt_valid, keys, P, B);
  voxelize_origin_final_kernel<<<blocks_for(n), kThreads, 0, s>>>(keys,
                                                                 origins, n);
  return (int)cudaGetLastError();
}

// `cell` [B*gx*gy*gz] and `counters` [2] arrive zeroed; `tile_sums` holds
// ceil(B*gx*gy*gz / 1024) + 1 ints.
extern "C" int tdv_voxelize(
    const float* pts, const long long* pt_scene, const uint8_t* pt_valid,
    const float* origins, int* cell, int* tile_sums, int* pkey,
    long long* point2anchor, uint8_t* point_valid, long long* anchor_idx3,
    long long* anchor_scene, float* anchor_center, uint8_t* anchor_valid,
    unsigned long long* counters, long long P, int B, int gx, int gy, int gz,
    float edge, int max_anchors, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_cells_all = B * gx * gy * gz;
  const int n_tiles = (n_cells_all + kScanTile - 1) / kScanTile;
  if (P > 0)
    voxelize_cell_kernel<<<blocks_for(P), kThreads, 0, s>>>(
        pts, pt_scene, pt_valid, origins, cell, pkey, point_valid, counters,
        P, B, gx, gy, gz, edge);
  if (n_tiles > 0)
    voxelize_scan_reduce_kernel<<<n_tiles, kThreads, 0, s>>>(cell, tile_sums,
                                                             n_cells_all);
  voxelize_scan_sums_kernel<<<1, 1024, 0, s>>>(tile_sums, n_tiles);
  if (n_tiles > 0)
    voxelize_scan_apply_kernel<<<n_tiles, kThreads, 0, s>>>(
        cell, tile_sums, origins, anchor_idx3, anchor_scene, anchor_center,
        anchor_valid, n_cells_all, gx, gy, gz, edge, max_anchors);
  if (max_anchors > 0)
    voxelize_anchor_tail_kernel<<<blocks_for(max_anchors), kThreads, 0, s>>>(
        tile_sums + n_tiles, origins, anchor_idx3, anchor_scene,
        anchor_center, anchor_valid, edge, max_anchors);
  if (P > 0)
    voxelize_assign_kernel<<<blocks_for(P), kThreads, 0, s>>>(
        pkey, cell, point2anchor, counters, P, max_anchors);
  return (int)cudaGetLastError();
}

// `dense` [B*gx*gy*gz, C], `occ` [B*gx*gy*gz] and the scratch `cell_anchor`
// [B*gx*gy*gz] arrive uninitialised (the scratch stays so where no anchor
// lies); every element of the first two is written once. C % 4 == 0 and
// B*gx*gy*gz * C / 4 < 2^31.
namespace {

template <typename V, typename O>
int scatter_dense(const V* feats, const long long* anchor_idx3,
                  const long long* anchor_scene, const uint8_t* anchor_valid,
                  V* dense, O* occ, int* cell_anchor, int A, int C,
                  int n_scenes, int gx, int gy, int gz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_cells = (long long)n_scenes * gx * gy * gz;
  const int cq = C / 4;
  const long long n = n_cells * cq;
  if (n == 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (A > 0)
    voxelize_scatter_map_kernel<<<blocks_for(A), kThreads, 0, s>>>(
        anchor_idx3, anchor_scene, anchor_valid, cell_anchor, A, gx, gy, gz);
  voxelize_scatter_stream_kernel<V, O><<<blocks_for(n), kThreads, 0, s>>>(
      feats, cell_anchor, anchor_idx3, anchor_scene, anchor_valid, dense,
      occ, (unsigned)n, (unsigned)cq, A, gx, gy, gz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdv_scatter_dense(const float* feats,
                                 const long long* anchor_idx3,
                                 const long long* anchor_scene,
                                 const uint8_t* anchor_valid, float* dense,
                                 float* occ, int* cell_anchor, int A, int C,
                                 int n_scenes, int gx, int gy, int gz,
                                 void* stream) {
  return scatter_dense(reinterpret_cast<const float4*>(feats), anchor_idx3,
                       anchor_scene, anchor_valid,
                       reinterpret_cast<float4*>(dense), occ, cell_anchor, A,
                       C, n_scenes, gx, gy, gz, stream);
}

// bf16 anchor rows into a bf16 grid and occupancy
extern "C" int tdv_scatter_dense_bf16(const void* feats,
                                      const long long* anchor_idx3,
                                      const long long* anchor_scene,
                                      const uint8_t* anchor_valid,
                                      void* dense, void* occ,
                                      int* cell_anchor, int A, int C,
                                      int n_scenes, int gx, int gy, int gz,
                                      void* stream) {
  return scatter_dense(static_cast<const uint2*>(feats), anchor_idx3,
                       anchor_scene, anchor_valid, static_cast<uint2*>(dense),
                       static_cast<unsigned short*>(occ), cell_anchor, A, C,
                       n_scenes, gx, gy, gz, stream);
}
