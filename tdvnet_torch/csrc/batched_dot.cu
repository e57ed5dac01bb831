// batched_dot: a batch of small bf16 matrix products rounded once to bf16,
// O[b] = bf16(W[b] @ F[b]), W [B, Q, Y], F [B, Y, C], O [B, Q, C].
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
// (0.153 ms at 3.35 TB/s); its 7.93 GFLOP need 8 us of the bf16 tensor
// cores (~15 FLOP a byte, the card's balance is ~295). The first version
// (one block per product, W and F widened to fp32 in shared memory, an
// fmaf chain with two shared-memory loads per FMA) was bound by those
// loads: 1.053 ms, 6.9x the bound, against torch.matmul's 0.172 ms (H100
// 80GB HBM3, 700 W).
//
// Design: keep device memory busy and the arithmetic off its path.
// - Persistent blocks, as many an SM as fit (seven at the probe's shape):
//   block x walks the products b = x, x + gridDim.x, ... through a ring of
//   two shared-memory stages (deeper rings fit fewer blocks and ran
//   slower).
// - One producer warp loads: per product two TMA tensor copies (W[b] and
//   F[b], each one box of a 3-D tensor map) that complete on the stage's
//   `full` mbarrier. The maps swizzle each row of 16-byte chunks (128, 64
//   or 32 bytes: chunk c of row r lands at c ^ f(r)), so that the eight
//   rows one ldmatrix phase reads fall on distinct banks. Whole-box bulk
//   copies ran faster than per-thread 16-byte cp.async copies and than
//   bulk copies of single rows.
// - Four consumer warps compute: ldmatrix (.trans for F, stored k-major)
//   feeds mma.sync.m16n8k16 bf16 with fp32 accumulators; a warp takes one
//   16-row tile and up to 32 columns, rounds it into a staged output tile
//   and stores it with 16-byte stores (whole rows, so contiguous, when
//   C <= 32), then releases the stage on its `empty` mbarrier. Rows Q..15
//   of the last 16-row tile are zero and never written. Y and C are
//   template constants, so the k-loop unrolls and every swizzle folds.
// - Cancellation: two fp32 sums in different orders can round to bf16
//   values more than one ulp apart where the sum is small against its
//   terms (torch.matmul's own bf16 and fp32 calls do so on some elements
//   of the probe's shape: the probe tool counts them). A second mma on |W|
//   and |F| gives each element's sum of |terms| A; where |sum| < A / 4096
//   the warp recomputes the element exactly (float64 products, one per
//   lane and k, summed in float64), so the result is the exact sum
//   rounded to fp32 and then to bf16, as the twin rounds it. Elsewhere the
//   tensor cores' error, a few fp32 roundings of partial sums below A
//   (about 2^-21 A), stays under one bf16 ulp of the sum (over 2^-20 A).
// Shapes (the wrapper's `batched_dot_shape_error`): 1 <= Q <= 256,
// Y in {16, 32, 64}, C in {8, 16, 32, 64}, contiguous 16-byte aligned
// inputs: the row widths the tensor maps' swizzles cover.
//
// Measured (chip_smoke.py phase 10, H100 80GB HBM3, 700 W): 0.178 and
// 0.182 ms in two runs against torch.matmul's 0.171 ms in the same runs
// (1.04x and 1.06x), 0.86 and 0.84 of the byte bound; every element within
// one bf16 ulp of the twin, 0.999984 of them bit-equal. What keeps it
// from torch.matmul's time is not located: deeper rings, more consumer
// warps, other item widths, L2 promotion and cache hints, and bulk
// stores of the output were tried on the card and none closed the gap
// (PERF.md section 6).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// an element is recomputed exactly where |sum| < sum of |terms| / 4096
constexpr float kCancel = 1.0f / 4096.0f;
// a ring of two stages keeps a block's shared memory small (~30 KB at the
// probe's shape), so that seven blocks share an SM; four consumer warps
// take the probe's four 16-row tiles
constexpr int kStages = 2;
constexpr int kConsumers = 4;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// a row of n bf16 values padded to an odd count of 16-byte units
__host__ __device__ constexpr int padded(int n) {
  return n + (((n / 8) % 2 == 0) ? 8 : 0);
}

// bytes of one stage: the W tile (rows rounded up to 16) and the F tile,
// each at a 1024-byte boundary (the swizzle's period)
__host__ __device__ inline int stage_bytes(int Q, int Y, int C) {
  return round_up(round_up(Q, 16) * Y * 2, 1024) + round_up(Y * C * 2, 1024);
}

// the alignment slack, the stages, the output tile and two barriers a
// stage (at most 119840 bytes, at Q=256, Y=C=64)
__host__ inline size_t smem_bytes(int Q, int Y, int C) {
  return 1024 + (size_t)kStages * stage_bytes(Q, Y, C) +
         round_up(Q * padded(C) * 2, 16) + 16 * kStages;
}

// byte offset of chunk `chunk` (8 bf16 values) of row r in a tile whose
// rows are `pitch` bytes (16, 32, 64 or 128), as the tensor map's swizzle
// of the same width lays it out
__device__ __forceinline__ uint32_t swz(int r, int chunk, int pitch) {
  return r * pitch + ((chunk ^ ((r * pitch >> 7) & (pitch / 16 - 1))) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// d += a @ b on one m16n8k16 tile, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// both bf16 halves' sign bits cleared
__device__ __forceinline__ uint32_t abs2(uint32_t x) {
  return x & 0x7fff7fffu;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
      smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(tx));
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity));
}

// box (0, 0, b) of a 3-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         long long b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(0), "r"(0), "r"((int)b), "r"(smem_addr(bar))
      : "memory");
}

// One producer warp (warp kConsumers) and kConsumers consumer warps walk
// the products b = blockIdx.x + j * gridDim.x through a ring of kStages
// stages; consumer warp w takes the items (16-row tile, chunk of up to
// four 8-column tiles) w, w + kConsumers, ... of each product. Y and C are
// compile-time, so the k-loop unrolls and every swizzle is a constant.
template <int Y, int C>
__global__ void __launch_bounds__((kConsumers + 1) * 32)
    batched_dot_kernel(const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_f,
                       __nv_bfloat16* __restrict__ O, long long B, int Q) {
  constexpr int WP = 2 * Y, FP = 2 * C;  // row pitches in bytes
  constexpr int S = kStages, NW = kConsumers;
  constexpr int NT = C / 8, TILES = NT < 4 ? NT : 4, NCH = NT / TILES;
  constexpr int Cp = padded(C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t base = smem_addr(smem);
  const int Qm = round_up(Q, 16);
  const int w_bytes = round_up(Qm * WP, 1024);
  const int stage = stage_bytes(Q, Y, C);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem + S * stage);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S * stage + round_up(Q * Cp * 2, 16));
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // rows Q..Qm-1 of every W tile: zero once, no copy ever writes them
  for (int s = 0; s < S; ++s)
    for (int i = tid; i < (Qm - Q) * WP / 4; i += (NW + 1) * 32)
      reinterpret_cast<uint32_t*>(smem + s * stage + Q * WP)[i] = 0u;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  }
  __syncthreads();

  const long long first = blockIdx.x, step = gridDim.x;
  const long long n_mine = first < B ? (B - 1 - first) / step + 1 : 0;

  if (warp == NW) {  // the producer
    if (lane == 0)
      for (long long j = 0; j < n_mine; ++j) {
        const int s = (int)(j % S);
        mbar_wait(empty + s, ((uint32_t)(j / S) & 1) ^ 1);
        mbar_expect_tx(full + s, (uint32_t)(Q * WP + Y * FP));
        tma_load(base + s * stage, &map_w, first + j * step, full + s);
        tma_load(base + s * stage + w_bytes, &map_f, first + j * step,
                 full + s);
      }
    return;
  }

  const int MT = Qm / 16;
  const int g = lane >> 2, c4 = lane & 3;
  for (long long j = 0; j < n_mine; ++j) {
    const int s = (int)(j % S);
    mbar_wait(full + s, (uint32_t)(j / S) & 1);
    const uint32_t Wb = base + s * stage, Fb = Wb + w_bytes;
    const unsigned char* Wg = smem + s * stage;
    const unsigned char* Fg = Wg + w_bytes;
    __nv_bfloat16* Ob = O + (first + j * step) * Q * C;

    for (int item = warp; item < MT * NCH; item += NW) {
      const int mt = item / NCH, t0 = TILES * (item - mt * NCH);
      float acc[TILES][4] = {}, mag[TILES][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < Y; k0 += 16) {
        uint32_t a[4], aa[4];
        ldmatrix_x4(a, Wb + swz(mt * 16 + (lane & 15), k0 / 8 + (lane >> 4),
                                WP));
#pragma unroll
        for (int i = 0; i < 4; ++i) aa[i] = abs2(a[i]);
        const int kr = k0 + (lane & 15);
#pragma unroll
        for (int t = 0; t < TILES; t += 2) {
          uint32_t b[4] = {};
          if (t + 1 < TILES)
            ldmatrix_x4_trans(b, Fb + swz(kr, t0 + t + (lane >> 4), FP));
          else
            ldmatrix_x2_trans(b, Fb + swz(kr, t0 + t, FP));
          mma_bf16(acc[t], a, b[0], b[1]);
          mma_bf16(mag[t], aa, abs2(b[0]), abs2(b[1]));
          if (t + 1 < TILES) {
            mma_bf16(acc[t + 1], a, b[2], b[3]);
            mma_bf16(mag[t + 1], aa, abs2(b[2]), abs2(b[3]));
          }
        }
      }

      // lane (g, c4) holds rows g and g + 8, columns 2 c4 and 2 c4 + 1 of
      // each 8-column tile: round them into the output tile, and mark in
      // `todo` (bit 4 t + e) the elements whose sum cancels
      const int r0 = mt * 16 + g;
      unsigned todo = 0;
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int col = (t0 + t) * 8 + c4 * 2;
        if (r0 < Q)
          *reinterpret_cast<__nv_bfloat162*>(Os + r0 * Cp + col) =
              __floats2bfloat162_rn(acc[t][0], acc[t][1]);
        if (r0 + 8 < Q)
          *reinterpret_cast<__nv_bfloat162*>(Os + (r0 + 8) * Cp + col) =
              __floats2bfloat162_rn(acc[t][2], acc[t][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (r0 + (e >> 1) * 8 < Q && fabsf(acc[t][e]) < kCancel * mag[t][e])
            todo |= 1u << (4 * t + e);
      }
      // recompute each marked element exactly, the whole warp on one: a
      // float64 product per lane and k, summed in float64, rounded to fp32
      // and then to bf16 over the tensor cores' value
      for (unsigned who = __ballot_sync(0xffffffffu, todo); who;
           who = __ballot_sync(0xffffffffu, todo)) {
        const int src = __ffs(who) - 1;
        const int bit = __shfl_sync(0xffffffffu, __ffs(todo) - 1, src);
        const int t = bit >> 2, e = bit & 3;
        const int q = mt * 16 + (src >> 2) + (e >> 1) * 8;
        const int c = (t0 + t) * 8 + (src & 3) * 2 + (e & 1);
        double part = 0.0;
#pragma unroll
        for (int k = lane; k < Y; k += 32) {
          const __nv_bfloat16 w = *reinterpret_cast<const __nv_bfloat16*>(
              Wg + swz(q, k >> 3, WP) + (k & 7) * 2);
          const __nv_bfloat16 f = *reinterpret_cast<const __nv_bfloat16*>(
              Fg + swz(k, c >> 3, FP) + (c & 7) * 2);
          part = fma((double)__bfloat162float(w), (double)__bfloat162float(f),
                     part);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == src) {
          Os[q * Cp + c] = __float2bfloat16_rn((float)part);
          todo &= todo - 1;
        }
      }
      __syncwarp();
      // the item's rows, TILES 16-byte chunks each (whole rows, so
      // contiguous, when the item spans C)
      const int rows = min(16, Q - mt * 16);
      for (int i = lane; i < rows * TILES; i += 32) {
        const int q = mt * 16 + i / TILES, c = (t0 + i % TILES) * 8;
        *reinterpret_cast<int4*>(Ob + (long long)q * C + c) =
            *reinterpret_cast<const int4*>(Os + q * Cp + c);
      }
      __syncwarp();
    }
    // this warp has read stage s for the last time
    if (lane == 0) mbar_arrive(empty + s);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled = nullptr;

// a 3-D map over [B, rows, width] bf16 whose box is one [rows, width]
// matrix, rows swizzled at their width
int make_map(CUtensorMap* map, const void* p, int width, int rows,
             long long B) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
      : width == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                    : CU_TENSOR_MAP_SWIZZLE_NONE;
  return (int)encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                           const_cast<void*>(p), dims, strides, box,
                           elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int Y, int C>
int launch(const CUtensorMap& map_w, const CUtensorMap& map_f, void* O,
           long long B, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, Y, C);
  auto kernel = batched_dot_kernel<Y, C>;
  const int threads = (kConsumers + 1) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)sms * per_sm;
  if (grid > B) grid = B;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(map_w, map_f,
                                                    (__nv_bfloat16*)O, B, Q);
  return (int)cudaGetLastError();
}

template <int Y>
int launch_y(const CUtensorMap& map_w, const CUtensorMap& map_f, void* O,
             long long B, int Q, int C, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<Y, 8>(map_w, map_f, O, B, Q, stream);
    case 16: return launch<Y, 16>(map_w, map_f, O, B, Q, stream);
    case 32: return launch<Y, 32>(map_w, map_f, O, B, Q, stream);
    case 64: return launch<Y, 64>(map_w, map_f, O, B, Q, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tdv_batched_dot(const void* Wm, const void* Fm, void* O,
                               long long B, int Q, int Y, int C,
                               void* stream) {
  if (B == 0) return 0;
  if (Q < 1 || Q > 256 || (Y != 16 && Y != 32 && Y != 64) ||
      (C != 8 && C != 16 && C != 32 && C != 64) || B >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!encode_tiled) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode_tiled, cudaEnableDefault,
        &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !encode_tiled)
      return (int)cudaErrorSymbolNotFound;
  }
  CUtensorMap map_w, map_f;
  if (make_map(&map_w, Wm, Y, Q, B) || make_map(&map_f, Fm, C, Y, B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Y) {
    case 16: return launch_y<16>(map_w, map_f, O, B, Q, C, s);
    case 32: return launch_y<32>(map_w, map_f, O, B, Q, C, s);
    case 64: return launch_y<64>(map_w, map_f, O, B, Q, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
