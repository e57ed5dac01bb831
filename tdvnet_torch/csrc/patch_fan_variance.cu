// patch_fan_variance: masked image-feature variance over each ref view's
// sources of every depth hypothesis of a pixel, each hypothesis sampled from
// one 4x4 patch per (pixel, source) around the centre hypothesis (the fast
// path's PointFlow variance).
//
// Replaces: tdvnet/ops/costvolume.py `hypothesis_patch_variance` (:180-230)
// over tdvnet/ops/sampling.py `pack_bilinear_patches` and
// `patch_sample_hypotheses` (:117-196), reached from
// tdvnet/models/threedvnet.py `run_pointflow` (:195-202). The 16C-wide patch
// table exists because the TPU's gather costs per row; here the kernel reads
// the unpacked [N, Hf, Wf, C] feature maps, which gives the same taps.
//
// Bound on an H100: in the contract's count, bytes: one chunk pass writes
// [16, 7, 3136, 32] fp32 (45 MB, ~0.019 ms at 3.35 TB/s) and reads 4.2 MB
// of points; the maps (20 x 64 x 80 x 32 fp32, 13 MB) stay in the 50 MB L2.
// The SMs do more: every (hypothesis, source, channel) is four taps and
// ~12 flops, 4 x 56 M 16-byte reads a pass through L1, and every (pixel,
// source, hypothesis) a projection with two IEEE divisions. Measured
// (PERF.md, section 6): half of a pass is the tile's fixed work
// (projections, tap records, the per-source walk and the stores; every
// source masked as padding) and half the taps. L1 serves the taps as fast
// as a window of each source staged in shared memory (cp.async, each texel
// crossing from L2 once a tile) did at the main path's shape, so the taps
// are read through L1 and no window is staged.
//
// Design: a block owns a tile of TP = 32 neighbouring pixels of one ref and
// up to 32 channels (gridDim.y slices wider maps), a thread one pixel and 4
// channels (1 where C % 4 != 0). Sources go in groups of up to 8. For a
// group, the block's threads first project every (source, hypothesis,
// pixel) once into shared memory (not once for every channel lane), then
// turn each into its tap record: the clamped 2x2 cell inside the centre's
// patch, its two fractions, and skip / sample / NaN. A hypothesis reads
// only its own 2x2 taps through L1 (4 fmas a channel, not 16 selects over
// the patch), summed in the order of the patch's 16-tap sums. The sums
// over sources stay in registers with no barrier between sources; the
// variance takes one division a thread and is written once with streaming
// stores.
//
// Kept from the JAX package exactly: local coordinates clamp to
// [0, PATCH_K - 1 - 1e-4] and the cell to [0, PATCH_K - 2], so a hypothesis
// beyond +-1 texel of the centre reads the patch's edge; a hypothesis is
// masked by its own anchor rule; the whole fan is zero for a source where
// the centre's anchor is out of bounds; var = s2/n - mean^2 with
// n = max(sum(mask), 1). The projection is written with explicit roundings
// (__fmul_rn, __fmaf_rn, __fadd_rn, __fdiv_rn) in the twin's order, which
// is also the order of XLA's CPU dot in the JAX package, so the
// coordinates, the patch's anchor and every clamp equal the twin's bit for
// bit (a floor that flips between the two would move a whole fan). Bounds
// are tested on the float coordinates before any float-to-int conversion; a
// non-finite coordinate gives NaN (the centre's: the whole fan), even for a
// padding source, as in `source_variance`.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HH_MAX = 8;  // hypotheses per pixel (7 on the main path)
constexpr int PK = 4;      // patch side, the JAX package's PATCH_K
constexpr int TP = 32;     // pixels a tile
constexpr int SG = 8;      // sources a group
constexpr int GROUPS = 8;  // channel groups (of VEC floats) a block
constexpr int NT = TP * GROUPS;
// static shared memory a block: a group's tap records and coordinates and
// the tile's points (8 sources a group up to Hh = 7, 7 at Hh = 8)
constexpr int SMEM_BYTES = 46 * 1024;
constexpr int SMEM_FLOATS = SMEM_BYTES / 4;

// a tap's status in a tile's per-source table
constexpr int SKIP = 0;    // adds nothing (padding source, off the map)
constexpr int SAMPLE = 1;  // sampled from its taps
constexpr int POISON = 2;  // a non-finite coordinate: the result is NaN

// texel coordinates packed in one int (each in [-32768, 32767])
__device__ __forceinline__ int pack_xy(int x, int y) {
  return (y << 16) | (x & 0xffff);
}
__device__ __forceinline__ int unpack_x(int xy) { return (int)(short)xy; }
__device__ __forceinline__ int unpack_y(int xy) { return xy >> 16; }

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T ldg(const float* p);
template <>
__device__ __forceinline__ float4 ldg<4>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <>
__device__ __forceinline__ float ldg<1>(const float* p) { return __ldg(p); }

// streaming store: the output is written once and never read back, so it
// should not push the feature maps out of L2
__device__ __forceinline__ void store(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }

// fma(m2, z, fma(m1, y, m0 * x)) + m3: the order of XLA's CPU dot and of
// the twin, with every rounding explicit so that nvcc contracts nothing else
__device__ __forceinline__ float dot_row(const float* M, float px, float py,
                                         float pz) {
  const float xy = __fmaf_rn(M[1], py, __fmul_rn(M[0], px));
  return __fadd_rn(__fmaf_rn(M[2], pz, xy), M[3]);
}

__device__ __forceinline__ float4 fma_v(float4 a, float w, float4 b) {
  return make_float4(fmaf(a.x, w, b.x), fmaf(a.y, w, b.y), fmaf(a.z, w, b.z),
                     fmaf(a.w, w, b.w));
}
__device__ __forceinline__ float fma_v(float a, float w, float b) {
  return fmaf(a, w, b);
}
__device__ __forceinline__ float4 mul_v(float4 a, float w) {
  return make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
}
__device__ __forceinline__ float mul_v(float a, float w) { return a * w; }
__device__ __forceinline__ float4 sq_v(float4 a) {
  return make_float4(a.x * a.x, a.y * a.y, a.z * a.z, a.w * a.w);
}
__device__ __forceinline__ float sq_v(float a) { return a * a; }
__device__ __forceinline__ void set_v(float4& a, float v) {
  a = make_float4(v, v, v, v);
}
__device__ __forceinline__ void set_v(float& a, float v) { a = v; }
// s2/n - (s/n)^2 with `in` = 1 / n: one IEEE division a thread, not two
// for every hypothesis and channel
__device__ __forceinline__ float4 var_v(float4 s, float4 s2, float in) {
  float4 v;
  float mu;
  mu = s.x * in; v.x = s2.x * in - mu * mu;
  mu = s.y * in; v.y = s2.y * in - mu * mu;
  mu = s.z * in; v.z = s2.z * in - mu * mu;
  mu = s.w * in; v.w = s2.w * in - mu * mu;
  return v;
}
__device__ __forceinline__ float var_v(float s, float s2, float in) {
  const float mu = s * in;
  return s2 * in - mu * mu;
}

template <int VEC>
__global__ void __launch_bounds__(NT) patch_fan_variance_kernel(
    const float* __restrict__ feats,      // [N, Hf, Wf, C]
    const float* __restrict__ pts,        // [R, Hh, P, 3]
    const int64_t* __restrict__ src_idx,  // [R, S]
    const float* __restrict__ src_w,      // [R, S]: 1 real source, 0 padding
    const float* __restrict__ proj,       // [N, 3, 4]
    float* __restrict__ out,              // [R, Hh, P, C]
    int Hh, long long P, int S, int Hf, int Wf, int C, float sx, float sy,
    int sg) {
  using V = typename Vec<VEC>::T;
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int tid = threadIdx.x;
  const long long tiles = (P + TP - 1) / TP;
  const int r = (int)(blockIdx.x / tiles);
  const long long p0 = (blockIdx.x % tiles) * TP;
  const int c0 = blockIdx.y * GROUPS * VEC;
  const int cw = min(GROUPS * VEC, C - c0);  // the slice's channels
  const int hc = Hh / 2;
  const int items = Hh * TP;                 // per source

  // per group the tap records and the projected coordinates, then the
  // tile's points
  int4* rec = reinterpret_cast<int4*>(smem);  // [sg][Hh][TP]
  float2* xy = reinterpret_cast<float2*>(rec + sg * items);
  float* pt = reinterpret_cast<float*>(xy + sg * items);  // [Hh][TP][3]

  for (int i = tid; i < items * 3; i += NT) {
    const int h = i / (TP * 3), k = i - h * TP * 3;
    pt[i] = p0 + k / 3 < P ? pts[((size_t)r * Hh + h) * P * 3 + p0 * 3 + k]
                           : 0.f;
  }
  __syncthreads();

  const int p = tid / GROUPS;  // this thread's pixel and channel group
  const int v = tid - p * GROUPS;
  const bool active = p0 + p < P && v * VEC < cw;
  const float wmax = (float)(Wf - 1);
  const float hmax = (float)(Hf - 1);
  V acc[HH_MAX], acc2[HH_MAX];
#pragma unroll
  for (int h = 0; h < HH_MAX; ++h) {
    set_v(acc[h], 0.f);
    set_v(acc2[h], 0.f);
  }
  float cnt = 0.f;

  for (int g0 = 0; g0 < S; g0 += sg) {
    const int ns = min(sg, S - g0);
    const int64_t* node = src_idx + (size_t)r * S + g0;
    const float* wgt = src_w + (size_t)r * S + g0;
    if (g0) __syncthreads();  // the last group is done with its records
    // every (source, hypothesis, pixel) of the group projected once
    for (int i = tid; i < ns * items; i += NT) {
      const int j = i / items, k = i - j * items;
      const int q = k % TP;
      if (p0 + q >= P) continue;
      const float* M = proj + node[j] * 12;
      const float px = pt[k * 3], py = pt[k * 3 + 1], pz = pt[k * 3 + 2];
      const float X = dot_row(M, px, py, pz);
      const float Y = dot_row(M + 4, px, py, pz);
      const float Z = dot_row(M + 8, px, py, pz);
      const float den = __fadd_rn(fabsf(Z), 1e-8f);
      xy[i] = make_float2(__fmul_rn(__fdiv_rn(X, den), sx),
                          __fmul_rn(__fdiv_rn(Y, den), sy));
    }
    __syncthreads();
    // tap records
    for (int i = tid; i < ns * items; i += NT) {
      const int j = i / items, k = i - j * items;
      const int h = k / TP, q = k - h * TP;
      int4 rc = make_int4(0, 0, 0, SKIP);
      if (p0 + q < P) {
        const float2 c = xy[j * items + hc * TP + q];
        const float2 e = xy[i];
        if (!(isfinite(c.x) && isfinite(c.y) && isfinite(e.x) &&
              isfinite(e.y))) {
          rc.w = POISON;
        } else if (wgt[j] != 0.f) {
          const float xc0f = floorf(c.x), yc0f = floorf(c.y);
          const float xh0f = floorf(e.x), yh0f = floorf(e.y);
          // the centre's 2x2 footprint misses the map: the fan is zero
          const bool centre = xc0f >= -1.f && xc0f <= wmax && yc0f >= -1.f &&
                              yc0f <= hmax;
          if (centre && xh0f >= -1.f && xh0f <= wmax && yh0f >= -1.f &&
              yh0f <= hmax) {
            const float ox = xc0f - 1.f, oy = yc0f - 1.f;  // patch origin
            const float lx =
                fminf(fmaxf(e.x - ox, 0.f), (float)PK - 1.f - 1e-4f);
            const float ly =
                fminf(fmaxf(e.y - oy, 0.f), (float)PK - 1.f - 1e-4f);
            const float ixf = fminf(fmaxf(floorf(lx), 0.f), (float)(PK - 2));
            const float iyf = fminf(fmaxf(floorf(ly), 0.f), (float)(PK - 2));
            rc.x = __float_as_int(lx - ixf);
            rc.y = __float_as_int(ly - iyf);
            rc.z = pack_xy((int)xc0f - 1 + (int)ixf, (int)yc0f - 1 + (int)iyf);
            rc.w = SAMPLE;
          }
        }
      }
      rec[i] = rc;
    }
    __syncthreads();

    for (int j = 0; j < ns; ++j) {
      const float m = wgt[j];
      cnt += m;
      if (!active) continue;
      const float* fm = feats + (size_t)node[j] * Hf * Wf * C + c0 + v * VEC;
      const int4* rj = rec + j * items + p;
#pragma unroll
      for (int h = 0; h < HH_MAX; ++h) {
        if (h >= Hh) continue;
        const int4 rc = rj[h * TP];
        if (rc.w == POISON) {
          set_v(acc[h], NAN);
          set_v(acc2[h], NAN);
        }
        if (rc.w != SAMPLE) continue;
        const float fx = __int_as_float(rc.x), fy = __int_as_float(rc.y);
        const int tx = unpack_x(rc.z), ty = unpack_y(rc.z);
        // the four taps, zero off the map
        const bool x0in = tx >= 0, x1in = tx + 1 < Wf;
        const bool y0in = ty >= 0, y1in = ty + 1 < Hf;
        const float* a = fm + ((long long)ty * Wf + tx) * C;
        V t00, t01, t10, t11;
        set_v(t00, 0.f);
        set_v(t01, 0.f);
        set_v(t10, 0.f);
        set_v(t11, 0.f);
        if (y0in && x0in) t00 = ldg<VEC>(a);
        if (y0in && x1in) t01 = ldg<VEC>(a + C);
        if (y1in && x0in) t10 = ldg<VEC>(a + (size_t)Wf * C);
        if (y1in && x1in) t11 = ldg<VEC>(a + (size_t)(Wf + 1) * C);
        // the order of the patch's 16-tap sums with their zero weights
        // dropped: rows first, then the two rows
        const V top = fma_v(t01, fx, mul_v(t00, 1.f - fx));
        const V bot = fma_v(t11, fx, mul_v(t10, 1.f - fx));
        const V f = fma_v(bot, fy, mul_v(top, 1.f - fy));
        acc[h] = fma_v(f, m, acc[h]);
        acc2[h] = fma_v(sq_v(f), m, acc2[h]);
      }
    }
  }
  if (!active) return;
  const float in = 1.f / fmaxf(cnt, 1.f);
#pragma unroll
  for (int h = 0; h < HH_MAX; ++h) {
    if (h < Hh)
      store(out + (((size_t)r * Hh + h) * P + p0 + p) * C + c0 + v * VEC,
            var_v(acc[h], acc2[h], in));
  }
}

template <int VEC>
int launch(const float* feats, const float* pts, const int64_t* src_idx,
           const float* src_w, const float* proj, float* out, int R, int Hh,
           long long P, int S, int Hf, int Wf, int C, float sx, float sy,
           cudaStream_t stream) {
  // sources a group: as many as the records and coordinates of Hh
  // hypotheses fit beside the tile's points
  const int per_source = Hh * TP * (int)(sizeof(int4) + sizeof(float2));
  const int fit = (SMEM_BYTES - Hh * TP * 3 * (int)sizeof(float)) / per_source;
  int sg = S < SG ? S : SG;
  if (sg > fit) sg = fit;
  const long long tiles = (P + TP - 1) / TP;
  const int per = GROUPS * VEC;
  const dim3 grid((unsigned)(R * tiles), (unsigned)((C + per - 1) / per));
  patch_fan_variance_kernel<VEC><<<grid, NT, 0, stream>>>(
      feats, pts, src_idx, src_w, proj, out, Hh, P, S, Hf, Wf, C, sx, sy, sg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdv_patch_fan_variance(const float* feats, const float* pts,
                                      const int64_t* src_idx,
                                      const float* src_w, const float* proj,
                                      float* out, int R, int Hh, long long P,
                                      int S, int Hf, int Wf, int C, float sx,
                                      float sy, void* stream) {
  if (Hh < 1 || Hh > HH_MAX || Hf > 32000 || Wf > 32000)
    return (int)cudaErrorInvalidValue;
  if ((long long)R * P == 0 || C == 0) return 0;
  const bool vec4 = C % 4 == 0 && (uintptr_t)feats % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  return vec4 ? launch<4>(feats, pts, src_idx, src_w, proj, out, R, Hh, P, S,
                          Hf, Wf, C, sx, sy, (cudaStream_t)stream)
              : launch<1>(feats, pts, src_idx, src_w, proj, out, R, Hh, P, S,
                          Hf, Wf, C, sx, sy, (cudaStream_t)stream);
}
