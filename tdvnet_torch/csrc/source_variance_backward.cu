// source_variance_backward: the gradient of the masked per-point feature
// variance (source_variance.cu) with respect to the feature maps.
//
// Replaces: the VJP that JAX derives for tdvnet/ops/costvolume.py
// `_source_variance` (:36-97) with respect to `feats`, through its
// rematerialised source scan and the quad-packed bilinear gathers
// (tdvnet/ops/sampling.py `bilinear_sample_quads`, :80-106). The points and
// projections take no gradient there: the plane-sweep points derive from
// the cameras only, and the scene and hypothesis points are
// `stop_gradient`ed (tdvnet/models/threedvnet.py:81, :192).
//
// Math: var = sum_s m_s f_s^2 / cnt - mean^2 with mean = sum_s m_s f_s / cnt,
// so d var / d f_s = 2 m_s (f_s - mean) / cnt, and the sample f_s is a
// bilinear blend of four taps of feats[src_idx[r, s]]. Each tap receives
// g * 2 m_s (f_s - mean) / cnt times its bilinear weight.
//
// Bound on an H100: bytes in the contract's count (grad_var and mean read
// once, 1.08 GB at the full-width cost volume, plus feats and grad_feats,
// ~0.33 ms at 3.35 TB/s). What held the first form (one 16-byte float
// reduction per point, source, tap and 4 channels straight into device
// memory, 0.68 ms a call) was the L2's atomic units: ~1.6e9 values onto
// 2.9 M elements, ~550 adds each, neighbouring points on the same taps; and
// those float adds landed in a run-dependent order, so a train step did not
// repeat.
//
// Design: order-free fixed-point sums (fixed_sum.cuh), merged in shared
// memory before they reach device memory.
//   amax      the largest finite |grad| and |feats| (two passes of
//             fx::amax_kernel): each term is at most
//             |g| * 2 * 2 max|feats| for masks in [0, 1] and the forward's
//             mean, and an element takes at most R * P * S terms, which
//             sets the call's power-of-two scale;
//   scatter   a block owns one ref, a slice of up to 32 channels, TPIX
//             pixels and TD = 8 planes of them: point p = plane * L +
//             pixel, with the plane (h, w) the caller gives (the plane-sweep
//             cost volume's, or the depth map's under the scene and
//             hypothesis points), so that a block takes an 8 x 4 tile of
//             pixels at 8 neighbouring depths, whose projections crowd onto
//             a few taps. A thread is (pixel, 4 channels) and keeps its 8
//             points' grad and mean in registers. Per source (a block-uniform loop)
//             the lanes of a pixel project its 8 points once between them
//             and pass the footprints by warp shuffles (the forward's
//             sv::project and sv::footprint, so the taps and weights are the
//             forward's), the block takes the bounding box of its taps,
//             zeroes a window of that many pixels x its channels in shared
//             memory (96 KB of dynamic shared memory), adds each quantised
//             tap there and flushes each non-zero element of the window once
//             with `red.global.add.u64` into an int64 accumulator of
//             grad_feats' shape (24 MB at the cost volume: L2-resident). A
//             tap outside a window that had to be cut to fit adds straight
//             to device memory. Every term is rounded on its own, so that
//             the sums do not depend on which points share a block. sm_90
//             has no 64-bit integer add in shared memory (a CAS loop): a
//             window element keeps its low and high words in two planes and
//             `fx::shared_add` adds them as two native 32-bit atomics, the
//             low word's old value giving the carry;
//   finalize  the accumulator back to fp32, one rounding;
//   nonfinite the scatter again in its non-finite mode: it exits at once
//             unless a term was non-finite, and then adds only those terms,
//             as floats, onto the result.
// The sample f_s keeps the forward's projection, footprint and blend
// (source_variance.cuh); the mean comes from the forward. A point whose
// projection is not finite has a NaN variance in the forward and scatters
// nothing here. Every sum is an integer sum: the result is the same bits
// from run to run, whatever order the blocks and threads take.
//
// The bf16 form (tdv_source_variance_backward_bf16; a bf16 model's features
// in training) is the same kernels templated on the storage of the
// features and their gradient (bf16) and of the incoming gradient (bf16 at
// the cost volume, whose variance is stored in bf16; fp32 at the points):
// the taps widened exactly, each source's sample rounded to bf16 as the
// bf16 forward rounds it, the terms and sums the fp32 form's fixed point
// (the amax over the bf16 inputs), each element converted to fp32 once and
// rounded to bf16 where it is stored; a non-finite term is added onto the
// bf16 result by a bf16 atomic. Bound: bytes, the grad and the features at
// their own widths.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "fixed_sum.cuh"
#include "source_variance.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTD = 8;                    // planes a thread walks
constexpr int kMaxSlice = 8;              // channel groups (of 4) a block
constexpr int kWindowBytes = 96 * 1024;   // the shared window's int64 sums
constexpr unsigned kFull = 0xffffffffu;

// scratch words: amax |grad|, amax |feats|, the non-finite flag, padding
struct Scratch {
  unsigned amax_g, amax_f, nf, pad;
};

__device__ __forceinline__ float4 scale4(const float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

// the call's scale exponent: every term below 2^(e_g + e_f + 5), at most
// 2^log2_terms of them an element
__device__ __forceinline__ int scale_of(const Scratch* scratch,
                                        int log2_terms) {
  return fx::scale_exp(
      fx::exp_of(scratch->amax_g) + fx::exp_of(scratch->amax_f) + 5,
      log2_terms);
}

// an integer term into window element i (its low words in the first plane
// of `cap`, its high words in the second), and an element's sum
__device__ __forceinline__ void window_add(unsigned* w, int cap, int i,
                                           long long q) {
  if (q) fx::shared_add(w + i, w + cap + i, q);
}
__device__ __forceinline__ long long window_value(const unsigned* w, int cap,
                                                  int i) {
  return (long long)(((unsigned long long)w[cap + i] << 32) | w[i]);
}

// a point's footprint in one source, packed: xy = (x0 + 1) | (y0 + 1) << 16,
// or -1 when the point adds nothing there
struct Fp {
  int xy;
  float wx, wy;
};

template <int CS>   // lanes of a pixel sharing projections; 0: none shared
__device__ __forceinline__ void footprints(
    Fp (&fp)[kTD], const float* __restrict__ pts, const float* M, int r,
    long long P, long long L, long long d0, long long pix, bool pix_ok,
    int lane_in_pixel, int Hf, int Wf, float sx, float sy) {
  // the points this lane projects: all 8 (CS = 0), or planes j with
  // j % CS == lane_in_pixel
  constexpr int kPer = CS == 0 ? kTD : kTD / CS;
  Fp mine[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = CS == 0 ? u : u * CS + lane_in_pixel;
    const long long p = (d0 + j) * L + pix;
    mine[u].xy = -1;
    mine[u].wx = mine[u].wy = 0.f;
    if (pix_ok && p < P) {
      const float* q = pts + ((long long)r * P + p) * 3;
      float x, y;
      sv::project(M, q[0], q[1], q[2], sx, sy, x, y);
      sv::Footprint f;
      if (isfinite(x) && isfinite(y) && sv::footprint(x, y, Hf, Wf, f)) {
        mine[u].xy = (f.x0 + 1) | ((f.y0 + 1) << 16);
        mine[u].wx = f.wx;
        mine[u].wy = f.wy;
      }
    }
  }
  if (CS == 0) {
#pragma unroll
    for (int j = 0; j < kTD; ++j) fp[j] = mine[j];
  } else {
    const int base = (threadIdx.x & 31) - lane_in_pixel;
#pragma unroll
    for (int j = 0; j < kTD; ++j) {
      const int from = base + (CS == 0 ? 0 : j % (CS == 0 ? 1 : CS));
      const int u = CS == 0 ? 0 : j / (CS == 0 ? 1 : CS);
      fp[j].xy = __shfl_sync(kFull, mine[u].xy, from);
      fp[j].wx = __shfl_sync(kFull, mine[u].wx, from);
      fp[j].wy = __shfl_sync(kFull, mine[u].wy, from);
    }
  }
}

// the point tiling: point p = plane * L + row * row_w + col; a block takes
// a tile of tile_w x (TPIX / tile_w) pixels (pix_bx x pix_by tiles a plane)
// and kTD planes
struct Geo {
  int R, S, Hf, Wf, C;
  long long P, L, row_w, rows;
  int tile_w, pix_bx, pix_by, plane_blocks, log2_terms;
  float sx, sy;
};

// NF false: the fixed-point scatter into `acc`; NF true: only the
// non-finite terms, as float adds into `out` (nothing unless the flag is
// up). F: the storage of the features and of `out`, Gr: of the grad (float
// or bf16::bits16)
template <int CS, bool NF, typename F, typename Gr>
__global__ void __launch_bounds__(kThreads) source_variance_backward_kernel(
    const Gr* __restrict__ grad,          // [R, P, C] d loss / d var
    const float* __restrict__ mean,       // [R, P, C] from the forward
    const F* __restrict__ feats,          // [N, Hf, Wf, C]
    const float* __restrict__ pts,        // [R, P, 3]
    const int64_t* __restrict__ src_idx,  // [R, S]
    const float* __restrict__ src_w,      // [R, S]
    const float* __restrict__ proj,       // [N, 3, 4]
    long long* __restrict__ acc,          // [N, Hf, Wf, C] int64, zeroed
    F* __restrict__ out,                  // [N, Hf, Wf, C]
    Scratch* __restrict__ scratch, Geo g) {
  using FV = typename bf16::Quad<F>::V;
  using GV = typename bf16::Quad<Gr>::V;
  // the window: each element's int64 sum as its low and high 32-bit words
  // in two planes (`fx::shared_add`), a pixel's channels padded by one
  // word so that neighbouring pixels start on other banks
  extern __shared__ unsigned window[];
  __shared__ int box[4];                  // x_lo, y_lo, x_hi, y_hi (+1)
  if (NF && *reinterpret_cast<volatile unsigned*>(&scratch->nf) == 0u)
    return;
  const int cq = g.C >> 2;
  const int cs = CS == 0 ? min(cq, kMaxSlice) : CS;
  const int tpix = kThreads / cs;
  const int t = threadIdx.x;
  const int lane_in_pixel = t % cs;
  const int q = blockIdx.y * cs + lane_in_pixel;
  const bool q_ok = q < cq && t < tpix * cs;
  int b = blockIdx.x;
  const int bx = b % g.pix_bx;
  b /= g.pix_bx;
  const int by = b % g.pix_by;
  b /= g.pix_by;
  const int db = b % g.plane_blocks;
  const int r = b / g.plane_blocks;
  const int slot = t / cs, tile_h = tpix / g.tile_w;
  const long long col = (long long)bx * g.tile_w + slot % g.tile_w;
  const long long row = (long long)by * tile_h + slot / g.tile_w;
  const long long pix = row * g.row_w + col;
  const bool pix_ok = col < g.row_w && row < g.rows && t < tpix * cs;
  const long long d0 = (long long)db * kTD;

  // the scale: every term below 2^(e_g + e_f + 5), at most 2^log2_terms
  // terms an element
  const int k = scale_of(scratch, g.log2_terms);
  const float scale = fx::pow2(k);

  float4 gv[kTD], mu[kTD];
#pragma unroll
  for (int j = 0; j < kTD; ++j) {
    const long long p = (d0 + j) * g.L + pix;
    gv[j] = mu[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pix_ok && q_ok && p < g.P) {
      const long long o = ((long long)r * g.P + p) * cq + q;
      gv[j] = bf16::load4(reinterpret_cast<const GV*>(grad) + o);
      mu[j] = __ldg(reinterpret_cast<const float4*>(mean) + o);
    }
  }
  float cnt = 0.f;
  for (int s = 0; s < g.S; ++s) cnt += src_w[r * g.S + s];
  const float c = fmaxf(cnt, 1.f);
  const int slice = cs * 4;              // channels of this block's window
  const int stride = slice + 1;          // words a window pixel
  const int cap = kWindowBytes / 8;      // window elements

  for (int s = 0; s < g.S; ++s) {
    const float m = src_w[r * g.S + s];
    if (m == 0.f) continue;              // uniform over the block
    const long long n = src_idx[r * g.S + s];
    Fp fp[kTD];
    {
      const float4* M4 = reinterpret_cast<const float4*>(proj + n * 12);
      const float4 a = __ldg(M4), bb = __ldg(M4 + 1), cc = __ldg(M4 + 2);
      const float M[12] = {a.x,  a.y,  a.z,  a.w,  bb.x, bb.y,
                           bb.z, bb.w, cc.x, cc.y, cc.z, cc.w};
      footprints<CS>(fp, pts, M, r, g.P, g.L, d0, pix, pix_ok,
                     lane_in_pixel, g.Hf, g.Wf, g.sx, g.sy);
    }
    // the window: the taps' bounding box, cut to the shared budget
    int wx0 = 0, wy0 = 0, ww = 0, wh = 0;
    if (!NF) {
      if (t == 0) {
        box[0] = box[1] = 1 << 30;
        box[2] = box[3] = -(1 << 30);
      }
      __syncthreads();
      int xl = 1 << 30, yl = 1 << 30, xh = -(1 << 30), yh = -(1 << 30);
#pragma unroll
      for (int j = 0; j < kTD; ++j) {
        if (fp[j].xy < 0 || !q_ok) continue;
        const int x0 = (fp[j].xy & 0xffff) - 1, y0 = (fp[j].xy >> 16) - 1;
        xl = min(xl, x0);
        yl = min(yl, y0);
        xh = max(xh, x0 + 1);
        yh = max(yh, y0 + 1);
      }
      xl = __reduce_min_sync(kFull, xl);
      yl = __reduce_min_sync(kFull, yl);
      xh = __reduce_max_sync(kFull, xh);
      yh = __reduce_max_sync(kFull, yh);
      if ((t & 31) == 0 && xh >= xl) {
        atomicMin(&box[0], xl);
        atomicMin(&box[1], yl);
        atomicMax(&box[2], xh);
        atomicMax(&box[3], yh);
      }
      __syncthreads();
      if (box[2] >= box[0]) {
        wx0 = box[0];
        wy0 = box[1];
        const int cap_px = cap / stride;
        ww = min(box[2] - box[0] + 1, cap_px);
        wh = min(box[3] - box[1] + 1, cap_px / ww);
      }
      for (int i = t; i < ww * wh * stride; i += kThreads)
        window[i] = window[cap + i] = 0u;
      __syncthreads();
    }
    unsigned* nf = &scratch->nf;
    if (q_ok) {
      const size_t base = (size_t)n * g.Hf * g.Wf * cq + q;
      const FV* fm = reinterpret_cast<const FV*>(feats) + base;
#pragma unroll
      for (int j = 0; j < kTD; ++j) {
        if (fp[j].xy < 0) continue;
        sv::Footprint f;
        f.x0 = (fp[j].xy & 0xffff) - 1;
        f.y0 = (fp[j].xy >> 16) - 1;
        f.wx = fp[j].wx;
        f.wy = fp[j].wy;
        f.xin0 = f.x0 >= 0;
        f.xin1 = f.x0 + 1 <= g.Wf - 1;
        f.yin0 = f.y0 >= 0;
        f.yin1 = f.y0 + 1 <= g.Hf - 1;
        float4 fs = sv::sample4(fm, f, g.Wf, cq);
        if constexpr (sizeof(F) == 2) fs = bf16::round(fs);
        const float kk = 2.f * m / c;
        float4 d = make_float4(
            gv[j].x * kk * (fs.x - mu[j].x), gv[j].y * kk * (fs.y - mu[j].y),
            gv[j].z * kk * (fs.z - mu[j].z), gv[j].w * kk * (fs.w - mu[j].w));
        // a tap's term d * w is finite wherever d is (0 <= w <= 1): the
        // fixed-point pass takes a non-finite channel's terms as 0 (and
        // raises the flag), the non-finite pass takes only those
        const bool finite = isfinite(d.x) && isfinite(d.y) &&
                            isfinite(d.z) && isfinite(d.w);
        if (NF && finite) continue;
        if (!NF && !finite) {
          *reinterpret_cast<volatile unsigned*>(nf) = 1u;
          d = make_float4(isfinite(d.x) ? d.x : 0.f, isfinite(d.y) ? d.y : 0.f,
                          isfinite(d.z) ? d.z : 0.f, isfinite(d.w) ? d.w : 0.f);
        }
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const int tx = f.x0 + (tap & 1), ty = f.y0 + (tap >> 1);
          if (!((tap & 1 ? f.xin1 : f.xin0) && (tap >> 1 ? f.yin1 : f.yin0)))
            continue;
          const float wt = (tap & 1 ? f.wx : 1.f - f.wx) *
                           (tap >> 1 ? f.wy : 1.f - f.wy);
          if (NF) {
            const float4 v = scale4(d, wt);
            F* o = out + base * 4 + ((size_t)ty * g.Wf + tx) * g.C;
            if (!isfinite(v.x)) bf16::add_nonfinite(o + 0, v.x);
            if (!isfinite(v.y)) bf16::add_nonfinite(o + 1, v.y);
            if (!isfinite(v.z)) bf16::add_nonfinite(o + 2, v.z);
            if (!isfinite(v.w)) bf16::add_nonfinite(o + 3, v.w);
            continue;
          }
          // rint(fl(d w) 2^k): the power of two is exact
          const float4 v = scale4(d, wt * scale);
          const long long qv[4] = {__float2ll_rn(v.x), __float2ll_rn(v.y),
                                   __float2ll_rn(v.z), __float2ll_rn(v.w)};
          const int lx = tx - wx0, ly = ty - wy0;
          if (lx >= 0 && lx < ww && ly >= 0 && ly < wh) {
            const int o = (ly * ww + lx) * stride + 4 * lane_in_pixel;
#pragma unroll
            for (int ch = 0; ch < 4; ++ch)
              window_add(window, cap, o + ch, qv[ch]);
          } else {
            long long* a = acc + base * 4 + ((size_t)ty * g.Wf + tx) * g.C;
#pragma unroll
            for (int ch = 0; ch < 4; ++ch)
              if (qv[ch]) fx::red_add(a + ch, qv[ch]);
          }
        }
      }
    }
    if (!NF) {
      __syncthreads();
      // each touched element of the window leaves once
      const int c0 = blockIdx.y * slice;
      const int width = min(slice, g.C - c0);
      // a thread takes one channel of every (kThreads / slice)-th pixel
      const int per_pass = kThreads / slice, ch = t % slice;
      if (ch < width && t < per_pass * slice) {
        for (int px = t / slice; px < ww * wh; px += per_pass) {
          const int i = px * stride + ch;
          const long long v = window_value(window, cap, i);
          if (v == 0) continue;
          const int y = px / ww, x = px - y * ww;
          fx::red_add(acc + (((size_t)n * g.Hf + wy0 + y) * g.Wf + wx0 + x) *
                                g.C + c0 + ch,
                      v);
        }
      }
      __syncthreads();
    }
  }
}

// out = acc * 2^-k, 4 elements a thread (rounded to bf16 where the
// storage is)
template <typename F>
__global__ void source_variance_backward_finalize_kernel(
    const long long* __restrict__ acc, F* __restrict__ out, long long n4,
    const Scratch* __restrict__ scratch, int log2_terms) {
  const float inv = fx::pow2(-scale_of(scratch, log2_terms));
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(acc) + 2 * i);
    const longlong2 b =
        __ldcs(reinterpret_cast<const longlong2*>(acc) + 2 * i + 1);
    bf16::store4(
        reinterpret_cast<typename bf16::Quad<F>::V*>(out) + i,
        make_float4(fx::dequantize(a.x, inv), fx::dequantize(a.y, inv),
                    fx::dequantize(b.x, inv), fx::dequantize(b.y, inv)));
  }
}

template <int CS, typename F, typename Gr>
void scatter(bool nf, dim3 grid, cudaStream_t st, const Gr* grad,
             const float* mean, const F* feats, const float* pts,
             const int64_t* src_idx, const float* src_w, const float* proj,
             long long* acc, F* out, Scratch* scratch, const Geo& g) {
  if (nf) {
    source_variance_backward_kernel<CS, true, F, Gr>
        <<<grid, kThreads, 0, st>>>(
        grad, mean, feats, pts, src_idx, src_w, proj, acc, out, scratch, g);
    return;
  }
  // the window is dynamic shared memory past 48 KB: the attribute once a
  // device
  constexpr int kDevices = 64;
  static bool set[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kDevices || !set[dev]) {
    cudaFuncSetAttribute(source_variance_backward_kernel<CS, false, F, Gr>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kWindowBytes);
    if (dev < kDevices) set[dev] = true;
  }
  source_variance_backward_kernel<CS, false, F, Gr>
      <<<grid, kThreads, kWindowBytes, st>>>(grad, mean, feats, pts, src_idx,
                                             src_w, proj, acc, out, scratch,
                                             g);
}

template <typename F, typename Gr>
int backward(const Gr* grad, const float* mean, const F* feats,
             const float* pts, const int64_t* src_idx, const float* src_w,
             const float* proj, F* grad_feats, long long* acc,
             unsigned* scratch, int R, long long P, int S, int N, int Hf,
             int Wf, int C, long long plane_stride, long long row_w,
             float sx, float sy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_out = (long long)N * Hf * Wf * C;
  if (n_out == 0) return 0;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(long long) * n_out, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(Scratch), st);
  if (err != cudaSuccess) return (int)err;
  const int cq = C / 4;
  const int cs = cq < kMaxSlice ? cq : kMaxSlice;
  const int tpix = kThreads / cs;
  Scratch* sc = reinterpret_cast<Scratch*>(scratch);
  if ((long long)R * P > 0) {
    Geo g;
    g.R = R;
    g.S = S;
    g.Hf = Hf;
    g.Wf = Wf;
    g.C = C;
    g.P = P;
    if (plane_stride <= 0 || row_w <= 0 || plane_stride % row_w)
      return (int)cudaErrorInvalidValue;
    g.L = plane_stride;
    g.row_w = row_w;
    g.rows = g.L / g.row_w;
    // tiles 8 pixels wide where the plane has rows; a run of the row
    // otherwise
    g.tile_w = g.rows > 1 ? 8 : tpix;
    const long long planes = (P + g.L - 1) / g.L;
    const long long pix_bx = (g.row_w + g.tile_w - 1) / g.tile_w;
    const long long pix_by = (g.rows + tpix / g.tile_w - 1) / (tpix / g.tile_w);
    const long long plane_blocks = (planes + kTD - 1) / kTD;
    if (pix_bx * pix_by * plane_blocks * R > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    g.pix_bx = (int)pix_bx;
    g.pix_by = (int)pix_by;
    g.plane_blocks = (int)plane_blocks;
    g.log2_terms = fx::log2_ceil((long long)R * P * (S > 0 ? S : 1));
    g.sx = sx;
    g.sy = sy;
    fx::amax(grad, (long long)R * P, C, C, &sc->amax_g, st);
    fx::amax(feats, (long long)N * Hf * Wf, C, C, &sc->amax_f, st);
    const dim3 grid((unsigned)(pix_bx * pix_by * plane_blocks * R),
                    (unsigned)((cq + cs - 1) / cs));
    for (int pass = 0; pass < 2; ++pass) {
      const bool nf = pass == 1;
      if (nf) {
        const long long n4 = n_out / 4;
        const long long blocks = (n4 + 255) / 256;
        source_variance_backward_finalize_kernel<F><<<
            (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, st>>>(
            acc, grad_feats, n4, sc, g.log2_terms);
      }
      switch (cs) {
        case 8: scatter<8>(nf, grid, st, grad, mean, feats, pts, src_idx,
                           src_w, proj, acc, grad_feats, sc, g); break;
        case 4: scatter<4>(nf, grid, st, grad, mean, feats, pts, src_idx,
                           src_w, proj, acc, grad_feats, sc, g); break;
        case 2: scatter<2>(nf, grid, st, grad, mean, feats, pts, src_idx,
                           src_w, proj, acc, grad_feats, sc, g); break;
        case 1: scatter<1>(nf, grid, st, grad, mean, feats, pts, src_idx,
                           src_w, proj, acc, grad_feats, sc, g); break;
        default: scatter<0>(nf, grid, st, grad, mean, feats, pts, src_idx,
                            src_w, proj, acc, grad_feats, sc, g); break;
      }
    }
  } else {
    cudaMemsetAsync(grad_feats, 0, sizeof(F) * n_out, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// grad, mean [R, P, C]; feats, grad_feats [N, Hf, Wf, C]; acc [N, Hf, Wf, C]
// int64 scratch and `scratch` 4 uint32 (both set here); C % 4 == 0;
// the points are planes of plane_stride pixels (the last one may be cut
// short) in rows of row_w pixels (plane_stride a multiple of row_w).
extern "C" int tdv_source_variance_backward(
    const float* grad, const float* mean, const float* feats, const float* pts,
    const int64_t* src_idx, const float* src_w, const float* proj,
    float* grad_feats, long long* acc, unsigned* scratch, int R, long long P,
    int S, int N, int Hf, int Wf, int C, long long plane_stride,
    long long row_w, float sx, float sy, void* stream) {
  return backward(grad, mean, feats, pts, src_idx, src_w, proj, grad_feats,
                  acc, scratch, R, P, S, N, Hf, Wf, C, plane_stride, row_w,
                  sx, sy, stream);
}

// the same on bf16 features and their bf16 gradient; the grad bf16 where
// `grad_bf16` (the cost volume), else fp32
extern "C" int tdv_source_variance_backward_bf16(
    int grad_bf16, const void* grad, const float* mean, const void* feats,
    const float* pts, const int64_t* src_idx, const float* src_w,
    const float* proj, void* grad_feats, long long* acc, unsigned* scratch,
    int R, long long P, int S, int N, int Hf, int Wf, int C,
    long long plane_stride, long long row_w, float sx, float sy,
    void* stream) {
  using E = bf16::bits16;
  const E* f = static_cast<const E*>(feats);
  E* out = static_cast<E*>(grad_feats);
  if (grad_bf16)
    return backward(static_cast<const E*>(grad), mean, f, pts, src_idx,
                    src_w, proj, out, acc, scratch, R, P, S, N, Hf, Wf, C,
                    plane_stride, row_w, sx, sy, stream);
  return backward(static_cast<const float*>(grad), mean, f, pts, src_idx,
                  src_w, proj, out, acc, scratch, R, P, S, N, Hf, Wf, C,
                  plane_stride, row_w, sx, sy, stream);
}
