// propagation_blend_backward: the gradients of the learned 3x3 neighbour
// blend (propagation_blend.cu) with respect to its logits and its depth.
//
// Replaces: the VJP that JAX derives for the blend tail of
// tdvnet/models/upsampling.py `PropagationNet` (:44-45) through the
// edge-replicated `unfold3x3` (:17-28), the XLA form of the round-1 Pallas
// kernel `propagation_blend` (tdvnet/kernels/depthops_pallas.py:67-100
// before commit 2df7997).
//
// Math: out = sum_k w_k u_k with w = softmax(logits) and u_k the depth at
// the edge-clamped neighbour k, so d out / d logit_k = w_k (u_k - out), and
// each depth pixel receives g * w_k from every (pixel, k) whose clamped
// neighbour it is: up to 9 pairs inside the map, more at the borders,
// where several taps of one pixel clamp onto the same source pixel.
//
// Bound on an H100: bytes. Per pixel it reads 9 logits, the depth, the
// output and its gradient and writes 9 logit gradients and one depth
// gradient (~85 MB at 256 x 320 x 14, ~25 us at 3.35 TB/s).
//
// Design: one launch that writes nothing but the outputs. A block owns a
// tile of 32 x 8 pixels of one map, a thread a pixel (a warp a row, so
// every load and store of a tile row is one aligned 128-byte line), and the
// first 84 threads also take a pixel of the tile's one-pixel halo ring.
// Each thread issues all its loads (the logits, through their own strides,
// the incoming gradient, the depth, and for a tile pixel the forward's
// output) before any arithmetic, then writes the softmax's g * w_k and the
// depth of its pixels into shared memory (9 x 10 x 34 floats and 10 x 34).
// The ring's softmaxes repeat those of the neighbouring tiles (1.33x the
// tile's), which spares the round trip of an [N, 9, H, W] scratch through
// HBM. After one barrier each tile pixel writes its logit gradients
// g * w_k * (u_k - out) from shared memory, through the logits' strides,
// so that the permuted view the caller handed in gets back a gradient of
// its layout, and gathers its depth gradient from the (pixel, k) pairs
// whose clamped neighbour it is: three (row, dy) pairs and three
// (column, dx) pairs, in a fixed order; deterministic, no atomics. The
// operations and their order are those of a two-pass form (softmax and
// g * w_k into a scratch, then the gather), and so are the bits. Measured
// on the card: 32 x 16 and 32 x 4 tiles, a halo walked in rows of 34 by
// 256 threads, and divisions only for the ring's taps that point into the
// tile were all slower or no faster.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32, kTileY = 8;
constexpr int kHaloX = kTileX + 2, kHaloY = kTileY + 2;
constexpr int kThreads = kTileX * kTileY;
constexpr int kRing = 2 * kHaloX + 2 * kTileY;   // 84 halo pixels

// The three (source row, tap row) pairs whose clamped neighbour row is `t`
// in a map of `n` rows (one row: three taps clamp onto it), in the order
// in which a walk over the taps d = 0, 1, 2 and then the clamped-up and
// clamped-down taps meets them.
__device__ __forceinline__ void clamp_preimage(int t, int n, int* src,
                                               int* tap) {
  const bool one = n == 1, first = t == 0, last = t == n - 1;
  src[0] = one ? 0 : first ? 1 : last ? n - 1 : t + 1;
  tap[0] = one ? 1 : first ? 0 : last ? 1 : 0;
  src[1] = one ? 0 : first ? 0 : last ? n - 2 : t;
  tap[1] = one ? 0 : first ? 1 : last ? 2 : 1;
  src[2] = one ? 0 : first ? 0 : last ? n - 1 : t - 1;
  tap[2] = one ? 2 : first ? 0 : 2;
}

__global__ void __launch_bounds__(kThreads)
    propagation_blend_backward_kernel(
        const float* __restrict__ grad,    // [N, H, W] d loss / d out
        const float* __restrict__ logits,  // [N, H, W, 9], strides below
        const float* __restrict__ depth,   // [N, H, W]
        const float* __restrict__ out,     // [N, H, W] the forward's output
        float* __restrict__ grad_logits,   // [N, H, W, 9], strides below
        float* __restrict__ grad_depth,    // [N, H, W]
        int H, int W, int tiles_x, int tiles, long long sn, long long sh,
        long long sw, long long sk, long long gn, long long gh, long long gwx,
        long long gk) {
  __shared__ float sgw[9][kHaloY][kHaloX];   // g * w_k, tile and halo
  __shared__ float sdep[kHaloY][kHaloX];     // the depth, tile and halo
  const long long n = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % tiles_x) * kTileX, y0 = (tile / tiles_x) * kTileY;
  const long long HW = (long long)H * W;
  const float* Dn = depth + n * HW;
  const float* Ln = logits + n * sn;
  const float* Gn = grad + n * HW;
  const int t = threadIdx.x;
  const int tx = t % kTileX, ty = t / kTileX;
  const int x = x0 + tx, y = y0 + ty;
  const bool own = x < W && y < H;
  // the ring pixel: the row above, the row below, the left, the right column
  int hx = 0, hy = 0;
  if (t < kHaloX) { hy = 0; hx = t; }
  else if (t < 2 * kHaloX) { hy = kTileY + 1; hx = t - kHaloX; }
  else if (t < 2 * kHaloX + kTileY) { hx = 0; hy = 1 + t - 2 * kHaloX; }
  else { hx = kTileX + 1; hy = 1 + t - 2 * kHaloX - kTileY; }
  const int rx = x0 - 1 + hx, ry = y0 - 1 + hy;
  const bool ring = t < kRing && rx >= 0 && rx < W && ry >= 0 && ry < H;
  float l[9], rl[9], g = 0.f, o = 0.f, dv = 0.f, rg = 0.f, rd = 0.f;
  if (own) {
    const float* L = Ln + y * sh + x * sw;
#pragma unroll
    for (int k = 0; k < 9; ++k) l[k] = L[k * sk];
    const long long p = (long long)y * W + x;
    g = Gn[p]; o = out[n * HW + p]; dv = Dn[p];
  }
  if (ring) {
    const float* L = Ln + ry * sh + rx * sw;
#pragma unroll
    for (int k = 0; k < 9; ++k) rl[k] = L[k * sk];
    const long long p = (long long)ry * W + rx;
    rg = Gn[p]; rd = Dn[p];
  }
  if (own) {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 9; ++k) m = fmaxf(m, l[k]);
    float e[9], den = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) { e[k] = expf(l[k] - m); den += e[k]; }
#pragma unroll
    for (int k = 0; k < 9; ++k) sgw[k][ty + 1][tx + 1] = g * (e[k] / den);
    sdep[ty + 1][tx + 1] = dv;
  }
  if (ring) {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 9; ++k) m = fmaxf(m, rl[k]);
    float e[9], den = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) { e[k] = expf(rl[k] - m); den += e[k]; }
#pragma unroll
    for (int k = 0; k < 9; ++k) sgw[k][hy][hx] = rg * (e[k] / den);
    sdep[hy][hx] = rd;
  }
  __syncthreads();
  if (!own) return;
  float* GL = grad_logits + n * gn + y * gh + x * gwx;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = min(max(y + dy - 1, 0), H - 1) - y0 + 1;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = min(max(x + dx - 1, 0), W - 1) - x0 + 1;
      const int k = 3 * dy + dx;
      GL[k * gk] = sgw[k][ty + 1][tx + 1] * (sdep[yy][xx] - o);
    }
  }
  int ys[3], dys[3], xs[3], dxs[3];
  clamp_preimage(y, H, ys, dys);
  clamp_preimage(x, W, xs, dxs);
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      acc += sgw[3 * dys[a] + dxs[b]][ys[a] - y0 + 1][xs[b] - x0 + 1];
  grad_depth[n * HW + (long long)y * W + x] = acc;
}
}  // namespace

extern "C" int tdv_propagation_blend_backward(
    const float* grad, const float* logits, const float* depth,
    const float* out, float* grad_logits, float* grad_depth, int N, int H,
    int W, long long sn, long long sh, long long sw, long long sk,
    long long gn, long long gh, long long gwx, long long gk, void* stream) {
  if ((long long)N * H * W == 0) return 0;
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles = tiles_x * ((H + kTileY - 1) / kTileY);
  propagation_blend_backward_kernel<<<(unsigned)((long long)N * tiles),
                                      kThreads, 0, (cudaStream_t)stream>>>(
      grad, logits, depth, out, grad_logits, grad_depth, H, W, tiles_x,
      tiles, sn, sh, sw, sk, gn, gh, gwx, gk);
  return (int)cudaGetLastError();
}
