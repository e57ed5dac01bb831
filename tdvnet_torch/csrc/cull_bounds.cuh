// cull_bounds.cuh: the half-spaces of the 3D evaluation kernels' exact
// culls (consistency_fuse.cu, tsdf_integrate.cu) and the test of a box
// against them. The plain twins are `kernels/fusion.py` `frustum_planes`
// and `box_cull`.
//
// A projected form m . p + m3, computed in fp32 as the kernels compute it
// (three roundings and an add, each within 2^-24 of its result), lies
// within REL times the sum of its terms' largest magnitudes, plus TINY_ABS
// for underflow, of its exact value: four roundings, with a factor of two
// spare. A view's half-spaces are linear forms in the point, built in
// double once per launch; a box (centre c, half-extent h, largest
// magnitudes A) lies outside one where the form's largest value over it,
// w3 + w . c + |w| . h, plus the margin REL (g . A + g3), is below zero.
// Double rounding is far below that margin. A box whose forms reach BIG is
// never culled (fp32 would overflow there).
#pragma once

#include <math.h>

namespace cull {

constexpr double REL = 0x1p-20;
constexpr double TINY_ABS = 0x1p-140;
constexpr double BIG = 1e30;
constexpr double TINY = 0x1p-126;        // the least normal fp32
constexpr double QUOT = 1.0 + 0x1p-22;   // two fp32 ulps of a quotient
constexpr int RECORDS = 7;               // six half-spaces, the magnitudes
constexpr int RECORD = 8;                // w0 w1 w2 w3 g0 g1 g2 g3

// One record (w0 w1 w2 w3 g0 g1 g2 g3) of a view, its fields `stride`
// apart: the records of all views are stored field by field, so that the
// lanes of a warp, one view each, read them in one coalesced load
__device__ __forceinline__ void record(double* r, int stride, double w0,
                                       double w1, double w2, double w3,
                                       double g0, double g1, double g2,
                                       double g3) {
  r[0] = w0;
  r[stride] = w1;
  r[2 * stride] = w2;
  r[3 * stride] = w3;
  r[4 * stride] = g0;
  r[5 * stride] = g1;
  r[6 * stride] = g2;
  r[7 * stride] = g3;
}

// The records of view s of N with projection P [3, 4] (fp32, rows X, Y,
// Z), into planes [RECORDS * RECORD, N]: Z <= z_min; X + low Z < 0; -X +
// high_x Z < 0; the same for Y; Z - dmax >= gap (every box outside where
// dmax <= 0, none where dmax or gap is NaN); then the rows' magnitudes.
__device__ inline void build_planes(const float* P, double z_min,
                                    double low, double high_x, double high_y,
                                    float dmax, double gap, double* planes,
                                    int s, int N) {
  const double T = TINY_ABS / REL;
  double m[3][4], a[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[r][i] = P[4 * r + i];
      a[r][i] = fabs(m[r][i]);
    }
  double* out = planes + s;
  const int R = RECORD * N;
  record(out, N, m[2][0], m[2][1], m[2][2], m[2][3] - z_min, a[2][0],
         a[2][1], a[2][2], a[2][3] + T);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const double high = r ? high_y : high_x;
    double* o = out + R * (1 + 2 * r);
    record(o, N, m[r][0] + low * m[2][0], m[r][1] + low * m[2][1],
           m[r][2] + low * m[2][2], m[r][3] + low * m[2][3],
           a[r][0] + low * a[2][0], a[r][1] + low * a[2][1],
           a[r][2] + low * a[2][2],
           a[r][3] + low * a[2][3] + (1 + low) * T);
    record(o + R, N, -m[r][0] + high * m[2][0], -m[r][1] + high * m[2][1],
           -m[r][2] + high * m[2][2], -m[r][3] + high * m[2][3],
           a[r][0] + high * a[2][0], a[r][1] + high * a[2][1],
           a[r][2] + high * a[2][2],
           a[r][3] + high * a[2][3] + (1 + high) * T);
  }
  const double dm = dmax;
  if (dm <= 0.0)
    record(out + 5 * R, N, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0);
  else
    record(out + 5 * R, N, -m[2][0], -m[2][1], -m[2][2],
           -m[2][3] + dm + gap, a[2][0], a[2][1], a[2][2], a[2][3] + T);
  record(out + 6 * R, N, 0.0, 0.0, 0.0, 0.0, a[0][0] + a[1][0] + a[2][0],
         a[0][1] + a[1][1] + a[2][1], a[0][2] + a[1][2] + a[2][2],
         a[0][3] + a[1][3] + a[2][3]);
}

// A box as the cull reads it: centre, half-extent, largest magnitudes
struct Box {
  double c[3], h[3], A[3];
};

__device__ __forceinline__ Box make_box(const float lo[3],
                                       const float hi[3]) {
  Box b;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double l = lo[i], u = hi[i];
    b.c[i] = (l + u) * 0.5;
    b.h[i] = (u - l) * 0.5;
    b.A[i] = fmax(fabs(l), fabs(u));
  }
  return b;
}

// Whether the (finite) box lies outside one of the half-spaces of view s
// of N in planes [RECORDS * RECORD, N] (read through the cache)
__device__ inline bool box_culled(const Box& b,
                                  const double* __restrict__ planes, int s,
                                  int N) {
  const double* pl = planes + s;
  const double* m = pl + 6 * RECORD * N;
  const double S = __ldg(m + 7 * N) + __ldg(m + 4 * N) * b.A[0] +
                   __ldg(m + 5 * N) * b.A[1] + __ldg(m + 6 * N) * b.A[2];
  if (!(S <= BIG)) return false;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const double* r = pl + p * RECORD * N;
    const double w0 = __ldg(r), w1 = __ldg(r + N), w2 = __ldg(r + 2 * N);
    const double U = __ldg(r + 3 * N) + w0 * b.c[0] + w1 * b.c[1] +
                     w2 * b.c[2] + fabs(w0) * b.h[0] + fabs(w1) * b.h[1] +
                     fabs(w2) * b.h[2];
    const double margin =
        REL * (__ldg(r + 7 * N) + __ldg(r + 4 * N) * b.A[0] +
               __ldg(r + 5 * N) * b.A[1] + __ldg(r + 6 * N) * b.A[2]);
    if (U + margin < 0.0) return true;
  }
  return false;
}

}  // namespace cull
