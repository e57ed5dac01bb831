"""Multi-view consistency fusion of a chunk of ref depth maps (K9b).

Kernel: `csrc/consistency_fuse.cu` (see its header for the TPU op it
replaces, its bound and its design). `consistency_fuse_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors. Both take the
per-view camera table of `camera_table`. `fuse_skip_ref` is the plain twin
of the kernel's cull: the (tile, pixel group, view) triples whose bounds
prove that no pair can be valid, which the kernel never runs.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from tdvnet_torch.kernels._launch import (check, launch, no_backward,
                                          on_cpu)
from tdvnet_torch.kernels.patchfan import _fma
from tdvnet_torch.ops.camera import linspace_f32

CAM = 33   # P [3, 4], K^-1 [3, 3], R [3, 3], t [3] per view
TILE = (16, 32)      # a block's tile of ref pixels (rows, columns)
# a projected form computed in fp32 (three roundings and an add) lies within
# CULL_REL of the sum of its terms' magnitudes (plus CULL_TINY) of its exact
# value: four roundings of at most 2^-24 each, with a factor of two spare
CULL_REL = 2.0 ** -20
CULL_TINY = 2.0 ** -140
CULL_BIG = 1e30      # a box or form beyond this is not culled
Z_MIN = float(torch.tensor(1e-4, dtype=torch.float32))   # the kernel's 1e-4f


def _row3(m0, m1, m2, a, b, c):
    """fma(m2, c, fma(m1, b, m0 * a)): a 3-term row in the order of XLA's
    CPU dot (and of the kernel)."""
    return _fma(m2, c, _fma(m1, b, m0 * a))


def camera_table(K: torch.Tensor, R: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """[N, 33] fp32 rows (P = K[R|t], K^-1, R, t) of N world-to-camera
    views, K/R [N, 3, 3], t [N, 3]. P's entries are 3-term rows in XLA's
    CPU order, as JAX's `projection_matrix` gives them; K^-1 is inverted in
    fp64 and rounded once (JAX inverts in fp32)."""
    Rt = torch.cat([R, t[..., None]], dim=-1)                  # [N, 3, 4]
    P = _row3(K[:, :, 0, None], K[:, :, 1, None], K[:, :, 2, None],
              Rt[:, None, 0, :], Rt[:, None, 1, :], Rt[:, None, 2, :])
    K_inv = torch.linalg.inv(K.double()).to(torch.float32)
    n = K.shape[0]
    return torch.cat([P.reshape(n, 12), K_inv.reshape(n, 9),
                      R.reshape(n, 9), t.reshape(n, 3)],
                     dim=1).to(torch.float32).contiguous()


@functools.lru_cache(maxsize=16)
def pixel_grid(H: int, W: int, device=None):
    """The pixel x of each column and y of each row, as the JAX package's
    `build_img_grid` at full resolution gives them under jit. Kept per
    shape and device (read only): building them is a dozen small torch
    ops, which cost the wrapper's host path more than the kernel's work."""
    return (linspace_f32(0.0, W - 1.0, W, device),
            linspace_f32(0.0, H - 1.0, H, device))


def _backproject(cam: torch.Tensor, x, y, d):
    """World points of pixels (x, y) at depth d seen by the views of `cam`
    rows [..., 33] (broadcast against x): R^T (K^-1 [x, y, 1] d - t)."""
    Ki = [cam[..., 12 + i] for i in range(9)]
    Rm = [cam[..., 21 + i] for i in range(9)]
    q = [_row3(Ki[3 * i], Ki[3 * i + 1], Ki[3 * i + 2], x, y,
               torch.ones_like(x)) * d - cam[..., 30 + i] for i in range(3)]
    return [_row3(Rm[i], Rm[3 + i], Rm[6 + i], q[0], q[1], q[2])
            for i in range(3)]


def ref_points(ref_depth: torch.Tensor, cams: torch.Tensor,
               self_idx: torch.Tensor):
    """The world points [C, H*W] x 3 of every ref pixel at its depth, as
    the kernel back-projects them."""
    C, H, W = ref_depth.shape
    gx, gy = pixel_grid(H, W, ref_depth.device)
    px, py = gx.repeat(H), gy.repeat_interleave(W)
    return _backproject(cams[self_idx][:, None, :], px[None], py[None],
                        ref_depth.reshape(C, H * W))


def _fuse_view(pw, cs, depth_s, zt):
    """Points pw (3 x [C, P]) reprojected into one view (camera row cs,
    depth map depth_s [H, W]): (valid but for the self test, x, y, the
    sampled depth). The nearest tap rounds half to even and is zero
    outside the map."""
    H, W = depth_s.shape
    X, Y, z = (_row3(cs[4 * i], cs[4 * i + 1], cs[4 * i + 2], *pw)
               + cs[4 * i + 3] for i in range(3))
    x, y = X / z, Y / z
    xi, yi = torch.round(x), torch.round(y)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    tap = torch.where(inb, yi * W + xi, torch.zeros_like(xi)).long()
    zs = torch.where(inb, depth_s.reshape(-1)[tap], torch.zeros_like(z))
    valid = (((z - zs).abs() < zt) & (x >= 0) & (x <= W - 1) & (y >= 0)
             & (y <= H - 1) & (z > 1e-4) & (zs > 0))
    return valid, x, y, zs


def consistency_fuse_ref(ref_depth: torch.Tensor, all_depth: torch.Tensor,
                         cams: torch.Tensor, self_idx: torch.Tensor,
                         z_thresh: float, n_consistent: int,
                         return_counts: bool = False):
    """ref_depth [C, H, W] (refs self_idx [C] of the N views), all_depth
    [N, H, W], cams [N, 33] from `camera_table`. Every ref pixel is
    back-projected at its depth and reprojected into every view in order;
    a view counts where the nearest tap (half to even, zero outside) of its
    depth d_s is positive, |z - d_s| < z_thresh, the pixel lies in [0, W-1]
    x [0, H-1], z > 1e-4, and the view is not the ref itself; its
    back-projected tap is then added to the point sum. Returns (pts [C,
    H*W, 3] = (point + sum) / (n + 1), keep [C, H*W] = n >= n_consistent
    and ref depth > 0), and with `return_counts` also n [C, H*W]."""
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    dev = ref_depth.device
    P = H * W
    d_ref = ref_depth.reshape(C, P)
    pw = ref_points(ref_depth, cams, self_idx)
    n = torch.zeros((C, P), dtype=torch.int32, device=dev)
    sums = [torch.zeros((C, P), dtype=torch.float32, device=dev)
            for _ in range(3)]
    zt = torch.tensor(z_thresh, dtype=torch.float32, device=dev)
    for s in range(N):
        cs = cams[s]
        valid, x, y, zs = _fuse_view(pw, cs, all_depth[s], zt)
        valid &= (self_idx != s)[:, None]
        o = _backproject(cs, x, y, zs)
        sums = [torch.where(valid, a + b, a) for a, b in zip(sums, o)]
        n = n + valid.to(torch.int32)
    den = (n + 1).to(torch.float32)
    pts = torch.stack([(a + b) / den for a, b in zip(pw, sums)], dim=-1)
    keep = (n >= n_consistent) & (d_ref > 0)
    return (pts, keep, n) if return_counts else (pts, keep)


# ------------------------------------------------------------------ the cull
def frustum_planes(P: torch.Tensor, z_min: float, low: float, high_x: float,
                   high_y: float, depth_max: torch.Tensor,
                   depth_gap: float) -> torch.Tensor:
    """The half-spaces of a cull, one set per view (`cull_bounds.cuh` builds
    the same per launch): P [N, 3, 4] fp32 projections whose rows give X,
    Y, Z of a point. Returns [N, 7, 8] float64 records (w0, w1, w2, w3, g0,
    g1, g2, g3): a box is outside a record's half-space where the largest
    value of w . p + w3 over it, plus CULL_REL (g . |p|max + g3), is below
    zero; g3 holds CULL_TINY (over CULL_REL) for each fp32 form it
    combines. Records 0-5: Z <= z_min; X + low Z < 0 (x below 0); -X +
    high_x Z < 0 (x above its edge); the same for Y; and Z - depth_max >=
    depth_gap (a view without a positive depth has a record every box is
    outside; a NaN largest depth or gap, one no box is). Record 6 holds the
    three rows' magnitudes: a box where they reach CULL_BIG is never
    culled."""
    P = P.double()
    m, m3 = P[:, :, :3], P[:, :, 3]
    T = CULL_TINY / CULL_REL

    def rec(w, w3, g, g3):
        return torch.cat([w, w3[:, None], g, g3[:, None]], -1)

    mx, my, mz = m[:, 0], m[:, 1], m[:, 2]
    ax, ay, az = mx.abs(), my.abs(), mz.abs()
    x3, y3, z3 = m3[:, 0], m3[:, 1], m3[:, 2]
    out = [rec(mz, z3 - z_min, az, z3.abs() + T)]
    for mr, ar, r3, high in ((mx, ax, x3, high_x), (my, ay, y3, high_y)):
        out.append(rec(mr + low * mz, r3 + low * z3, ar + low * az,
                       r3.abs() + low * z3.abs() + (1 + low) * T))
        out.append(rec(-mr + high * mz, -r3 + high * z3, ar + high * az,
                       r3.abs() + high * z3.abs() + (1 + high) * T))
    dmax = depth_max.double()
    depth = rec(-mz, -z3 + dmax + depth_gap, az, z3.abs() + T)
    always = torch.zeros_like(depth)
    always[:, 3] = -1.0
    out.append(torch.where((dmax <= 0)[:, None], always, depth))
    out.append(rec(torch.zeros_like(mz), torch.zeros_like(z3),
                   ax + ay + az, x3.abs() + y3.abs() + z3.abs()))
    return torch.stack(out, 1)


def box_cull(lo: torch.Tensor, hi: torch.Tensor,
             planes: torch.Tensor) -> torch.Tensor:
    """Whether float64 boxes lo/hi [..., 1, 3] lie outside one of the
    half-spaces of each view's `frustum_planes` [N, 7, 8] -> [..., N]. The
    largest value of a form over a box is w3 + w . c + |w| . h (centre c,
    half-extent h); a box with a non-finite bound is never culled."""
    c, h = (lo + hi) / 2, (hi - lo) / 2
    A = torch.maximum(lo.abs(), hi.abs())
    w, w3, g, g3 = (planes[..., :3], planes[..., 3], planes[..., 4:7],
                    planes[..., 7])
    c, h, A = c[..., None, :], h[..., None, :], A[..., None, :]
    U = w3 + (w * c).sum(-1) + (w.abs() * h).sum(-1)
    margin = CULL_REL * (g3 + (g * A).sum(-1))
    hit = (U + margin < 0)[..., :6].any(-1)
    sane = (g3 + (g * A).sum(-1))[..., 6] <= CULL_BIG
    finite = torch.isfinite(lo).all(-1) & torch.isfinite(hi).all(-1)
    return hit & sane & finite


TINY = 2.0 ** -126           # the least normal fp32
QUOT = 1 + 2.0 ** -22        # two fp32 ulps of a quotient


def fuse_planes(cams: torch.Tensor, depth_max: torch.Tensor, W: int, H: int,
                z_thresh: float) -> torch.Tensor:
    """K9b's half-spaces per view (`frustum_planes`): no point of a box can
    make a valid pair where z <= 1e-4, or x < 0, x > W - 1, y < 0 or y >
    H - 1 for every z > 1e-4 (each quotient two ulps past its edge, and
    past the least normal for underflow), or z >= the view's largest depth
    + z_thresh, or the view has no positive depth."""
    zt = float(torch.tensor(z_thresh, dtype=torch.float32))
    return frustum_planes(cams[:, :12].reshape(-1, 3, 4), Z_MIN, TINY,
                          (W - 1) * QUOT + TINY, (H - 1) * QUOT + TINY,
                          depth_max, zt)


def fuse_cull(lo: torch.Tensor, hi: torch.Tensor, cams: torch.Tensor,
              depth_max: torch.Tensor, W: int, H: int,
              z_thresh: float) -> torch.Tensor:
    """Whether the bounds prove that no point of a box can make a valid
    pair with a view: float64 boxes lo/hi [..., 1, 3] of fp32 points
    against the views of cams [N, 33] with their largest depths [N]
    (NaN disables the depth test) -> [..., N] (`fuse_planes`, `box_cull`).
    A box with a non-finite or huge bound is never skipped."""
    return box_cull(lo, hi, fuse_planes(cams, depth_max, W, H, z_thresh))


def fuse_tile_boxes(ref_depth: torch.Tensor, cams: torch.Tensor,
                    self_idx: torch.Tensor):
    """The kernel's pixel groups and their boxes: the ref pixels in tiles of
    TILE, each tile's pixels in two groups (0: depth > 0 and finite; 1: the
    others, where a zero depth puts the point at the ref camera). Returns
    (lo, hi [C, T, 2, 3] float64 over each group's world points, +-inf
    where the group is empty or holds a non-finite point, members [C, T, 2],
    pixel_tile [H*W] and pixel_group [C, H*W]), tiles in row-major
    order."""
    C, H, W = ref_depth.shape
    th, tw = TILE
    ny, nx = -(-H // th), -(-W // tw)
    T = ny * nx
    dev = ref_depth.device
    pw = torch.stack(ref_points(ref_depth, cams, self_idx), -1).double()
    d = ref_depth.reshape(C, H * W)
    group = (~((d > 0) & (d < float("inf")))).long()
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    tile = ((yy // th) * nx + xx // tw).reshape(-1)
    slot = (tile[None] * 2 + group).reshape(C, -1)          # [C, P]
    bad = ~torch.isfinite(pw).all(-1)
    inf = torch.full((C, T * 2, 3), float("inf"), dtype=torch.float64,
                     device=dev)
    idx = slot[..., None].expand(C, H * W, 3)
    lo = inf.scatter_reduce(1, idx, pw, "amin")
    hi = (-inf).scatter_reduce(1, idx, pw, "amax")
    members = torch.zeros((C, T * 2), dtype=torch.long, device=dev) \
        .scatter_add(1, slot, torch.ones_like(slot))
    nonfinite = torch.zeros((C, T * 2), dtype=torch.long, device=dev) \
        .scatter_add(1, slot, bad.long()) > 0
    lo = torch.where(nonfinite[..., None], -inf, lo)
    hi = torch.where(nonfinite[..., None], inf, hi)
    shape = (C, T, 2)
    return (lo.reshape(*shape, 3), hi.reshape(*shape, 3),
            members.reshape(shape), tile, group)


def fuse_skip_ref(ref_depth: torch.Tensor, all_depth: torch.Tensor,
                  cams: torch.Tensor, self_idx: torch.Tensor,
                  z_thresh: float, depth_max=None):
    """The kernel's cull in plain torch: skip [C, T, 2, N] for every (ref,
    tile, pixel group, view) that the kernel never runs (`fuse_cull` on
    the group's box, and the ref's own view), with the groups' members
    [C, T, 2], each pixel's tile [H*W] and group [C, H*W]."""
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    if depth_max is None:
        depth_max = all_depth.reshape(N, -1).amax(1)
    lo, hi, members, tile, group = fuse_tile_boxes(ref_depth, cams,
                                                   self_idx)
    skip = fuse_cull(lo[..., None, :], hi[..., None, :], cams, depth_max, W,
                     H, z_thresh)
    own = torch.arange(N, device=ref_depth.device) == self_idx[:, None]
    return skip | own[:, None, None, :], members, tile, group


def consistency_fuse(ref_depth: torch.Tensor, all_depth: torch.Tensor,
                     cams: torch.Tensor, self_idx: torch.Tensor,
                     z_thresh: float, n_consistent: int,
                     depth_max: torch.Tensor = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as `consistency_fuse_ref`; launches the CUDA kernel
    for CUDA tensors. `depth_max` [N] is each view's largest depth (NaN
    where its map holds a NaN), which the kernel's cull reads; the caller
    that runs several chunks against the same views reduces it once
    (`all_depth.reshape(N, -1).amax(1)`), else the wrapper does."""
    if on_cpu(ref_depth, all_depth, cams, self_idx):
        return consistency_fuse_ref(ref_depth, all_depth, cams, self_idx,
                                    z_thresh, n_consistent)
    no_backward("consistency_fuse", ref_depth, all_depth, cams)
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    check(ref_depth, "ref_depth", torch.float32, (C, H, W))
    check(all_depth, "all_depth", torch.float32, (N, H, W))
    check(cams, "cams", torch.float32, (N, CAM))
    check(self_idx, "self_idx", torch.int64, (C,))
    if depth_max is None:
        depth_max = all_depth.reshape(N, -1).amax(1)
    check(depth_max, "depth_max", torch.float32, (N,))
    dev = ref_depth.device
    gx, gy = pixel_grid(H, W, dev)
    pts = torch.empty((C, H * W, 3), dtype=torch.float32, device=dev)
    keep = torch.empty((C, H * W), dtype=torch.bool, device=dev)
    planes = torch.empty((7 * 8, N), dtype=torch.float64, device=dev)
    launch("tdv_consistency_fuse", dev, ref_depth.data_ptr(),
           all_depth.data_ptr(), cams.data_ptr(), depth_max.data_ptr(),
           planes.data_ptr(), self_idx.data_ptr(), gx.data_ptr(),
           gy.data_ptr(), pts.data_ptr(), keep.data_ptr(), C, N, H, W,
           float(z_thresh), int(n_consistent))
    consistency_fuse.launches += 1
    return pts, keep


consistency_fuse.launches = 0
