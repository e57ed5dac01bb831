"""The exact culls of the 3D evaluation's kernels in plain torch, on the
CPU: every (tile, pixel group, view) that `fusion.fuse_skip_ref` skips
holds no valid pair of `consistency_fuse_ref` (K9b), every (brick, frame)
that `tsdf.tsdf_skip_ref` skips no valid pair of `tsdf_integrate_ref`
(K9a), on tiny scenes with ragged tiles and bricks and hostile depths and
on points placed ulps from every edge of the frustum; a normal scene skips
a share above 0. Also the timing tool's counts and bounds
(`tools/time_eval3d.py`) against the twins and plain formulas."""
import numpy as np
import pytest
import torch

from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)


def _scene(n_views, hw, seed=5, drop=0.05):
    """A synthetic room scene with noisy depths (a `drop` share zeroed), its
    camera table and projections."""
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.kernels.fusion import camera_table

    sc = synthetic.make_scene(n_views, hw, seed=seed, normalize=False)
    rng = np.random.default_rng(seed)
    d = sc["depth"] * (1 + rng.normal(0, 0.003, sc["depth"].shape))
    d[rng.random(d.shape) < drop] = 0
    cams = camera_table(*(torch.from_numpy(sc[k])
                          for k in ("K", "rotmats", "tvecs")))
    P = np.einsum("nij,njk->nik", sc["K"], np.concatenate(
        [sc["rotmats"], sc["tvecs"][..., None]], 2)).astype(np.float32)
    return torch.from_numpy(d.astype(np.float32)), cams, torch.from_numpy(P), \
        sc


def _hostile(d):
    """NaN, inf and negative blocks, a map of zeros, a duplicate view."""
    d = d.clone()
    d[0, :3] = float("nan")
    d[1, 5:9, 4:20] = float("inf")
    d[2, 10:, 20:] *= -1
    d[3] = 0
    return d


def _fuse_violations(depth, cams, refs, z_thresh=0.01):
    """(skipped pairs that are valid, valid pairs, the share of pairs the
    cull leaves) of the twin's cull on refs against all views."""
    from tdvnet_torch.kernels import fusion as F

    idx = torch.arange(*refs)
    args = (depth[refs[0]:refs[1]], depth, cams, idx, z_thresh)
    skip, members, tile, group = F.fuse_skip_ref(*args)
    pw = F.ref_points(depth[refs[0]:refs[1]], cams, idx)
    zt = torch.tensor(z_thresh, dtype=torch.float32)
    rows = torch.arange(len(idx))[:, None]
    bad = n_valid = 0
    for s in range(depth.shape[0]):
        valid, *_ = F._fuse_view(pw, cams[s], depth[s], zt)
        valid &= (idx != s)[:, None]
        n_valid += int(valid.sum())
        bad += int((valid & skip[rows, tile[None], group, s]).sum())
    runs = float((members[..., None] * ~skip).sum()) / (
        depth[refs[0]:refs[1]].numel() * depth.shape[0])
    return bad, n_valid, runs


@pytest.mark.parametrize("case", ["normal", "ragged_hostile", "duplicate"])
def test_fuse_skip_has_no_valid_pair(case):
    d, cams, _, _ = _scene(10, (17, 33) if case != "normal" else (40, 52))
    if case == "ragged_hostile":
        d = _hostile(d)
    if case == "duplicate":
        # views 4 and 5 share view 3's camera and depth: every pixel of ref
        # 3 lands on itself in both, the map's edges included
        cams = cams.clone()
        cams[4] = cams[5] = cams[3]
        d = d.clone()
        d[4] = d[5] = d[3]
    bad, n_valid, runs = _fuse_violations(d, cams, (0, 6))
    assert bad == 0
    assert n_valid > 0
    assert 0.0 < runs < 1.0           # something is skipped, not all


def test_fuse_skip_is_exact_for_the_ref_camera_points():
    """Zero depths put a pixel at its ref's camera; that group's box is one
    point, and in a ring of outward-looking cameras no other view sees it
    in front: the twin skips every view for it and no pair was valid."""
    from tdvnet_torch.kernels import fusion as F

    d, cams, _, _ = _scene(10, (40, 52), drop=0.3)
    skip, members, _, _ = F.fuse_skip_ref(d[:4], d, cams, torch.arange(4),
                                          0.01)
    assert (members[..., 1] > 0).any()
    assert skip[..., 1, :][members[..., 1] > 0].all()
    assert _fuse_violations(d, cams, (0, 4))[0] == 0


def _tsdf_violations(depth, P, origin, dims, vs):
    from tdvnet_torch.kernels import tsdf as T

    skip, brick = T.tsdf_skip_ref(depth, P, origin, dims, vs)
    world = T.voxel_centers(dims, vs, origin)
    it = torch.tensor(T._inv_trunc(vs, 3.0))
    bad = n_valid = 0
    for f in range(depth.shape[0]):
        valid, _, _ = T._tsdf_frame(P[f], world[:, 0], world[:, 1],
                                    world[:, 2], depth[f], it)
        n_valid += int(valid.sum())
        bad += int((valid & skip[brick, f]).sum())
    members = torch.bincount(brick, minlength=skip.shape[0])
    runs = float((members[:, None] * ~skip).sum()) / (
        world.shape[0] * depth.shape[0])
    return bad, n_valid, runs


@pytest.mark.parametrize("case", ["normal", "ragged_hostile", "far_volume"])
def test_tsdf_skip_has_no_valid_pair(case):
    d, _, P, _ = _scene(12, (37, 53))
    origin, dims, vs = torch.tensor([-2.3, -2.2, -0.25]), (23, 17, 11), 0.2
    if case == "ragged_hostile":
        d = _hostile(d)
        d[4] = -1.0                       # no positive depth
        P = P.clone()
        P[5] = -P[5]                      # the volume behind the camera
    if case == "far_volume":
        origin, dims = torch.tensor([-9.0, -9.0, -6.0]), (90, 90, 70)
    bad, n_valid, runs = _tsdf_violations(d, P, origin, dims, vs)
    assert bad == 0
    assert n_valid > 0
    assert 0.0 < runs < (0.2 if case == "far_volume" else 1.0)


# ------------------------------------------------- points ulps from an edge
def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _edge_cameras(gen, n):
    """n random world-to-pixel cameras: a camera table [n, 33] (P = K[R|t])
    and the projections [n, 3, 4]."""
    from tdvnet_torch.kernels.fusion import camera_table

    q, _ = torch.linalg.qr(torch.randn(n, 3, 3, generator=gen,
                                       dtype=torch.float64))
    R = (q * torch.sign(torch.linalg.det(q))[:, None, None]).float()
    f = 20 + 100 * torch.rand(n, generator=gen)
    K = torch.zeros(n, 3, 3)
    K[:, 0, 0], K[:, 1, 1] = f, f * (0.9 + 0.2 * torch.rand(n, generator=gen))
    K[:, 0, 2] = 15 * torch.rand(n, generator=gen)
    K[:, 1, 2] = 11 * torch.rand(n, generator=gen)
    K[:, 2, 2] = 1
    t = torch.randn(n, 3, generator=gen)
    cams = camera_table(K, R, t)
    return cams, cams[:, :12].reshape(n, 3, 4)


def _points_at(P, uv, z):
    """World points [n, m, 3] (fp32) that project with P [n, 3, 4] near the
    pixels uv [n, m, 2] at depth z [n, m], solved in double."""
    M, m3 = P[:, :, :3].double(), P[:, :, 3].double()
    rhs = torch.stack([uv[..., 0] * z, uv[..., 1] * z, z], -1) - m3[:, None]
    return torch.linalg.solve(M[:, None], rhs[..., None])[..., 0].float()


def _project(P, p):
    """The kernels' fp32 forms of points p [n, m, 3] (rows fma(m2, z,
    fma(m1, y, m0 * x)) + m3)."""
    from tdvnet_torch.kernels.tsdf import _project_rows

    return [torch.stack([_project_rows(P[i], *p[i].unbind(-1))[r]
                         for i in range(len(P))]) for r in range(3)]


def _near_edges(gen, n, m, W, H):
    """Pixels on and near the edges (0, W - 1, -0.5, W - 0.5, ...) and a
    spread of depths, ulps to a few thousandths off."""
    edges = torch.tensor([0.0, W - 1.0, -0.5, W - 0.5, 0.0, H - 1.0, -0.5,
                          H - 0.5])
    k = torch.randint(0, 4, (n, m), generator=gen)
    side = torch.randint(0, 2, (n, m), generator=gen)
    off = torch.sign(torch.randn(n, m, generator=gen)) * 10 ** (
        -7 + 4 * torch.rand(n, m, generator=gen))
    u = torch.rand(n, m, generator=gen) * W
    v = torch.rand(n, m, generator=gen) * H
    e = edges[k + 4 * side] + off * torch.rand(n, m, generator=gen).round()
    uv = torch.stack([torch.where(side == 0, e, u),
                      torch.where(side == 1, e, v)], -1)
    z = 10 ** (-4 + 5 * torch.rand(n, m, generator=gen))
    return uv.double(), z.double()


def test_fuse_cull_is_sound_ulps_from_every_edge():
    """Single points and pairs of nearby points on x = 0 and W - 1, y = 0
    and H - 1 (and a few ulps off), at z from 1e-4 (and 1e-4f +- 1 ulp) up:
    where `fuse_cull` skips a box, no point of it passes the kernel's
    frustum test, nor can it match any depth up to the view's largest."""
    from tdvnet_torch.kernels.fusion import fuse_cull

    gen = torch.Generator().manual_seed(0)
    W, H, n, m = 31, 23, 16, 512
    cams, P = _edge_cameras(gen, n)
    uv, z = _near_edges(gen, n, m, W, H)
    z[:, :24] = torch.tensor(np.float32(1e-4)).double()
    z[:, 24:48] = float(np.nextafter(np.float32(1e-4), np.float32(1)))
    z[:, 48:72] = float(np.nextafter(np.float32(1e-4), np.float32(0)))
    p = _points_at(P, uv, z)
    X, Y, Z = _project(P, p)
    x, y = X / Z, Y / Z
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (Z > 1e-4)
    dmax = torch.rand(n, generator=gen) * 3
    zt = 0.01
    near = (Z - dmax[:, None]) < _f32(zt)     # some depth <= dmax matches
    possible = inside & near & (dmax[:, None] > 0)
    # boxes of one point and of each point with its neighbour
    for lo, hi in ((p, p), (torch.minimum(p, p.roll(1, 1)),
                            torch.maximum(p, p.roll(1, 1)))):
        skip = torch.stack([fuse_cull(
            lo[i].double()[:, None], hi[i].double()[:, None], cams[i:i + 1],
            dmax[i:i + 1], W, H, zt)[:, 0] for i in range(n)])
        ok = possible if lo is p else possible | possible.roll(1, 1)
        assert not (skip & ok).any()
        assert skip.any() and (~skip).any()
    assert inside.any() and (~inside).any()


def test_tsdf_cull_is_sound_ulps_from_every_edge():
    """Voxel centres whose quotient lies on -0.5, W - 0.5, -0.5 and H - 0.5
    (where the rounded pixel changes) and ulps off, and centres near the
    camera plane: where `tsdf_cull` skips a box, no centre of it has an
    in-range pixel, or every one lies more than trunc behind the frame's
    largest depth."""
    from tdvnet_torch.kernels.tsdf import tsdf_cull

    gen = torch.Generator().manual_seed(1)
    W, H, n, m = 31, 23, 16, 512
    _, P = _edge_cameras(gen, n)
    uv, z = _near_edges(gen, n, m, W, H)
    z[:, :32] = 10 ** (-30 + 25 * torch.rand(n, 32, generator=gen)).double()
    p = _points_at(P, uv, z)
    cx, cy, pz = _project(P, p)
    px, py = torch.round(cx / pz), torch.round(cy / pz)
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (pz > 0)
    dmax = torch.rand(n, generator=gen) * 3
    it = np.float32(1) / np.float32(0.12)
    sdf = torch.minimum((dmax[:, None] - pz) * _f32(it), _f32(1.0))
    possible = inb & (sdf > -1) & (dmax[:, None] > 0)
    for lo, hi in ((p, p), (torch.minimum(p, p.roll(1, 1)),
                            torch.maximum(p, p.roll(1, 1)))):
        skip = torch.stack([tsdf_cull(
            lo[i].double()[:, None], hi[i].double()[:, None], P[i:i + 1],
            dmax[i:i + 1], W, H, it)[:, 0] for i in range(n)])
        ok = possible if lo is p else possible | possible.roll(1, 1)
        assert not (skip & ok).any()
        assert skip.any() and (~skip).any()
    assert inb.any() and (~inb).any()


def test_culls_skip_nothing_for_non_finite_boxes_or_depths():
    from tdvnet_torch.kernels.fusion import fuse_cull
    from tdvnet_torch.kernels.tsdf import tsdf_cull

    gen = torch.Generator().manual_seed(2)
    cams, P = _edge_cameras(gen, 3)
    far = torch.tensor([[[1e3, 1e3, 1e3]]], dtype=torch.float64)
    for lo, hi in ((far * float("nan"), far), (-far * float("inf"), far),
                   (far, far * 1e30)):
        assert not fuse_cull(lo, hi, cams, torch.ones(3), 31, 23, 0.01).any()
        assert not tsdf_cull(lo, hi, P, torch.ones(3), 31, 23, 8.0).any()
    # a frame without a positive depth is skipped; NaN disables the test
    pt = torch.zeros(1, 1, 3, dtype=torch.float64)
    for dmax, want in ((0.0, True), (-1.0, True), (float("nan"), False)):
        got = fuse_cull(pt, pt, cams[:1], torch.tensor([dmax]), 31, 23, 0.01)
        assert bool(got.all()) if want else True
        got = tsdf_cull(pt, pt, P[:1], torch.tensor([dmax]), 31, 23, 8.0)
        assert bool(got.all()) if want else True


# ----------------------------------------------------------- the tool
def test_time_eval3d_counts_and_bounds():
    from tdvnet_torch.kernels.fusion import consistency_fuse_ref
    from tdvnet_torch.kernels.tsdf import tsdf_integrate_ref
    from tdvnet_torch.tools import time_eval3d as T

    d, cams, P, sc = _scene(8, (24, 40))
    d = _hostile(d)
    fargs = (d[:4], d, cams, torch.arange(4), 0.01, 2)
    st = T.fuse_pair_stats(fargs)
    _, _, n = consistency_fuse_ref(*fargs, return_counts=True)
    C, H, W = 4, 24, 40
    assert st["pairs"] == C * H * W * 8
    assert st["valid"] == int(n.sum()) > 0
    assert st["valid"] <= st["frustum"] <= st["pairs"]
    assert st["valid"] <= st["run"] < st["pairs"]
    assert T.fuse_bytes(fargs) == 4 * 8 * H * W + 4 * 33 * 8 + C * H * W * 13
    assert T.fuse_touched_bytes(fargs, st) == 4 * C * H * W + 4 * 33 * 8 \
        + C * H * W * 13 + 4 * st["run_taps"]
    cols = torch.from_numpy((sc["images"] * 255).astype(np.uint8))
    targs = (d, cols, P, torch.tensor([-2.3, -2.2, -0.25]), (23, 17, 11),
             0.2, 3.0)
    st = T.tsdf_pair_stats(targs)
    _, w, _ = tsdf_integrate_ref(*targs)
    V = 23 * 17 * 11
    assert st["pairs"] == V * 8 and st["voxels"] == V
    assert st["valid"] == int(w.sum()) > 0
    assert st["observed"] == int((w > 0).sum())
    assert st["valid"] <= st["in_range"] < st["pairs"]
    assert st["valid"] <= st["run"] < st["pairs"]
    assert st["colour_taps"] <= st["taps"]
    assert T.tsdf_bytes(targs, 3) == 7 * 8 * H * W + 48 * 8 + 20 * V
    assert T.tsdf_touched_bytes(targs, st, 3) == 20 * V + 48 * 8 \
        + 4 * st["run_taps"] + 3 * st["colour_taps"]
    assert T.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert T.bound_ms(0, 67e9) == pytest.approx(1.0)
