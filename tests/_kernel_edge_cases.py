"""Seeded numpy inputs at the edges that the brick-binned trilinear
backward (`csrc/trilinear_sample_backward.cu`), the map-based dense
scatter (`csrc/voxelize.cu`) and the two variance kernels
(`csrc/source_variance.cu`, `csrc/patch_fan_variance.cu`) must keep. Numpy
only: the CPU tests hand them to the JAX functions and the twins, the card
tests to the kernels."""
import numpy as np

# grids of 17 x 9 x 12 nodes: bricks of 8 (and 4) along x end in a partial
# brick, one of one node along y, one of four along z
TRI_DIMS = (17, 9, 12)
TRI_CELL = 0.25
TRILINEAR_CASES = ("brick_faces", "grid_edges", "nonfinite", "one_cell",
                   "no_points", "four_channels")


def trilinear_case(name, seed=0):
    """(grad [B, Q, C], pts [B, Q, 3], center0 [B, 3], cell, grid_shape),
    fp32. Node coordinates are multiples of 1/64 and the cell 0.25, so the
    world points and (pts - center0) / cell are exact: an anchor meant to
    sit on a brick's face or the grid's last node does."""
    rng = np.random.default_rng(seed + TRILINEAR_CASES.index(name))
    B, C = 2, 8
    dims = np.array(TRI_DIMS)
    frac = lambda *s: rng.integers(1, 64, s) / 64.0
    if name == "brick_faces":
        # anchors on the high faces of the 8-node (and 4-node) bricks, and
        # at a corner where eight bricks meet
        Q = 400
        q = np.stack([rng.choice([3, 7, 11, 15], (B, Q)),
                      rng.choice([3, 7], (B, Q)),
                      rng.choice([3, 7], (B, Q))], -1) + frac(B, Q, 3)
        q[:, :40] = 7 + frac(B, 40, 3)
    elif name == "grid_edges":
        # on the last node, between the last node and the one past it,
        # anchor -1 (and exactly -1), and just off the grid on both sides
        Q = 600
        picks = [lambda n, s: np.full(s, n - 1.0),
                 lambda n, s: n - 1 + frac(*s),
                 lambda n, s: -1 + frac(*s),
                 lambda n, s: np.full(s, -1.0),
                 lambda n, s: n + frac(*s),
                 lambda n, s: -1 - frac(*s),
                 lambda n, s: rng.integers(0, n - 1, s) + frac(*s)]
        q = np.empty((B, Q, 3))
        for a in range(3):
            which = rng.integers(0, len(picks), (B, Q))
            for i, pick in enumerate(picks):
                q[..., a] = np.where(which == i, pick(dims[a], (B, Q)),
                                     q[..., a])
    elif name == "nonfinite":
        Q = 300
        q = rng.integers(0, dims - 1, (B, Q, 3)) + frac(B, Q, 3)
    elif name == "one_cell":
        # every point in the cell at the corner of eight bricks: long runs
        # of one anchor, one list per brick
        Q = 3000
        q = 7 + frac(B, Q, 3)
    elif name == "no_points":
        Q = 0
        q = np.zeros((B, 0, 3))
    elif name == "four_channels":
        Q, C = 500, 4
        q = rng.integers(-2, dims + 1, (B, Q, 3)) + frac(B, Q, 3)
    else:
        raise ValueError(name)
    c0 = (rng.integers(-8, 8, (B, 3)) / 64.0).astype(np.float32)
    pts = (c0[:, None] + q * TRI_CELL).astype(np.float32)
    if name == "nonfinite":
        for i, v in enumerate((np.nan, np.inf, -np.inf)):
            pts[:, 10 * i:10 * i + 5, i] = v
            pts[:, 10 * i + 5:10 * i + 10, (i + 1) % 3] = v
    grad = rng.normal(size=(B, Q, C)).astype(np.float32)
    return grad, pts, c0, TRI_CELL, (B, *TRI_DIMS, C)


def finite_points(pts):
    """[B, Q] whether a point's coordinates are all finite."""
    return np.isfinite(pts).all(-1)


SCATTER_CASES = ("no_valid", "all_valid", "last_cells", "three_scenes")
SCATTER_GRID = (6, 5, 4)


def scatter_case(name, seed=0):
    """(feats [A, C], anchor_idx3 [A, 3], anchor_scene [A], anchor_valid [A],
    grid_size, n_scenes): an anchor table as `voxelize` leaves it (the
    valid anchors first, in ascending cell order, then the invalid ones at
    cell 0 of scene 0), which JAX's sorted segment sum needs."""
    rng = np.random.default_rng(seed + 10 * SCATTER_CASES.index(name))
    gx, gy, gz = SCATTER_GRID
    n_cells = gx * gy * gz
    B, C = (3 if name == "three_scenes" else 2), 8
    if name == "no_valid":
        A, keys = 50, np.zeros(0, np.int64)
    elif name == "all_valid":
        A = 90
        keys = np.sort(rng.choice(B * n_cells, A, replace=False))
    elif name == "last_cells":
        A = 40
        last = np.arange(1, B + 1) * n_cells - 1
        others = rng.choice(np.setdiff1d(np.arange(B * n_cells), last), 20,
                            replace=False)
        keys = np.sort(np.concatenate([last, others]))
    else:
        A = 200
        keys = np.sort(rng.choice(B * n_cells, 150, replace=False))
    n_valid = len(keys)
    flat = keys % n_cells
    idx3 = np.zeros((A, 3), np.int64)
    idx3[:n_valid] = np.stack([flat // (gy * gz), (flat // gz) % gy,
                               flat % gz], -1)
    scene = np.zeros(A, np.int64)
    scene[:n_valid] = keys // n_cells
    valid = np.arange(A) < n_valid
    feats = rng.normal(size=(A, C)).astype(np.float32)
    return feats, idx3, scene, valid, SCATTER_GRID, B


# ------------------------------------------------------- the variance kernels
# K1 (`source_variance`) takes [R, P, 3] points, K7 (`patch_fan_variance`)
# [R, Hh, P, 3] hypothesis fans (the centre at Hh // 2) along the rays of
# camera 0, which is every ref's first source, so that the cases can place
# a point's footprint (K1) or a fan's centre (K7) on chosen texels of that
# source's map; the other sources see it shifted by their baselines.
VARIANCE_CASES = ("scattered", "edges", "nonfinite", "ragged")
# (name, Hh, the case's channels on the CPU)
FAN_CASES = (("scattered", 7, 32), ("edges", 7, 6), ("wide", 7, 4),
             ("nonfinite", 7, 8), ("single", 1, 64), ("eight", 8, 32))
VARIANCE_CHANNELS = {"scattered": 32, "edges": 4, "nonfinite": 8,
                     "ragged": 64}
SRC_IDX = np.array([[0, 1, 2, 3], [0, 2, 3, 4], [0, 3, 4, 5]])


def _rodrigues(a):
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def variance_cameras(rng, hf, wf, n=6):
    """n cameras along x 0.06 m apart, slightly rotated, whose images are
    (4 hf, 4 wf) pixels: (K, rotmats, tvecs) fp32 and img_size."""
    H, W = 4 * hf, 4 * wf
    K = np.array([[0.8 * W, 0, (W - 1) / 2], [0, 0.8 * W, (H - 1) / 2],
                  [0, 0, 1.0]])
    Rs = [_rodrigues(rng.normal(0, 0.02, 3)) for _ in range(n)]
    ts = [np.array([0.06 * (i - n // 2), *rng.normal(0, 0.01, 2)])
          for i in range(n)]
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(np.repeat(K[None], n, 0)), f32(Rs), f32(ts), (H, W)


def projection_matrices(K, rotmats, tvecs):
    """P = K @ [R | t] [N, 3, 4] fp32 (numpy, for the card tests; the CPU
    tests take the JAX package's)."""
    Rt = np.concatenate([rotmats, tvecs[..., None]], -1).astype(np.float64)
    return (K.astype(np.float64) @ Rt).astype(np.float32)


def _world(K, R, t, fxy, z, img, hw):
    """World points whose camera-0 feature-grid coordinates are fxy [..., 2]
    (x, y) at camera depth z [...]."""
    (H, W), (hf, wf) = img, hw
    u = fxy[..., 0] * (W - 1) / (wf - 1)
    v = fxy[..., 1] * (H - 1) / (hf - 1)
    cam = np.linalg.solve(K.astype(np.float64),
                          np.stack([u, v, np.ones_like(u)], -1)[..., None]
                          )[..., 0] * z[..., None]
    return (cam - t) @ R.astype(np.float64)


def _on_plane(rng, R, t, n):
    """n world points on a camera's plane (camera depth 0, off its axis):
    their projections are huge."""
    cam = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))], -1)
    return (cam - t) @ R.astype(np.float64)


def _edge_anchors(rng, n, size):
    """n texel coordinates whose anchors lie at the map's two edges (-1, 0,
    size - 2, size - 1), fractions away from the integers."""
    a = rng.choice([-1, 0, size - 2, size - 1], n)
    return a + rng.uniform(0.05, 0.95, n)


def variance_case(name, C=None, seed=0):
    """K1's inputs: dict(pts [R, P, 3], feats [N, hf, wf, C], src_idx
    [R, S], src_mask [R, S], K, rotmats, tvecs, img_size), fp32 (the mask
    bool, src_idx int64). Padding sources in every case."""
    rng = np.random.default_rng(100 + seed + VARIANCE_CASES.index(name))
    C = VARIANCE_CHANNELS[name] if C is None else C
    hf, wf = (48, 60) if name == "scattered" else (16, 20)
    K, Rs, ts, img = variance_cameras(rng, hf, wf)
    R = SRC_IDX.shape[0]
    world = lambda fxy, z: _world(K[0], Rs[0], ts[0], fxy, z, img, (hf, wf))
    if name == "scattered":
        # uniform in a box around the cameras: in view, outside it, behind
        # the cameras and on their planes
        P = 320
        pts = rng.uniform([-3, -2, -1.5], [3, 2, 5], (R, P, 3))
        pts[:, ::7] = _on_plane(rng, Rs[0], ts[0], len(range(0, P, 7)))
        m = len(range(3, P, 7))
        pts[:, 3::7] = world(rng.uniform(0, [wf - 1, hf - 1], (m, 2)),
                             rng.uniform(0.5, 4, m))[None]
    elif name == "edges":
        # groups of 32 at the left, right, top and bottom edges and the
        # four corners of camera 0's map, then some fully off it
        P = 288
        fxy = np.empty((P, 2))
        for g in range(8):
            sl = slice(32 * g, 32 * g + 32)
            fxy[sl, 0] = rng.uniform(0.05, wf - 1.05, 32)
            fxy[sl, 1] = rng.uniform(0.05, hf - 1.05, 32)
            if g in (0, 1, 4, 5, 6, 7):
                fxy[sl, 0] = _edge_anchors(rng, 32, wf)
            if g in (2, 3, 4, 5, 6, 7):
                fxy[sl, 1] = _edge_anchors(rng, 32, hf)
        fxy[256:, 0] = rng.choice([-2.5, -1.0 - 1e-3, wf - 1e-3, wf + 0.5], 32)
        fxy[256:, 1] = rng.uniform(0, hf - 1, 32)
        pts = world(fxy, rng.uniform(1.5, 3, P))[None].repeat(R, 0)
    elif name == "nonfinite":
        P = 96
        fxy = rng.uniform(0, [wf - 1, hf - 1], (P, 2))
        pts = world(fxy, rng.uniform(1, 3, P))[None].repeat(R, 0)
        for i, v in enumerate((np.nan, np.inf, -np.inf)):
            pts[:, 5 + 10 * i:8 + 10 * i, i] = v
        pts[:, 40:42] = 3e38               # the projection overflows fp32
    else:  # ragged: a plane sweep's planes, P not a multiple of 32
        P = 100
        g = np.stack(np.meshgrid(np.linspace(0, wf - 1, 10),
                                 np.linspace(0, hf - 1, 5)), -1).reshape(-1, 2)
        pts = np.concatenate([world(g, np.full(50, z)) for z in (1.0, 2.5)])
        pts = pts[None].repeat(R, 0)
    mask = np.ones(SRC_IDX.shape, bool)
    mask[1, 3] = mask[2, 1:3] = False
    feats = rng.normal(size=(6, hf, wf, C)).astype(np.float32)
    return dict(pts=pts.astype(np.float32), feats=feats,
                src_idx=SRC_IDX.copy(), src_mask=mask, K=K, rotmats=Rs,
                tvecs=ts, img_size=img)


def fan_case(name, C=None, seed=0):
    """K7's inputs, as `variance_case` returns them, with pts [R, Hh, P, 3]:
    fans of Hh hypotheses along camera 0's rays (the centre at Hh // 2)."""
    names = [c[0] for c in FAN_CASES]
    _, Hh, c_default = FAN_CASES[names.index(name)]
    rng = np.random.default_rng(200 + seed + names.index(name))
    C = c_default if C is None else C
    hf, wf = (48, 60) if name == "scattered" else (16, 20)
    K, Rs, ts, img = variance_cameras(rng, hf, wf)
    R = SRC_IDX.shape[0]
    # hypothesis depth steps: a fan spans about a texel in the other
    # sources, several texels in "wide"
    step = 0.3 if name == "wide" else 0.02
    if name == "scattered":
        P = 160
        fxy = rng.uniform(-8, [wf + 8, hf + 8], (P, 2))
        z = rng.uniform(-1, 4, P)         # in front of and behind camera 0
    elif name == "edges":
        # tiles of 16 centres at the edges and corners of camera 0's map,
        # then centres whose anchor is out of bounds (-2, wf, far)
        P = 144
        fxy = np.stack([rng.uniform(0.05, wf - 1.05, P),
                        rng.uniform(0.05, hf - 1.05, P)], -1)
        for g in range(8):
            sl = slice(16 * g, 16 * g + 16)
            if g in (0, 1, 4, 5, 6, 7):
                fxy[sl, 0] = _edge_anchors(rng, 16, wf)
            if g in (2, 3, 4, 5, 6, 7):
                fxy[sl, 1] = _edge_anchors(rng, 16, hf)
        fxy[128:, 0] = rng.choice([-1.5, wf + 0.2, 3 * wf], 16)
        z = rng.uniform(1.5, 3, P)
    else:
        P = {"single": 50, "eight": 40}.get(name, 96)
        fxy = rng.uniform(0, [wf - 1, hf - 1], (P, 2))
        z = rng.uniform(1, 3, P)
    centre = _world(K[0], Rs[0], ts[0], fxy, z, img, (hf, wf))
    ray = _world(K[0], Rs[0], ts[0], fxy, np.ones(P), img, (hf, wf)) \
        - _world(K[0], Rs[0], ts[0], fxy, np.zeros(P), img, (hf, wf))
    if name == "scattered":
        centre[::9] = _on_plane(rng, Rs[0], ts[0], len(range(0, P, 9)))
    k = (np.arange(Hh) - Hh // 2)[:, None, None] * step
    pts = (centre[None] + k * ray[None])[None].repeat(R, 0)
    if name == "nonfinite":
        pts[:, Hh // 2, 3:6, 0] = np.nan   # the centre: the whole fan
        pts[:, 1, 10:13, 1] = np.inf       # one hypothesis
        pts[:, 5, 20:23, 2] = -np.inf
        pts[1, :, 30:32] = 3e38            # every hypothesis overflows
    mask = np.ones(SRC_IDX.shape, bool)
    mask[1, 3] = mask[2, 1:3] = False
    feats = rng.normal(size=(6, hf, wf, C)).astype(np.float32)
    return dict(pts=pts.astype(np.float32), feats=feats,
                src_idx=SRC_IDX.copy(), src_mask=mask, K=K, rotmats=Rs,
                tvecs=ts, img_size=img)

