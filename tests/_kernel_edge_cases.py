"""Seeded numpy inputs at the edges that the trilinear sampling forward
(`csrc/trilinear_sample.cu`), its int8 form (`csrc/trilinear_sample_i8.cu`)
and its brick-binned backward (`csrc/trilinear_sample_backward.cu`), the
map-based dense scatter (`csrc/voxelize.cu`), the two variance kernels
(`csrc/source_variance.cu`, `csrc/patch_fan_variance.cu`), the masked
GroupNorm forward (`csrc/masked_group_norm.cu`), the PointNet's segment
plan, pools and concat-back (`csrc/segment_plan.cu`, `csrc/segment_max.cu`),
the soft-argmax (`csrc/softargmax_depth.cu`) and the propagation blend's
backward (`csrc/propagation_blend_backward.cu`) must keep. Numpy only: the
CPU tests hand them to the JAX functions and the twins, the card tests to
the kernels."""
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


# the forward's cases: the backward's, and the runs the forward's tiles of
# 32 queries walk (C/4 lanes a query, up to 32 queries a warp)
TRILINEAR_FORWARD_CASES = TRILINEAR_CASES + ("anchor_runs", "alternating",
                                             "ragged")
TRILINEAR_FORWARD_CHANNELS = (4, 64, 128)


def trilinear_forward_case(name, C, seed=0):
    """(grid [B, X, Y, Z, C], pts [B, Q, 3], center0 [B, 3], cell), fp32:
    the backward's cases' points and new ones. "anchor_runs": runs of 1 to
    40 consecutive queries in one cell, some cells on the grid's faces (a
    partial tap set), runs crossing the tiles' boundaries; "alternating":
    two or three anchors taking turns inside runs, among them anchors with
    the same cell index and other in-grid taps (anchor y = -1 beside the
    previous x plane's y = Y - 1 cell, and scene 1's x = -1 beside scene
    0's x = X - 1 cell at the scenes' boundary); "ragged": B * Q = 2 * 45
    queries, so a tile holds both scenes' and the last tile is partial."""
    rng = np.random.default_rng(1000 + seed
                                + TRILINEAR_FORWARD_CASES.index(name))
    dims = np.array(TRI_DIMS)
    B = 2
    frac = lambda *s: rng.integers(1, 64, s) / 64.0
    if name in TRILINEAR_CASES:
        _, pts, c0, cell, _ = trilinear_case(name, seed)
    else:
        c0 = (rng.integers(-8, 8, (B, 3)) / 64.0).astype(np.float32)
        if name == "anchor_runs":
            Q = 700
            cells = []
            while len(cells) < Q:
                a = rng.integers(-1, dims)          # -1 .. X - 1: in range
                cells += [a] * int(rng.integers(1, 41))
            q = np.array(cells[:Q], np.float64)[None].repeat(B, 0) \
                + frac(B, Q, 3)
        elif name == "alternating":
            Q = 640
            X, Y, Z = dims
            pairs = [((3, -1, 4), (2, Y - 1, 4)),  # one cell index, two taps
                     ((5, 2, -1), (5, 1, Z - 1)),
                     ((0, 0, 0), (1, 0, 0)), ((7, 3, 5), (7, 3, 6))]
            q = np.empty((B, Q, 3))
            for i in range(Q // 32):
                a, b2 = pairs[i % len(pairs)]
                pat = [a, b2] if i % 3 else [a, a, b2, a, b2, b2]
                third = rng.integers(0, dims - 1)
                for j in range(32):
                    cell_j = pat[j % len(pat)] if j % 11 else third
                    q[:, 32 * i + j] = cell_j
            q += frac(B, Q, 3)
            # at the scenes' boundary scene 0 ends at x = X - 1, scene 1
            # starts at x = -1: the same cell index, other taps
            q[0, -8:] = (X - 1, 4, 5) + frac(8, 3)
            q[1, :8] = (-1, 4, 5) + frac(8, 3)
        elif name == "ragged":
            Q = 45
            q = rng.integers(-1, dims, (B, Q, 3)) + frac(B, Q, 3)
            q[:, 10:30] = q[:, 10:11]               # one run
        else:
            raise ValueError(name)
        cell = TRI_CELL
        pts = (c0[:, None] + q * cell).astype(np.float32)
    return forward_grid(C), pts, c0, cell


def forward_grid(C):
    """The forward cases' grid [2, X, Y, Z, C <= 256]: the first C channels
    of one seeded 256-channel grid, so that one JAX call covers every
    width."""
    grid = np.random.default_rng(999).normal(size=(2, *TRI_DIMS, 256))
    return np.ascontiguousarray(grid[..., :C], np.float32)


# ------------------------------------------------- the masked GroupNorm
# (name, B, dims): V = 1; V % 4 != 0; the scene U-Net's level sizes
# (1 536, 12 288, 98 304 voxels); one active voxel; an empty mask; two
# scenes with different counts; a mean large against its spread.
# One width (C = 8, G = 2) so that the CPU tests stack every case in one
# JAX call; the card tests add the U-Net's widths
GN_CASES = (("one_voxel", 2, (1, 1, 1)), ("ragged", 2, (5, 3, 3)),
            ("level2", 2, (16, 12, 8)), ("level1", 1, (32, 24, 16)),
            ("level0", 1, (64, 48, 32)), ("one_active", 2, (16, 12, 8)),
            ("empty", 2, (16, 12, 8)), ("two_counts", 2, (16, 12, 8)),
            ("large_mean", 2, (16, 12, 8)))
GN_DIMS = (64, 48, 32)                  # every case's dims fit in these


def gn_case(name, C=8, G=2):
    """(x [B, C, *dims], mask [B, 1, *dims] in {0, 1}, skip [B, C, *dims],
    weight [C], bias [C], groups), fp32, NCDHW as the kernel takes them;
    x and skip are zero where the mask is (the U-Net's inputs are)."""
    names = [c[0] for c in GN_CASES]
    _, B, dims = GN_CASES[names.index(name)]
    rng = np.random.default_rng(300 + names.index(name))
    active = {"two_counts": None, "empty": 0.0}.get(name, 0.3)
    if name == "one_voxel":
        mask = np.array([1.0, 0.0])[:, None, None, None, None] \
            * np.ones((B, 1, *dims))
    elif name == "two_counts":
        mask = np.stack([rng.uniform(size=(1, *dims)) < p
                         for p in (0.9, 0.05)])
    elif name == "one_active":
        mask = np.zeros((B, 1, *dims))
        mask[0, 0, 3, 5, 2] = 1.0
        mask[1, 0, 15, 11, 7] = 1.0
    else:
        mask = rng.uniform(size=(B, 1, *dims)) < active
    mask = mask.astype(np.float32)
    mean, spread = (30.0, 1.0) if name == "large_mean" else (1.0, 2.0)
    x = (rng.normal(mean, spread, (B, C, *dims)) * mask).astype(np.float32)
    skip = (rng.normal(size=(B, C, *dims)) * mask).astype(np.float32)
    # one affine for every case (the CPU tests' JAX call takes one)
    wb = np.random.default_rng(399).normal(size=(2, C)).astype(np.float32)
    return x, mask, skip, wb[0], wb[1], G


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



# ------------------------------------------- the int8 sampling (K6-int8)
# the forward's points in an int8 grid padded by I8_PAD low-side nodes, as
# the fast path's merged grid is (node coordinates (pts - center0) / cell +
# I8_PAD): the anchors at -1 and dim - 1 and the pad's nodes, outside the
# grid, non-finite points, runs of one anchor, anchors that alternate, a
# ragged last tile; C = 96 is the fast path's rank
I8_CHANNELS = (4, 96, 128, 160)
I8_PAD = 3


def i8_case(name, C, seed=0):
    """(grid [2, X, Y, Z, C] int8, scale [2, C] fp32, pts [2, Q, 3],
    center0 [2, 3], cell, cell_offset): `trilinear_forward_case`'s points,
    whose node coordinates stay exact (multiples of 1/64, the cell 0.25, the
    centre moved by the pad), in the first C channels of one seeded
    160-channel table, so that one JAX call covers every width."""
    _, pts, c0, cell = trilinear_forward_case(name, 4, seed)
    rng = np.random.default_rng(777)
    grid = rng.integers(-127, 128, (2, *TRI_DIMS, 160)).astype(np.int8)
    grid[:, 4:6] = 0                       # a slab of empty cells
    scale = rng.uniform(1e-3, 5e-2, (2, 160)).astype(np.float32)
    return (np.ascontiguousarray(grid[..., :C]),
            np.ascontiguousarray(scale[:, :C]), pts,
            (c0 + np.float32(I8_PAD * cell)).astype(np.float32), cell,
            float(I8_PAD))


# --------------------------------------- the PointNet's pools (K4 forward)
# (name, P, n_seg): NaN of either sign, +-inf, -0.0 and maxima at and
# around the empty threshold -5e29; every row invalid; ids below 0 and at
# or past n_seg; one segment of ~10^5 rows; many empty trailing segments;
# segments of 256 and 257 rows (either side of the pools' long path) and a
# dump slot that overflowing points fill, as the main path's
POOL_CASES = (("specials", 600, 40), ("all_invalid", 300, 20),
              ("out_of_range", 500, 30), ("one_long", 100000, 50),
              ("trailing_empty", 400, 5000), ("long_threshold", 3000, 257))
POOL_CHANNELS = (4, 128, 160)
NEG_NAN = np.frombuffer(np.uint32(0xffc00000).tobytes(), np.float32)[0]


def pool_case(name, C=160, seed=0):
    """(y [P, C] fp32, seg [P] int64, valid [P] bool, n_seg): the first C
    channels of one seeded 160-channel case, so that one JAX call covers
    every width."""
    names = [c[0] for c in POOL_CASES]
    _, P, n_seg = POOL_CASES[names.index(name)]
    rng = np.random.default_rng(500 + seed + names.index(name))
    y = rng.normal(size=(P, 160)).astype(np.float32)
    seg = rng.integers(0, n_seg, P)
    valid = rng.uniform(size=P) < 0.8
    if name == "specials":
        seg[:80] = np.repeat(np.arange(8), 10)    # segments 0-7, ten rows
        seg[80:] = rng.integers(8, n_seg, P - 80)
        valid[:80] = True
        y[0:10] = -0.0                            # only -0.0
        y[10, 0] = np.nan                         # a NaN beside finite rows
        y[20, 1] = NEG_NAN                        # a NaN with its sign set
        y[30:40] = -np.inf                        # reads 0
        y[40:50] = -6e29
        y[45] = -5e29                             # at the threshold: 0
        y[50:60] = -6e29
        y[55] = -4.9e29                           # above it: kept
        y[60, :] = np.inf
        y[70:75] = -0.0
        y[75:80] = 0.0                            # -0.0 beside +0.0
        y[100::40, 3] = np.nan                    # invalid: no effect
        valid[100::40] = False
        y[121::40, 5] = NEG_NAN                   # valid: the max is NaN
        valid[121::40] = True
    elif name == "all_invalid":
        valid[:] = False
    elif name == "out_of_range":
        seg = rng.integers(-3, n_seg + 4, P)
        seg[:5] = (-1, n_seg, n_seg + 1, -(2 ** 40), 2 ** 40)
    elif name == "one_long":
        seg[rng.uniform(size=P) < 0.98] = 17
        valid[:] = True
    elif name == "trailing_empty":
        seg = rng.integers(0, 10, P)
    elif name == "long_threshold":
        # segments 3, 4 and 9 hold 256, 257 and 1000 valid rows; the dump
        # slot (n_seg - 1) the invalid points and 300 valid ones
        seg = rng.integers(10, n_seg - 1, P)
        valid[:] = True
        at = 0
        for s, k in ((3, 256), (4, 257), (9, 1000), (n_seg - 1, 300)):
            seg[at:at + k] = s
            at += k
        seg[at:at + 200] = n_seg - 1
        valid[at:at + 200] = False
        order = rng.permutation(P)
        seg, valid, y = seg[order], valid[order], y[order]
    return np.ascontiguousarray(y[:, :C]), seg.astype(np.int64), valid, n_seg


# ------------------------------- the soft-argmax (K8b) and K8a's backward
# (name, D, (h, w)): one plane (one warp's band), 97 planes (bands of 11
# and a ragged last one), and at 24 planes: +-inf costs, NaN, exact ties
# and costs x100 (the exponentials underflow to zero but at the minimum).
# The maps of 7 x 9 pixels (odd: one pixel a lane) and 6 x 11 (even: two a
# lane) cut each ref's second strip.
SOFTARGMAX_CASES = (("one_plane", 1, (7, 9)), ("ragged_band", 97, (6, 11)),
                    ("infinities", 24, (7, 9)), ("nan", 24, (6, 11)),
                    ("ties", 24, (7, 9)), ("large", 24, (6, 11)))


def softargmax_case(name, seed=0):
    """(cost [3, D, h, w], depth_vals [D], grad [3, h, w]), fp32; grad is
    an incoming gradient of the depth."""
    names = [c[0] for c in SOFTARGMAX_CASES]
    _, D, (h, w) = SOFTARGMAX_CASES[names.index(name)]
    rng = np.random.default_rng(700 + seed + names.index(name))
    R = 3
    cost = rng.normal(0, 3, (R, D, h, w))
    if name == "infinities":
        cost[0, 3, 2, :] = -np.inf     # -cost = +inf: inf - inf, NaN
        cost[1, :, 1, 1] = np.inf      # every plane -inf after negation
        cost[1, 5, 3, 3] = np.inf      # one plane's weight exactly 0
        cost[2, :, 4, 4] = -np.inf
        cost[2, 7:, 5, 6] = np.inf
    elif name == "nan":
        cost[0, 7, 1, 2] = np.nan
        cost[2, :, 0, 0] = np.nan
        cost[1, 0, 5, 10] = np.nan     # the first plane, last pixel
    elif name == "ties":
        cost = rng.integers(-2, 3, (R, D, h, w)).astype(np.float64)
        cost[0, :, 0, :] = 1.0         # every plane the same
        cost[1, :, 2, 3] = 0.0
        cost[1, :, 2, 4] = -0.0
    elif name == "large":
        cost = cost * 100
    dv = (0.5 + 0.05 * np.arange(D)).astype(np.float32)
    grad = rng.normal(size=(R, h, w)).astype(np.float32)
    return cost.astype(np.float32), dv, grad


# (name, H, W): one pixel, one row, one column, 2 x 2 (every tap clamps
# somewhere) and a map that the kernel's 32 x 8 tiles cut on both axes
BLEND_CASES = (("one_pixel", 1, 1), ("one_row", 1, 40),
               ("one_column", 37, 1), ("two_by_two", 2, 2),
               ("ragged", 33, 65))


def blend_case(name, seed=0):
    """(grad [3, H, W], logits [3, 9, H, W], depth [3, H, W]), fp32: the
    logits as the NCHW output of a conv, which PropagationNet hands over
    as the [N, H, W, 9] view `logits.transpose(0, 2, 3, 1)`; grad is an
    incoming gradient of the blend's output."""
    names = [c[0] for c in BLEND_CASES]
    _, H, W = BLEND_CASES[names.index(name)]
    rng = np.random.default_rng(800 + seed + names.index(name))
    logits = rng.normal(0, 3, (3, 9, H, W)).astype(np.float32)
    depth = rng.uniform(0.5, 5, (3, H, W)).astype(np.float32)
    grad = rng.normal(size=(3, H, W)).astype(np.float32)
    return grad, logits, depth
