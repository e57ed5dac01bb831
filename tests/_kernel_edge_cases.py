"""Seeded numpy inputs at the edges that the brick-binned trilinear
backward (`csrc/trilinear_sample_backward.cu`) and the map-based dense
scatter (`csrc/voxelize.cu`) must keep. Numpy only: the CPU tests hand them
to the JAX functions and the twins, the card tests to the kernels."""
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
