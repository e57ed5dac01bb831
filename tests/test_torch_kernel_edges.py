"""The edges that the brick-binned trilinear backward, the map-based dense
scatter and the two variance kernels must keep, on the CPU: each twin
against the JAX function it stands for, on the seeded numpy inputs of
`_kernel_edge_cases` (the card tests in tests/test_torch_cuda.py hold the
kernels to these twins on the same inputs); and a plain model of the
backward's binning (each point's entries per brick, each brick summing
only its own nodes) against the twin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import n, t
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# relative L2 of an fp32 grid gradient against another fp32 sum of the same
# terms (both sides read 0 to 3.4e-8 on these inputs)
GRAD_RTOL = 1e-6


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_grid_grad(grad, pts, c0, cell, shape):
    """jax.vjp of the oct path that training samples through
    (tdvnet/models/hypothesis.py:122) with respect to the grid."""
    from tdvnet.ops.sampling import (pack_trilinear_octs,
                                     trilinear_sample_octs)

    B, X, Y, Z, C = shape

    def sample(gr):
        q = (jnp.asarray(pts) - jnp.asarray(c0)[:, None]) / cell
        octs = jax.vmap(pack_trilinear_octs)(gr)
        return jax.vmap(trilinear_sample_octs, in_axes=(0, 0, None))(
            octs, q, (X, Y, Z))

    _, vjp = jax.vjp(sample, jnp.zeros(shape, jnp.float32))
    return np.asarray(vjp(jnp.asarray(grad))[0])


@pytest.mark.parametrize("case", E.TRILINEAR_CASES)
def test_trilinear_backward_ref_matches_jax_at_edges(case):
    from tdvnet_torch.kernels.trilinear import trilinear_sample_backward_ref

    grad, pts, c0, cell, shape = E.trilinear_case(case)
    got = n(trilinear_sample_backward_ref(t(grad), t(pts), t(c0), cell,
                                          shape))
    assert got.shape == shape
    keep = E.finite_points(pts).all(0)
    if case == "nonfinite":
        # the one deliberate difference: JAX's gradient of a point with a
        # non-finite coordinate is NaN (XLA converts floor(NaN) to cell 0,
        # and inf - inf weights times a zero mask stay NaN); the twin and
        # the kernel take nothing from it, as if it were absent
        assert not keep.all() and np.isfinite(got).all()
    want = _jax_grid_grad(grad[:, keep], pts[:, keep], c0, cell, shape)
    if case == "no_points":
        assert not got.any() and not want.any()
        return
    assert np.abs(want).max() > 0
    assert _rel_l2(got, want) < GRAD_RTOL
    if case == "grid_edges":
        # taps on the grid's faces, from both sides, took gradient
        X, Y, Z = shape[1:4]
        for face in (want[:, 0], want[:, X - 1], want[:, :, 0],
                     want[:, :, Y - 1], want[..., 0, :], want[..., Z - 1, :]):
            assert np.abs(face).max() > 0


def _brick_model(grad, pts, c0, cell, shape, brick=8):
    """The kernel's algorithm in numpy: an entry per (point, brick that its
    in-grid taps touch), then each brick summing the taps of its entries
    that fall in its own nodes. Returns (d grid, entries per point that
    takes gradient)."""
    B, X, Y, Z, C = shape
    dims = np.array([X, Y, Z])
    sizes = np.array([brick] * 3)
    q = ((pts - c0[:, None]) / np.float32(cell)).astype(np.float32)
    out = np.zeros(shape, np.float32)
    n_entries = n_taking = 0
    for b in range(B):
        for p in range(pts.shape[1]):
            if not np.isfinite(q[b, p]).all():
                continue
            f = np.floor(q[b, p])
            if ((f < -1) | (f > dims - 1)).any():
                continue
            n_taking += 1
            a0 = f.astype(int)
            w = q[b, p] - f
            lo = np.maximum(a0, 0)
            hi = np.minimum(a0 + 1, dims - 1)
            bricks = [range(lo[i] // sizes[i], hi[i] // sizes[i] + 1)
                      for i in range(3)]
            for bx in bricks[0]:
                for by in bricks[1]:
                    for bz in bricks[2]:
                        n_entries += 1
                        start = np.array([bx, by, bz]) * sizes
                        for d in np.ndindex(2, 2, 2):
                            node = a0 + d
                            if ((node < start) | (node >= start + sizes)
                                    | (node < 0) | (node >= dims)).any():
                                continue
                            wt = np.float32(1)
                            for i in range(3):
                                wt *= w[i] if d[i] else 1 - w[i]
                            out[(b, *node)] += grad[b, p] * wt
    return out, n_entries / max(n_taking, 1)


@pytest.mark.parametrize("case", ["brick_faces", "grid_edges", "one_cell"])
def test_brick_binning_model_matches_twin(case):
    from tdvnet_torch.kernels.trilinear import (brick_count,
                                                trilinear_sample_backward_ref)

    grad, pts, c0, cell, shape = E.trilinear_case(case)
    if case == "one_cell":
        grad, pts = grad[:, :200], pts[:, :200]
    got, per_point = _brick_model(grad, pts, c0, cell, shape)
    want = n(trilinear_sample_backward_ref(t(grad), t(pts), t(c0), cell,
                                           shape))
    assert _rel_l2(got, want) < GRAD_RTOL
    # every point of the corner cell touches eight bricks; of the others,
    # only those whose anchor lies on a brick's high face touch more than one
    if case == "one_cell":
        assert per_point == 8
    else:
        assert (1 < per_point < 8) if case == "brick_faces" else \
            (1 <= per_point < 8)
    B, X, Y, Z, _ = shape
    assert brick_count(shape) == B * -(-X // 8) * 2 * 2


@pytest.mark.parametrize("case", E.SCATTER_CASES)
def test_scatter_ref_matches_jax_at_edges(case):
    from tdvnet.ops import voxelize as J
    from tdvnet_torch.kernels.voxelize import (VoxelGrid,
                                               scatter_anchors_to_dense_ref)

    feats, idx3, scene, valid, grid, B = E.scatter_case(case)
    jvg = J.VoxelGrid(None, jnp.asarray(idx3, jnp.int32),
                      jnp.asarray(scene, jnp.int32), None,
                      jnp.asarray(valid), None, None, None, None, None, None)
    tvg = VoxelGrid(None, torch.from_numpy(idx3), torch.from_numpy(scene),
                    None, torch.from_numpy(valid), None, None, None, None,
                    None, None)
    da, oa = J.scatter_anchors_to_dense(jnp.asarray(feats), jvg, grid, B)
    db, ob = scatter_anchors_to_dense_ref(t(feats), tvg, grid, B)
    np.testing.assert_array_equal(np.asarray(da), n(db))
    np.testing.assert_array_equal(np.asarray(oa), n(ob))
    assert n(ob).shape == (B, *grid, 1)
    assert int(n(ob).sum()) == int(valid.sum())
    if case == "last_cells":
        assert (n(ob)[:, -1, -1, -1, 0] == 1).all()


# ----------------------------------------------------- the variance kernels
def _jax_projections(case):
    from tdvnet.ops import camera as JC

    return np.asarray(JC.projection_matrix(case["K"], case["rotmats"],
                                           case["tvecs"]))


@pytest.mark.parametrize("name", E.VARIANCE_CASES)
def test_source_variance_ref_matches_jax_at_edges(name):
    """K1's twin against the JAX package's `_source_variance` on the edge
    inputs: footprints scattered over the map, behind the cameras and on
    their planes; on the map's edges and corners and off it; NaN, inf and
    overflowing coordinates; P not a multiple of a block's points; padding
    sources (fed the JAX package's projection matrices)."""
    from tdvnet.ops.costvolume import _source_variance
    from tdvnet_torch.kernels.variance import source_variance_ref

    c = E.variance_case(name)
    P_all = _jax_projections(c)
    args = (c["pts"], c["feats"], c["src_idx"], c["src_mask"], P_all,
            c["img_size"])
    want, want_mean = (np.asarray(a) for a in _source_variance(
        *(jnp.asarray(a) for a in args[:5]), args[5]))
    got, got_mean = (n(a) for a in source_variance_ref(
        *(t(a) for a in args[:5]), args[5], with_mean=True))
    assert got.shape == want.shape == (*c["pts"].shape[:2],
                                       c["feats"].shape[-1])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-4, atol=2e-5)
    bad = ~np.isfinite(c["pts"]).all(-1) | (np.abs(c["pts"]) > 1e30).any(-1)
    assert np.isnan(got[bad]).all() and not np.isnan(got[~bad]).any()
    assert np.abs(got[~bad]).max() > 0.1


@pytest.mark.parametrize("name", [c[0] for c in E.FAN_CASES])
def test_patch_fan_variance_ref_matches_jax_at_edges(name):
    """K7's twin against the JAX package's `hypothesis_patch_variance` on
    the tiled kernel's edge inputs: centres scattered, behind camera 0 and
    on its plane; on the map's edges and corners; centre anchors out of
    bounds; hypotheses beyond +-1 texel; Hh = 1 and 8; P not a multiple of
    a tile; NaN, inf and overflowing coordinates; padding sources. Where a
    coordinate is not finite the twin gives NaN (the port's rule, as in
    `source_variance`); JAX's float-to-int of an infinite coordinate masks
    its hypothesis to 0 instead, so the two are compared where the twin is
    finite, and the twin's NaN must cover JAX's."""
    from tdvnet.ops.costvolume import hypothesis_patch_variance
    from tdvnet_torch.kernels.patchfan import patch_fan_variance_ref

    c = E.fan_case(name)
    want = np.asarray(hypothesis_patch_variance(
        jnp.asarray(c["pts"]), jnp.asarray(c["feats"]),
        jnp.asarray(c["src_idx"]), jnp.asarray(c["src_mask"]),
        jnp.asarray(c["rotmats"]), jnp.asarray(c["tvecs"]),
        jnp.asarray(c["K"]), c["img_size"]))
    got = n(patch_fan_variance_ref(
        t(c["pts"]), t(c["feats"]), t(c["src_idx"]), t(c["src_mask"]),
        t(_jax_projections(c)), c["img_size"]))
    assert got.shape == want.shape == (*c["pts"].shape[:3],
                                       c["feats"].shape[-1])
    fin = ~np.isnan(got)
    assert np.isnan(got[np.isnan(want)]).all()
    # an ulp of a coordinate between XLA's dot and the twin's fma chain
    # moves unit-variance features by ~1e-5 of their largest (the limit
    # chip_smoke.py holds the kernel to)
    scale = max(1.0, float(np.abs(want[fin]).max()))
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * scale
    if name == "nonfinite":
        assert (~fin).any() and fin.any()
    else:
        assert fin.all()
    assert np.abs(got[fin]).max() > 0.1



# --------------------------------------------- the trilinear sampling forward
@pytest.fixture(scope="module")
def jax_forward_samples():
    """The JAX package's `trilinear_sample` of every forward case on the
    128-channel grid, in one jitted call: {case: [B, Q, 128]}. The node
    coordinates (pts - center0) / cell are IEEE fp32 operations, the same
    in numpy as in JAX."""
    from tdvnet.ops.sampling import trilinear_sample_batched

    qs, sizes = [], {}
    for case in E.TRILINEAR_FORWARD_CASES:
        _, pts, c0, cell = E.trilinear_forward_case(case, 4)
        qs.append(((pts - c0[:, None]) / np.float32(cell)).astype(np.float32))
        sizes[case] = pts.shape[1]
    got = np.asarray(jax.jit(trilinear_sample_batched)(
        jnp.asarray(E.forward_grid(128)), jnp.asarray(np.concatenate(qs, 1))))
    out, q0 = {}, 0
    for case, q in sizes.items():
        out[case] = got[:, q0:q0 + q]
        q0 += q
    return out


@pytest.mark.parametrize("case", E.TRILINEAR_FORWARD_CASES)
def test_trilinear_forward_ref_matches_jax_at_edges(case,
                                                     jax_forward_samples):
    """K6's twin against the JAX package's `trilinear_sample` on the
    forward's edge inputs (the backward's cases; runs of one anchor; anchors
    that alternate, some with one cell index and other taps; B * Q not a
    multiple of a tile) at C = 4, 64 and 128: within 1e-6 of the largest
    sample (the same products and sums in the same order). The twin gives
    NaN exactly where a coordinate is not finite (the port's rule); jitted
    XLA gives 0 for an infinite one and NaN for NaN, so the twin's NaN must
    cover JAX's, and the two are compared where the twin is finite."""
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref

    for C in E.TRILINEAR_FORWARD_CHANNELS:
        grid, pts, c0, cell = E.trilinear_forward_case(case, C)
        got = n(trilinear_sample_ref(t(grid), t(pts), t(c0), cell))
        want = jax_forward_samples[case][..., :C]
        assert got.shape == want.shape == (*pts.shape[:2], C)
        nan = ~E.finite_points(pts)[..., None].repeat(C, -1)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert not np.isnan(want[~nan]).any()
        fin = ~nan
        if fin.any():
            scale = max(1.0, float(np.abs(want[fin]).max()))
            assert np.abs(got[fin] - want[fin]).max() <= 1e-6 * scale
    if case == "nonfinite":
        assert nan.any() and fin.any()
    if case == "grid_edges":
        assert (got == 0).all(-1).any()          # queries wholly outside


# ------------------------------------------------------ the masked GroupNorm
def _gn_f64(x, mask, skip, w, b, G, eps=1e-5):
    """The three tails of the masked GroupNorm in float64 numpy (NCDHW)."""
    B, C = x.shape[:2]
    xg = x.reshape(B, G, -1).astype(np.float64)
    m = np.broadcast_to(mask.reshape(B, 1, 1, -1).astype(np.float64),
                        (B, 1, C // G, mask[0].size)).reshape(B, 1, -1)
    cnt = np.maximum(m.sum(-1), 1.0)
    mean = (xg * m).sum(-1) / cnt
    var = np.maximum((xg * xg * m).sum(-1) / cnt - mean ** 2, 0.0)
    xn = ((xg - mean[..., None]) / np.sqrt(var[..., None] + eps))
    shape = (1, C) + (1,) * (x.ndim - 2)
    y = (xn.reshape(x.shape) * w.reshape(shape) + b.reshape(shape)) * mask
    return (y, np.maximum(y, 0) * mask, np.maximum(y + skip, 0) * mask)


@pytest.fixture(scope="module")
def jax_group_norms():
    """The JAX package's `masked_group_norm` and its two U-Net tails on
    every case, in one jitted call: the cases stacked along the batch, each
    padded to GN_DIMS with inactive voxels (statistics run over the active
    voxels only, so the padding adds nothing): {case: (none, relu, skip)}
    NCDHW at the case's own dims."""
    from tdvnet.models.layers import masked_group_norm as J

    cases = {c[0]: E.gn_case(c[0]) for c in E.GN_CASES}
    _, _, _, w, b, G = next(iter(cases.values()))
    rows = sum(c[0].shape[0] for c in cases.values())
    C = w.shape[0]
    xs = np.zeros((rows, *E.GN_DIMS, C), np.float32)
    ms = np.zeros((rows, *E.GN_DIMS, 1), np.float32)
    ss = np.zeros_like(xs)
    r0, at = 0, {}
    for name, (x, mask, skip, _, _, _) in cases.items():
        B, dims = x.shape[0], x.shape[2:]
        sl = (slice(r0, r0 + B),) + tuple(slice(0, d) for d in dims)
        cl = lambda a: np.moveaxis(a, 1, -1)
        xs[sl], ms[sl], ss[sl] = cl(x), cl(mask), cl(skip)
        at[name] = sl
        r0 += B

    def tails(x, m, s):
        y = J(x, m, G, jnp.asarray(w), jnp.asarray(b))
        return y, jax.nn.relu(y) * m, jax.nn.relu(y + s) * m

    got = [np.asarray(a) for a in jax.jit(tails)(xs, ms, ss)]
    return {name: tuple(np.moveaxis(a[sl], -1, 1) for a in got)
            for name, sl in at.items()}


@pytest.mark.parametrize("name", [c[0] for c in E.GN_CASES])
def test_masked_group_norm_ref_matches_jax_at_edges(name, jax_group_norms):
    """K5's twin against the JAX package's `masked_group_norm` (and the
    U-Net's `relu(y) * mask` and `relu(y + skip) * mask` tails) on the
    kernel's edge inputs: V = 1, V % 4 != 0, the scene U-Net's three level
    sizes, one active voxel, an empty mask, two scenes with different
    counts, a mean large against its spread. Within 1e-5 of the largest
    output (fp32 statistics against float64 ones), except where the mean is
    large: there the JAX package's one-pass fp32 variance is the less exact
    side, so the twin must lie within 1e-6 of a float64 numpy reference and
    no further from JAX than that reference does (plus 1e-6)."""
    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref

    x, mask, skip, w, b, G = E.gn_case(name)
    f64 = _gn_f64(x, mask, skip, w, b, G)
    for i, kw in enumerate(({}, {"relu": True}, {"skip": t(skip)})):
        got = n(masked_group_norm_ref(t(x), t(mask), G, t(w), t(b), **kw))
        want = jax_group_norms[name][i]
        assert got.shape == want.shape == x.shape
        scale = max(1.0, float(np.abs(f64[i]).max()))
        assert np.abs(got - f64[i]).max() <= 1e-6 * scale
        if name == "large_mean":
            jax_err = np.abs(want - f64[i]).max()
            assert np.abs(got - want).max() <= jax_err + 1e-6 * scale
            assert jax_err > 1e-5 * scale     # the cancellation shows
        else:
            assert np.abs(got - want).max() <= 1e-5 * scale
        # inactive voxels read 0 in every tail
        assert not (got * (1 - mask)).any()
    if name == "empty":
        assert not got.any()


# ------------------------------------------- the int8 sampling (K6-int8)
@pytest.fixture(scope="module")
def jax_i8_samples():
    """The JAX package's `trilinear_sample_octs_scaled` (fp32 sums, as the
    port sums; the JAX package's own default sums in bf16) of every int8
    case on the 160-channel table, in one jitted call: {case: [B, Q, 160]}
    fp32. The node coordinates are exact in fp32 (`i8_case`)."""
    from tdvnet.ops.sampling import (pack_trilinear_octs,
                                     trilinear_sample_octs_scaled)

    qs, sizes = [], {}
    for case in E.TRILINEAR_FORWARD_CASES:
        grid, scale, pts, c0, cell, off = E.i8_case(case, 160)
        qs.append(((pts - c0[:, None]) / np.float32(cell)
                   + np.float32(off)).astype(np.float32))
        sizes[case] = pts.shape[1]
    dims = E.TRI_DIMS

    def sample(g, s, q):
        return trilinear_sample_octs_scaled(pack_trilinear_octs(g), s, q,
                                            dims, out_dtype=jnp.float32)

    got = np.asarray(jax.jit(jax.vmap(sample))(
        jnp.asarray(grid), jnp.asarray(scale),
        jnp.asarray(np.concatenate(qs, 1))))
    out, q0 = {}, 0
    for case, q in sizes.items():
        out[case] = got[:, q0:q0 + q]
        q0 += q
    return out


def _bf16_ulps(a, b):
    """|a - b| in bf16 ulps of the larger magnitude (plus 1e-6)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), np.abs(b)))[1] - 8)
    return np.abs(a - b) / (ulp + 1e-6)


@pytest.mark.parametrize("case", E.TRILINEAR_FORWARD_CASES)
def test_trilinear_i8_ref_matches_jax_at_edges(case, jax_i8_samples):
    """K6-int8's twin against the JAX package's int8 sampling on the int8
    edge inputs (the anchors at -1 and dim - 1 and the pad's nodes, outside
    the grid, non-finite points, runs of one anchor, alternating anchors,
    a ragged tile) at C = 4, 96, 128 and 160: within one bf16 ulp of JAX's
    fp32 sum (both round once to bf16; XLA may fuse a product into its
    sum), NaN exactly where a coordinate is not finite (JAX's jitted form
    gives 0 for an infinite one), and through the CPU wrapper into channels
    [4, 4 + C) of a wider output whose other channels stay untouched."""
    from tdvnet_torch.kernels.trilinear import (trilinear_sample_i8,
                                                trilinear_sample_i8_ref)

    for C in E.I8_CHANNELS:
        grid, scale, pts, c0, cell, off = E.i8_case(case, C)
        got = trilinear_sample_i8_ref(t(grid), t(scale), t(pts), t(c0),
                                      cell, off)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        want = jax_i8_samples[case][..., :C]
        nan = ~E.finite_points(pts)[..., None].repeat(C, -1)
        np.testing.assert_array_equal(np.isnan(got), nan)
        fin = ~nan
        assert (_bf16_ulps(got[fin], want[fin]) <= 1.0).all()
        wide = torch.full((*pts.shape[:2], C + 8), 7.0,
                          dtype=torch.bfloat16)
        trilinear_sample_i8(t(grid), t(scale), t(pts), t(c0), cell, wide, 4,
                            cell_offset=off)
        assert (wide[..., :4] == 7).all() and (wide[..., 4 + C:] == 7).all()
        np.testing.assert_array_equal(wide[..., 4:4 + C].float().numpy(),
                                      got)
    if case == "grid_edges":
        assert (got[fin.all(-1)] == 0).all(-1).any()   # wholly outside
    if case == "nonfinite":
        assert nan.any() and fin.any()


# --------------------------------------- the PointNet's pools (K4 forward)
def _jax_pool(y, seg, valid, n_seg):
    """The JAX package's pool (tdvnet/models/pointnet.py `_segmax` over the
    masked rows) and its concat-back's gather (`pooled.at[seg].get()`). JAX
    without x64 takes int32 ids, so an id past either end goes in as one
    just past it (out of range, as the original is); the gather takes the
    ids clamped, as the port's contract is (JAX clamps one past the end and
    wraps a negative id)."""
    from tdvnet.models.pointnet import NEG, _segmax

    ids = jnp.asarray(np.clip(seg, -1, n_seg).astype(np.int32))

    @jax.jit
    def run(y, ids, valid, gather_ids):
        pooled = _segmax(jnp.where(valid[:, None], y, NEG), ids, n_seg)
        return pooled, pooled.at[gather_ids].get()

    pooled, back = run(jnp.asarray(y), ids, jnp.asarray(valid),
                       jnp.asarray(np.clip(seg, 0, n_seg - 1)
                                   .astype(np.int32)))
    return np.asarray(pooled), np.asarray(back)


def _same_or_nan(a, b):
    """Equal where neither is NaN (-0.0 equals +0.0) and NaN in the same
    places."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape == b.shape and ((a == b) | (np.isnan(a) & np.isnan(b))).all():
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(a)
    np.testing.assert_array_equal(a[keep], b[keep])


def _check_plan(plan, seg, valid, n_seg):
    """A segment plan against numpy: its offsets the counted rows' running
    count, its rows the counted rows by segment, its long list exactly the
    segments of more than SEGMENT_LONG rows, and its work partition by
    where the segments start."""
    from tdvnet_torch.kernels.segmax import SEGMENT_LONG, SEGMENT_WORK

    ok = valid & (seg >= 0) & (seg < n_seg)
    counts = np.bincount(seg[ok], minlength=n_seg)
    np.testing.assert_array_equal(np.diff(n(plan.offsets)), counts)
    assert n(plan.offsets)[0] == 0
    rows = n(plan.rows)[:ok.sum()]
    np.testing.assert_array_equal(np.sort(rows), np.flatnonzero(ok))
    np.testing.assert_array_equal(
        seg[rows], np.repeat(np.arange(n_seg), counts))
    longs = n(plan.longs)
    np.testing.assert_array_equal(
        np.sort(longs[1:1 + longs[0]]), np.flatnonzero(counts > SEGMENT_LONG))
    # the work partition: warp w takes the segments that start (offset +
    # index) in its window of SEGMENT_WORK; every segment in exactly one
    starts = n(plan.offsets).astype(np.int64) + np.arange(n_seg + 1)
    first = n(plan.first).astype(np.int64)
    last = starts[-1] // SEGMENT_WORK + 1
    want = np.searchsorted(starts, np.arange(last + 1) * SEGMENT_WORK)
    np.testing.assert_array_equal(first[:last + 1], np.minimum(want, n_seg))
    assert (np.diff(first[:last + 1]) >= 0).all() and first[last] == n_seg


@pytest.mark.parametrize("case", [c[0] for c in E.PLAN_CASES])
def test_plan_twin_matches_jax_at_plan_edges(case):
    """The segment plan's twin on the plan's own edges (no points, one
    segment, long segments either side of the scan's tile boundaries, more
    points than a co-resident grid has threads, a scene's 262145 segments
    with few occupied): the plan against numpy, and a 4-channel pool
    through it equal to the JAX package's `_segmax`."""
    from tdvnet_torch.kernels.segmax import (segment_max_plan_ref,
                                             segment_plan_ref)

    seg, valid, n_seg = E.plan_case(case)
    plan = segment_plan_ref(t(seg), torch.from_numpy(valid), n_seg)
    _check_plan(plan, seg, valid, n_seg)
    y = np.random.default_rng(3).normal(size=(len(seg), 4)).astype(
        np.float32)
    want, _ = _jax_pool(y, seg, valid, n_seg)
    _same_or_nan(n(segment_max_plan_ref(t(y), plan, n_seg)), want)


@pytest.mark.parametrize("case", [c[0] for c in E.POOL_CASES])
def test_pool_twins_match_jax_at_edges(case):
    """K4's twins against the JAX package's pool and gather-back on the
    pools' edge inputs (NaN of either sign, +-inf, -0.0, maxima at and
    around -5e29, every row invalid, ids out of range, a segment of ~10^5
    rows, empty trailing segments, segments either side of the long path's
    256 rows and a filled dump slot) at C = 4, 128 and 160: the same values
    (a max and a copy are exact), NaN in the same places. The segment plan's
    twin pooled through its plan gives the pool's twin's result, lists
    exactly the segments of more than SEGMENT_LONG rows, and partitions the
    segments over the pool's warps by where they start."""
    from tdvnet_torch.kernels.segmax import (gather_concat_ref,
                                             segment_max_plan_ref,
                                             segment_max_ref,
                                             segment_plan_ref)

    y, seg, valid, n_seg = E.pool_case(case)
    want, back = _jax_pool(y, seg, valid, n_seg)
    plan = segment_plan_ref(t(seg), torch.from_numpy(valid), n_seg)
    _check_plan(plan, seg, valid, n_seg)
    for C in E.POOL_CHANNELS:
        yc = t(np.ascontiguousarray(y[:, :C]))
        got = segment_max_ref(yc, t(seg), torch.from_numpy(valid), n_seg)
        _same_or_nan(n(got), want[:, :C])
        _same_or_nan(n(segment_max_plan_ref(yc, plan, n_seg)), n(got))
        for relu in (False, True):
            cat = gather_concat_ref(yc, got, t(seg), relu)
            ref = np.concatenate([y[:, :C], back[:, :C]], -1)
            _same_or_nan(n(cat), np.maximum(ref, 0) if relu else ref)
    if case == "specials":
        assert np.isnan(want[1, 0]) and np.isnan(want[2, 1])
        assert (want[[0, 3, 4]] == 0).all() and (want[5] == -4.9e29).all()
        assert (want[6] == np.inf).all()
        assert not np.isnan(want[:, 3]).any()
        assert np.isnan(want[seg[121::40], 5]).all()
    if case == "all_invalid":
        assert not want.any()
