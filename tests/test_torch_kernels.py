"""Each kernel's plain twin against the JAX function it replaces, on seeded
numpy inputs (the CUDA kernels themselves are held to these twins on the
card by tests/test_torch_cuda.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_helpers import both_batches, jax_tiny_config, n, t
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def scene():
    cfg = jax_tiny_config()
    jb, tb = both_batches(cfg, [0])
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(jb.n_imgs, 16, 20, 8)).astype(np.float32)
    # refs 1 and 2 lose their last source: cnt = 2 there, not 3
    mask = np.asarray(jb.src_mask).copy()
    mask[1:, 2] = False
    return cfg, jb, tb, feats, jnp.asarray(mask)


def test_source_variance_ref_matches_plane_sweep_cost_volume(scene):
    from tdvnet.ops import costvolume as J
    from tdvnet_torch.ops import costvolume as T

    cfg, jb, tb, feats, mask = scene
    # planes from 0.05 m to 6 m: the near ones project far out of the
    # source images, the far ones partly out
    args = (0.05, 0.4, 16, cfg.model.img_size, (8, 10))
    a = J.plane_sweep_cost_volume(feats, jb.rotmats, jb.tvecs, jb.K,
                                  jb.ref_idx, jb.src_idx, mask, *args,
                                  mode="gather")
    b = T.plane_sweep_cost_volume(t(feats), tb.rotmats, tb.tvecs, tb.K,
                                  tb.ref_idx, tb.src_idx, t(np.asarray(mask)),
                                  *args)
    assert b.shape == (3, 16, 8, 10, 8) == a.shape
    # fp32 projections in another summation order move a sample point by
    # a few ulps of its ~100-pixel coordinate; unit-variance features then
    # move the variance by ~1e-5 of its scale
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-4, atol=2e-5)


def test_source_variance_ref_matches_point_variance(scene):
    from tdvnet.ops import costvolume as J
    from tdvnet_torch.ops import costvolume as T

    cfg, jb, tb, feats, mask = scene
    rng = np.random.default_rng(6)
    # points around the cameras: in view, out of view, behind the cameras,
    # one far away, and one whose projection overflows fp32
    pts = rng.normal(0, 1.5, (3, 400, 3)).astype(np.float32)
    pts[:, 0] = 1e6
    pts[:, 1] = (0.0, 0.0, 3e38)
    a = J.hypothesis_point_variance(pts, feats, jb.src_idx, mask, jb.rotmats,
                                    jb.tvecs, jb.K, cfg.model.img_size)
    b = T.hypothesis_point_variance(t(pts), t(feats), tb.src_idx,
                                    t(np.asarray(mask)), tb.rotmats,
                                    tb.tvecs, tb.K, cfg.model.img_size,
                                    (1, pts.shape[1]))
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-4, atol=2e-5)
    assert np.abs(n(b)[:, 2:]).max() > 0.1     # not all out of view
    np.testing.assert_array_equal(n(b)[:, 0], 0.0)
    # a non-finite projection makes the bilinear weights NaN in JAX, so the
    # variance is NaN there (the CUDA kernel keeps this)
    assert np.isnan(np.asarray(a)[:, 1]).all() and np.isnan(n(b)[:, 1]).all()


def test_trilinear_sample_ref_matches_jax():
    from tdvnet.ops import sampling as J
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref

    rng = np.random.default_rng(7)
    vol = rng.normal(size=(2, 6, 5, 7, 8)).astype(np.float32)
    center0 = rng.normal(0, 0.1, (2, 3)).astype(np.float32)
    cell = 0.16
    # queries inside, on the faces and outside the grid, and one at
    # infinity (its weights are NaN in JAX, so its sample is NaN)
    pts = rng.uniform(-0.5, 1.4, (2, 300, 3)).astype(np.float32)
    pts[:, 0, 0] = np.inf
    q = (pts - center0[:, None]) / np.float32(cell)
    a = jax.vmap(J.trilinear_sample)(vol, q)
    b = trilinear_sample_ref(t(vol), t(pts), t(center0), cell)
    # the same float32 node coordinate on both sides; weights and the
    # 8-tap sum agree to a few ulps of values of unit size
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-5, atol=2e-6)
    assert (n(b) == 0).all(axis=-1).any()      # some queries fully outside
    assert np.isnan(n(b)[:, 0]).all()


def test_sample_scales_matches_jax():
    from tdvnet.models import hypothesis as J
    from tdvnet_torch.models import hypothesis as T

    rng = np.random.default_rng(8)
    edge = 0.08
    dims = ((8, 8, 8, 16), (4, 4, 4, 24), (2, 2, 2, 24))
    grids = [rng.normal(size=(2, *d)).astype(np.float32) for d in dims]
    origins = rng.normal(0, 0.2, (2, 3)).astype(np.float32)
    pts = (origins[:, None] + rng.uniform(-0.2, 0.9, (2, 500, 3))) \
        .astype(np.float32)
    # coarsest first, as the U-Net returns them
    js = [{"grid": jnp.asarray(g), "stride": s}
          for g, s in zip(grids[::-1], (4, 2, 1))]
    ts = [{"grid": t(g), "stride": s} for g, s in zip(grids[::-1], (4, 2, 1))]
    a = J.sample_scales(js, pts, origins, edge)
    b = T.sample_scales(ts, t(pts), t(origins), edge)
    assert a.shape == b.shape == (2, 500, 64)
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-5, atol=2e-6)


def test_propagation_blend_ref_matches_xla_form():
    from tdvnet.models.upsampling import unfold3x3
    from tdvnet_torch.kernels.propagation import propagation_blend_ref

    rng = np.random.default_rng(9)
    logits = rng.normal(0, 3, (3, 9, 11, 9)).astype(np.float32)
    depth = rng.uniform(0.5, 5, (3, 9, 11)).astype(np.float32)
    a = jnp.sum(jax.nn.softmax(logits, axis=-1) * unfold3x3(depth), axis=-1)
    b = propagation_blend_ref(t(logits), t(depth))
    # a softmax of 9 and a 9-term sum in fp32
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=2e-6, atol=1e-6)


def test_softargmax_ref_matches_xla_form():
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref
    from tdvnet_torch.ops.camera import linspace_f32

    rng = np.random.default_rng(10)
    cost = rng.normal(0, 4, (3, 24, 5, 6)).astype(np.float32)
    dv = jnp.linspace(0.5, 0.5 + 0.05 * 23, 24, dtype=jnp.float32)
    prob = jax.nn.softmax(-cost, axis=1)
    a = jnp.sum(prob * dv[None, :, None, None], axis=1)
    b = softargmax_depth_ref(t(cost), linspace_f32(0.5, 0.5 + 0.05 * 23, 24))
    # a 24-term softmax expectation of depths ~1 m in fp32
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=2e-6, atol=1e-6)


def _cloud(rng, n_pts, n_scenes):
    """Points around a 16^3 grid of 0.08 m (1.28 m): inside, outside, some
    invalid, and a few hostile coordinates."""
    pts = rng.uniform(-0.3, 1.6, (n_pts, 3)).astype(np.float32)
    scene = np.sort(rng.integers(0, n_scenes, n_pts)).astype(np.int32)
    valid = rng.uniform(size=n_pts) > 0.1
    valid[:8] = True
    pts[0] = (np.nan, 0.5, 0.5)
    pts[1] = (0.5, np.inf, 0.5)
    pts[2] = (0.5, 0.5, -np.inf)
    pts[3] = (1e30, 0.5, 0.5)
    return pts, scene, valid


@pytest.mark.parametrize("max_anchors", [4096, 60, 1])
def test_voxelize_ref_matches_jax_with_hostile_points(max_anchors):
    import torch

    from tdvnet.ops import voxelize as J
    from tdvnet_torch.kernels.voxelize import (scatter_anchors_to_dense_ref,
                                               voxelize_ref)

    rng = np.random.default_rng(21)
    pts, scene, valid = _cloud(rng, 3000, 2)
    # fixed origins: a NaN or infinite coordinate of a valid point would
    # otherwise decide the bbox minimum
    origins = np.array([[-0.1, 0.0, 0.05], [0.2, -0.2, 0.0]], np.float32)
    targs = (t(scene), 0.08, (16, 16, 16), max_anchors, 2)
    b_nan = voxelize_ref(t(pts), targs[0], torch.from_numpy(valid), *targs[1:],
                         origins=t(origins))
    # the one deliberate difference: XLA converts floor(NaN) to cell 0, so
    # JAX voxelizes a NaN coordinate; the port tests the bounds on the
    # float, so the point is out of the grid. Against JAX the NaN point is
    # flagged invalid on input; the port's own run with it valid differs
    # only in the out-of-grid count.
    valid = valid.copy()
    valid[0] = False
    a = J.voxelize(pts, scene, valid, 0.08, (16, 16, 16), max_anchors, 2,
                   origins=origins)
    b = voxelize_ref(t(pts), targs[0], torch.from_numpy(valid), *targs[1:],
                     origins=t(origins))
    for f in b._fields:
        if f == "n_out_of_grid":
            assert int(b_nan.n_out_of_grid) == int(b.n_out_of_grid) + 1
        else:
            assert torch.equal(getattr(b_nan, f), getattr(b, f)), f
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), n(getattr(b, f))
        if f in ("order", "p2a_sorted"):
            # JAX's argsort is not stable among equal keys: compare the
            # sorted keys, not the permutation
            continue
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(np.asarray(a.p2a_sorted), n(b.p2a_sorted))
    # the hostile points are out of the grid
    assert not n(b.point_valid)[:4].any()
    assert (n(b.point2anchor)[:4] == max_anchors).all()
    assert int(b.n_out_of_grid) >= 3
    assert (int(b.n_overflow) > 0) == (max_anchors < 1000)
    feats = rng.normal(size=(max_anchors, 8)).astype(np.float32)
    da, oa = J.scatter_anchors_to_dense(feats, a, (16, 16, 16), 2)
    db, ob = scatter_anchors_to_dense_ref(t(feats), b, (16, 16, 16), 2)
    np.testing.assert_array_equal(np.asarray(da), n(db))
    np.testing.assert_array_equal(np.asarray(oa), n(ob))


def test_scene_origins_ref_matches_jax():
    import torch

    from tdvnet.ops.voxelize import scene_origins as J
    from tdvnet_torch.kernels.voxelize import scene_origins_ref

    rng = np.random.default_rng(22)
    pts = rng.normal(0, 2, (500, 3)).astype(np.float32)
    scene = np.sort(rng.integers(0, 3, 500)).astype(np.int32)
    valid = rng.uniform(size=500) > 0.3
    valid[scene == 1] = False                  # an empty scene gives 0
    a = J(pts, scene, valid, 3)
    b = scene_origins_ref(t(pts), t(scene), torch.from_numpy(valid), 3)
    np.testing.assert_array_equal(np.asarray(a), n(b))
    assert (n(b)[1] == 0).all() and (n(b)[0] < -1).all()


def test_segment_max_and_gather_concat_refs_match_jax():
    import torch

    from tdvnet.models.pointnet import NEG, _segmax
    from tdvnet_torch.kernels.segmax import gather_concat_ref, segment_max_ref

    rng = np.random.default_rng(23)
    P, C, n_seg = 600, 12, 40
    y = rng.normal(0, 3, (P, C)).astype(np.float32)
    seg = rng.integers(0, n_seg, P).astype(np.int32)
    seg[seg == 7] = 8                          # segment 7 is empty
    valid = rng.uniform(size=P) > 0.2
    valid[seg == 11] = False                   # segment 11 is all masked
    y[seg == 13] = -3e29                       # above the empty threshold
    y[seg == 14] = -6e29                       # at or below it: reads as 0
    a = _segmax(jnp.where(jnp.asarray(valid)[:, None], y, NEG), seg, n_seg)
    b = segment_max_ref(t(y), t(seg), torch.from_numpy(valid), n_seg)
    np.testing.assert_array_equal(np.asarray(a), n(b))
    assert (n(b)[[7, 11, 14]] == 0).all() and (n(b)[13] == -3e29).all()
    back = a.at[seg].get()
    cat = jnp.concatenate([y, back], axis=-1)
    np.testing.assert_array_equal(
        np.asarray(cat), n(gather_concat_ref(t(y), b, t(seg))))
    np.testing.assert_array_equal(
        np.asarray(jax.nn.relu(cat)),
        n(gather_concat_ref(t(y), b, t(seg), relu=True)))


@pytest.mark.parametrize("tail", ["none", "relu", "skip"])
@pytest.mark.parametrize("full_mask", [False, True])
def test_masked_group_norm_ref_matches_jax(tail, full_mask):
    from tdvnet.models.layers import masked_group_norm as J
    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref

    rng = np.random.default_rng(24)
    x = rng.normal(1, 2, (2, 6, 5, 4, 12)).astype(np.float32)
    if full_mask:
        mask = np.ones((2, 6, 5, 4, 1), np.float32)
    else:
        mask = (rng.uniform(size=(2, 6, 5, 4, 1)) > 0.4).astype(np.float32)
        mask[1] = 0.0                          # one batch element is empty
    x = x * mask
    skip = (rng.normal(size=x.shape) * mask).astype(np.float32)
    scale = rng.normal(size=12).astype(np.float32)
    bias = rng.normal(size=12).astype(np.float32)
    a = J(x, mask, 4, scale, bias)
    if tail == "relu":
        a = jax.nn.relu(a) * mask
    elif tail == "skip":
        a = jax.nn.relu(a + skip) * mask
    cf = lambda v: t(v).permute(0, 4, 1, 2, 3)
    b = masked_group_norm_ref(cf(x), cf(mask), 4, t(scale), t(bias),
                              relu=tail == "relu",
                              skip=cf(skip) if tail == "skip" else None)
    # fp32 group statistics over a few hundred sites
    np.testing.assert_allclose(np.asarray(a), n(b.permute(0, 2, 3, 4, 1)),
                               rtol=1e-5, atol=1e-5)
    if not full_mask:
        assert not n(b)[1].any()
