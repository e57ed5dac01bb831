"""Each kernel's plain twin against the JAX function it replaces, on seeded
numpy inputs (the CUDA kernels themselves are held to these twins on the
card by tests/test_torch_cuda.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_helpers import both_batches, jax_tiny_config, n, t


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
                                    tb.tvecs, tb.K, cfg.model.img_size)
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
