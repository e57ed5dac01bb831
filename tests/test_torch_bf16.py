"""bf16 inference of the port (`ModelConfig(dtype=torch.bfloat16)`) against
the JAX package's bf16 model at the tiny config.

JAX's bf16 bits are no target: XLA's CPU backend keeps some results of a
bf16 graph in fp32 (a convolution's output that the next op widens is never
rounded) and rounds others after each op. Each kernel's bf16 twin is held to
a float64 referee computed from the same bf16 inputs, and JAX's own distance
to that referee sizes the tolerance: the port may be no further from it than
JAX is, plus one bf16 ulp. The referees:

  K4 pool, concat-back and K3 scatter: a max and a copy round nothing, so
      the referee is the fp32 op on the widened values cast back, and the
      twins and JAX must equal it bit for bit;
  K6 trilinear sampling: the exact sum of the bf16 grid's taps with the
      fp32 weights (the twin sums in fp32 and rounds once; JAX sums in
      bf16), its distance in ulps of the result, or of 2^-8 of the sum of
      the terms' magnitudes where the taps cancel;
  K5 masked GroupNorm: float64 statistics and normalisation, then the bf16
      stores of JAX's graph (the normalised x, its product with the bf16
      weight, the sum with the bf16 bias, the residual add), each op's
      distance counted in ulps of its largest operand;
  K1/K2 source variance: the exact variance of the bf16 features' bilinear
      samples, its distance stated relative to E[F^2], F the bilinear sample
      of the features' magnitudes (each sample is a bf16 value in both
      packages: one rounding of at most 2^-8 F a sample).

The whole slice runs the port's and JAX's bf16 `infer_depth` over ten tiny
scenes and a parity `FusedSceneInference` scene, and holds the port's
|d depth| against JAX's fp32 run to 1.5x JAX's own bf16 error at the median
and the 99th percentile. One scene alone does not show it: where the second
refinement iteration's scene cloud moves a point into another voxel, that
scene's error can double in either package; pooled over ten scenes the
ratios read 0.97-1.16, and 1.11 / 1.34 over the parity scene.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (both_batches, init_variables, jax_tiny_config,
                            n, t, torch_module)
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

BF = torch.bfloat16
OFFSETS = ((0.05, 0.025), (0.025,))
SEEDS = tuple(range(4, 14))
# the port's error against JAX's fp32 run, over JAX's own bf16 error
ERR_RATIO = 1.5
# K1's bf16 variance against the exact one, relative to E[F^2], F the
# bilinear sample of the features' magnitudes (`chip_smoke.BF16_VAR_REL`:
# each sample rounds once to bf16)
VAR_REL = 1.01 * 2.0 ** -6


def bf16_np(a):
    """numpy float32 -> the same values rounded to bf16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF) \
        .float().numpy()


def to_bf(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)


def ulp(m):
    """bf16 spacing at magnitudes m (numpy, float64)."""
    _, e = np.frexp(np.asarray(m, np.float64))
    return np.ldexp(1.0, e - 8)


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


# --------------------------------------------------------------- per kernel
def test_pool_and_concat_back_bit_equal_in_bf16():
    from tdvnet.models.pointnet import NEG, _segmax
    from tdvnet_torch.kernels.segmax import (gather_concat_ref,
                                             segment_max_ref)

    rng = np.random.default_rng(0)
    P, C, n_seg = 3000, 32, 1500
    y = bf16_np(rng.normal(size=(P, C)) * 4 - 5)
    y[rng.random((P, C)) < 0.02] = -3.0e30        # at or below NEG / 2
    seg = rng.integers(0, n_seg, P)
    valid = rng.random(P) > 0.1
    yj = jnp.asarray(y, jnp.bfloat16)
    pooled_j = _segmax(jnp.where(jnp.asarray(valid)[:, None], yj, NEG),
                       jnp.asarray(seg, jnp.int32), n_seg)
    back_j = jax.nn.relu(jnp.concatenate(
        [yj, pooled_j.at[jnp.asarray(seg)].get()], axis=-1))
    pooled = segment_max_ref(to_bf(y), t(seg), t(valid), n_seg)
    back = gather_concat_ref(to_bf(y), pooled, t(seg), relu=True)
    assert pooled.dtype == back.dtype == BF
    # the referee: the fp32 op on the same values, cast to bf16
    ref = segment_max_ref(t(y), t(seg), t(valid), n_seg).to(BF)
    for got in (pooled, ref):
        np.testing.assert_array_equal(as64(got), as64(pooled_j))
    np.testing.assert_array_equal(as64(back), as64(back_j))
    assert (as64(pooled) == 0).any() and (as64(pooled) < 0).any()


def test_scatter_bit_equal_in_bf16():
    from tdvnet.ops import voxelize as JV
    from tdvnet_torch.kernels.voxelize import (scatter_anchors_to_dense_ref,
                                               voxelize_ref)

    rng = np.random.default_rng(1)
    P, grid, A, B = 4000, (12, 10, 8), 300, 2
    pts = (rng.random((P, 3)) * np.array(grid) * 0.08).astype(np.float32)
    scene = (np.arange(P) * B // P).astype(np.int64)
    valid = rng.random(P) > 0.1
    vg = voxelize_ref(t(pts), t(scene), t(valid), 0.08, grid, A, B)
    feats = bf16_np(rng.normal(size=(A, 24)))
    dense, occ = scatter_anchors_to_dense_ref(to_bf(feats), vg, grid, B)
    vj = JV.voxelize(jnp.asarray(pts), jnp.asarray(scene, jnp.int32),
                     jnp.asarray(valid), 0.08, grid, A, B)
    dj, oj = JV.scatter_anchors_to_dense(jnp.asarray(feats, jnp.bfloat16),
                                         vj, grid, B)
    assert dense.dtype == occ.dtype == BF
    np.testing.assert_array_equal(as64(dense), as64(dj))
    np.testing.assert_array_equal(as64(occ), as64(oj))
    ref = scatter_anchors_to_dense_ref(t(feats), vg, grid, B)
    np.testing.assert_array_equal(as64(dense), as64(ref[0].to(BF)))
    assert int(as64(occ).sum()) == int(vg.anchor_valid.sum())


def test_trilinear_sampling_within_an_ulp_of_the_exact_sum():
    from tdvnet.ops.sampling import (pack_trilinear_octs,
                                     trilinear_sample_octs_batched)
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref

    rng = np.random.default_rng(2)
    B, dims, C, Q = 2, (9, 8, 7), 20, 4000
    grid = bf16_np(rng.normal(size=(B, *dims, C)))
    q = (rng.random((B, Q, 3)) * (np.array(dims) + 1) - 1).astype(np.float32)
    zero = torch.zeros(B, 3)
    got = trilinear_sample_ref(to_bf(grid), t(q), zero, 1.0)
    assert got.dtype == BF
    ref = as64(trilinear_sample_ref(t(grid).double(), t(q), zero, 1.0))
    # ulps at the larger of the result and the sum of its terms' magnitudes
    # (where the taps cancel, one fp32 rounding of a term outweighs the
    # result's own ulp)
    terms = as64(trilinear_sample_ref(t(np.abs(grid)).double(), t(q), zero,
                                      1.0))
    scale = ulp(np.maximum(np.abs(ref), terms * 2.0 ** -8))
    # JAX's sampling of a bf16 scale (`sample_scales`): its oct table
    octs = jax.vmap(pack_trilinear_octs)(jnp.asarray(grid, jnp.bfloat16))
    jax_out = as64(trilinear_sample_octs_batched(octs, jnp.asarray(q), dims))
    port_ulps = np.abs(as64(got) - ref) / scale
    jax_ulps = np.abs(jax_out - ref) / scale
    assert port_ulps.max() <= 1.0, port_ulps.max()
    assert port_ulps.max() <= jax_ulps.max() + 1.0
    # JAX's bf16 sums are further off (the reason the port sums in fp32)
    assert jax_ulps.max() > 1.0


def _gn_referee(x, mask, G, w, b, skip):
    """The float64 referee of the bf16 masked GroupNorm and its tail, and
    per element the magnitude that its ops' roundings scale with."""
    B, C = x.shape[:2]
    xg = x.reshape(B, G, C // G, -1).astype(np.float64)
    m = mask.reshape(B, 1, 1, -1).astype(np.float64)
    cnt = np.maximum(m.sum(axis=(2, 3)) * (C // G), 1.0)
    mean = (xg * m).sum(axis=(2, 3)) / cnt
    var = (xg * xg * m).sum(axis=(2, 3)) / cnt - mean ** 2
    xn = (xg - mean[..., None, None]) / np.sqrt(np.maximum(var, 0)
                                                 + 1e-5)[..., None, None]
    r = lambda a: bf16_np(a).astype(np.float64)
    shape = (1, C) + (1,) * (x.ndim - 2)
    wb, bb = r(w).reshape(shape), r(b).reshape(shape)
    xn = r(xn.reshape(x.shape))
    prod = r(xn * wb)
    y = r(prod + bb) * mask
    scale = np.maximum(np.abs(prod), np.abs(bb))
    if skip is None:
        return np.maximum(y, 0) * mask, scale
    s = r(y + skip)
    return np.maximum(s, 0) * mask, np.maximum(scale, np.abs(skip))


@pytest.mark.parametrize("tail", ["relu", "skip"])
def test_masked_group_norm_within_an_ulp_of_the_referee(tail):
    from tdvnet.models.layers import masked_group_norm as J
    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref

    rng = np.random.default_rng(3)
    B, C, G, dims = 2, 16, 4, (6, 5, 4)
    mask = (rng.random((B, 1, *dims)) > 0.4).astype(np.float32)
    x = bf16_np((rng.normal(size=(B, C, *dims)) * 2 + 1) * mask)
    skip = bf16_np(rng.normal(size=(B, C, *dims)) * mask) \
        if tail == "skip" else None
    w, b = rng.normal(size=C).astype(np.float32), \
        rng.normal(size=C).astype(np.float32)
    got = masked_group_norm_ref(
        to_bf(x), to_bf(mask), G, t(w), t(b), relu=tail == "relu",
        skip=None if skip is None else to_bf(skip))
    assert got.dtype == BF
    ref, scale = _gn_referee(x, mask, G, w, b, skip)
    # JAX: the function in NDHWC, then the U-Net's bf16 tail
    cl = lambda a: jnp.asarray(np.moveaxis(a, 1, -1), jnp.bfloat16)
    yj = J(cl(x), cl(mask), G, jnp.asarray(w), jnp.asarray(b))
    mj = cl(mask)
    yj = jax.nn.relu(yj + cl(skip)) * mj if skip is not None \
        else jax.nn.relu(yj) * mj
    jax_out = np.moveaxis(as64(yj), -1, 1)
    port_ulps = np.abs(as64(got) - ref) / ulp(scale)
    jax_ulps = np.abs(jax_out - ref) / ulp(scale)
    assert port_ulps.max() <= 1.0, port_ulps.max()
    assert port_ulps.max() <= jax_ulps.max() + 1.0


def test_source_variance_within_its_bound():
    from tdvnet.ops.costvolume import _source_variance as J
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera

    cfg = jax_tiny_config()
    _, tb = both_batches(cfg, [4])
    rng = np.random.default_rng(4)
    N, (H, W) = tb.images.shape[0], cfg.model.img_size
    feats = bf16_np(rng.normal(size=(N, H // 4, W // 4, 8)) * 2 + 0.5)
    ri = tb.ref_idx
    dc = cfg.model.depth_test
    pts = camera.plane_sweep_points(dc.depth_start, dc.depth_interval, 6,
                                    tb.rotmats[ri], tb.tvecs[ri], tb.K[ri],
                                    cfg.model.img_size, dc.size)
    P_all = camera.projection_matrix(tb.K, tb.rotmats, tb.tvecs)
    args = (tb.src_idx, tb.src_mask, P_all, cfg.model.img_size)
    var32 = source_variance_ref(pts, to_bf(feats), *args)
    var16 = source_variance_ref(pts, to_bf(feats), *args, out_dtype=BF)
    assert (var32.dtype, var16.dtype) == (torch.float32, BF)
    # the cost volume's bf16 variance is the fp32 one rounded once
    assert torch.equal(var16, var32.to(BF))
    v64 = source_variance_ref(pts, t(feats).double(), *args)
    va, ma = source_variance_ref(pts, t(np.abs(feats)).double(), *args,
                                 with_mean=True)
    ef2 = as64(va) + as64(ma) ** 2
    vj, _ = J(jnp.asarray(n(pts)), jnp.asarray(feats, jnp.bfloat16),
              jnp.asarray(n(tb.src_idx)), jnp.asarray(n(tb.src_mask)),
              jnp.asarray(n(P_all)), cfg.model.img_size)
    floor = 1e-30
    port = np.abs(as64(var32) - as64(v64)) / np.maximum(ef2, floor)
    jax_d = np.abs(as64(vj) - as64(v64)) / np.maximum(ef2, floor)
    assert port.max() <= VAR_REL, port.max()
    assert port.max() <= jax_d.max() + 2.0 ** -8
    # the bf16 cost volume: one more rounding of |var| <= E[f^2]
    port16 = np.abs(as64(var16) - as64(v64)) / np.maximum(ef2, floor)
    assert port16.max() <= VAR_REL + 2.0 ** -8


# -------------------------------------------------------------- whole slice
def _stages(m, batch):
    dc = m.cfg.depth_test
    half, quarter, _ = m.extract_features(batch.images)
    d0, _ = m.initial_depth(batch, dc, quarter)
    d = d0
    for offs in OFFSETS:
        scales, origins, _ = m.model_scene(d, quarter, batch)
        for off in offs:
            d = d + m.run_pointflow(scales, origins, d, quarter, batch, off,
                                    3)
    final = m.upsample(d, half, quarter, batch.images, batch.ref_idx)
    return d0, d, final


@pytest.fixture(scope="module")
def models():
    from tdvnet.models.threedvnet import ThreeDVNet as J
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet as T

    cfg = jax_tiny_config()
    jb, _ = both_batches(cfg, [SEEDS[0]])
    jm = J(cfg.model)
    vs = init_variables(jm, jb, OFFSETS, method=J.infer_depth)
    jm16 = J(dataclasses.replace(cfg.model, dtype=jnp.bfloat16))
    tm = torch_module(T(dataclasses.replace(tiny_test_config().model,
                                            dtype=BF)), vs)
    return cfg, jm, jm16, vs, tm


def _ratio_check(what, jax32, jax16, port16):
    """Median and p99 of |port - jax32| at most ERR_RATIO times those of
    |jax16 - jax32|."""
    ej, ep = np.abs(jax16 - jax32), np.abs(port16 - jax32)
    stats = {k: (f(ej), f(ep)) for k, f in (
        ("median", np.median), ("p99", lambda a: np.percentile(a, 99)))}
    print(what, {k: f"jax {a:.3e} port {b:.3e} x{b / a:.2f}"
                 for k, (a, b) in stats.items()})
    for k, (a, b) in stats.items():
        assert b <= ERR_RATIO * a, (what, k, a, b)


def test_infer_depth_error_against_fp32_within_jax_own(models):
    cfg, jm, jm16, vs, tm = models
    f32 = jax.jit(lambda v, b: jm.apply(v, b, method=_stages))
    f16 = jax.jit(lambda v, b: jm16.apply(v, b, method=_stages))
    got = {k: ([], [], []) for k in ("initial", "refined", "final")}
    for seed in SEEDS:
        jb, tb = both_batches(cfg, [seed])
        out = tm.infer_stages(tb, OFFSETS)
        assert out["final"].dtype == torch.float32
        assert bool(torch.isfinite(out["final"]).all())
        for k, a32, a16 in zip(got, f32(vs, jb), f16(vs, jb)):
            got[k][0].append(np.asarray(a32).ravel())
            got[k][1].append(np.asarray(a16, np.float32).ravel())
            got[k][2].append(n(out[k]).ravel())
    for k, (a32, a16, p16) in got.items():
        _ratio_check(k, *(np.concatenate(a) for a in (a32, a16, p16)))


def test_parity_scene_error_against_fp32_within_jax_own(models):
    import warnings

    from tdvnet.eval.fused_scene import FusedSceneInference as JF
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.eval.fused_scene import FusedSceneInference as TF

    cfg, jm, jm16, vs, tm = models
    ev = dict(fused_chunk=4, n_src_on_either_side=1,
              eval_grid_size=(16, 16, 16), eval_max_anchors=2048,
              grid_bucket=8)
    offsets = ((0.05, 0.025),)
    jcfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval,
                                                             **ev))
    tcfg = tiny_test_config()
    tcfg = dataclasses.replace(
        tcfg, model=tm.cfg, eval=dataclasses.replace(tcfg.eval, **ev))
    views = synthetic.make_scene(n_views=11, img_size=(64, 80), seed=2)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for m, c in ((jm, jcfg), (jm16, dataclasses.replace(
                jcfg, model=jm16.cfg))):
            out.append(JF(m, vs, c, offsets_list=offsets, fetch_mm=False,
                          fast_path=False).predict_scene(views))
        tinf = TF(tm, tcfg, offsets_list=offsets, fetch_mm=False)
        out.append(tinf.predict_scene(views))
    assert out[2].dtype == np.float32 and np.isfinite(out[2]).all()
    assert out[2].shape == out[0].shape == (9, 64, 80)
    _ratio_check("scene", *out)


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_model_config_still_refuses_other_dtypes(dtype):
    from tdvnet_torch.config import ModelConfig

    with pytest.raises(NotImplementedError, match="dtype"):
        ModelConfig(dtype=dtype)


def test_config_names_the_dtype():
    from tdvnet_torch.config import load_config

    cfg = load_config({"model": {"dtype": "bfloat16"}})
    assert cfg.model.dtype == BF
    assert load_config().model.dtype == torch.float32


def test_bf16_fast_path_and_training_refused(models, tmp_path):
    """The bf16 fast path is refused (ROADMAP.md queue 1 item 2c) before any
    work; training a bf16 model, refused until item 2b, runs."""
    from tdvnet_torch.config import (Config, TrainConfig, load_config,
                                     tiny_test_config)
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.tools import eval_3dvnet, run_synthetic_eval
    from tdvnet_torch.train.loop import create_state, make_train_step

    cfg, _, _, _, tm = models
    with pytest.raises(NotImplementedError, match="item 2c"):
        FusedSceneInference(tm, Config(), fast_path=True)
    with pytest.raises(NotImplementedError, match="item 2c"):
        eval_3dvnet.main(["--ckpt-dir", str(tmp_path / "none"), "--bf16",
                          "--fast-path", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 2c"):
        run_synthetic_eval.main(["--workdir", str(tmp_path / "w"), "--bf16",
                                 "--fast-path", "--device", "cpu"])
    assert not (tmp_path / "w").exists()
    # training a bf16 model runs (ROADMAP.md queue 1 item 2b): its
    # forward's loss, a train step, a fresh state, and the knobs construct
    tcfg = dataclasses.replace(tiny_test_config(), model=tm.cfg)
    _, tb = both_batches(cfg, [SEEDS[0]])
    with torch.no_grad():
        assert np.isfinite(float(tm(tb, OFFSETS[0], 0)["loss"]))
    st = create_state(tcfg, device="cpu")
    assert st.model.cfg.dtype == BF
    st, mets = make_train_step(st.model, tcfg, 0)(st, tb, 0.5)
    assert np.isfinite(float(mets["loss"])) and st.optimizer.count == 1
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    for kw in ({"bf16_compute": True}, {"remat": True},
               {"grad_accum_steps": 2}):
        assert dataclasses.asdict(TrainConfig(**kw)).items() >= kw.items()
    assert load_config().train.bf16_compute is False


def test_bf16_model_keeps_fp32_parameters(models):
    """The fp32 weights load into a bf16 model unchanged: every parameter
    and buffer stays fp32 (each layer casts at use), and they export back
    to the same flax variables."""
    from tdvnet_torch.weights import to_flax_variables

    _, _, _, vs, tm = models
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in tm.buffers())
    back = to_flax_variables(tm)
    flat = lambda tree, pre=(): [
        x for k, v in sorted(tree.items())
        for x in (flat(v, pre + (k,)) if isinstance(v, dict)
                  else [(pre + (k,), np.asarray(v))])]
    for (ka, a), (kb, b) in zip(flat(back), flat(vs)):
        assert ka == kb and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
