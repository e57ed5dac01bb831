"""The port's whole-scene fast path against the JAX package's at the tiny
config (chunk 4, k = 1, grid 16^3, bucket 8) with `fast_rank = 3 *
decoder_hidden = 48` (the tiny decoder reads 64 scene channels, so the
default rank of 96 would switch the projection off): each piece on the
same seeded numpy inputs, one PointFlow pass teacher-forced, and the slice
as a whole on one short ragged scene. The only JAX whole-graph compile is
the fast `FusedSceneInference` of the `ragged` fixture; the tiny model's
weights are seeded numpy values in the shapes `jax.eval_shape` reports."""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both_batches, jax_tiny_config, n, t, torch_module
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

RANK = 48
# two refinement iterations of one pass each: the iterations' tables and
# stats, at the cost of the fewest passes
OFFSETS = ((0.05,), (0.025,))
EVAL = dict(fused_chunk=4, n_src_on_either_side=1, eval_grid_size=(16, 16, 16),
            eval_max_anchors=2048, grid_bucket=8, fast_path=True,
            fast_rank=RANK)
EDGE = 0.08


def _jax_cfg(**over):
    cfg = jax_tiny_config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, **dict(EVAL, **over)))


def _torch_cfg(**over):
    from tdvnet_torch.config import tiny_test_config

    cfg = tiny_test_config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, **dict(EVAL, **over)))


def _random_variables(module, *args, seed=0, **kwargs):
    """Seeded numpy variables in the shapes flax's init would make
    (traced with `jax.eval_shape`, nothing compiled): kernels
    N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1), running
    means N(0, 0.1), running variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, 1 / math.sqrt(math.prod(sd.shape[:-1])),
                           sd.shape)
        elif name == "scale":
            v = 1 + rng.normal(0, 0.1, sd.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, sd.shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, sd.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def models():
    from tdvnet.models.threedvnet import ThreeDVNet as J
    from tdvnet_torch.models.threedvnet import ThreeDVNet as T

    cfg = _jax_cfg()
    jb, tb = both_batches(cfg, [4])
    jm = J(cfg.model)
    vs = _random_variables(jm, jb, OFFSETS, method=J.infer_depth)
    tm = torch_module(T(_torch_cfg().model), vs)
    return jm, vs, tm, jb, tb


def _views(n_views, seed=2):
    from tdvnet_torch.data import synthetic

    return synthetic.make_scene(n_views=n_views, img_size=(64, 80), seed=seed)


def _port(tm, **over):
    from tdvnet_torch.eval.fused_scene import FusedSceneInference

    return FusedSceneInference(tm, _torch_cfg(**over), offsets_list=OFFSETS,
                               fetch_mm=False)


@pytest.fixture(scope="module")
def ragged(models):
    """One scene of 11 views (9 refs: three chunks of 4, the last ragged)
    through the JAX class's fast path and the port's."""
    from tdvnet.eval.fused_scene import FusedSceneInference as J

    jm, vs, tm, _, _ = models
    views = _views(11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jinf = J(jm, vs, _jax_cfg(), offsets_list=OFFSETS, fetch_mm=False)
        grids = []
        choose = jinf._grid_from_extent
        jinf._grid_from_extent = lambda e: grids.append(choose(e)) or grids[-1]
        d_jax = jinf.predict_scene(views)
        tinf = _port(tm)
        d_port = tinf.predict_scene(views)
    return dict(views=views, d_jax=d_jax, jinf=jinf, grid=grids[0],
                d_port=d_port, tinf=tinf)


def _scales(rng, B=1):
    """Coarsest-first U-Net-like scales at the tiny config's widths, with
    inactive (zero) cells, in numpy."""
    out = []
    for stride, C in ((4, 24), (2, 24), (1, 16)):
        d = 16 // stride
        g = rng.normal(size=(B, d, d, d, C)).astype(np.float32)
        g *= rng.uniform(size=(B, d, d, d, 1)) > 0.4
        out.append((g, stride))
    return out


def _jax_combine(sc):
    """The JAX package's `combine_scales` on numpy (grid, stride) pairs,
    jitted (eager, its upsampling runs as hundreds of small ops)."""
    from tdvnet.models.hypothesis import combine_scales

    meta = []

    def grids_of(*grids):
        out = combine_scales([{"grid": g, "stride": s}
                              for g, (_, s) in zip(grids, sc)])
        meta.extend({k: v for k, v in d.items() if k != "grid"} for d in out)
        return [d["grid"] for d in out]

    grids = jax.jit(grids_of)(*[g for g, _ in sc])
    return [dict(m, grid=g) for m, g in zip(meta, grids)]


def test_combine_scales_and_upsample_match_jax():
    from tdvnet.ops import sampling as JS
    from tdvnet_torch.models import hypothesis as TH
    from tdvnet_torch.ops import sampling as TS

    rng = np.random.default_rng(0)
    sc = _scales(rng, B=2)
    a = _jax_combine(sc)
    b = TH.combine_scales([{"grid": t(g), "stride": s} for g, s in sc])
    assert len(a) == len(b) == 1
    assert a[0]["stride"] == b[0]["stride"] == 1
    assert a[0]["cell_offset"] == b[0]["cell_offset"] == 3.0
    assert b[0]["grid"].shape == (2, 19, 19, 19, 64)
    # the same fp32 midpoints in the same order
    assert np.abs(np.asarray(a[0]["grid"]) - n(b[0]["grid"])).max() <= 1e-6
    g = sc[0][0]
    up = jax.jit(JS.upsample_linear_zeropad, static_argnums=(1, 2))
    for factor, out in ((2, (8, 8, 8)), (4, (17, 15, 16)), (4, (12, 20, 3))):
        u = up(jnp.asarray(g), factor, out)
        v = TS.upsample_linear_zeropad(t(g), factor, out)
        assert u.shape == v.shape == (2, *out, 24)
        assert np.abs(np.asarray(u) - n(v)).max() <= 1e-6
    with pytest.raises(ValueError, match="power of two"):
        TS.upsample_linear_zeropad(t(g), 3, (8, 8, 8))


def test_quantize_per_channel_int8_matches_jax():
    from tdvnet.ops.sampling import quantize_per_channel_int8 as J
    from tdvnet_torch.ops.sampling import quantize_per_channel_int8 as T

    rng = np.random.default_rng(1)
    v = rng.normal(size=(6, 5, 4, 8)).astype(np.float32)
    v[..., 3] = 0.0                               # an all-zero channel
    v[0, 0, 0, :3] = 2.0                          # the absmax of three
    v[1, 0, 0, :3] = 2.0 * 64.5 / 127             # ties at half a step
    v[2, 0, 0, :3] = -2.0 * 0.5 / 127
    qa, sa = J(jnp.asarray(v))
    qb, sb = T(t(v))
    assert qb.dtype == torch.int8 and sb.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(qa), n(qb))
    np.testing.assert_array_equal(np.asarray(sa), n(sb))
    assert not n(qb)[..., 3].any()


def test_decoder_scene_projection_matches_jax(models):
    from tdvnet.models.hypothesis import decoder_scene_projection as J
    from tdvnet_torch.models.hypothesis import projected_decoder

    jm, vs, tm, _, _ = models
    feat_dim = tm.cfg.feat_dim
    Vj, new_dec, tail_j = J(vs["params"]["decoder"], feat_dim, RANK)
    Vt, dec, tail_t = projected_decoder(tm.decoder, feat_dim, RANK)
    assert Vt.shape == Vj.shape == (64, RANK)
    np.testing.assert_allclose(np.abs(Vt.T @ np.asarray(Vj)), np.eye(RANK),
                               atol=1e-5)
    assert abs(tail_t - tail_j) <= 1e-6
    # the projected first conv, in flax layout [taps, rank + var, hidden]
    k = n(dec.Conv_0.weight).transpose(2, 1, 0)
    kj = np.asarray(new_dec["Conv_0"]["kernel"])
    signs = np.sign(np.sum(Vt * np.asarray(Vj), axis=0))
    kj = np.concatenate([kj[:, :RANK] * signs[None, :, None],
                         kj[:, RANK:]], axis=1)
    np.testing.assert_allclose(k, kj, rtol=1e-5, atol=1e-6)
    # the rest of the decoder is the model's own, untouched
    assert dec.Conv_1.weight is not tm.decoder.Conv_1.weight
    assert torch.equal(dec.Conv_1.weight, tm.decoder.Conv_1.weight)
    assert tm.decoder.Conv_0.weight.shape[1] == 64 + feat_dim
    with pytest.raises(ValueError, match="rank"):
        projected_decoder(tm.decoder, feat_dim, 64)


def test_decoder_scene_projection_on_the_synth48_checkpoint():
    """The basis and projected decoder the full-width fast path uses, from
    the trained weights: the port's decoder loaded from the checkpoint
    against the JAX package's function on the same parameters."""
    import os

    from tdvnet.models.hypothesis import decoder_scene_projection as J
    from tdvnet_torch.config import EvalConfig, ModelConfig
    from tdvnet_torch.models.hypothesis import (HypothesisDecoder,
                                                projected_decoder)
    from tdvnet_torch.weights import load_flax_into, load_npz

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "weights", "3dvnet_synth48.npz")
    variables, _ = load_npz(path)
    mc, rank = ModelConfig(), EvalConfig().fast_rank
    dec = HypothesisDecoder(sum(mc.unet_dims) + mc.feat_dim,
                            mc.decoder_hidden, mc.hyp_ksize)
    load_flax_into(dec, {c: tree["decoder"] for c, tree in variables.items()})
    Vj, new_dec, tail_j = J(variables["params"]["decoder"], mc.feat_dim, rank)
    Vt, tdec, tail_t = projected_decoder(dec.eval(), mc.feat_dim, rank)
    assert Vt.shape == (sum(mc.unet_dims), rank)
    np.testing.assert_allclose(np.abs(Vt.T @ np.asarray(Vj)), np.eye(rank),
                               atol=1e-5)
    assert abs(tail_t - tail_j) <= 1e-6 and 0.3 < tail_t < 0.4
    np.testing.assert_allclose(
        n(tdec.Conv_0.weight).transpose(2, 1, 0),
        np.asarray(new_dec["Conv_0"]["kernel"]), rtol=1e-5, atol=1e-6)


def _bf16_close(a, b):
    """Each element within one bf16 ulp of the larger magnitude, plus 1e-6;
    returns the largest |a - b| in ulps."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.ldexp(1.0, np.frexp(m)[1] - 8)
    d = np.abs(a - b)
    assert (d <= ulp + 1e-6).all(), float((d - ulp).max())
    return float((d / ulp).max())


def _octs_scaled_fp32(monkeypatch):
    """Make the JAX package's `sample_scales` sample its int8 tables with
    fp32 sums rounded once to bf16, as the port does (its own default sums
    in bf16, where XLA on the CPU keeps no excess precision)."""
    import functools

    import tdvnet.models.hypothesis as JH
    from tdvnet.ops.sampling import trilinear_sample_octs_scaled

    f = jax.vmap(functools.partial(trilinear_sample_octs_scaled,
                                   out_dtype=jnp.float32),
                 in_axes=(0, 0, 0, None))
    monkeypatch.setattr(JH, "trilinear_sample_octs_scaled_batched",
                        lambda *a: f(*a).astype(jnp.bfloat16))


def test_trilinear_sample_i8_ref_matches_jax(monkeypatch):
    """The twin against the JAX package's int8 sampling on the same table,
    across the low pad and outside the grid: within one bf16 ulp of JAX's
    function with fp32 sums (the port's arithmetic); JAX's default bf16
    sums lose up to ~180 ulps where the taps cancel, the port stays within
    0.52 ulp of the exact value."""
    from tdvnet.models import hypothesis as JH
    from tdvnet.ops.sampling import (pack_trilinear_octs,
                                     quantize_per_channel_int8 as JQ)
    from tdvnet_torch.models import hypothesis as TH

    rng = np.random.default_rng(2)
    g = rng.normal(size=(2, 7, 6, 5, 12)).astype(np.float32)
    qj, sj = jax.vmap(JQ)(jnp.asarray(g))
    origins = rng.normal(0, 0.2, (2, 3)).astype(np.float32)
    # inside, across the low pad, partly and wholly outside
    pts = (origins[:, None] + rng.uniform(-0.45, 0.4, (2, 400, 3))) \
        .astype(np.float32)
    js = [{"grid": jnp.asarray(g), "stride": 1, "cell_offset": 3.0,
           "octs": jax.vmap(pack_trilinear_octs)(qj), "oct_scale": sj,
           "dims": (7, 6, 5)}]
    ts = [{"grid": t(qj).to(torch.int8), "scale": t(sj), "stride": 1,
           "cell_offset": 3.0}]
    b = TH.sample_scales(ts, t(pts), t(origins), EDGE)
    assert b.dtype == torch.bfloat16 and b.shape == (2, 400, 12)
    b = b.float().numpy()
    assert (b == 0).all(-1).sum() > 20 and (b != 0).all(-1).sum() > 100
    # the exact value, in float64 from the same int8 table
    from tdvnet_torch.ops.sampling import trilinear_sample_batched

    q = (pts - (origins + 0.5 * EDGE)[:, None]).astype(np.float64) / EDGE + 3
    exact = n(trilinear_sample_batched(t(qj).double(), torch.from_numpy(q))) \
        * np.asarray(sj, np.float64)[:, None]
    assert _bf16_close(exact, b) <= 0.52
    _octs_scaled_fp32(monkeypatch)
    a = JH.sample_scales(js, pts, origins, EDGE)
    assert a.dtype == jnp.bfloat16
    _bf16_close(np.asarray(a.astype(jnp.float32)), b)


def _fan_case(jb, rng, img_size, P=(6, 10)):
    """Hypothesis fans [R, 7, P, 3] along the refs' pixel rays at depths of
    1-3 m, stepped per pixel by 0.002 m (inside one texel), 0.02 m or
    0.3 m (beyond +-1 texel of the centre); a fifth of the fans moved 3 m
    sideways, out of the sources' views."""
    from tdvnet_torch.models.threedvnet import hypothesis_points

    R = jb.ref_idx.shape[0]
    d = t(rng.uniform(1.0, 3.0, (R, *P)).astype(np.float32))
    ri = t(jb.ref_idx)
    fans = [n(hypothesis_points(d, t(jb.K)[ri], t(jb.rotmats)[ri],
                                t(jb.tvecs)[ri], img_size, step))
            for step in (0.002, 0.02, 0.3)]
    pick = rng.integers(0, 3, (R, 1, P[0] * P[1], 1))
    pts = np.choose(pick, fans)
    side = rng.uniform(size=(R, 1, P[0] * P[1], 1)) < 0.2
    return (pts + side * np.array([3.0, 0.0, 0.0])).astype(np.float32)


def test_patch_fan_variance_ref_matches_jax():
    """K7's twin against the JAX package's `hypothesis_patch_variance`, fed
    the JAX package's projection matrices (the port's batched 3x3 @ 3x4
    product rounds 5% of their entries differently, which moves a
    coordinate by an ulp and unit-variance features by ~1e-5), with
    centres out of bounds, hypotheses beyond +-1 texel of the centre and
    masked sources."""
    from tdvnet.ops import camera as JC, costvolume as J
    from tdvnet_torch.kernels.patchfan import _project, patch_fan_variance_ref
    from tdvnet_torch.ops import costvolume as T

    cfg = jax_tiny_config()
    jb, tb = both_batches(cfg, [0])
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(jb.n_imgs, 16, 20, 8)).astype(np.float32)
    mask = np.asarray(jb.src_mask).copy()
    mask[1:, 2] = False                          # cnt = 2 for refs 1 and 2
    mask[2, 0] = False                           # and 1 for ref 2
    img = cfg.model.img_size
    pts = _fan_case(jb, rng, img)
    a = np.asarray(J.hypothesis_patch_variance(
        jnp.asarray(pts), feats, jb.src_idx, jnp.asarray(mask), jb.rotmats,
        jb.tvecs, jb.K, img))
    P_all = t(JC.projection_matrix(jb.K, jb.rotmats, jb.tvecs))
    b = patch_fan_variance_ref(t(pts), t(feats), tb.src_idx, t(mask), P_all,
                               img)
    assert b.shape == a.shape == (3, 7, 60, 8)
    np.testing.assert_allclose(a, n(b), rtol=1e-5, atol=1e-6)
    # the port's own projection matrices, through the op the model calls
    c = T.hypothesis_patch_variance(t(pts), t(feats), tb.src_idx, t(mask),
                                    tb.rotmats, tb.tvecs, tb.K, img)
    np.testing.assert_allclose(a, n(c), rtol=1e-4, atol=2e-5)
    # the cases the test is for: centres out of bounds, hypotheses beyond
    # +-1 texel of the centre, and in-bounds fans
    xy = _project(t(pts).reshape(3, -1, 3), P_all[tb.src_idx[:, 0]],
                  19 / 79, 15 / 63).reshape(3, 7, 60, 2)
    c0 = torch.floor(xy[:, 3])
    out_c = ~((c0 >= -1) & (c0 <= torch.tensor([19.0, 15.0]))).all(-1)
    far = ((torch.floor(xy) - c0[:, None]).abs() > 1).any(-1).any(1)
    assert out_c.sum() > 10 and (far & ~out_c).sum() > 5 \
        and (~far & ~out_c).sum() > 10


def _jax_fast_tables(sc, V):
    """The JAX class's per-iteration table steps (`_refine_impl`) on numpy
    (grid, stride) pairs; each table keeps its int8 grid as "q" beside the
    packed one."""
    from tdvnet.models.hypothesis import _COMBINE_BUDGET_BYTES, pack_scales
    from tdvnet.ops.sampling import quantize_per_channel_int8

    scales = _jax_combine(sc)
    projected = len(scales) == 1 and scales[0]["grid"].shape[-1] == V.shape[0]
    if projected:
        g = scales[0]["grid"]
        scales = [dict(scales[0], grid=jnp.einsum("bxyzc,cr->bxyzr", g, V))]
    qs = [jax.vmap(quantize_per_channel_int8)(sc["grid"]) for sc in scales]
    octs = pack_scales([q for q, _ in qs], budget=_COMBINE_BUDGET_BYTES)
    return [dict(sc, octs=o, oct_scale=s, q=q,
                 dims=tuple(sc["grid"].shape[1:4]))
            for sc, o, (q, s) in zip(scales, octs, qs)], projected


def _jax_tables_to_torch(tables):
    """The JAX tables as the port's scale dicts: int8 grids where JAX packed
    one, else the float grid."""
    out = []
    for x in tables:
        d = {"stride": x["stride"]}
        if "cell_offset" in x:
            d["cell_offset"] = x["cell_offset"]
        if x["octs"] is not None:
            d.update(grid=t(x["q"]).to(torch.int8), scale=t(x["oct_scale"]))
        else:
            d["grid"] = t(x["grid"])
        out.append(d)
    return out


@pytest.mark.parametrize("budget,n_tables,projected,n_int8", [
    (None, 1, True, 1),                   # the default: one merged grid
    (2 * 1024 * 1024, 2, False, 2),       # only the two coarse scales merge
    (500 * 1024, 3, False, 2),            # the finest scale's table is fp32
    (1024, 3, False, 0),                  # nothing merges, nothing is int8
])
def test_fast_tables_and_their_sampling_match_jax(models, monkeypatch, budget,
                                                  n_tables, projected,
                                                  n_int8):
    """The budget decides the branch: with one merged grid the tables are
    projected and the projected decoder reads them; otherwise the scales
    stay (partly) apart, unprojected, and a grid whose int8 oct table
    would exceed the budget is sampled in fp32."""
    import tdvnet.models.hypothesis as JH
    import tdvnet_torch.models.hypothesis as TH

    if budget is not None:
        monkeypatch.setattr(JH, "_COMBINE_BUDGET_BYTES", budget)
        monkeypatch.setattr(TH, "_COMBINE_BUDGET_BYTES", budget)
    jm, vs, tm, _, _ = models
    rng = np.random.default_rng(4)
    sc = _scales(rng)
    tinf = _port(tm)
    V = tinf._proj_V.numpy()
    ja, jproj = _jax_fast_tables(sc, jnp.asarray(V))
    tb_, dec = tinf._fast_tables([{"grid": t(g), "stride": s}
                                  for g, s in sc])
    assert len(ja) == len(tb_) == n_tables
    assert jproj == (dec is not None) == projected
    assert sum(x["octs"] is not None for x in ja) == n_int8
    for x, y in zip(ja, tb_):
        assert (x["octs"] is not None) == (y["grid"].dtype == torch.int8)
        assert x["stride"] == y["stride"]
        assert x.get("cell_offset", 0.0) == y.get("cell_offset", 0.0)
        if y["grid"].dtype == torch.int8:
            dq = np.abs(np.asarray(x["q"], np.int32)
                        - n(y["grid"]).astype(np.int32))
            # the merge is exact; a projected value may sit on a rounding
            # tie that the two matrix products break apart
            assert dq.max() <= (1 if projected else 0)
            assert dq.mean() <= 1e-3
            np.testing.assert_allclose(np.asarray(x["oct_scale"]),
                                       n(y["scale"]), rtol=1e-6)
        else:
            np.testing.assert_allclose(np.asarray(x["grid"]), n(y["grid"]),
                                       rtol=0, atol=1e-6)
    # sampled from the same tables in both packages, with fp32 sums
    _octs_scaled_fp32(monkeypatch)
    origins = np.zeros((1, 3), np.float32)
    pts = rng.uniform(-0.4, 1.5, (1, 500, 3)).astype(np.float32)
    a = JH.sample_scales(ja, pts, origins, EDGE)
    b = TH.sample_scales(_jax_tables_to_torch(ja), t(pts), t(origins), EDGE)
    assert b.dtype == (torch.bfloat16 if n_int8 == n_tables
                       else torch.float32)
    assert a.dtype == (jnp.bfloat16 if n_int8 == n_tables else jnp.float32)
    a, b = np.asarray(a, np.float32), b.float().numpy()
    if n_int8:
        _bf16_close(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)


def test_fast_pointflow_pass_teacher_forced(models):
    """One fast PointFlow pass: the JAX tables (projected, int8) and the
    projected decoder on both sides, the patch-fan variance, bf16 scene
    features."""
    from tdvnet.models.hypothesis import decoder_scene_projection
    from _torch_helpers import flax_apply
    from tdvnet.models.threedvnet import ThreeDVNet as J
    from tdvnet_torch.models.threedvnet import hypothesis_points

    jm, vs, tm, jb, tb = models
    rng = np.random.default_rng(5)
    sc = _scales(rng)
    tinf = _port(tm)
    V = tinf._proj_V.numpy()
    _, new_dec, _ = decoder_scene_projection(vs["params"]["decoder"],
                                             tm.cfg.feat_dim, RANK)
    vs_fast = dict(vs, params=dict(vs["params"], decoder=new_dec))
    tables, projected = _jax_fast_tables(sc, jnp.asarray(V))
    assert projected
    d = rng.uniform(1.2, 2.5, (3, 16, 16)).astype(np.float32)
    quarter = rng.normal(size=(jb.n_imgs, 16, 20, 8)).astype(np.float32)
    # a grid origin that puts the hypotheses inside the 1.28 m grid
    ri = tb.ref_idx
    hp = hypothesis_points(t(d), tb.K[ri], tb.rotmats[ri], tb.tvecs[ri],
                           tm.cfg.img_size, 0.05)
    origins = n(hp.reshape(-1, 3).amin(0) - 0.1)[None]
    delta = flax_apply(jm, vs_fast, tables, origins, d, quarter, jb, 0.05, 3,
                       None, False, True, method=J.run_pointflow)
    with torch.no_grad():
        got = tm.run_pointflow(_jax_tables_to_torch(tables), t(origins),
                               t(d), t(quarter), tb, 0.05, 3, None, True,
                               tinf._decoder_fast)
    # a softmax expectation of offsets <= 0.15 m from bf16 features: one
    # bf16 rounding of a feature moves a logit by ~4e-3 of its size
    np.testing.assert_allclose(np.asarray(delta), n(got), rtol=0, atol=2e-4)


def test_fast_path_settings_match_jax(models):
    """The fast offsets replace the parity offsets only; the projection is
    off from the decoder's scene-channel count on; `fast_patch` follows
    `fast_path`."""
    from tdvnet.eval.fused_scene import FusedSceneInference as J
    from tdvnet_torch.eval.fused_scene import (FAST_OFFSETS, PARITY_OFFSETS,
                                               FusedSceneInference as T)

    jm, vs, tm, _, _ = models
    assert FAST_OFFSETS == J.FAST_OFFSETS
    cases = [(dict(), PARITY_OFFSETS, None), (dict(), OFFSETS, None),
             (dict(fast_rank=64), PARITY_OFFSETS, None),
             (dict(fast_patch=False), OFFSETS, None),
             (dict(fast_path=False), PARITY_OFFSETS, None),
             (dict(fast_path=False), PARITY_OFFSETS, True)]
    for over, offs, fast in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            j = J(jm, vs, _jax_cfg(**over), offsets_list=offs, fast_path=fast)
        tinf = T(tm, _torch_cfg(**over), offsets_list=offs, fast_path=fast)
        assert tinf.offsets_list == j.offsets_list, over
        assert (tinf.fast_path, tinf.fast_patch, tinf.fast_rank) == \
            (j.fast_path, j.fast_patch, j.fast_rank), over
        assert (tinf._proj_V is None) == (j._proj_V is None), over


def test_fast_predict_scene_matches_jax_on_a_ragged_scene(ragged):
    r = ragged
    d_jax, d_port, tinf, jinf = r["d_jax"], r["d_port"], r["tinf"], r["jinf"]
    assert d_port.shape == d_jax.shape == (9, 64, 80)
    assert np.isfinite(d_port).all()
    assert tinf.last_scene_stats == jinf.last_scene_stats
    assert tuple(tinf.last_grid_size) == tuple(r["grid"].grid_size)
    assert tinf.last_projected and jinf._proj_V is not None
    assert tinf.last_n_tables == 1
    # the slack the JAX package's own test allows between two fast
    # variants: int8 and bf16 roundings flip on ulp-level differences
    d = np.abs(d_port - d_jax)
    assert d.max() <= 2e-2 and d.mean() <= 3e-3, (d.max(), d.mean())


def test_fast_pred_fn_follows_the_config(models, ragged):
    """`make_3dvnet_pred_fn` runs the fast path when the config asks for
    it: the same millimetres as the port's fast class."""
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.eval.harness import make_3dvnet_pred_fn

    tm = models[2]
    views = _views(7)
    cfg = _torch_cfg()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = make_3dvnet_pred_fn(tm, cfg)(views, "scene0", None)
        want = FusedSceneInference(tm, cfg).predict_scene(views)
    np.testing.assert_array_equal(out, want)
