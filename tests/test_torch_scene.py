"""The port's whole-scene inference against the JAX `FusedSceneInference` at
a tiny config (chunk 4, k = 1, grid 16^3, 2048 anchors, bucket 8), with the
same numpy views and the same random weights through both packages."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_helpers import (both_batches, flax_variables, jax_tiny_config, n,
                            torch_module)

OFFSETS = ((0.05, 0.025),)
EVAL = dict(fused_chunk=4, n_src_on_either_side=1, eval_grid_size=(16, 16, 16),
            eval_max_anchors=2048, grid_bucket=8)


def _jax_cfg(**over):
    cfg = jax_tiny_config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, **dict(EVAL, **over)))


def _torch_cfg(**over):
    from tdvnet_torch.config import tiny_test_config

    cfg = tiny_test_config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, **dict(EVAL, **over)))


def _views(n_views, seed=2):
    from tdvnet_torch.data import synthetic

    return synthetic.make_scene(n_views=n_views, img_size=(64, 80), seed=seed)


@pytest.fixture(scope="module")
def models():
    from tdvnet.models.threedvnet import ThreeDVNet as J
    from tdvnet_torch.models.threedvnet import ThreeDVNet as T

    cfg = _jax_cfg()
    jb, _ = both_batches(cfg, [4])
    jm = J(cfg.model)
    vs = flax_variables(jm, jb, OFFSETS, method=J.infer_depth)
    tm = torch_module(T(_torch_cfg().model), vs)
    return jm, vs, tm


def _port(tm, fetch_mm=False, **over):
    from tdvnet_torch.eval.fused_scene import FusedSceneInference

    return FusedSceneInference(tm, _torch_cfg(**over), offsets_list=OFFSETS,
                               fetch_mm=fetch_mm)


@pytest.fixture(scope="module")
def ragged(models):
    """One scene of 11 views (9 refs: three chunks of 4, the last ragged)
    through the JAX class and the port."""
    from tdvnet.eval.fused_scene import FusedSceneInference as J

    jm, vs, tm = models
    views = _views(11)
    jinf = J(jm, vs, _jax_cfg(), offsets_list=OFFSETS, fetch_mm=False,
             fast_path=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d_jax = jinf.predict_scene(views)
        tinf = _port(tm)
        d_port = tinf.predict_scene(views)
    return views, d_jax, jinf.last_scene_stats, d_port, tinf


def test_predict_scene_matches_jax_on_a_ragged_scene(ragged):
    views, d_jax, stats_jax, d_port, tinf = ragged
    assert d_port.shape == d_jax.shape == (9, 64, 80)
    assert d_port.dtype == np.float32 and np.isfinite(d_port).all()
    # every stage of the port matches JAX to ~1e-5 at this size; the chain
    # is held looser because a 1e-6 difference can move a point to another
    # voxel (and the JAX class samples merged scale lattices)
    d = np.abs(d_port - d_jax)
    assert d.max() <= 1e-3, d.max()
    assert np.median(d) < 1e-5 and np.percentile(d, 99) < 1e-4, \
        (np.median(d), np.percentile(d, 99))
    assert tinf.last_scene_stats == stats_jax
    assert set(stats_jax) == {"n_out_of_grid", "n_overflow", "n_points"}


def test_u8_ingest_and_float_ingest_agree(models, ragged):
    from tdvnet_torch.eval.harness import maybe_drop_u8

    views, _, _, d_port, _ = ragged
    assert "images_u8" in views
    as_float = {k: v for k, v in views.items()
                if k not in ("images_u8", "rgb_scale", "rgb_mean", "rgb_std")}
    # `images` holds the unquantized render, so normalize the u8 stack on
    # the host as the device ingest does
    host = maybe_drop_u8(views)
    assert host is views                      # the default keeps u8
    u8 = views["images_u8"].astype(np.float32)
    as_float["images"] = ((u8 / np.float32(views["rgb_scale"])
                           - views["rgb_mean"]) / views["rgb_std"]
                          ).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d_float = _port(models[2]).predict_scene(as_float)
    np.testing.assert_array_equal(d_float, d_port)


def test_maybe_drop_u8_normalizes_on_the_host(monkeypatch):
    from tdvnet.eval.harness import maybe_drop_u8 as J
    from tdvnet_torch.eval.harness import maybe_drop_u8 as T

    views = _views(3)
    monkeypatch.setenv("TDVNET_U8_UPLOAD", "0")
    a, b = J(views), T(views)
    assert a.keys() == b.keys() and "images_u8" not in b
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_fetch_mm_is_within_half_a_millimetre(models, ragged):
    views, _, _, d_port, _ = ragged
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d_mm = _port(models[2], fetch_mm=True).predict_scene(views)
    assert d_mm.dtype == np.float32
    assert np.abs(d_mm - d_port).max() <= 5.1e-4
    # exactly the millimetre grid
    np.testing.assert_array_equal(
        d_mm, np.round(np.clip(d_port, 0, 65.535) * 1000.0)
        .astype(np.uint16).astype(np.float32) * 1e-3)


def test_predict_scenes_equals_predict_scene(models):
    tm = models[2]
    scenes = [_views(6, seed=s) for s in (2, 3, 4)]
    inf = _port(tm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sync, stats = [], []
        for v in scenes:
            sync.append(inf.predict_scene(v))
            stats.append(dict(inf.last_scene_stats))
        piped = []
        for d in inf.predict_scenes(iter(scenes)):
            piped.append(d)
            assert inf.last_scene_stats == stats[len(piped) - 1]
    assert len(piped) == 3
    for a, b in zip(piped, sync):
        np.testing.assert_array_equal(a, b)


def test_ragged_chunking_equals_one_chunk(models):
    """9 views, R = 7: chunk 4 pads one ref slot, chunk 7 pads none. The
    masks must keep the padded slot out of the real outputs."""
    tm = models[2]
    views = _views(9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d_a = _port(tm).predict_scene(views)
        d_b = _port(tm, fused_chunk=7).predict_scene(views)
    assert d_a.shape == d_b.shape == (7, 64, 80)
    # the same arithmetic per ref; only the convolutions' batch differs
    np.testing.assert_allclose(d_a, d_b, rtol=0, atol=1e-5)


def test_dropped_points_warn_and_show_in_the_stats(models):
    tm = models[2]
    inf = _port(tm, eval_max_anchors=64)
    with pytest.warns(UserWarning, match="scene volume dropped"):
        inf.predict_scene(_views(6))
    assert inf.last_scene_stats["n_overflow"] > 0
    assert inf.last_grid_size is not None


EXTENTS = [
    ("inside", (0.9, 0.5, 0.3)),
    ("exact bucket", (0.48, 0.48, 0.48)),
    ("over the cap", (4.0, 0.5, 0.3)),
    ("all over the cap", (9.0, 9.0, 9.0)),
    ("zero", (0.0, 0.5, 0.3)),
    ("negative", (-2e9, 1.0, 1.0)),
    ("nan", (float("nan"), 0.5, 0.3)),
    ("inf", (float("inf"), 0.5, 0.3)),
]


@pytest.mark.parametrize("auto_grid", [True, False])
@pytest.mark.parametrize("name,extent", EXTENTS)
def test_grid_from_extent_matches_jax(models, name, extent, auto_grid):
    from tdvnet.eval.fused_scene import FusedSceneInference as J

    jm, vs, tm = models
    over = dict(auto_grid=auto_grid, eval_grid_size=(32, 24, 16))
    jinf = J(jm, vs, _jax_cfg(**over), fast_path=False)
    tinf = _port(tm, **over)
    ext = np.asarray(extent, np.float32)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        a = jinf._grid_from_extent(ext)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        b = tinf._grid_from_extent(ext)
    assert (a.edge_len, tuple(a.grid_size), a.max_anchors) == \
        (b.edge_len, tuple(b.grid_size), b.max_anchors)
    assert [str(w.message) for w in wj] == [str(w.message) for w in wt]
    assert bool(wt) == (auto_grid and "cap" in name)


@pytest.mark.parametrize("n_refs", [1, 3, 4, 7, 9])
def test_chunk_tables_and_masks_match_jax(models, n_refs):
    from tdvnet.eval.fused_scene import FusedSceneInference as J

    jm, vs, tm = models
    jinf = J(jm, vs, _jax_cfg(), fast_path=False)
    tinf = _port(tm)
    k, CH = 1, 4
    Rb = -(-n_refs // CH) * CH
    for a, b in zip(jinf._chunk_tables(), tinf._chunk_tables()):
        np.testing.assert_array_equal(np.asarray(a), n(b))
    for r0 in range(0, Rb, CH):
        for a, b in zip(jinf._chunk_masks(r0, n_refs, n_refs + 2 * k),
                        tinf._chunk_masks(r0, n_refs, n_refs + 2 * k)):
            np.testing.assert_array_equal(np.asarray(a), n(b))
    rng = np.random.default_rng(n_refs)
    cams = (rng.normal(size=(Rb + 2 * k, 3, 3)).astype(np.float32),
            rng.normal(size=(Rb + 2 * k, 3)).astype(np.float32),
            rng.normal(size=(Rb + 2 * k, 3, 3)).astype(np.float32))
    tcams = tuple(torch.from_numpy(c) for c in cams)
    pairs = [(jinf._scene_frame_batch(cams, Rb, n_refs, n_refs + 2 * k),
              tinf._scene_frame_batch(tcams, Rb, n_refs, n_refs + 2 * k))]
    pairs += [(jinf._chunk_frame_batch(cams, r0, n_refs, n_refs + 2 * k),
               tinf._chunk_frame_batch(tcams, r0, n_refs, n_refs + 2 * k))
              for r0 in range(0, Rb, CH)]
    for a, b in pairs:
        assert a.n_scenes == b.n_scenes == 1
        for f in ("rotmats", "tvecs", "K", "ref_idx", "src_idx", "src_mask",
                  "ref_mask", "img_mask", "img_scene", "ref_scene"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          n(getattr(b, f)), f)


def test_eval_config_matches_jax_and_refuses_fast_path_keys():
    from tdvnet.config import EvalConfig as J
    from tdvnet_torch.config import Config, EvalConfig, load_config

    ours = dataclasses.asdict(EvalConfig())
    theirs = dataclasses.asdict(J())
    assert set(theirs) - set(ours) == {
        "fast_path", "fast_rank", "fast_patch", "init_depth_batch",
        "offset_batch", "upsample_batch"}
    assert all(theirs[k] == v for k, v in ours.items())
    assert Config().eval == EvalConfig()
    assert load_config({"eval": {"fused_chunk": 8}}).eval.fused_chunk == 8
    for key in ("fast_path", "fast_rank", "fast_patch"):
        with pytest.raises(KeyError, match=key):
            load_config({"eval": {key: 1}})


def test_pred_fn_runs_whole_scene_inference(models, ragged, capsys):
    from tdvnet_torch.eval.harness import make_3dvnet_pred_fn

    views, _, _, d_port, _ = ragged
    cfg = dataclasses.replace(_torch_cfg())
    pred_fn = make_3dvnet_pred_fn(models[2], cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pred_fn(views, "scene0", None)
    assert out.shape == d_port.shape
    assert "scene volume stats" in capsys.readouterr().out
    # the default plug-in fetches millimetres with the parity offsets, so it
    # is another run than `ragged`; both are depths of the same scene
    assert np.isfinite(out).all() and np.abs(out - d_port).max() < 0.5
