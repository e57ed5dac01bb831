"""JAX golden for the port's full-width depth inference.

The card that runs `chip_smoke.py` has no JAX, so the full-width path of
`tdvnet_torch` is held there against arrays that the JAX package computed
here on the CPU: `ThreeDVNet.infer_depth` with the exact gather warp, the
synth48 weights, the default `BatchConfig` (2 scenes x 9 views, 7 refs each)
on synthetic scenes, at the parity offsets.

Regenerate (several minutes on the CPU, a few GB of memory):

    python tests/test_torch_golden.py --write

A second golden holds whole-scene inference: `FusedSceneInference` at the
parity settings (default `EvalConfig`, `fast_path=False`, millimetre fetch)
on one synthetic scene whose ref count is not a multiple of the chunk, plus
the JAX package's `abs_rel` and drop counters on the first scene of the
stream `chip_smoke.py` serves (52 views; about ten minutes on the CPU in
all):

    python tests/test_torch_golden.py --write-scene [n_views]

A third holds the fast path: the same scene and stream through
`FusedSceneInference(fast_path=True)` with the default `EvalConfig`
(`fast_rank=96`, `fast_patch=True`, the fast offsets), plus the rank
projection's basis V and its discarded energy:

    python tests/test_torch_golden.py --write-fast-scene [n_views]

A fourth holds 3D evaluation: the JAX package's 2D, fused-cloud and TSDF
metrics (GT-mesh masking on, `run_tsdf_fusion=True`) of a recipe's
predictions for one synthetic scene written by
`tools/make_synthetic_dataset.py` (52 views at 480x640), with the fused
point count before the downsample and the GT mesh's size; the recipe and
the `EvalConfig` fields are recorded beside them (a few minutes on the CPU):

    python tests/test_torch_golden.py --write-eval3d

The tier-1 tests below only check that the recorded settings are the ones
`chip_smoke.py` drives.
"""
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth48.npz")
SCENE_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_golden_scene_synth48.npz")
FAST_SCENE_GOLDEN = os.path.join(ROOT, "tests", "data",
                                 "torch_golden_fastscene_synth48.npz")
WEIGHTS = os.path.join(ROOT, "weights", "3dvnet_synth48.npz")
SCENE_VIEWS, SCENE_SEED = 24, 11


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _config_record(model_cfg, batch_cfg):
    """The settings both sides must share, as plain JSON."""
    m = {k: v for k, v in dataclasses.asdict(model_cfg).items()
         if k not in ("dtype", "warp_mode", "warp_alpha_max", "conv3d_impl")}
    return json.loads(json.dumps({"model": m,
                                  "batch": dataclasses.asdict(batch_cfg)}))


def write_golden():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from chip_smoke import GOLDEN_SEEDS, OFFSETS
    from tdvnet.config import BatchConfig, ModelConfig
    from tdvnet.data import batch as B, synthetic
    from tdvnet.eval import metrics2d
    from tdvnet.models.threedvnet import ThreeDVNet
    from tdvnet.train.checkpoints import load_npz

    mc = ModelConfig(warp_mode="gather")
    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                         bc.depth_img_size, seed=s,
                                         n_src_on_either_side=bc.n_src_on_either_side)
              for s in GOLDEN_SEEDS]
    fb = B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                          bc.n_src_on_either_side)
    variables, epoch = load_npz(WEIGHTS)
    model = ThreeDVNet(mc)

    def run(m, batch):
        dc = m.cfg.depth_test
        half, quarter, _ = m.extract_features(batch.images)
        d0, _ = m.initial_depth(batch, dc, quarter)
        d = d0
        for offs in OFFSETS:
            scales, origins, stats = m.model_scene(d, quarter, batch)
            for off in offs:
                d = d + m.run_pointflow(scales, origins, d, quarter, batch,
                                        off, 3)
        final = m.upsample(d, half, quarter, batch.images, batch.ref_idx)
        return d0, d, final, stats

    fn = jax.jit(lambda v, b: model.apply(v, b, method=run))
    d0, d, final, stats = jax.tree.map(np.asarray, fn(variables, fb))
    mets = metrics2d.calc_2d_depth_metrics(final, fb.depth_gt)
    record = {
        "config": _config_record(mc, bc),
        "seeds": list(GOLDEN_SEEDS),
        "offsets": [list(o) for o in OFFSETS],
        "weights": os.path.relpath(WEIGHTS, ROOT),
        "weights_sha256": file_sha256(WEIGHTS),
        "weights_epoch": int(epoch),
        "warp_mode": "gather",
        "abs_rel": float(mets["abs_rel"]),
        "n_out_of_grid": int(stats["n_out_of_grid"]),
        "n_overflow": int(stats["n_overflow"]),
    }
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, depth_init=d0.astype(np.float32),
                        depth_refined=d.astype(np.float32),
                        depth_final=final.astype(np.float16),
                        record=np.array(json.dumps(record)))
    print(json.dumps(record))


def _eval_record(eval_cfg, fast=False):
    """The `EvalConfig` fields whole-scene inference reads (with `fast`,
    also the fast path's)."""
    keys = ("n_src_on_either_side", "fused_chunk", "eval_grid_size",
            "eval_max_anchors", "auto_grid", "grid_bucket")
    if fast:
        keys += ("fast_path", "fast_rank", "fast_patch")
    d = dataclasses.asdict(eval_cfg)
    return json.loads(json.dumps({k: d[k] for k in keys}))


def write_scene_golden(n_views=SCENE_VIEWS, fast=False):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from chip_smoke import OFFSETS, STREAM_SEEDS, STREAM_VIEWS
    from tdvnet.config import BatchConfig, Config, ModelConfig
    from tdvnet.data import synthetic
    from tdvnet.eval import metrics2d
    from tdvnet.eval.fused_scene import FusedSceneInference
    from tdvnet.models.threedvnet import ThreeDVNet
    from tdvnet.train.checkpoints import load_npz

    mc = ModelConfig(warp_mode="gather")
    cfg = Config(model=mc)
    if fast:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, fast_path=True))
    variables, epoch = load_npz(WEIGHTS)
    views = synthetic.make_scene(n_views=n_views, img_size=mc.img_size,
                                 seed=SCENE_SEED)
    # the fast path swaps the parity offsets for its own
    inf = FusedSceneInference(ThreeDVNet(mc), variables, cfg,
                              offsets_list=OFFSETS, fast_path=fast,
                              fetch_mm=True)
    grids = []
    choose = inf._grid_from_extent

    def recording(extent):
        gc = choose(extent)
        grids.append([float(x) for x in extent] + list(gc.grid_size))
        return gc
    inf._grid_from_extent = recording
    depth = inf.predict_scene(views)
    stats = dict(inf.last_scene_stats)
    k = cfg.eval.n_src_on_either_side
    gt = views["depth"][k:n_views - k]
    mets = metrics2d.calc_2d_depth_metrics(depth, gt)
    # the stream's first scene: only its metric and counters are kept
    s_views = synthetic.make_scene(n_views=STREAM_VIEWS, img_size=mc.img_size,
                                   seed=STREAM_SEEDS[0])
    s_depth = inf.predict_scene(s_views)
    s_mets = metrics2d.calc_2d_depth_metrics(
        s_depth, s_views["depth"][k:STREAM_VIEWS - k])
    stream = {"n_views": STREAM_VIEWS, "seed": STREAM_SEEDS[0],
              "grid_size": grids[-1][3:],
              "abs_rel": float(s_mets["abs_rel"]),
              "stats": {k_: int(v) for k_, v in
                        inf.last_scene_stats.items()}}
    record = {
        "config": _config_record(mc, BatchConfig()),
        "eval": _eval_record(cfg.eval, fast),
        "n_views": int(n_views), "seed": SCENE_SEED,
        "n_refs": int(depth.shape[0]),
        "offsets": [list(o) for o in inf.offsets_list],
        "weights": os.path.relpath(WEIGHTS, ROOT),
        "weights_sha256": file_sha256(WEIGHTS),
        "weights_epoch": int(epoch),
        "warp_mode": "gather", "fast_path": fast, "fetch_mm": True,
        "extent": grids[0][:3], "grid_size": grids[0][3:],
        "stats": {k_: int(v) for k_, v in stats.items()},
        "abs_rel": float(mets["abs_rel"]),
        "stream": stream,
    }
    arrays = {"depth_mm": np.round(depth * 1000.0).astype(np.uint16)}
    if fast:
        from tdvnet.models.hypothesis import decoder_scene_projection

        V, _, tail = decoder_scene_projection(
            variables["params"]["decoder"], mc.feat_dim, cfg.eval.fast_rank)
        record["projected"] = inf._proj_V is not None
        record["tail"] = tail
        arrays["V"] = np.asarray(V, np.float32)
    np.savez_compressed(FAST_SCENE_GOLDEN if fast else SCENE_GOLDEN,
                        record=np.array(json.dumps(record)), **arrays)
    print(json.dumps(record))


EVAL3D_FIELDS = ("z_thresh", "n_consistent_thresh", "voxel_downsample",
                 "fscore_thresh", "run_tsdf_fusion", "run_pc_fusion",
                 "tsdf_img_batch", "tsdf_voxel_size", "tsdf_margin",
                 "tsdf_bounds_quantile", "tsdf_trunc_ratio")


def _eval3d_fields(eval_cfg):
    d = dataclasses.asdict(eval_cfg)
    return json.loads(json.dumps({k: d[k] for k in EVAL3D_FIELDS}))


def write_eval3d_golden():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")

    from chip_smoke import (EVAL3D, EVAL3D_EVAL, EVAL3D_GOLDEN, eval3d_preds,
                            recording_fused_points)
    from tdvnet.config import EvalConfig
    from tdvnet.eval import processresults as PR
    from tdvnet.ops import fusion, ply
    from tools.make_synthetic_dataset import make_scene_dir

    r = EVAL3D
    ecfg = EvalConfig(**EVAL3D_EVAL)
    k, n = r["k"], r["n_views"]
    with tempfile.TemporaryDirectory() as root:
        scene = make_scene_dir(root, r["scene"], n, r["hw"], r["seed"])
        with open(os.path.join(scene, "info.json")) as f:
            info = json.load(f)
        verts, faces, _ = ply.read_ply(info["gt_mesh"])
        poses = np.stack([np.asarray(fr["pose"], np.float32)
                          for fr in info["frames"]])
        preds = eval3d_preds(poses, info["intrinsics"],
                             PR.load_gt_depth(np.arange(k, n - k), scene),
                             r["scene"])
        save = os.path.join(root, "save")
        os.makedirs(save)
        np.savez(os.path.join(save, "preds.npz"), **preds)
        fused = []
        with recording_fused_points(fusion, fused):
            metrics = {"metrics_2d.json": PR.process_scene_2d_metrics(
                scene, save)}
            name3 = (f"metrics_3d_{ecfg.z_thresh:.3f}_"
                     f"{ecfg.n_consistent_thresh}v_masked.json")
            metrics[name3] = PR.process_depth_3d_metrics(scene, save, ecfg,
                                                         True)
        with open(os.path.join(save, "metrics_tsdf_masked.json")) as f:
            metrics["metrics_tsdf_masked.json"] = json.load(f)
    record = {"recipe": EVAL3D, "eval_overrides": EVAL3D_EVAL,
              "eval": _eval3d_fields(ecfg), "metrics": metrics,
              "n_fused_points": fused[0], "gt_mesh_vertices": len(verts),
              "gt_mesh_faces": len(faces)}
    np.savez_compressed(EVAL3D_GOLDEN, record=np.array(json.dumps(record)))
    print(json.dumps(record))


def read_record(path=GOLDEN):
    with np.load(path) as z:
        return json.loads(str(z["record"]))


def test_golden_matches_chip_smoke_settings():
    import chip_smoke
    from tdvnet_torch.config import BatchConfig, ModelConfig

    rec = read_record()
    assert rec["config"] == _config_record(ModelConfig(), BatchConfig())
    assert tuple(rec["seeds"]) == tuple(chip_smoke.GOLDEN_SEEDS)
    assert [tuple(o) for o in rec["offsets"]] == \
        [tuple(o) for o in chip_smoke.OFFSETS]
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    assert rec["warp_mode"] == "gather"
    with np.load(GOLDEN) as z:
        n_ref = BatchConfig().n_refs_total
        assert z["depth_init"].shape == (n_ref, *ModelConfig().depth_test.size)
        assert z["depth_final"].shape == (n_ref, *ModelConfig().img_size)


def test_scene_golden_matches_chip_smoke_settings():
    import chip_smoke
    from tdvnet_torch.config import BatchConfig, EvalConfig, ModelConfig

    rec = read_record(SCENE_GOLDEN)
    assert rec == chip_smoke.scene_golden_record()
    assert rec["config"] == _config_record(ModelConfig(), BatchConfig())
    assert rec["eval"] == _eval_record(EvalConfig())
    assert [tuple(o) for o in rec["offsets"]] == \
        [tuple(o) for o in chip_smoke.OFFSETS]
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    assert (rec["warp_mode"], rec["fast_path"], rec["fetch_mm"]) == \
        ("gather", False, True)
    ev = EvalConfig()
    n_refs = rec["n_views"] - 2 * ev.n_src_on_either_side
    assert rec["n_refs"] == n_refs
    assert n_refs % ev.fused_chunk != 0 and n_refs > ev.fused_chunk, \
        "the golden scene must end in a ragged chunk"
    assert rec["stats"]["n_points"] == \
        len(rec["offsets"]) * n_refs * 56 * 56
    assert (rec["stream"]["n_views"], rec["stream"]["seed"]) == \
        (chip_smoke.STREAM_VIEWS, chip_smoke.STREAM_SEEDS[0])
    with np.load(SCENE_GOLDEN) as z:
        assert z["depth_mm"].shape == (n_refs, *ModelConfig().img_size)
        assert z["depth_mm"].dtype == np.uint16


def test_fast_scene_golden_matches_chip_smoke_settings():
    import chip_smoke
    from tdvnet_torch.config import BatchConfig, EvalConfig, ModelConfig
    from tdvnet_torch.eval.fused_scene import FAST_OFFSETS

    rec = read_record(FAST_SCENE_GOLDEN)
    parity = read_record(SCENE_GOLDEN)
    assert rec == chip_smoke.scene_golden_record(FAST_SCENE_GOLDEN)
    assert rec["config"] == _config_record(ModelConfig(), BatchConfig())
    fast_eval = dataclasses.replace(EvalConfig(), fast_path=True)
    assert rec["eval"] == _eval_record(fast_eval, fast=True)
    assert [tuple(o) for o in rec["offsets"]] == list(FAST_OFFSETS)
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    assert (rec["warp_mode"], rec["fast_path"], rec["fetch_mm"],
            rec["projected"]) == ("gather", True, True, True)
    # the same scene and stream as the parity golden
    for k in ("n_views", "seed", "n_refs", "extent", "grid_size"):
        assert rec[k] == parity[k], k
    assert (rec["stream"]["n_views"], rec["stream"]["seed"]) == \
        (parity["stream"]["n_views"], parity["stream"]["seed"])
    assert rec["stats"]["n_points"] == \
        len(rec["offsets"]) * rec["n_refs"] * 56 * 56
    n_scene = sum(ModelConfig().unet_dims)
    with np.load(FAST_SCENE_GOLDEN) as z:
        assert z["depth_mm"].shape == (rec["n_refs"], *ModelConfig().img_size)
        assert z["depth_mm"].dtype == np.uint16
        V = z["V"]
    assert V.shape == (n_scene, EvalConfig().fast_rank)
    np.testing.assert_allclose(V.T @ V, np.eye(V.shape[1]), atol=1e-5)
    assert 0.0 < rec["tail"] < 1.0


def test_eval3d_golden_matches_chip_smoke_settings():
    import chip_smoke
    from tdvnet_torch.config import EvalConfig

    rec = chip_smoke.eval3d_record()
    assert rec["recipe"] == chip_smoke.EVAL3D
    assert rec["eval_overrides"] == chip_smoke.EVAL3D_EVAL
    ecfg = EvalConfig(**chip_smoke.EVAL3D_EVAL)
    assert rec["eval"] == _eval3d_fields(ecfg)
    assert sorted(rec["metrics"]) == sorted(chip_smoke.EVAL3D_AVG_FILES)
    assert rec["metrics"]["metrics_3d_0.010_3v_masked.json"]["n"] == \
        chip_smoke.EVAL3D["n_views"] - 2 * chip_smoke.EVAL3D["k"]
    # the recipe's noise and dropped pixels make the consistency test
    # reject some of the refs' pixels
    n_px = (rec["metrics"]["metrics_2d.json"]["n"]
            * chip_smoke.EVAL3D["hw"][0] * chip_smoke.EVAL3D["hw"][1])
    assert 0 < rec["n_fused_points"] < 0.9 * n_px
    assert rec["gt_mesh_vertices"] > 0 and rec["gt_mesh_faces"] > 0
    assert os.path.getsize(chip_smoke.EVAL3D_GOLDEN) < 1 << 20


if __name__ == "__main__":
    for flag, fast in (("--write-scene", False), ("--write-fast-scene", True)):
        if flag in sys.argv:
            rest = sys.argv[sys.argv.index(flag) + 1:]
            write_scene_golden(int(rest[0]) if rest else SCENE_VIEWS, fast)
            break
    else:
        if "--write-eval3d" in sys.argv:
            write_eval3d_golden()
        elif "--write" in sys.argv:
            write_golden()
        else:
            sys.exit("usage: python tests/test_torch_golden.py --write | "
                     "--write-scene [n_views] | --write-fast-scene [n_views]"
                     " | --write-eval3d")
