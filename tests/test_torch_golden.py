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


def _eval_record(eval_cfg):
    """The `EvalConfig` fields whole-scene inference reads."""
    keys = ("n_src_on_either_side", "fused_chunk", "eval_grid_size",
            "eval_max_anchors", "auto_grid", "grid_bucket")
    d = dataclasses.asdict(eval_cfg)
    return json.loads(json.dumps({k: d[k] for k in keys}))


def write_scene_golden(n_views=SCENE_VIEWS):
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
    variables, epoch = load_npz(WEIGHTS)
    views = synthetic.make_scene(n_views=n_views, img_size=mc.img_size,
                                 seed=SCENE_SEED)
    inf = FusedSceneInference(ThreeDVNet(mc), variables, cfg,
                              offsets_list=OFFSETS, fast_path=False,
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
              "abs_rel": float(s_mets["abs_rel"]),
              "stats": {k_: int(v) for k_, v in
                        inf.last_scene_stats.items()}}
    record = {
        "config": _config_record(mc, BatchConfig()),
        "eval": _eval_record(cfg.eval),
        "n_views": int(n_views), "seed": SCENE_SEED,
        "n_refs": int(depth.shape[0]),
        "offsets": [list(o) for o in OFFSETS],
        "weights": os.path.relpath(WEIGHTS, ROOT),
        "weights_sha256": file_sha256(WEIGHTS),
        "weights_epoch": int(epoch),
        "warp_mode": "gather", "fast_path": False, "fetch_mm": True,
        "extent": grids[0][:3], "grid_size": grids[0][3:],
        "stats": {k_: int(v) for k_, v in stats.items()},
        "abs_rel": float(mets["abs_rel"]),
        "stream": stream,
    }
    depth_mm = np.round(depth * 1000.0).astype(np.uint16)
    np.savez_compressed(SCENE_GOLDEN, depth_mm=depth_mm,
                        record=np.array(json.dumps(record)))
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


if __name__ == "__main__":
    if "--write-scene" in sys.argv:
        rest = sys.argv[sys.argv.index("--write-scene") + 1:]
        write_scene_golden(int(rest[0]) if rest else SCENE_VIEWS)
    elif "--write" in sys.argv:
        write_golden()
    else:
        sys.exit("usage: python tests/test_torch_golden.py "
                 "--write | --write-scene [n_views]")
