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

A fifth holds training: three n_iters=0 steps of the JAX package's
`make_train_step` (default `TrainConfig`, the non-finetune regime with the
backbone's BatchNorm frozen) from the synth48 weights on the batch of the
first golden: the loss and loss_2d of each step, step 1's gradient norm per
module and the full gradient of three leaves (the gradient read from the
optimizer's first moment, mu = (1 - b1) g after one Adam update), and one
CostRegNet BatchNorm's running statistics after the steps (a few minutes
and ~6 GB on the CPU):

    python tests/test_torch_golden.py --write-train

A seventh holds bf16 inference (`ModelConfig(dtype=bfloat16)`, parameters
fp32, as `tools/eval_3dvnet.py --bf16` sets it): `infer_depth` on the first
golden's batch and `FusedSceneInference` on the parity golden's scene, with
the same weights and settings, and JAX's own bf16 error against unquantized
fp32 runs of both (JAX on the CPU, about five minutes):

    python tests/test_torch_golden.py --write-bf16

A sixth holds n_iters=1 training: the same three steps, batch and weights
at the epoch-5 lambda (0.5; epoch 0's is 0, which zeroes every refinement
loss term), with one gradient leaf more in each scene stage (PointNet,
scene U-Net, decoder) and the decoder's first BatchNorm beside CostRegNet's
(JAX on the CPU, ~10 minutes and ~23 GB; `--write-train` writes both
training goldens):

    python tests/test_torch_golden.py --write-train-refine

An eighth holds bf16 training (`TrainConfig(bf16_compute=True)`: the
model computes in bf16, the parameters, gradients and Adam's state stay
fp32): one step of the JAX package's bf16 and fp32 `make_train_step` at the
n_iters=0 and n_iters=1 settings of the two training goldens (the same
weights, lambdas, leaves and BatchNorms), from the same weights on each of
ten batches (`chip_smoke.BF16_TRAIN_SEEDS`: the golden batch and nine
more), each (dtype, n_iters) in a process of its own, and JAX's own
|bf16 - fp32| per batch and quantity: the loss, loss_2d and the gradient
norm per module as scalars, the median and p99 over each gradient leaf's
elements and over each BatchNorm's running statistics after the step (JAX
on the CPU, ~60 minutes, ~23 GB at n_iters=1):

    python tests/test_torch_golden.py --write-bf16-train

`--train-bn-error` prints how far JAX's fp32 batch statistics of
CostRegNet's first BatchNorm lie from float64 ones in that step (the
golden's own error, which `chip_smoke.py` phase 9b measures against a
float64 rerun on the card).

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
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_golden_train_synth48.npz")
BF16_GOLDEN = os.path.join(ROOT, "tests", "data",
                           "torch_golden_bf16_synth48.npz")
BF16_TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                                 "torch_golden_bf16_train_synth48.npz")
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


def _err_stats(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"median": float(np.median(d)),
            "p99": float(np.percentile(d, 99))}


def write_bf16_golden():
    """JAX's bf16 `infer_depth` on the golden batch and its bf16 parity
    `FusedSceneInference` on the parity golden's scene, with JAX's own bf16
    error: the median and p99 of |bf16 - fp32| per stage, from unquantized
    fp32 runs of the same inputs (the fp32 goldens keep the final depth in
    fp16 and the scene in millimetres, coarser than that error)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import time

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from chip_smoke import GOLDEN_SEEDS, OFFSETS
    from tdvnet.config import BatchConfig, Config, ModelConfig
    from tdvnet.data import batch as B, synthetic
    from tdvnet.eval import metrics2d
    from tdvnet.eval.fused_scene import FusedSceneInference
    from tdvnet.models.threedvnet import ThreeDVNet
    from tdvnet.train.checkpoints import load_npz

    mc32 = ModelConfig(warp_mode="gather")
    mc = dataclasses.replace(mc32, dtype=jnp.bfloat16)
    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                         bc.depth_img_size, seed=s,
                                         n_src_on_either_side=bc.n_src_on_either_side)
              for s in GOLDEN_SEEDS]
    fb = B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                          bc.n_src_on_either_side)
    variables, epoch = load_npz(WEIGHTS)

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

    outs = {}
    for name, c in (("fp32", mc32), ("bf16", mc)):
        t0 = time.perf_counter()
        model = ThreeDVNet(c)
        fn = jax.jit(lambda v, b: model.apply(v, b, method=run))
        outs[name] = jax.tree.map(np.asarray, fn(variables, fb))
        print(f"infer_depth {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    d0, d, final, stats = outs["bf16"]
    err = {k: _err_stats(outs["bf16"][i], outs["fp32"][i])
           for i, k in enumerate(("initial", "refined", "final"))}
    mets = metrics2d.calc_2d_depth_metrics(final, fb.depth_gt)

    views = synthetic.make_scene(n_views=SCENE_VIEWS, img_size=mc.img_size,
                                 seed=SCENE_SEED)
    cfg = Config(model=mc)
    depths, grids = {}, []
    for name, c in (("fp32", mc32), ("bf16", mc)):
        t0 = time.perf_counter()
        inf = FusedSceneInference(ThreeDVNet(c), variables,
                                  Config(model=c), offsets_list=OFFSETS,
                                  fast_path=False, fetch_mm=False)
        choose = inf._grid_from_extent

        def recording(extent, choose=choose):
            gc = choose(extent)
            grids.append(list(gc.grid_size))
            return gc
        inf._grid_from_extent = recording
        depths[name] = inf.predict_scene(views)
        print(f"scene {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    err["scene"] = _err_stats(depths["bf16"], depths["fp32"])
    depth = depths["bf16"]
    k = cfg.eval.n_src_on_either_side
    s_mets = metrics2d.calc_2d_depth_metrics(
        depth, views["depth"][k:SCENE_VIEWS - k])
    record = {
        "config": _config_record(mc, bc),
        "dtype": "bfloat16",
        "seeds": list(GOLDEN_SEEDS),
        "offsets": [list(o) for o in OFFSETS],
        "weights": os.path.relpath(WEIGHTS, ROOT),
        "weights_sha256": file_sha256(WEIGHTS),
        "weights_epoch": int(epoch),
        "warp_mode": "gather",
        "abs_rel": float(mets["abs_rel"]),
        "n_out_of_grid": int(stats["n_out_of_grid"]),
        "n_overflow": int(stats["n_overflow"]),
        "jax_bf16_error": err,
        "scene": {"eval": _eval_record(cfg.eval), "n_views": SCENE_VIEWS,
                  "seed": SCENE_SEED, "n_refs": int(depth.shape[0]),
                  "grid_size": grids[-1], "fetch_mm": False,
                  "abs_rel": float(s_mets["abs_rel"]),
                  "stats": {k_: int(v) for k_, v in
                            inf.last_scene_stats.items()}},
    }
    np.savez_compressed(BF16_GOLDEN, depth_init=d0.astype(np.float32),
                        depth_refined=d.astype(np.float32),
                        depth_final=final.astype(np.float16),
                        scene_depth_mm=np.round(depth * 1000.0)
                        .astype(np.uint16),
                        record=np.array(json.dumps(record)))
    print(json.dumps(record))


def bf16_train_run(dtype, n_iters, out_path):
    """One JAX train step (`dtype` "bf16": `bf16_compute=True`) at the
    settings of the n_iters=0 or n_iters=1 training golden, from the synth48
    weights on each batch of `chip_smoke.BF16_TRAIN_SEEDS` (one compile);
    writes per batch its losses, its gradient norms per module and gradient
    leaves and the BatchNorms' running statistics after it to
    `out_path`."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from chip_smoke import (BF16_TRAIN_SEEDS, TRAIN_MODULES,
                            TRAIN_REFINE_BNS, TRAIN_REFINE_EPOCH,
                            TRAIN_REFINE_LEAVES)
    from tdvnet.config import BatchConfig, Config, ModelConfig, TrainConfig
    from tdvnet.data import batch as B, synthetic
    from tdvnet.models.threedvnet import ThreeDVNet
    from tdvnet.train import loop as L
    from tdvnet.train.checkpoints import load_npz
    from tdvnet_torch.weights import from_flax_variables

    bc = BatchConfig()
    cfg = Config(model=ModelConfig(warp_mode="gather"), batch=bc,
                 train=TrainConfig(bf16_compute=dtype == "bf16"))
    mc = cfg.model
    if cfg.train.bf16_compute:
        # what `create_state` builds for bf16_compute; the parameters stay
        # fp32
        mc = dataclasses.replace(mc, dtype=jnp.bfloat16)
    variables, _ = load_npz(WEIGHTS)
    model = ThreeDVNet(mc)
    state = L.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        tx=L.make_tx(cfg, variables["params"], 1),
        batch_stats=variables["batch_stats"])
    step = L.make_train_step(model, cfg, n_iters, donate=False)
    lam = L.lambda_for_epoch(cfg, TRAIN_REFINE_EPOCH if n_iters else 0)
    arrays = {"lam": np.float64(lam)}
    for b, seeds in enumerate(BF16_TRAIN_SEEDS):
        scenes = [synthetic.make_batch_scene(
            bc.n_views, bc.img_size, bc.depth_img_size, seed=s,
            n_src_on_either_side=bc.n_src_on_either_side) for s in seeds]
        fb = B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                              bc.n_src_on_either_side)
        new, mets = step(state, fb, jnp.float32(lam))
        inner = new.opt_state.inner_states["train"].inner_state
        adam = next(x for x in jax.tree.leaves(
            inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState))
        for leaf in jax.tree.leaves(new.params):
            assert leaf.dtype == jnp.float32, leaf.dtype
        grads = jax.tree.map(
            lambda m: np.zeros(1, np.float32)
            if isinstance(m, optax.MaskedNode) else
            np.asarray(m) / np.float32(1 - 0.9), adam.mu,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        sd = from_flax_variables({"params": grads})
        stats = from_flax_variables({"batch_stats": jax.tree.map(
            np.asarray, new.batch_stats)})
        pre = f"b{b}:"
        arrays[pre + "loss"] = np.float64(mets["loss"])
        arrays[pre + "loss_2d"] = np.float64(mets["loss_2d"])
        for m in TRAIN_MODULES:
            arrays[pre + "norm:" + m] = np.float64(np.sqrt(sum(
                float((v.double() ** 2).sum()) for k, v in sd.items()
                if k.startswith(m + "."))))
        for k in TRAIN_REFINE_LEAVES:
            arrays[pre + "grad:" + k] = sd[k].numpy()
        for name in TRAIN_REFINE_BNS:
            for k in ("running_mean", "running_var"):
                arrays[f"{pre}bn:{name}.{k}"] = stats[f"{name}.{k}"].numpy()
        print(f"{dtype} n_iters={n_iters} seeds {seeds}: loss "
              f"{float(mets['loss'])}", flush=True)
    np.savez(out_path, **arrays)


def write_bf16_train_golden():
    """The bf16 training golden: `bf16_train_run` for bf16 and fp32 at
    n_iters 0 and 1, each in a process of its own (the n_iters=1 steps
    take ~23 GB apiece), and JAX's own |bf16 - fp32| of each quantity on
    each batch."""
    import subprocess
    import tempfile

    sys.path.insert(0, ROOT)
    from chip_smoke import (BF16_TRAIN_SEEDS, TRAIN_MODULES,
                            TRAIN_REFINE_BNS, TRAIN_REFINE_LEAVES)
    from tdvnet_torch.config import BatchConfig, ModelConfig, TrainConfig

    err = {}
    lams = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n_iters in (0, 1):
            runs = {}
            for dtype in ("bf16", "fp32"):
                out = os.path.join(tmp, f"{dtype}_{n_iters}.npz")
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--bf16-train-run", dtype, str(n_iters),
                                out], check=True)
                with np.load(out) as z:
                    runs[dtype] = {k: z[k] for k in z.files}
            lams[n_iters] = float(runs["bf16"]["lam"])
            per_batch = []
            for b in range(len(BF16_TRAIN_SEEDS)):
                bf = {k[len(f"b{b}:"):]: v for k, v in runs["bf16"].items()
                      if k.startswith(f"b{b}:")}
                f = {k[len(f"b{b}:"):]: v for k, v in runs["fp32"].items()
                     if k.startswith(f"b{b}:")}
                e = {k: abs(float(bf[k]) - float(f[k]))
                     for k in ("loss", "loss_2d")}
                e["norms"] = {m: abs(float(bf["norm:" + m])
                                     - float(f["norm:" + m]))
                              for m in TRAIN_MODULES}
                e["grads"] = {k: _err_stats(bf["grad:" + k], f["grad:" + k])
                              for k in TRAIN_REFINE_LEAVES}
                e["bn"] = {f"{n}.{k}": _err_stats(bf[f"bn:{n}.{k}"],
                                                  f[f"bn:{n}.{k}"])
                           for n in TRAIN_REFINE_BNS
                           for k in ("running_mean", "running_var")}
                e["bf16_loss"] = float(bf["loss"])
                e["fp32_loss"] = float(f["loss"])
                per_batch.append(e)
            err[str(n_iters)] = per_batch
    record = {
        "config": _config_record(ModelConfig(), BatchConfig()),
        "train": _train_record(TrainConfig()),
        "bf16_compute": True,
        "seeds": [list(x) for x in BF16_TRAIN_SEEDS],
        "weights": os.path.relpath(WEIGHTS, ROOT),
        "weights_sha256": file_sha256(WEIGHTS),
        "warp_mode": "gather",
        "steps": 1,
        "lam": {str(k): v for k, v in lams.items()},
        "leaves": list(TRAIN_REFINE_LEAVES),
        "bns": list(TRAIN_REFINE_BNS),
        "jax_bf16_error": err,
    }
    np.savez_compressed(BF16_TRAIN_GOLDEN,
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


def _train_record(train_cfg):
    keys = ("lr", "lr_step", "lr_gamma", "finetune", "offsets",
            "lambda_ramp_epochs")
    return json.loads(json.dumps({k: getattr(train_cfg, k) for k in keys}))


def write_train_golden(refine=False):
    """The n_iters=0 golden, or with `refine` the n_iters=1 one (its own
    file, lambda, leaves and BatchNorms, the same batch, weights and step
    count)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from chip_smoke import (GOLDEN_SEEDS, TRAIN_BN, TRAIN_LEAVES,
                            TRAIN_MODULES, TRAIN_REFINE_BNS,
                            TRAIN_REFINE_EPOCH, TRAIN_REFINE_GOLDEN,
                            TRAIN_REFINE_LEAVES, TRAIN_STEPS)
    from tdvnet.config import BatchConfig, Config, ModelConfig
    from tdvnet.data import batch as B, synthetic
    from tdvnet.models.threedvnet import ThreeDVNet
    from tdvnet.train import loop as L
    from tdvnet.train.checkpoints import load_npz
    from tdvnet_torch.weights import from_flax_variables

    mc = ModelConfig(warp_mode="gather")
    bc = BatchConfig()
    cfg = Config(model=mc, batch=bc)
    if refine:
        n_iters, epoch_lam = 1, TRAIN_REFINE_EPOCH
        path, leaf_names, bns = (TRAIN_REFINE_GOLDEN, TRAIN_REFINE_LEAVES,
                                 TRAIN_REFINE_BNS)
    else:
        n_iters, epoch_lam = 0, 0
        path, leaf_names, bns = TRAIN_GOLDEN, TRAIN_LEAVES, (TRAIN_BN,)
    scenes = [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                         bc.depth_img_size, seed=s,
                                         n_src_on_either_side=bc.n_src_on_either_side)
              for s in GOLDEN_SEEDS]
    fb = B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                          bc.n_src_on_either_side)
    variables, epoch = load_npz(WEIGHTS)
    model = ThreeDVNet(mc)
    state = L.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        tx=L.make_tx(cfg, variables["params"], 1),
        batch_stats=variables["batch_stats"])
    step = L.make_train_step(model, cfg, n_iters, donate=False)
    lam = L.lambda_for_epoch(cfg, epoch_lam)
    losses, losses_2d = [], []
    for i in range(TRAIN_STEPS):
        state, mets = step(state, fb, jnp.float32(lam))
        losses.append(float(mets["loss"]))
        losses_2d.append(float(mets["loss_2d"]))
        print(f"step {i}: loss {losses[-1]} loss_2d {losses_2d[-1]}",
              flush=True)
        if i == 0:
            inner = state.opt_state.inner_states["train"].inner_state
            adam = next(x for x in jax.tree.leaves(
                inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(x, optax.ScaleByAdamState))
            grads = jax.tree.map(
                lambda m: np.zeros(1, np.float32)
                if isinstance(m, optax.MaskedNode) else
                np.asarray(m) / np.float32(1 - 0.9), adam.mu,
                is_leaf=lambda x: isinstance(x, optax.MaskedNode))
            # the frozen backbone BatchNorm leaves hold a zero placeholder
            sd = from_flax_variables({"params": grads})
            norms = {m: float(np.sqrt(sum(
                float((v.double() ** 2).sum()) for k, v in sd.items()
                if k.startswith(m + "."))))
                for m in TRAIN_MODULES}
            leaves = {k: sd[k].numpy() for k in leaf_names}
    stats = from_flax_variables({"batch_stats": jax.tree.map(
        np.asarray, state.batch_stats)})
    record = {
        "config": _config_record(mc, bc),
        "train": _train_record(cfg.train),
        "seeds": list(GOLDEN_SEEDS),
        "weights": os.path.relpath(WEIGHTS, ROOT),
        "weights_sha256": file_sha256(WEIGHTS),
        "weights_epoch": int(epoch),
        "warp_mode": "gather",
        "n_iters": n_iters,
        "lam": lam,
        "steps": TRAIN_STEPS,
        "loss": losses,
        "loss_2d": losses_2d,
        "grad_norms": norms,
        "bn": bns[0],
    }
    arrays = {"bn_running_mean": stats[bns[0] + ".running_mean"].numpy(),
              "bn_running_var": stats[bns[0] + ".running_var"].numpy()}
    if refine:
        record["bns"] = list(bns)
        for name in bns:
            for k in ("running_mean", "running_var"):
                arrays[f"bn:{name}.{k}"] = stats[f"{name}.{k}"].numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, record=np.array(json.dumps(record)), **arrays,
        **{"grad:" + k: v for k, v in leaves.items()})
    print(json.dumps(record))


def train_bn_error():
    """How far the JAX package's fp32 batch statistics of CostRegNet's first
    BatchNorm lie from float64 ones in the golden's first step: the same
    cost volume and convolution, then flax's `_compute_stats` against numpy
    in float64 over the 4.2M elements per channel."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from flax.linen.normalization import _compute_stats

    from chip_smoke import GOLDEN_SEEDS
    from tdvnet.config import BatchConfig, ModelConfig
    from tdvnet.data import batch as B, synthetic
    from tdvnet.models.threedvnet import ThreeDVNet
    from tdvnet.ops import costvolume
    from tdvnet.train.checkpoints import load_npz

    mc = ModelConfig(warp_mode="gather")
    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                         bc.depth_img_size, seed=s,
                                         n_src_on_either_side=bc.n_src_on_either_side)
              for s in GOLDEN_SEEDS]
    fb = B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                          bc.n_src_on_either_side)
    variables, _ = load_npz(WEIGHTS)

    def cost_volume(m, b):
        _, quarter, _ = m.extract_features(b.images, False)
        dc = m.cfg.depth_train
        return costvolume.plane_sweep_cost_volume(
            quarter, b.rotmats, b.tvecs, b.K, b.ref_idx, b.src_idx,
            b.src_mask, dc.depth_start, dc.depth_interval, dc.n_intervals,
            m.cfg.img_size, dc.size)

    var = jax.jit(lambda v, b: ThreeDVNet(mc).apply(
        v, b, method=cost_volume))(variables, fb)
    kernel = variables["params"]["mvsnet"]["cost_reg"]["ConvBnRelu_0"][
        "Conv_0"]["kernel"]
    y = jax.lax.conv_general_dilated(
        var, jnp.asarray(kernel), (1, 1, 1), ((1, 1),) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    mean, fvar = jax.jit(lambda y: _compute_stats(y, (0, 1, 2, 3), None))(y)
    y64 = np.asarray(y, np.float64)
    m64, v64 = y64.mean(axis=(0, 1, 2, 3)), y64.var(axis=(0, 1, 2, 3))
    print(json.dumps({
        "elements_per_channel": int(y64.size // y64.shape[-1]),
        "var_rel_err": (np.abs(np.asarray(fvar) - v64) / v64).tolist(),
        "mean_err_in_std": (np.abs(np.asarray(mean) - m64)
                            / np.sqrt(v64)).tolist(),
        "mean_sq_over_var": (m64 ** 2 / v64).tolist()}))


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


def test_bf16_golden_matches_chip_smoke_settings():
    import chip_smoke
    import torch
    from tdvnet_torch.config import BatchConfig, EvalConfig, ModelConfig

    assert chip_smoke.BF16_GOLDEN == BF16_GOLDEN
    rec = read_record(BF16_GOLDEN)
    assert rec == chip_smoke.bf16_golden_record()
    assert rec["dtype"] == "bfloat16"
    assert rec["config"] == _config_record(
        ModelConfig(dtype=torch.bfloat16), BatchConfig())
    assert tuple(rec["seeds"]) == tuple(chip_smoke.GOLDEN_SEEDS)
    assert [tuple(o) for o in rec["offsets"]] == \
        [tuple(o) for o in chip_smoke.OFFSETS]
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    assert rec["warp_mode"] == "gather"
    # the parity golden's scene and settings
    parity = read_record(SCENE_GOLDEN)
    sc = rec["scene"]
    assert sc["eval"] == _eval_record(EvalConfig()) == parity["eval"]
    assert (sc["n_views"], sc["seed"], sc["n_refs"], sc["grid_size"]) == \
        (parity["n_views"], parity["seed"], parity["n_refs"],
         parity["grid_size"])
    assert sc["stats"]["n_points"] == parity["stats"]["n_points"]
    # JAX's own bf16 error per stage, the yardstick of phases 3' and 6a'
    assert sorted(rec["jax_bf16_error"]) == ["final", "initial", "refined",
                                             "scene"]
    for e in rec["jax_bf16_error"].values():
        assert 0.0 < e["median"] < e["p99"] < 0.1
    with np.load(BF16_GOLDEN) as z:
        n_ref = BatchConfig().n_refs_total
        assert z["depth_init"].shape == (n_ref, *ModelConfig().depth_test.size)
        assert z["depth_final"].shape == (n_ref, *ModelConfig().img_size)
        assert z["scene_depth_mm"].shape == (sc["n_refs"],
                                             *ModelConfig().img_size)
    assert os.path.getsize(BF16_GOLDEN) < 1.5 * (1 << 20)


def test_bf16_train_golden_matches_chip_smoke_settings():
    """The bf16 training golden (`--write-bf16-train`) records the settings
    phase 9h drives: its batches, the weights, one step at the two
    training goldens' lambdas, their leaves and BatchNorms, and JAX's own
    error per batch and quantity."""
    import chip_smoke
    from tdvnet_torch.config import (BatchConfig, Config, ModelConfig,
                                     TrainConfig)
    from tdvnet_torch.train.loop import lambda_for_epoch

    assert chip_smoke.BF16_TRAIN_GOLDEN == BF16_TRAIN_GOLDEN
    rec = read_record(BF16_TRAIN_GOLDEN)
    assert rec == chip_smoke.bf16_train_golden_record()
    assert rec["config"] == _config_record(ModelConfig(), BatchConfig())
    assert rec["train"] == _train_record(TrainConfig())
    assert rec["bf16_compute"] is True and rec["steps"] == 1
    seeds = [tuple(x) for x in rec["seeds"]]
    assert seeds == list(chip_smoke.BF16_TRAIN_SEEDS)
    assert seeds[0] == tuple(chip_smoke.GOLDEN_SEEDS)
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    assert rec["leaves"] == list(chip_smoke.TRAIN_REFINE_LEAVES)
    assert rec["bns"] == list(chip_smoke.TRAIN_REFINE_BNS)
    assert rec["lam"] == {
        "0": lambda_for_epoch(Config(), 0),
        "1": lambda_for_epoch(Config(), chip_smoke.TRAIN_REFINE_EPOCH)}
    for k in ("0", "1"):
        assert len(rec["jax_bf16_error"][k]) == len(seeds)
        for e in rec["jax_bf16_error"][k]:
            assert sorted(e["norms"]) == sorted(chip_smoke.TRAIN_MODULES)
            assert sorted(e["grads"]) == \
                sorted(chip_smoke.TRAIN_REFINE_LEAVES)
            assert 0.0 < e["loss"] < 0.1 * e["fp32_loss"]
            # n_iters=0 trains no scene stage, n_iters=1 all of them
            for m in ("pointnet", "scene_unet", "decoder"):
                assert (e["norms"][m] > 0.0) == (k == "1")
    assert os.path.getsize(BF16_TRAIN_GOLDEN) < 1 << 16


def test_train_golden_matches_chip_smoke_settings():
    import chip_smoke
    from tdvnet_torch.config import BatchConfig, ModelConfig, TrainConfig

    rec = read_record(TRAIN_GOLDEN)
    assert rec["config"] == _config_record(ModelConfig(), BatchConfig())
    assert rec["train"] == _train_record(TrainConfig())
    assert tuple(rec["seeds"]) == tuple(chip_smoke.GOLDEN_SEEDS)
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    assert (rec["warp_mode"], rec["n_iters"], rec["lam"]) == \
        ("gather", 0, 0.0)
    assert rec["steps"] == chip_smoke.TRAIN_STEPS == len(rec["loss"]) \
        == len(rec["loss_2d"])
    assert sorted(rec["grad_norms"]) == sorted(chip_smoke.TRAIN_MODULES)
    # n_iters=0: the scene stages take no gradient
    for m in ("pointnet", "scene_unet", "decoder"):
        assert rec["grad_norms"][m] == 0.0
    assert rec["bn"] == chip_smoke.TRAIN_BN
    with np.load(TRAIN_GOLDEN) as z:
        leaves = sorted(k[len("grad:"):] for k in z.files
                        if k.startswith("grad:"))
        assert z["bn_running_var"].shape == \
            (ModelConfig().cost_base_channels,)
    assert leaves == sorted(chip_smoke.TRAIN_LEAVES)
    assert os.path.getsize(TRAIN_GOLDEN) < 1 << 20


def test_train_refine_golden_matches_chip_smoke_settings():
    import chip_smoke
    from tdvnet_torch.config import (BatchConfig, Config, ModelConfig,
                                     TrainConfig)
    from tdvnet_torch.train.loop import lambda_for_epoch

    rec = read_record(chip_smoke.TRAIN_REFINE_GOLDEN)
    assert rec["config"] == _config_record(ModelConfig(), BatchConfig())
    assert rec["train"] == _train_record(TrainConfig())
    assert tuple(rec["seeds"]) == tuple(chip_smoke.GOLDEN_SEEDS)
    assert rec["weights_sha256"] == file_sha256(WEIGHTS)
    lam = lambda_for_epoch(Config(), chip_smoke.TRAIN_REFINE_EPOCH)
    assert (rec["warp_mode"], rec["n_iters"], rec["lam"]) == \
        ("gather", 1, lam) and lam > 0
    assert rec["steps"] == chip_smoke.TRAIN_STEPS == len(rec["loss"]) \
        == len(rec["loss_2d"])
    assert sorted(rec["grad_norms"]) == sorted(chip_smoke.TRAIN_MODULES)
    # n_iters=1: the scene stages train
    for m in ("pointnet", "scene_unet", "decoder"):
        assert rec["grad_norms"][m] > 0.0
    assert rec["bns"] == list(chip_smoke.TRAIN_REFINE_BNS)
    with np.load(chip_smoke.TRAIN_REFINE_GOLDEN) as z:
        leaves = sorted(k[len("grad:"):] for k in z.files
                        if k.startswith("grad:"))
        assert z["bn:decoder.BatchNorm_0.running_var"].shape == \
            (ModelConfig().decoder_hidden,)
    assert leaves == sorted(chip_smoke.TRAIN_REFINE_LEAVES)
    assert os.path.getsize(chip_smoke.TRAIN_REFINE_GOLDEN) < 1 << 21


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
        elif "--write-train-refine" in sys.argv:
            write_train_golden(refine=True)
        elif "--write-train" in sys.argv:
            write_train_golden()
            write_train_golden(refine=True)
        elif "--bf16-train-run" in sys.argv:
            rest = sys.argv[sys.argv.index("--bf16-train-run") + 1:]
            bf16_train_run(rest[0], int(rest[1]), rest[2])
        elif "--write-bf16-train" in sys.argv:
            write_bf16_train_golden()
        elif "--write-bf16" in sys.argv:
            write_bf16_golden()
        elif "--train-bn-error" in sys.argv:
            train_bn_error()
        elif "--write" in sys.argv:
            write_golden()
        else:
            sys.exit("usage: python tests/test_torch_golden.py --write | "
                     "--write-scene [n_views] | --write-fast-scene [n_views]"
                     " | --write-eval3d | --write-bf16 | --write-bf16-train | "
                     "--write-train | "
                     "--write-train-refine | --train-bn-error")
