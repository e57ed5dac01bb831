"""The port's command-line entry points (`tdvnet_torch/tools/*.py`) and the
config fields they read, on the CPU, in this process (`main(argv)`, no
subprocess): `load_config(yaml_path=...)` against the JAX package's, the
synthetic dataset writer, the weight export in both directions, the
validation split against the JAX tool's lines, a tiny training run, the
evaluation entries against a direct `harness.main` call (which
tests/test_torch_eval3d.py holds to the JAX package), and the flags the
port refuses before any work. The only JAX work is a YAML parse and an
`.npz` write and read: nothing compiles."""
import dataclasses
import json
import os
import runpy
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the scenes' size and the harness settings of tests/test_torch_eval3d.py
HW = (60, 80)
EVAL = {"depth_img_size": HW, "pdist": 0.05, "n_src_on_either_side": 1,
        "fused_chunk": 4, "eval_grid_size": (16, 16, 16),
        "eval_max_anchors": 2048, "grid_bucket": 8}
YAML = """\
model:
  feat_dim: 16
  img_size: [128, 160]
  unet_dims: [32, 48, 48]
  depth_test:
    n_intervals: 48
    size: [32, 40]
  grid:
    grid_size: [32, 32, 16]
train:
  lr: 0.0005
  offsets: [0.1, 0.05, 0.02]
  loader_workers: 2
  loader_prefetch: 1
batch:
  n_ref: 5
data:
  img_interval: 10
  num_workers: 3
eval:
  fast_path: true
  eval_grid_size: [96, 96, 48]
ckpt_path: /ckpts/run1
"""


def _tiny_load_config(**eval_fields):
    """A stand-in for a CLI module's `load_config`: the tiny config, then
    the CLI's overrides except the batch's (the tiny batch stays), then
    `eval_fields`."""
    from tdvnet_torch.config import _overlay, tiny_test_config

    def load(overrides=None, yaml_path=None):
        o = {k: v for k, v in (overrides or {}).items() if k != "batch"}
        cfg = _overlay(tiny_test_config(), o)
        return _overlay(cfg, {"eval": eval_fields}) if eval_fields else cfg

    return load


def _fields(dc):
    """{dotted field name: value} over a config tree."""
    out = {}
    for f in dataclasses.fields(dc):
        v = getattr(dc, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _fields(v).items()})
        else:
            out[f.name] = v
    return out


# ------------------------------------------------------------------ config
def test_yaml_config_matches_jax(tmp_path):
    """One YAML file (nested fields, tuples as lists) through both
    packages' `load_config(yaml_path=...)`, with a dict overlaid after it:
    every field the port keeps agrees, apart from its two deliberate
    deviations (`dtype` as a torch dtype, `warp_mode` only "gather")."""
    from tdvnet.config import load_config as jload
    from tdvnet_torch.config import load_config as tload

    path = tmp_path / "run.yaml"
    path.write_text(YAML)
    over = {"train": {"lr": 2e-4}, "eval": {"fast_rank": 64}}
    want, got = (_fields(f(over, yaml_path=str(path)))
                 for f in (jload, tload))
    kept = set(got) - {"model.dtype", "model.warp_mode"}
    assert kept <= set(want), sorted(kept - set(want))
    assert {k: got[k] for k in kept} == {k: want[k] for k in kept}
    assert got["train.lr"] == 2e-4 and got["train.offsets"] == (0.1, 0.05,
                                                                0.02)
    assert got["model.grid.grid_size"] == (32, 32, 16)
    assert got["ckpt_path"] == "/ckpts/run1"
    assert tload(yaml_path=None) == tload()


def test_new_config_fields_have_jax_defaults():
    from tdvnet.config import Config as J
    from tdvnet_torch.config import Config as T

    j, t = J(), T()
    assert t.ckpt_path is None and j.ckpt_path is None
    for sub, name in (("train", "loader_workers"), ("train",
                                                    "loader_prefetch"),
                      ("data", "img_interval"), ("data", "num_workers")):
        assert getattr(getattr(t, sub), name) == \
            getattr(getattr(j, sub), name), name


def test_yaml_without_pyyaml_names_the_file(tmp_path, monkeypatch):
    from tdvnet_torch.config import Config, load_config

    path = tmp_path / "run.yaml"
    path.write_text(YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)     # import fails
    with pytest.raises(ImportError, match="run.yaml.*PyYAML"):
        load_config(yaml_path=str(path))
    assert load_config() == Config()


def test_model_config_refuses_a_feat_dim_past_the_pools():
    from tdvnet_torch.config import MAX_FEAT_DIM, ModelConfig

    ModelConfig(feat_dim=MAX_FEAT_DIM)
    with pytest.raises(ValueError, match="48 KB of shared memory"):
        ModelConfig(feat_dim=MAX_FEAT_DIM + 1)


# ------------------------------------------------------------- the dataset
def test_make_synthetic_dataset_writes_the_library_scenes(tmp_path):
    """Two scenes of 4 views at 48x64: the files `make_scene_dir` writes
    for the same seeds, byte for byte, and each `info.json` names its 4
    frames."""
    from tdvnet_torch.data.synthetic_dataset import make_scene_dir
    from tdvnet_torch.tools import make_synthetic_dataset as M

    dirs = M.main(["--dst", str(tmp_path / "cli"), "--scenes", "2",
                   "--views", "4", "--hw", "48", "64", "--device", "cpu"])
    assert [os.path.basename(d) for d in dirs] == ["synth_0000",
                                                   "synth_0001"]
    for s, d in enumerate(dirs):
        ref = make_scene_dir(str(tmp_path / "lib"), f"synth_{s:04d}", 4,
                             (48, 64), s, "cpu")
        with open(os.path.join(d, "info.json")) as f:
            info = json.load(f)
        assert len(info["frames"]) == 4
        for sub in ("color/00003.png", "depth/00000.png", "gt_mesh.ply"):
            with open(os.path.join(d, sub), "rb") as a, \
                    open(os.path.join(ref, sub), "rb") as b:
                assert a.read() == b.read(), sub


# ------------------------------------------------------------------ weights
@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A tiny model (seeded, BatchNorm statistics moved off their init)
    saved as the port's checkpoint at epoch 3."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import checkpoints as C
    from tdvnet_torch.train import loop as L

    cfg = tiny_test_config()
    torch.manual_seed(0)
    model = ThreeDVNet(cfg.model)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    d = str(tmp_path_factory.mktemp("ckpt"))
    C.save(d, L.TrainState(model, L.make_optimizer(cfg, model, 1)), 3, cfg)
    return cfg, model, d


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_export_weights_round_trip(tiny_checkpoint, tmp_path):
    """The port's checkpoint -> `.npz`: the port's loader consumes every
    key (each tensor the model's, rounded to fp16), the JAX package's
    `load_npz` reads the same tree and epoch, and an `.npz` that the JAX
    package's `export_npz` wrote loads into the port and exports again to
    the same arrays."""
    from tdvnet.train import checkpoints as JC
    from tdvnet_torch.tools import export_weights as E
    from tdvnet_torch.weights import (load_npz, load_threedvnet,
                                      to_flax_variables)

    cfg, model, d = tiny_checkpoint
    out = str(tmp_path / "w.npz")
    assert E.main(["--ckpt-dir", d, "--out", out]) == out
    loaded = load_threedvnet(out, cfg.model, device="cpu")
    own = model.state_dict()
    for k, v in loaded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, own[k].half().float()), k
    (tv, te), (jv, je) = load_npz(out), JC.load_npz(out)
    assert te == je == 3
    a, b = _leaves(tv), _leaves(jv)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)

    jax_npz = str(tmp_path / "from_jax.npz")
    JC.export_npz(jax_npz, to_flax_variables(model), epoch=5)
    load_threedvnet(jax_npz, cfg.model, device="cpu")
    again = str(tmp_path / "again.npz")
    E.main(["--ckpt-dir", jax_npz, "--out", again])
    with np.load(jax_npz) as x, np.load(again) as y:
        assert sorted(x.files) == sorted(y.files)
        assert all(np.array_equal(x[k], y[k]) for k in x.files)


def test_export_weights_names_a_missing_checkpoint(tmp_path):
    from tdvnet_torch.tools import export_weights as E

    for missing in (str(tmp_path / "none"), str(tmp_path / "none.npz")):
        with pytest.raises(FileNotFoundError, match="none"):
            E.main(["--ckpt-dir", missing, "--out", str(tmp_path / "o.npz")])


# ---------------------------------------------------------- validation split
def test_make_validation_split_matches_the_jax_tool(tmp_path, monkeypatch):
    """A fake 120-scene `scannetv2_train.txt`: the port's split holds the
    JAX tool's lines (a copy of the tool run from `tmp_path`, so that it
    writes there), and a second run refuses to overwrite."""
    from tdvnet_torch.tools import make_validation_split as V

    scannet = tmp_path / "scannet"
    scannet.mkdir()
    names = [f"scene{i:04d}_{i % 3:02d}" for i in range(120)]
    (scannet / "scannetv2_train.txt").write_text("\n".join(names) + "\n")
    argv = ["--scannet-dir", str(scannet), "--n", "30", "--seed", "7"]

    monkeypatch.setattr(V, "SPLITS_DIR", str(tmp_path / "port"))
    out = V.main(argv)
    with pytest.raises(FileExistsError):
        V.main(argv)

    tool = tmp_path / "jax" / "tools" / "make_validation_split.py"
    tool.parent.mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "tools", "make_validation_split.py"),
                tool)
    path = list(sys.path)
    monkeypatch.setattr(sys, "argv", [str(tool)] + argv)
    try:
        runpy.run_path(str(tool), run_name="__main__")
    finally:
        sys.path[:] = path
    want = tmp_path / "jax" / "tdvnet" / "data" / "scannet_splits" / \
        "val_split1.txt"
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines == want.read_text().splitlines()
    assert len(lines) == 30 and len(set(lines)) == 30


# ----------------------------------------------------------------- training
def test_train_cli_runs_one_tiny_step(tmp_path, monkeypatch):
    """`--synthetic 1 --epochs 1 --steps-per-epoch 1` at the tiny config
    on the CPU: the synthetic cache under the temporary directory, a
    finite loss in the log, the epoch's checkpoint, and an `.npz` export
    that holds the trained weights."""
    from tdvnet_torch.tools import train_3dvnet as T
    from tdvnet_torch.train import checkpoints as C
    from tdvnet_torch.weights import load_npz, to_flax_variables

    monkeypatch.setattr(T, "load_config", _tiny_load_config())
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ck, log, npz = (str(tmp_path / x) for x in ("ck", "log", "w.npz"))
    model, state = T.main(["--synthetic", "1", "--epochs", "1",
                           "--steps-per-epoch", "1", "--ckpt-dir", ck,
                           "--log-dir", log, "--export-npz", npz,
                           "--export-every", "1", "--device", "cpu"])
    cache = [d for d in os.listdir(tmp_path)
             if d.startswith("tdvnet_torch_synth_")]
    assert cache == ["tdvnet_torch_synth_1x16x64x80"]
    assert sorted(os.listdir(tmp_path / cache[0])) == [
        "s000", "val000", "val001", "val002", "val003"]
    with open(os.path.join(log, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(train) == 1 and np.isfinite(train[0])
    assert any("val/loss" in r for r in recs)
    assert C.latest_epoch(ck) == 1
    variables, ep = load_npz(npz)
    assert ep == 1
    want = _leaves(to_flax_variables(model))
    got = _leaves(variables)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k].astype(np.float16)
                              .astype(np.float32)) for k in got)


@pytest.fixture(scope="module")
def synthetic_cache(tmp_path_factory):
    """One temporary directory for the knob cases' `--synthetic 1` cache
    (the dataset is written once, by the first case)."""
    return str(tmp_path_factory.mktemp("synth_cache"))


@pytest.mark.parametrize("flags", [["--bf16"], ["--remat"],
                                   ["--grad-accum", "2"]])
def test_train_cli_refuses_before_any_data(flags, tmp_path, monkeypatch,
                                           synthetic_cache):
    """Each training knob of the CLI at the tiny config on the CPU (the
    port refused them before it had them): one epoch of one step, a finite
    loss, the checkpoint. `--bf16` trains a bf16 model whose parameters
    stay fp32, `--remat` updates, and `--grad-accum 2` takes its first
    microstep without an update."""
    from tdvnet_torch.tools import train_3dvnet as T
    from tdvnet_torch.train import checkpoints as C

    monkeypatch.setattr(T, "load_config", _tiny_load_config())
    monkeypatch.setattr(tempfile, "tempdir", synthetic_cache)
    ck, log = str(tmp_path / "ck"), str(tmp_path / "log")
    model, state = T.main(["--synthetic", "1", "--epochs", "1",
                           "--steps-per-epoch", "1", "--ckpt-dir", ck,
                           "--log-dir", log, "--device", "cpu"] + flags)
    with open(os.path.join(log, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(train) >= 1 and np.isfinite(train).all()
    assert C.latest_epoch(ck) == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.cfg.dtype == (torch.bfloat16 if "--bf16" in flags
                               else torch.float32)
    k = 2 if "--grad-accum" in flags else 1
    assert state.optimizer.accum_steps == k
    assert (state.optimizer.count, state.optimizer.mini_step) == \
        ((1, 0) if k == 1 else (0, 1))


# --------------------------------------------------------------- evaluation
@pytest.fixture(scope="module")
def eval_dataset(tmp_path_factory, tiny_checkpoint):
    """One 8-view synthetic scene at 60x80 and the tiny model's weights as
    an `.npz`."""
    from tdvnet_torch.data.synthetic_dataset import make_scene_dir
    from tdvnet_torch.tools import export_weights as E

    root = tmp_path_factory.mktemp("evaldata")
    make_scene_dir(str(root / "data"), "synth_0003", 8, HW, 3, "cpu")
    npz = str(root / "w.npz")
    E.main(["--ckpt-dir", tiny_checkpoint[2], "--out", npz])
    return str(root / "data"), npz


def _direct_eval(cfg, npz, save_dir, name, pred_fn=None):
    """`harness.main` called directly with the model of `npz`."""
    from tdvnet_torch.eval import harness
    from tdvnet_torch.weights import load_threedvnet

    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, save_dir=save_dir))
    if pred_fn is None:
        pred_fn = harness.make_3dvnet_pred_fn(
            load_threedvnet(npz, cfg.model, device="cpu"), cfg)
    return harness.main(name, pred_fn, cfg, depth=True, device="cpu")


def test_eval_cli_matches_the_harness(eval_dataset, tmp_path, monkeypatch):
    """`eval_3dvnet` from the `.npz` on the synthetic scene, with the grid
    and anchors from its flags: the averaged metrics of a direct
    `harness.main` call with the same model and config, every file."""
    from tdvnet_torch.tools import eval_3dvnet as EV

    data, npz = eval_dataset
    load = _tiny_load_config(**EVAL)
    monkeypatch.setattr(EV, "load_config", load)
    got = EV.main(["--ckpt-dir", npz, "--dataset", f"synthetic:{data}",
                   "--save-dir", str(tmp_path / "cli"), "--eval-grid",
                   "16", "16", "16", "--max-anchors", "2048",
                   "--device", "cpu"])
    cfg = load({"eval": {"dataset_type": f"synthetic:{data}"}})
    want = _direct_eval(cfg, npz, str(tmp_path / "direct"), "3dvnet")
    assert set(got) == {"metrics_2d.json",
                        "metrics_3d_0.010_3v_masked.json"}
    assert got == want
    assert np.isfinite(got["metrics_2d.json"]["abs_rel"])


def test_eval_cli_bf16_matches_the_harness(eval_dataset, tmp_path,
                                           monkeypatch):
    """`eval_3dvnet --bf16` (the parity path in bf16, parameters fp32): the
    averaged metrics of a direct `harness.main` call with a bf16 model of
    the same weights, and finite."""
    from tdvnet_torch.tools import eval_3dvnet as EV

    data, npz = eval_dataset
    load = _tiny_load_config(**EVAL)
    monkeypatch.setattr(EV, "load_config", load)
    got = EV.main(["--ckpt-dir", npz, "--dataset", f"synthetic:{data}",
                   "--save-dir", str(tmp_path / "cli"), "--eval-grid",
                   "16", "16", "16", "--max-anchors", "2048", "--bf16",
                   "--device", "cpu"])
    cfg = load({"eval": {"dataset_type": f"synthetic:{data}"}})
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=torch.bfloat16))
    want = _direct_eval(cfg, npz, str(tmp_path / "direct"), "3dvnet")
    assert got == want
    assert all(np.isfinite(v) for m in got.values() for v in m.values())


@pytest.mark.parametrize("flags,item", [(["--bf16", "--fast-path"],
                                         "item 2c"),
                                        (["--dp"], "item 5"),
                                        (["--space-shard"], "item 5")])
def test_eval_cli_refuses_before_reading_a_checkpoint(flags, item, tmp_path):
    from tdvnet_torch.tools import eval_3dvnet as EV

    with pytest.raises(NotImplementedError, match=item):
        EV.main(["--ckpt-dir", str(tmp_path / "none"), "--device", "cpu"]
                + flags)


def test_synthetic_eval_cli_matches_the_harness(tmp_path):
    """`run_synthetic_eval` (GT passthrough, one 8-view scene at 60x80
    written into the work directory) prints the averaged metrics of a
    direct `harness.main` call over that scene with its config."""
    from tdvnet_torch.config import load_config
    from tdvnet_torch.tools import run_synthetic_eval as R

    work = str(tmp_path / "work")
    got = R.main(["--workdir", work, "--views", "8", "--hw", "60", "80",
                  "--seed-base", "3", "--device", "cpu"])
    cfg = load_config({"batch": {"img_size": HW}, "eval": {
        "depth_img_size": HW, "pdist": 0.05, "n_src_on_either_side": 2,
        "eval_grid_size": (64, 64, 48), "eval_max_anchors": 65536,
        "dataset_type": f"synthetic:{work}/data"}})

    def passthrough(views, scene_dir, dset):
        return views["depth"][dset.k:-dset.k]

    want = _direct_eval(cfg, None, str(tmp_path / "direct"),
                        "gt_passthrough", passthrough)
    assert set(got) == {"metrics_2d.json",
                        "metrics_3d_0.010_3v_masked.json"}
    assert got == want
    assert got["metrics_2d.json"]["abs_rel"] < 1e-3


def test_synthetic_eval_cli_runs_the_flagship(eval_dataset, tmp_path,
                                              monkeypatch):
    """With `--ckpt-dir`: the tiny model of the `.npz` (the tiny config in
    place of the full-width one) over the written scene, the metrics of a
    direct `harness.main` call."""
    from tdvnet_torch.tools import run_synthetic_eval as R

    _, npz = eval_dataset
    load = _tiny_load_config(**EVAL)
    monkeypatch.setattr(R, "load_config", load)
    work = str(tmp_path / "work")
    got = R.main(["--workdir", work, "--views", "8", "--hw", "60", "80",
                  "--seed-base", "3", "--ckpt-dir", npz, "--device", "cpu"])
    cfg = load({"eval": {"dataset_type": f"synthetic:{work}/data"}})
    assert got == _direct_eval(cfg, npz, str(tmp_path / "direct"), "3dvnet")
