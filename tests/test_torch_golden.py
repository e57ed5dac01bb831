"""JAX golden for the port's full-width depth inference.

The card that runs `chip_smoke.py` has no JAX, so the full-width path of
`tdvnet_torch` is held there against arrays that the JAX package computed
here on the CPU: `ThreeDVNet.infer_depth` with the exact gather warp, the
synth48 weights, the default `BatchConfig` (2 scenes x 9 views, 7 refs each)
on synthetic scenes, at the parity offsets.

Regenerate (several minutes on the CPU, a few GB of memory):

    python tests/test_torch_golden.py --write

The tier-1 test below only checks that the recorded settings are the ones
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
WEIGHTS = os.path.join(ROOT, "weights", "3dvnet_synth48.npz")


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


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --write")
    write_golden()
