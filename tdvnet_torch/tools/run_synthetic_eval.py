"""One-command synthetic end-to-end evaluation (the port of
`tools/run_synthetic_eval.py`).

Writes a synthetic `info.json` scene set into `--workdir/data`, runs a
method through the whole evaluation harness (the GT-depth passthrough by
default, or the flagship from `--ckpt-dir`, a checkpoint directory or an
`.npz`) and prints the averaged metrics as JSON: the quickest way to see
the data, prediction, fusion and metrics pipeline work without real data.
Scenes that exist are reused.

    python -m tdvnet_torch.tools.run_synthetic_eval --workdir /tmp/se
    python -m tdvnet_torch.tools.run_synthetic_eval --workdir /tmp/se \\
        --ckpt-dir weights/3dvnet_synth48.npz

`--bf16` runs the flagship in bf16 with fp32 parameters, as
`eval_3dvnet --bf16` does (the JAX tool has no such flag); with
`--fast-path` it raises before any work (ROADMAP.md queue 1 item 2c).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from tdvnet_torch.config import (check_bf16_fast_path, load_config,
                                 resolve_device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--hw", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--ckpt-dir", default=None,
                    help="evaluate the flagship from this checkpoint "
                         "instead of GT passthrough")
    ap.add_argument("--eval-grid", type=int, nargs=3, default=(64, 64, 48))
    ap.add_argument("--seed-base", type=int, default=0,
                    help="scene seed offset (training caches use seeds "
                         "0..N-1; pick >=100 for unseen eval scenes)")
    ap.add_argument("--fast-path", action="store_true",
                    help="validated fast path: int8 scene tables + "
                         "adaptive iter-2 offsets")
    ap.add_argument("--fast-rank", type=int, default=None,
                    help="fast-path rank-r sampling-interface projection "
                         "(0 = off; default: EvalConfig.fast_rank = 96)")
    ap.add_argument("--fast-patch", type=int, choices=(0, 1), default=None,
                    help="fast-path patch-fan image variance (default: "
                         "EvalConfig.fast_patch = on)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute of the flagship (params stay "
                         "fp32)")
    ap.add_argument("--name", default=None,
                    help="results dirname (default: 3dvnet / "
                         "3dvnet_fast / gt_passthrough)")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain twins)")
    args = ap.parse_args(argv)
    if args.bf16:
        check_bf16_fast_path(load_config({"model": {
            "dtype": torch.bfloat16}}).model, args.fast_path)
    device = resolve_device(args.device)

    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir
    from tdvnet_torch.eval import harness

    data_dir = os.path.join(args.workdir, "data")
    os.makedirs(data_dir, exist_ok=True)
    scenes = [ensure_scene_dir(data_dir, f"synth_{seed:04d}", args.views,
                               tuple(args.hw), seed, device)
              for seed in range(args.seed_base, args.seed_base + args.scenes)]

    cfg = load_config({
        "batch": {"img_size": (256, 320) if args.ckpt_dir
                  else tuple(args.hw)},
        "eval": {"save_dir": os.path.join(args.workdir, "results"),
                 "depth_img_size": tuple(args.hw),
                 "pdist": 0.05, "n_src_on_either_side": 2,
                 "eval_grid_size": tuple(args.eval_grid),
                 "eval_max_anchors": 65536,
                 "fast_path": args.fast_path,
                 **({"fast_rank": args.fast_rank}
                    if args.fast_rank is not None else {}),
                 **({"fast_patch": bool(args.fast_patch)}
                    if args.fast_patch is not None else {})},
    })

    if args.bf16:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype=torch.bfloat16))
    if args.ckpt_dir:
        from tdvnet_torch.models.threedvnet import ThreeDVNet
        from tdvnet_torch.train import checkpoints as C
        from tdvnet_torch.weights import load_flax_into

        # params-only restore: any optimizer config, and the .npz form
        restored = C.restore_params(args.ckpt_dir)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
        raw, ep = restored
        model = ThreeDVNet(cfg.model)
        load_flax_into(model, {"params": raw["params"],
                               "batch_stats": raw["batch_stats"]})
        model = model.to(device).eval()
        print(f"restored epoch {ep} (params-only)")
        pred_fn = harness.make_3dvnet_pred_fn(model, cfg)
        name = "3dvnet_fast" if args.fast_path else "3dvnet"
    else:
        def pred_fn(views, scene_dir, dset):
            k = dset.k
            return views["depth"][k:-k]

        name = "gt_passthrough"

    avg = harness.main(args.name or name, pred_fn, cfg, depth=True,
                       scenes=scenes, device=device)
    print(json.dumps(avg, indent=2))
    return avg


if __name__ == "__main__":
    main()
