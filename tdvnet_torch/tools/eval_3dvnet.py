"""Whole-scene evaluation entry (the port of `tools/eval_3dvnet.py`;
reference `mv3d/eval-3dvnet.py`): the flagship from a checkpoint directory
or an exported `.npz` (the JAX package's exports included) through
`eval/harness.main`, depth and 3D metrics, on the CUDA card unless
`--device` names another.

    python -m tdvnet_torch.tools.eval_3dvnet --ckpt-dir ckpts/3dvnet \\
        --dataset scannet --scannet-dir /data/scannet
    python -m tdvnet_torch.tools.eval_3dvnet --ckpt-dir w.npz \\
        --dataset synthetic:/tmp/synth --save-dir eval_results

`--bf16` computes in bf16 with fp32 parameters (`ModelConfig.dtype`), as
the JAX tool's flag does, on the parity path; `--bf16 --fast-path`
(ROADMAP.md queue 1 item 2c) and `--dp` / `--space-shard` (item 5) raise
before any checkpoint is read: the port has neither yet.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from tdvnet_torch.config import (check_bf16_fast_path, load_config,
                                 resolve_device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--dataset", default="scannet")
    ap.add_argument("--scannet-dir", default=None)
    ap.add_argument("--icl-dir", default=None)
    ap.add_argument("--tum-dir", default=None)
    ap.add_argument("--save-dir", default="eval_results")
    ap.add_argument("--name", default="3dvnet")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--eval-grid", type=int, nargs=3, default=None,
                    help="scene grid cells (x y z), default from config")
    ap.add_argument("--max-anchors", type=int, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (params stay fp32)")
    ap.add_argument("--fast-path", action="store_true",
                    help="validated fast path: int8 scene tables + "
                         "adaptive iter-2 offsets (cfg.eval.fast_path)")
    ap.add_argument("--fast-rank", type=int, default=None,
                    help="fast-path rank-r sampling-interface projection "
                         "(0 = off; default: EvalConfig.fast_rank = 96)")
    ap.add_argument("--fast-patch", type=int, choices=(0, 1), default=None,
                    help="fast-path patch-fan image variance (default: "
                         "EvalConfig.fast_patch = on)")
    ap.add_argument("--dp", action="store_true",
                    help="DP-over-scenes fused eval over all local devices")
    ap.add_argument("--space-shard", action="store_true",
                    help="spatially-sharded scene volumes over all local "
                         "devices for scenes too big for one device")
    ap.add_argument("--device", default=None,
                    help="where to evaluate (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain twins)")
    args = ap.parse_args(argv)
    if args.dp or args.space_shard:
        raise NotImplementedError(
            "--dp / --space-shard: the port evaluates on one device so far "
            "(ROADMAP.md queue 1 item 5, parallelism)")
    device = resolve_device(args.device)

    from tdvnet_torch.eval.harness import main as harness_main
    from tdvnet_torch.eval.harness import make_3dvnet_pred_fn
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import checkpoints as C
    from tdvnet_torch.weights import load_flax_into

    overrides = {"eval": {"dataset_type": args.dataset,
                          "save_dir": args.save_dir,
                          "fast_path": args.fast_path,
                          **({"fast_rank": args.fast_rank}
                             if args.fast_rank is not None else {}),
                          **({"fast_patch": bool(args.fast_patch)}
                             if args.fast_patch is not None else {})}}
    if args.eval_grid:
        overrides["eval"]["eval_grid_size"] = tuple(args.eval_grid)
    if args.max_anchors:
        overrides["eval"]["eval_max_anchors"] = args.max_anchors
    data_over = {}
    if args.scannet_dir:
        data_over["scannet_dir"] = args.scannet_dir
    if args.icl_dir:
        data_over["icl_nuim_dir"] = args.icl_dir
    if args.tum_dir:
        data_over["tum_rgbd_dir"] = args.tum_dir
    if data_over:
        overrides["data"] = data_over
    cfg = load_config(overrides)
    if args.bf16:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype=torch.bfloat16))
    check_bf16_fast_path(cfg.model, cfg.eval.fast_path)

    # params-only restore: whatever optimizer the training run used
    restored = C.restore_params(args.ckpt_dir)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
    raw, epoch = restored
    model = ThreeDVNet(cfg.model)
    load_flax_into(model, {"params": raw["params"],
                           "batch_stats": raw.get("batch_stats", {})})
    model = model.to(device).eval()
    print(f"restored epoch {epoch} from {args.ckpt_dir}")
    pred_fn = make_3dvnet_pred_fn(model, cfg)
    return harness_main(args.name, pred_fn, cfg, depth=True,
                        overwrite=args.overwrite, device=device)


if __name__ == "__main__":
    main()
