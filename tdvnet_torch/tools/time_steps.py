"""Time the port's two hot entry points on the card, for comparing trees.

    python -m tdvnet_torch.tools.time_steps [--batches 8] [--steps 6]

From the synth48 weights (`weights/3dvnet_synth48.npz`) and the synthetic
golden batch of `chip_smoke.py` (two scenes x 9 views, 7 refs each):
`infer_depth` at the chip_smoke offsets, then warm train steps at n_iters
0, 1 and 2 (the non-finetune regime, lambda 0.5), each timed on the host
clock to a synchronise after two warm-up calls. Prints one JSON line with
every time and the medians. To compare two trees in one call, run it from
each tree's root with that root first on the path, alternating:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_steps.py)
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

OFFSETS = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))


def _batch(seeds):
    from tdvnet_torch.config import BatchConfig
    from tdvnet_torch.data import batch as B, synthetic

    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(
        bc.n_views, bc.img_size, bc.depth_img_size, seed=s,
        n_src_on_either_side=bc.n_src_on_either_side) for s in seeds]
    return B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                            bc.n_src_on_either_side)


def _times(fn, n, warm=2):
    for _ in range(warm):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def run(root: str, batches: int, steps: int):
    from tdvnet_torch.config import Config
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    weights = os.path.join(root, "weights", "3dvnet_synth48.npz")
    device = torch.device("cuda")
    batch = _batch((0, 1)).to(device)
    rec = {"root": os.path.abspath(root)}
    model = load_threedvnet(weights, device=device)
    with torch.no_grad():
        rec["infer_ms"] = _times(lambda: model.infer_depth(batch, OFFSETS),
                                 batches)
    cfg = Config()
    for n_iters in (0, 1, 2):
        model = load_threedvnet(weights, device=device)
        state = L.TrainState(model, L.make_optimizer(cfg, model, 1))
        step = L.make_train_step(model, cfg, n_iters)
        rec[f"train{n_iters}_ms"] = _times(
            lambda: step(state, batch, 0.5), steps)
        del model, state, step
        torch.cuda.empty_cache()
    rec["medians"] = {k: statistics.median(v) for k, v in rec.items()
                      if k.endswith("_ms")}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_steps: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    import tdvnet_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tdvnet_torch.__file__)))
    rec = run(root, args.batches, args.steps)
    rec["card"] = card
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
