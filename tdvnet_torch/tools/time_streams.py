"""Time whole-scene inference on the card, parity and fast path, for
comparing trees.

    python -m tdvnet_torch.tools.time_streams [--rounds 3]

From the synth48 weights (`weights/3dvnet_synth48.npz`): the stream of
`chip_smoke.py`'s phases 6b and 7b (three synthetic scenes of 52 views at
256x320, seeds 7-9, through `FusedSceneInference.predict_scenes`), each
scene timed on the host clock from the result before it, `--rounds`
times on each path after one warm-up scene. Prints one JSON line: the
card, and per path every round's seconds per scene. To compare two trees
in one call, run it from each tree's root with that root first on the
path, alternating:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_streams.py)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

OFFSETS = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
SEEDS = (7, 8, 9)
N_VIEWS = 52


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_streams: no CUDA device")
    import tdvnet_torch
    from tdvnet_torch.config import Config, ModelConfig
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.weights import load_threedvnet

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tdvnet_torch.__file__)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    model = load_threedvnet(os.path.join(root, "weights",
                                         "3dvnet_synth48.npz"),
                            device=torch.device("cuda"))
    scenes = [synthetic.make_scene(n_views=N_VIEWS,
                                   img_size=ModelConfig().img_size, seed=s)
              for s in SEEDS]
    cfg = Config()
    fast = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, fast_path=True))
    rec = {"root": root, "card": card}
    for name, inf in (("parity", FusedSceneInference(
            model, cfg, offsets_list=OFFSETS, fetch_mm=True)),
                      ("fast", FusedSceneInference(model, fast,
                                                   fetch_mm=True))):
        inf.predict_scene(scenes[0])                 # warm-up
        rounds = []
        for _ in range(args.rounds):
            torch.cuda.synchronize()
            secs = []
            t0 = time.perf_counter()
            for _ in inf.predict_scenes(iter(scenes)):
                now = time.perf_counter()
                secs.append(now - t0)
                t0 = now
            rounds.append(secs)
        rec[name] = {"rounds": rounds,
                     "s_per_scene": [sum(r) / len(r) for r in rounds]}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
