"""Profile K3's dense scatter (`scatter_anchors_to_dense`) against one
PyTorch call for the same function, `torch.zeros(...).index_put_(...)`, at
`chip_smoke.py`'s two shapes: `infer_depth`'s and a whole scene's.

    python -m tdvnet_torch.tools.profile_scatter [--reps 3]

Run from the repository's root (it builds its inputs with
`chip_smoke.scene_model_cases`). Per shape and repetition, kernel and
library alternating: the mean CUDA-event ms of 10 back-to-back calls
(`timing.time_ms`) and the host's wall microseconds a call over 50 calls
(no synchronisation inside the loop, so where the card keeps up this is
the host path); then the device microseconds a call that `torch.profiler`
traces over 20 calls. A call whose host path is longer than its device
time is host-bound, and its event time reads the host. Prints one JSON
line per shape.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def host_us(fn, n: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def device_us(fn, n: int = 20) -> float:
    """Device microseconds a call: the kernels' traced durations summed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type.name == "CUDA") / n


def scatter_cases(device):
    """`chip_smoke.py`'s two scatter cases (its `Case` objects)."""
    import chip_smoke as cs
    from tdvnet_torch.config import EvalConfig, ModelConfig

    cfg = ModelConfig()
    g, dc = cfg.grid, cfg.depth_test
    gen = torch.Generator().manual_seed(0)
    unet = (cfg.unet_dims, cfg.unet_groups, cfg.unet_res)
    b = cs.golden_batch(cs.GOLDEN_SEEDS)
    R, B = b.src_idx.shape[0], b.n_scenes
    P_ref = dc.size[0] * dc.size[1]
    ev, rec = EvalConfig(), cs.scene_golden_record()
    n_refs = cs.STREAM_VIEWS - 2 * ev.n_src_on_either_side
    n_slots = -(-n_refs // ev.fused_chunk) * ev.fused_chunk
    cases = cs.scene_model_cases(device, gen, "infer_depth", "infer_depth",
                                 R * P_ref, B, g.grid_size, g.max_anchors,
                                 unet)
    cases += cs.scene_model_cases(device, gen, "scene", "scene",
                                  n_slots * P_ref, 1,
                                  tuple(rec["grid_size"]),
                                  ev.eval_max_anchors, unet)
    return [c for c in cases if c.label.startswith("scatter")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scatter: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from tdvnet_torch.tools.timing import time_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for case in scatter_cases(torch.device("cuda")):
        fns = {"kernel": case.run, "library": case.library}
        reps = []
        for rep in range(args.reps):
            names = ("kernel", "library") if rep % 2 == 0 else (
                "library", "kernel")
            reps.append({k: {"event_ms": time_ms(fns[k]),
                             "host_us": host_us(fns[k])} for k in names})
        print(json.dumps({
            "case": case.label, "card": card,
            "bound_ms": case.bound_ms, "reps": reps,
            "device_us": {k: device_us(f) for k, f in fns.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
