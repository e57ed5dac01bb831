"""Time the scene sampling's grid backward (`trilinear_sample_backward`) on
the card at the three scales of the full-width n_iters=1 train step, on two
point sets, for comparing trees.

    python -m tdvnet_torch.tools.time_k6_backward [--iters 20]

The point sets: "synthetic", an offset pass's hypotheses uniform over each
scene's grid and a margin of 0.3 m around it (the distribution of
`chip_smoke.py`'s backward case), and "real", the hypotheses and incoming
gradients of one offset pass of the golden batch's n_iters=1 step from the
synth48 weights, recorded as they reach the backward
(`capture_sampling_backward`). Prints one JSON line: per point set and
scale the kernel's mean ms over `--iters` calls (CUDA events) and its byte
bound (inputs read once, the grid written once, at 3.35 TB/s), and their
sums over the three scales of one pass. To compare two trees in one call,
run it from each tree's root with that root first on the path,
alternating:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_k6_backward.py)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S


def capture_sampling_backward(weights: str, device, lam: float = 0.5):
    """One n_iters=1 train step from `weights` on the golden batch, with
    `TrilinearSampleFn.backward` (`tdvnet_torch.kernels.trilinear`) wrapped
    to record the arguments that reach it, and put back afterwards. Returns
    one offset pass's calls, the finest scale first:
    [(grad, pts, center0, cell, grid_shape)] on the card."""
    from tdvnet_torch.config import Config
    from tdvnet_torch.kernels import trilinear as T
    from tdvnet_torch.tools.time_steps import _batch
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    backward = T.TrilinearSampleFn.backward
    calls = []

    def record(ctx, grad):
        pts, center0 = ctx.saved_tensors
        calls.append((grad.contiguous().clone(), pts, center0, ctx.cell,
                      tuple(ctx.grid_shape)))
        return backward(ctx, grad)

    cfg = Config()
    batch = _batch((0, 1)).to(device)
    model = load_threedvnet(weights, device=device)
    state = L.TrainState(model, L.make_optimizer(cfg, model, 1))
    step = L.make_train_step(model, cfg, 1)
    T.TrilinearSampleFn.backward = staticmethod(record)
    try:
        step(state, batch, lam)
        torch.cuda.synchronize()
    finally:
        T.TrilinearSampleFn.backward = staticmethod(backward)
    del state, model, step
    # the three scales of one pass share its points
    passes = {}
    for c in calls:
        passes.setdefault(c[1].data_ptr(), []).append(c)
    one = next(v for v in passes.values() if len(v) == 3)
    one.sort(key=lambda c: -c[4][1])
    return [(g, p.clone(), c0.clone(), cell, shape)
            for g, p, c0, cell, shape in one]


def uniform_points(origins, extent: float, Q: int, gen):
    """[B, Q, 3] points uniform over each scene's grid (`origins` [B, 3] its
    low corner, `extent` its side in metres) and 0.3 m around it: the
    uniform point set of the backward's timings."""
    u = torch.rand(origins.shape[0], Q, 3, generator=gen).to(origins.device)
    return (origins[:, None, :] - 0.3 + u * (extent + 0.6)).contiguous()


def backward_bytes(grad, pts, shape) -> int:
    """The backward's byte bound: the incoming gradient, the points and the
    scenes' centres read once, the grid gradient `shape` written once."""
    B, X, Y, Z, C = shape
    return 4 * (grad.numel() + pts.numel() + 3 * B + B * X * Y * Z * C)


def synthetic_calls(real, seed: int = 0):
    """The same shapes as `real`, with one set of hypotheses for the three
    scales (`uniform_points`), and normal incoming gradients."""
    gen = torch.Generator().manual_seed(seed)
    grad, pts, c0, cell, shape = real[0]          # the finest scale
    p = uniform_points(c0 - 0.5 * cell, shape[1] * cell, pts.shape[1], gen)
    return [(torch.randn(g.shape, generator=gen).to(g.device), p, c, s, sh)
            for g, _, c, s, sh in real]


def time_calls(calls, iters: int):
    from tdvnet_torch.kernels.trilinear import trilinear_sample_backward as fn
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for args in calls:
        label = f"{args[4][1]}^3 x {args[4][4]}"
        rec[label] = {
            "ms": time_ms(lambda a=args: fn(*a), iters=iters, warmup=3),
            "bound_ms": 1e3 * backward_bytes(args[0], args[1], args[4])
            / HBM_BYTES_PER_S}
    rec["pass"] = {k: sum(v[k] for v in list(rec.values()))
                   for k in ("ms", "bound_ms")}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k6_backward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    import tdvnet_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tdvnet_torch.__file__)))
    device = torch.device("cuda")
    real = capture_sampling_backward(
        os.path.join(root, "weights", "3dvnet_synth48.npz"), device)
    torch.cuda.empty_cache()
    rec = {"root": root, "card": card,
           "synthetic": time_calls(synthetic_calls(real), args.iters),
           "real": time_calls(real, args.iters)}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
