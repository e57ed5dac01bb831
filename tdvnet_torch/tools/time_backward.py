"""Time the four order-free backward kernels on the card, with a digest of
every output, for comparing trees: K1/K2's `source_variance_backward`,
K6's `trilinear_sample_backward`, K4's concat-back
`gather_concat_backward` and K5's `masked_group_norm_backward`.

    python -m tdvnet_torch.tools.time_backward [--iters 20]

"captured": the first call of each shape that one full-width n_iters=1
train step of the golden batch (synth48 weights, lambda 0.5) makes to each
wrapper, recorded as it reaches the wrapper (`capture_backward`).
"synthetic": the same calls with the incoming gradient replaced by seeded
normal values (the captured ones are ~1e-9..1e-6). Per case: the mean ms
over `--iters` calls (CUDA events), the host microseconds of one call
(the wrapper's path up to the launch, no synchronise), the byte bound
(inputs read once, outputs written once, at 3.35 TB/s), a sha256 digest of
the outputs, and whether a second launch gave the same bits. The last line
is one JSON object. Run it from each tree's root with that root first on
the path, alternating, to read bit-equality and speed in one call:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_backward.py)
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import time

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S

# (module under tdvnet_torch.kernels, wrapper) of each timed kernel
WRAPPERS = (("variance", "source_variance_backward"),
            ("trilinear", "trilinear_sample_backward"),
            ("segmax", "gather_concat_backward"),
            ("groupnorm", "masked_group_norm_backward"))


def digest(out) -> str:
    """sha256 over the bytes of a tensor or of the tensors of a tuple (None
    skipped)."""
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _shape_key(name, args):
    dims = [tuple(a.shape) for a in args if torch.is_tensor(a)][:2]
    extra = [a for a in args if isinstance(a, (bool, int)) and not
             torch.is_tensor(a)]
    return f"{name}{dims}{extra}"


@contextlib.contextmanager
def capture_backward(calls):
    """Within the block, every call of the four wrappers (through their
    module, as the autograd Functions call them) is recorded into `calls`
    {key: (name, args, kwargs)}, the first of each shape, its tensors
    cloned; the wrappers are put back after it."""
    import importlib

    saved = []
    for mod_name, name in WRAPPERS:
        mod = importlib.import_module(f"tdvnet_torch.kernels.{mod_name}")
        fn = getattr(mod, name)

        def record(*args, _fn=fn, _name=name, **kwargs):
            key = _shape_key(_name, args)
            if key not in calls:
                keep = lambda a: a.detach().clone() if torch.is_tensor(a) \
                    else a
                calls[key] = (_name, tuple(keep(a) for a in args),
                              {k: keep(v) for k, v in kwargs.items()})
            return _fn(*args, **kwargs)

        record.launches = fn.launches
        saved.append((mod, name, fn))
        setattr(mod, name, record)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def captured_calls(weights: str, device, lam: float = 0.5):
    """The first call of each shape of the four wrappers in one n_iters=1
    train step from `weights` on the golden batch."""
    from tdvnet_torch.config import Config
    from tdvnet_torch.tools.time_steps import _batch
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    cfg = Config()
    batch = _batch((0, 1)).to(device)
    model = load_threedvnet(weights, device=device)
    state = L.TrainState(model, L.make_optimizer(cfg, model, 1))
    step = L.make_train_step(model, cfg, 1)
    calls = {}
    with capture_backward(calls):
        step(state, batch, lam)
        if device.type == "cuda":
            torch.cuda.synchronize()
    del state, model, step
    return calls


def synthetic_like(calls, seed: int = 0):
    """The same calls with the incoming gradient (each wrapper's first
    argument) replaced by seeded normal values of its shape."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, (name, args, kwargs) in calls.items():
        g = torch.randn(args[0].shape, generator=gen).to(args[0].device)
        out[key] = (name, (g,) + tuple(args[1:]), kwargs)
    return out


def call_bytes(name, args) -> int:
    """The byte bound of one call: its inputs read once, its outputs
    written once."""
    n = lambda t: t.numel() * t.element_size()
    if name == "source_variance_backward":
        grad, mean, pts, feats, src_idx, src_mask, P_all = args[:7]
        return (n(grad) + n(mean) + n(pts) + 2 * n(feats) + n(src_idx)
                + 4 * src_mask.numel() + n(P_all))
    if name == "trilinear_sample_backward":
        grad, pts, center0, _, shape = args[:5]
        B, X, Y, Z, C = shape
        return n(grad) + n(pts) + n(center0) + 4 * B * X * Y * Z * C
    if name == "gather_concat_backward":
        grad, y, pooled, seg = args[:4]
        return n(grad) + 2 * n(y) + 2 * n(pooled) + n(seg)
    if name == "masked_group_norm_backward":
        grad, x, mask, _, weight, out = args[:6]
        skip = bool(args[9]) if len(args) > 9 else False
        return (n(grad) + n(x) + n(out) + n(mask) + 3 * n(weight)
                + n(x) * (2 if skip else 1))
    raise KeyError(name)


def time_calls(named, iters: int):
    import importlib

    from tdvnet_torch.tools.timing import time_ms

    fns = {name: getattr(importlib.import_module(
        f"tdvnet_torch.kernels.{mod}"), name) for mod, name in WRAPPERS}
    rec = {}
    for key, (name, args, kwargs) in named.items():
        run = lambda f=fns[name], a=args, kw=kwargs: f(*a, **kw)
        ms = time_ms(run, iters=iters, warmup=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        host_us = 1e6 * (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
        a, b = run(), run()
        same = digest(a) == digest(b)
        rec[key] = {"kernel": name, "ms": ms, "host_us": host_us,
                    "bound_ms": 1e3 * call_bytes(name, args)
                    / HBM_BYTES_PER_S,
                    "digest": digest(a), "repeats": same}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_backward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    import tdvnet_torch
    from tdvnet_torch.config import set_fp32_numerics
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tdvnet_torch.__file__)))
    device = torch.device("cuda")
    set_fp32_numerics()
    calls = captured_calls(
        os.path.join(root, "weights", "3dvnet_synth48.npz"), device)
    torch.cuda.empty_cache()
    rec = {"root": root, "card": card,
           "synthetic": time_calls(synthetic_like(calls), args.iters),
           "captured": time_calls(calls, args.iters)}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
