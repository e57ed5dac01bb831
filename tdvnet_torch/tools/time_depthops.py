"""Time K8b's forward (`softargmax_depth`) and backward
(`softargmax_depth_backward`) and K8a's backward
(`propagation_blend_backward`) on the card at their main-path inputs and at
their edge inputs, with a digest of every output, for comparing trees.

    python -m tdvnet_torch.tools.time_depthops [--iters 50] [--profile]

Main-path inputs: K8b's two calls of `chip_smoke.kernel_cases` (the
`infer_depth` call [14, 96, 56, 56] and a whole-scene chunk's [16, 96, 56,
56], seeded costs x3), K8b's backward at the train step's call of
`chip_smoke.train_cases` ([14, 96, 56, 56]: seeded costs x3 and incoming
gradients, the twin's depths) and K8a's backward at its three calls there
([14, h, w] for (h, w) = (64, 80), (128, 160), (256, 320): seeded logits
as a permuted NCHW view, depths and incoming gradients, the twin's
output). Edge inputs: `tests/_kernel_edge_cases.py` (`softargmax_case`,
the backward's depths the twin's, and `blend_case`) of the tree this file
lies in, so that two trees time the same inputs. Past the register
form's planes: K8b forward and backward at [14, D, 56, 56] for D = 392 and
768 (`plane_inputs`: seeded costs x3, incoming gradients, the twin's
depths), which the any-D form takes (it reads the volume twice forward,
three times backward; a tree without that form raises there).

Per case: the wrapper's mean ms over `--iters` calls (CUDA events; K8b's
under `torch.no_grad()`, as inference calls it), the bound as
`chip_smoke.py` reckons it (K8b: the volume, the plane depths and the
output moved once, 5 flops a cost element; its backward: the volume read
and its gradient written once, the plane depths, incoming gradients and
depths read once, 8 flops a cost element; K8a's backward: 22 floats a
pixel moved once, 90 flops a pixel; bytes at 3.35 TB/s, flops at 67
TFLOP/s, the larger), and a sha256 digest of every output. K8a's
main-path cases add the host microseconds of one `torch.empty` of the
[N, 9, H, W] fp32 scratch that a two-pass backward allocates.
`--profile` adds device us per kernel (torch.profiler). The last line is
one JSON object. Run it from each tree's root with that root first on the
path, alternating, to read bit-equality and speed in one call:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_depthops.py)
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S

FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
SOFTARGMAX_FLOPS = 5         # a cost element
SOFTARGMAX_BACKWARD_FLOPS = 8   # a cost element
BLEND_BACKWARD_FLOPS = 90    # a pixel
BLEND_BACKWARD_FLOATS = 22   # a pixel: 9 logits, depth, out, grad; 9 + 1


def digest(out) -> str:
    """sha256 over the bytes of a tensor or of the tensors of a tuple, each
    made contiguous first."""
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def softargmax_cost(cost: torch.Tensor) -> tuple:
    """(bytes, flops) of one soft-argmax call over cost [R, D, h, w]."""
    R, D, h, w = cost.shape
    return 4 * (cost.numel() + D + R * h * w), SOFTARGMAX_FLOPS * cost.numel()


def softargmax_backward_cost(cost: torch.Tensor) -> tuple:
    """(bytes, flops) of one soft-argmax backward over cost [R, D, h, w]:
    the volume read and its gradient written, the plane depths, the
    incoming gradients and the depths read."""
    R, D, h, w = cost.shape
    return (4 * (2 * cost.numel() + D + 2 * R * h * w),
            SOFTARGMAX_BACKWARD_FLOPS * cost.numel())


def blend_backward_cost(depth: torch.Tensor) -> tuple:
    """(bytes, flops) of one propagation-blend backward over depth
    [N, H, W]."""
    return 4 * BLEND_BACKWARD_FLOATS * depth.numel(), \
        BLEND_BACKWARD_FLOPS * depth.numel()


# ------------------------------------------------------------------ inputs
def _inputs_of(case):
    """The input tuple a `chip_smoke.Case` closes over (its `run`'s default
    argument)."""
    return case.run.__defaults__[0]


def main_inputs(device):
    """({name: (cost, dvals)}, {name: (grad, logits, depth, out)}) of the
    main path's K8b and K8a-backward calls in `chip_smoke.py`."""
    import chip_smoke

    fwd = {}
    for c in chip_smoke.kernel_cases(device):
        if c.kernel == "softargmax_depth":
            cost = _inputs_of(c)[0]
            name = "batch" if c.path == "infer_depth" else c.path
            fwd[f"{name} {list(cost.shape)}"] = _inputs_of(c)
    bwd = {}
    for c in chip_smoke.train_cases(device):
        if c.kernel == "propagation_blend_backward":
            bwd[f"train {list(_inputs_of(c)[2].shape)}"] = _inputs_of(c)
    return fwd, bwd


def softargmax_backward_inputs(device):
    """{name: (grad, cost, dvals, depth)} of K8b's backward: the train
    step's call in `chip_smoke.train_cases` and the soft-argmax edge cases
    (the twin's depths, computed on `device`)."""
    import chip_smoke

    out = {}
    for c in chip_smoke.train_cases(device):
        if c.kernel == "softargmax_depth_backward":
            out[f"train {list(_inputs_of(c)[1].shape)}"] = _inputs_of(c)
    out.update(backward_edge_inputs(device))
    return out


PLANE_COUNTS = (392, 768)       # past the register form's 384 planes


def plane_inputs(device, planes=PLANE_COUNTS):
    """{name: (grad, cost, dvals, depth)} of K8b past the register form's
    planes, at the batch's [14, D, 56, 56]: seeded costs x3, a D-plane
    sweep's depths from 0.5 m in steps of 0.05 m, seeded incoming
    gradients and the twin's depths."""
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref

    gen = torch.Generator().manual_seed(5)
    out = {}
    for D in planes:
        cost = (torch.randn(14, D, 56, 56, generator=gen) * 3).to(device)
        dv = (0.5 + 0.05 * torch.arange(D, dtype=torch.float32)).to(device)
        grad = torch.randn(14, 56, 56, generator=gen).to(device)
        out[f"planes {list(cost.shape)}"] = (
            grad, cost, dv, softargmax_depth_ref(cost, dv))
    return out


def backward_edge_inputs(device):
    """{name: (grad, cost, dvals, depth)} of K8b's backward at the
    soft-argmax edge cases, the depths the twin's, computed on `device`."""
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref

    E = edge_module()
    up = lambda a: torch.from_numpy(a).to(device)
    out = {}
    for name, *_ in E.SOFTARGMAX_CASES:
        cost, dv, grad = map(up, E.softargmax_case(name))
        out[f"edge {name}"] = (grad, cost, dv,
                               softargmax_depth_ref(cost, dv))
    return out


def edge_module():
    """`tests/_kernel_edge_cases.py` of the tree this file lies in."""
    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import _kernel_edge_cases

    return _kernel_edge_cases


def edge_inputs(device):
    """The edge cases as ({name: (cost, dvals)}, {name: (grad, logits,
    depth, out)}) on `device`; K8a's `out` is the twin's."""
    from tdvnet_torch.kernels.propagation import propagation_blend_ref

    E = edge_module()
    up = lambda a: torch.from_numpy(a).to(device)
    fwd = {}
    for name, *_ in E.SOFTARGMAX_CASES:
        cost, dv, _ = E.softargmax_case(name)
        fwd[f"edge {name}"] = (up(cost), up(dv))
    bwd = {}
    for name, _, _ in E.BLEND_CASES:
        grad, logits, depth = map(up, E.blend_case(name))
        view = logits.permute(0, 2, 3, 1)
        bwd[f"edge {name}"] = (grad, view, depth,
                               propagation_blend_ref(view, depth))
    return fwd, bwd


# ------------------------------------------------------------------ timing
def profile_us(fn) -> dict:
    from tdvnet_torch.tools.time_pool_i8 import profile_us as p

    return p(fn)


def alloc_host_us(shape, device, n=200) -> float:
    """Host microseconds of one `torch.empty(shape)` fp32 on `device`,
    freed before the next (the caching allocator's round trip)."""
    for _ in range(10):
        torch.empty(shape, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    for _ in range(n):
        torch.empty(shape, dtype=torch.float32, device=device)
    return 1e6 * (time.perf_counter() - t0) / n


def _record(run, nbytes, flops, iters, profile):
    from tdvnet_torch.tools.timing import time_ms

    r = {"ms": time_ms(run, iters=iters, warmup=3),
         "bound_ms": bound_ms(nbytes, flops), "digest": digest(run())}
    if profile:
        r["profile_us"] = profile_us(run)
    return r


def time_softargmax(named, iters, profile):
    from tdvnet_torch.kernels import softargmax_depth

    def run(a):
        with torch.no_grad():
            return softargmax_depth(*a)

    rec = {}
    for name, a in named.items():
        rec[name] = _record(lambda a=a: run(a), *softargmax_cost(a[0]),
                            iters, profile)
        rec[name]["shape"] = list(a[0].shape)
    return rec


def time_softargmax_backward(named, iters, profile):
    from tdvnet_torch.kernels import softargmax_depth_backward

    rec = {}
    for name, a in named.items():
        rec[name] = _record(lambda a=a: softargmax_depth_backward(*a),
                            *softargmax_backward_cost(a[1]), iters, profile)
        rec[name]["shape"] = list(a[1].shape)
    return rec


def time_blend_backward(named, iters, profile, alloc=()):
    from tdvnet_torch.kernels import propagation_blend_backward

    rec = {}
    for name, a in named.items():
        depth = a[2]
        rec[name] = _record(lambda a=a: propagation_blend_backward(*a),
                            *blend_backward_cost(depth), iters, profile)
        rec[name]["shape"] = list(depth.shape)
        if name in alloc:
            N, H, W = depth.shape
            rec[name]["scratch_alloc_host_us"] = alloc_host_us(
                (N, 9, H, W), depth.device)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--profile", action="store_true",
                    help="add device time per kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_depthops: no CUDA device")
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
    fwd, bwd = main_inputs(device)
    main_bwd = tuple(bwd)
    efwd, ebwd = edge_inputs(device)
    fwd.update(efwd)
    bwd.update(ebwd)
    planes = plane_inputs(device)
    fwd.update({k: (cost, dv) for k, (_, cost, dv, _) in planes.items()})
    sbwd = softargmax_backward_inputs(device)
    sbwd.update(planes)
    rec = {"root": root, "card": card,
           "softargmax": time_softargmax(fwd, args.iters, args.profile),
           "softargmax_backward": time_softargmax_backward(
               sbwd, args.iters, args.profile),
           "blend_backward": time_blend_backward(bwd, args.iters,
                                                 args.profile, main_bwd)}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
