"""Drive the PyTorch/CUDA port of tdvnet on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels with nvcc
     (seconds and the ptxas register/shared-memory summary);
  2. hold each kernel against its plain PyTorch twin at the shapes the main
     path gives it, and time kernel, twin and (where one exists) a single
     PyTorch library call with CUDA events;
  3. load the synth48 weights and run full-width `ThreeDVNet.infer_depth`
     on the golden batch (2 synthetic scenes x 9 views, 7 refs each), hold
     it against the JAX golden `tests/data/torch_golden_synth48.npz`, and
     check from the launch counters that every kernel ran on that path;
  4. serve three more batches and time each;
  5. trace one more batch with torch.profiler: the device's busy share of
     the window, host and device time per stage span, the top kernels,
     and the device time of the port's own kernels.

The line before the last is the `kernels` JSON; the last line is the device
JSON. Imports nothing of JAX; the port runs on the card only.
"""
import json
import os
import subprocess
import sys
import time

GOLDEN_SEEDS = (0, 1)
OFFSETS = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
# each served batch holds two synthetic scenes, seeds 2s and 2s + 1
SERVE_SEEDS = (2, 3, 4)

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "weights", "3dvnet_synth48.npz")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth48.npz")

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores

# golden tolerances on the full path (see PERF.md): the card sums in
# another order than the JAX CPU run, and the golden's final depth is f16
INIT_MAX_REL = 1e-3
FINAL_MEDIAN_ABS = 1e-3
ABS_REL_DELTA = 2e-3
EXPECTED_LAUNCHES = {"source_variance": 9, "trilinear_sample": 18,
                     "propagation_blend": 3, "softargmax_depth": 1}

KERNEL_META = {
    "source_variance": ("tdvnet_torch/csrc/source_variance.cu",
                        "tdvnet/ops/costvolume.py:36"),
    "trilinear_sample": ("tdvnet_torch/csrc/trilinear_sample.cu",
                         "tdvnet/ops/sampling.py:199"),
    "propagation_blend": ("tdvnet_torch/csrc/propagation_blend.cu",
                          "tdvnet/kernels/depthops_pallas.py:83 (2df7997^)"),
    "softargmax_depth": ("tdvnet_torch/csrc/softargmax_depth.cu",
                         "tdvnet/kernels/depthops_pallas.py:44 (2df7997^)"),
}


def log(*args):
    print(*args, flush=True)


def golden_batch(seeds):
    from tdvnet_torch.config import BatchConfig
    from tdvnet_torch.data import batch as B, synthetic

    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(
        bc.n_views, bc.img_size, bc.depth_img_size, seed=s,
        n_src_on_either_side=bc.n_src_on_either_side) for s in seeds]
    return B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                            bc.n_src_on_either_side)


# --------------------------------------------------------------- kernel cases
def bound_by(nbytes, flops):
    """Which of the card's two rates bounds work of this size."""
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations")


class Case:
    """One main-path call of a kernel: its wrapper and twin as closures over
    inputs on the card, how often one infer_depth makes this call, the
    bytes it must move and the flops it does, its tolerance, and where one
    exists a single PyTorch call computing the same function."""

    def __init__(self, kernel, label, per_infer, run, ref, tol, nbytes,
                 flops, library=None):
        self.kernel, self.label, self.per_infer = kernel, label, per_infer
        self.run, self.ref, self.tol = run, ref, tol
        self.nbytes, self.flops, self.library = nbytes, flops, library

    @property
    def bound_ms(self):
        return 1e3 * max(self.nbytes / HBM_BYTES_PER_S,
                         self.flops / FP32_FLOPS)


def kernel_cases(device, seed=0):
    """The calls the full-width main path makes, on the golden batch's
    cameras, with seeded random features, grids, logits and costs."""
    import torch
    import torch.nn.functional as F

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import (propagation_blend, softargmax_depth,
                                      source_variance, trilinear_sample)
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera

    cfg = ModelConfig()
    dc, g = cfg.depth_test, cfg.grid
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    b = golden_batch(GOLDEN_SEEDS).to(device)
    R, S = b.src_idx.shape
    N = b.n_imgs
    H, W = cfg.img_size
    f = cfg.feat_dim
    feats = rnd(N, H // 4, W // 4, f).contiguous()
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs).contiguous()
    active = float(b.src_mask.sum())        # real (ref, source) pairs
    ri = b.ref_idx
    cases = []

    # source_variance at its three main-path shapes: the cost volume (D
    # planes), the scene point cloud (1 plane) and pointflow (7 hypotheses)
    hw = f"{dc.size[0]}*{dc.size[1]}"
    for label, planes, per_infer in (
            (f"cost volume [{R},{dc.n_intervals}*{hw},{f}]", dc.n_intervals, 1),
            (f"scene cloud [{R},{hw},{f}]", 1, 2),
            (f"pointflow [{R},7*{hw},{f}]", 7, 6)):
        interval = dc.depth_interval * (dc.n_intervals - 1) / max(planes - 1, 1)
        pts = camera.plane_sweep_points(
            dc.depth_start, interval, planes, b.rotmats[ri], b.tvecs[ri],
            b.K[ri], cfg.img_size, dc.size).contiguous()
        P = pts.shape[1]
        args = (pts, feats, b.src_idx, b.src_mask, P_all, cfg.img_size)
        nbytes = 4 * (pts.numel() + feats.numel() + R * P * f + P_all.numel()
                      + R * S * 3)
        flops = (active / R) * R * P * (24 + 11 * f) + R * P * f * 4
        cases.append(Case("source_variance", label, per_infer,
                          lambda a=args: source_variance(*a),
                          lambda a=args: source_variance_ref(*a),
                          1e-4, nbytes, flops))

    # trilinear_sample: the three U-Net scales at the pointflow queries
    B = b.n_scenes
    Q = (R // B) * 7 * dc.size[0] * dc.size[1]
    edge = g.edge_len
    extent = g.grid_size[0] * edge
    origins = rnd(B, 3) * 0.1
    center0 = (origins + 0.5 * edge).contiguous()
    # queries over the grid and a margin around it, so some fall outside
    pts_q = (origins[:, None, :] - 0.3
             + torch.rand(B, Q, 3, generator=gen).to(device) * (extent + 0.6)
             ).contiguous()
    n_ch = sum(cfg.unet_dims)
    off = 0
    for stride, C in zip((1, 2, 4), cfg.unet_dims):
        dims = tuple(d // stride for d in g.grid_size)
        grid = rnd(B, *dims, C).contiguous()
        cell = stride * edge
        out = torch.empty(B, Q, n_ch, device=device)
        # grid_sample on 5-D input: [B, C, X, Y, Z] with (z, y, x) coords
        # normalised with align_corners=True
        qn = (pts_q - center0[:, None, :]) / cell
        lim = torch.tensor([d - 1 for d in dims], device=device,
                           dtype=torch.float32)
        gs_grid = (qn / lim * 2 - 1).flip(-1).reshape(B, Q, 1, 1, 3)
        gs_in = grid.permute(0, 4, 1, 2, 3)
        nbytes = 4 * (grid.numel() + pts_q.numel() + center0.numel()
                      + B * Q * C)
        flops = B * Q * (30 + 16 * C)
        cases.append(Case(
            "trilinear_sample", f"scale s={stride} [{B},{dims[0]}^3,{C}]"
            f" x {Q} queries", 6,
            lambda a=(grid, pts_q, center0, cell, out, off), c=C:
                trilinear_sample(*a)[..., a[5]:a[5] + c],
            lambda a=(grid, pts_q, center0, cell):
                trilinear_sample_ref(*a),
            1e-5, nbytes, flops,
            library=lambda a=(gs_in, gs_grid): F.grid_sample(
                a[0], a[1], mode="bilinear", padding_mode="zeros",
                align_corners=True)))
        off += C

    # propagation_blend at the three upsampling sizes; the logits are the
    # NCHW output of a conv handed over as an [N, H, W, 9] view
    for h, w in ((H // 4, W // 4), (H // 2, W // 2), (H, W)):
        logits = rnd(R, 9, h, w).permute(0, 2, 3, 1)
        depth = (1.0 + torch.rand(R, h, w, generator=gen) * 3).to(device)
        nbytes = 4 * R * h * w * 11
        cases.append(Case(
            "propagation_blend", f"[{R},{h},{w},9]", 1,
            lambda a=(logits, depth): propagation_blend(*a),
            lambda a=(logits, depth): propagation_blend_ref(*a),
            1e-5, nbytes, R * h * w * 45))

    # softargmax_depth over the regularised cost volume
    D = dc.n_intervals
    cost = (rnd(R, D, *dc.size) * 3).contiguous()
    dvals = camera.linspace_f32(dc.depth_start, dc.depth_end, D, device)
    cases.append(Case(
        "softargmax_depth", f"[{R},{D},{dc.size[0]},{dc.size[1]}]", 1,
        lambda a=(cost, dvals): softargmax_depth(*a),
        lambda a=(cost, dvals): softargmax_depth_ref(*a),
        1e-5, 4 * (cost.numel() + D + R * dc.size[0] * dc.size[1]),
        cost.numel() * 5))
    return cases


def check_case(case):
    """Max |kernel - twin| and whether it is within the tolerance, which is
    relative to the twin's largest magnitude (at least 1)."""
    import torch

    got = case.run()
    want = case.ref()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    return err, err <= case.tol * scale


def time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(device):
    ok = True
    per_kernel = {}
    for case in kernel_cases(device):
        err, good = check_case(case)
        ms = time_ms(case.run)
        plain = time_ms(case.ref, iters=3, warmup=1)
        lib = time_ms(case.library) if case.library else None
        log(f"  {case.kernel:18s} {case.label:48s} max|d|={err:.3e} "
            f"{'ok' if good else 'FAIL (tol %.0e)' % case.tol} "
            f"kernel={ms:.4f} ms plain={plain:.4f} ms "
            f"library={'%.4f ms' % lib if lib is not None else '-'} "
            f"bound={case.bound_ms:.4f} ms "
            f"({bound_by(case.nbytes, case.flops)}) "
            f"x{case.per_infer} per infer_depth")
        ok &= good
        k = per_kernel.setdefault(case.kernel, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": None, "nbytes": 0.0, "flops": 0.0, "calls": []})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["ms"] += case.per_infer * ms
        k["plain_ms"] += case.per_infer * plain
        k["bound_ms"] += case.per_infer * case.bound_ms
        k["nbytes"] += case.per_infer * case.nbytes
        k["flops"] += case.per_infer * case.flops
        if lib is not None:
            k["library_ms"] = (k["library_ms"] or 0.0) + case.per_infer * lib
        k["calls"].append({"shape": case.label, "per_infer": case.per_infer,
                           "ms": ms, "plain_ms": plain, "library_ms": lib,
                           "bound_ms": case.bound_ms, "max_abs_err": err})
    return ok, per_kernel


# ------------------------------------------------------------------ full path
def full_path_phase(model, device):
    import numpy as np
    import torch

    from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts

    with np.load(GOLDEN) as z:
        rec = json.loads(str(z["record"]))
        g_init, g_final = z["depth_init"], z["depth_final"].astype(np.float32)
    if tuple(rec["seeds"]) != GOLDEN_SEEDS:
        raise RuntimeError(f"golden seeds {rec['seeds']} != {GOLDEN_SEEDS}")
    batch = golden_batch(GOLDEN_SEEDS)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.infer_stages(batch, OFFSETS)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()

    init = out["initial"].cpu().numpy()
    final = out["final"].float()
    init_rel = float(np.max(np.abs(init - g_init) / np.abs(g_init)))
    d_final = np.abs(final.cpu().numpy() - g_final)
    med, p99 = float(np.median(d_final)), float(np.percentile(d_final, 99))
    abs_rel = float(calc_2d_depth_metrics(
        final, batch.depth_gt.to(device))["abs_rel"])
    finite = bool(torch.isfinite(final).all())
    stats = {k: int(v) for k, v in out["stats"].items()}
    log(f"  first infer_depth {first_ms:.1f} ms (cold: includes cuDNN "
        f"set-up); final depth {tuple(final.shape)} finite={finite}")
    log(f"  initial depth max rel err vs golden {init_rel:.3e} "
        f"(limit {INIT_MAX_REL:.0e})")
    log(f"  final depth |d| vs golden: median {med:.3e} m (limit "
        f"{FINAL_MEDIAN_ABS:.0e}), p99 {p99:.3e} m")
    log(f"  abs_rel vs synthetic GT {abs_rel:.6f}, golden {rec['abs_rel']:.6f}"
        f" (limit +-{ABS_REL_DELTA})")
    log(f"  n_overflow={stats['n_overflow']} n_out_of_grid="
        f"{stats['n_out_of_grid']} n_points={stats['n_points']} (golden "
        f"n_overflow={rec['n_overflow']} n_out_of_grid={rec['n_out_of_grid']})")
    log(f"  launches in that infer_depth: {json.dumps(counts)} "
        f"(expected {json.dumps(EXPECTED_LAUNCHES)})")
    ok = (finite and init_rel <= INIT_MAX_REL and med <= FINAL_MEDIAN_ABS
          and abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
          and counts == EXPECTED_LAUNCHES
          and all(v > 0 for v in counts.values()))
    return ok, counts, first_ms


def serve_phase(model, card):
    import torch

    batches = [golden_batch((2 * s, 2 * s + 1)) for s in SERVE_SEEDS]
    n_refs = batches[0].n_refs
    torch.cuda.reset_peak_memory_stats()
    times = []
    for s, b in zip(SERVE_SEEDS, batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth = model.infer_depth(b, OFFSETS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        times.append(ms)
        if not bool(torch.isfinite(depth).all()):
            raise RuntimeError(f"non-finite depth on batch {s}")
        log(f"  batch {s}: {ms:.1f} ms, {1e3 * n_refs / ms:.2f} ref-frames/s "
            f"[{card}]")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak memory allocated {peak / 2**30:.2f} GiB [{card}]")
    return times, peak, n_refs


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_phase(model, card):
    """One traced infer_depth: the device's busy share of the host's window
    (the union of the intervals in which a kernel, copy or set ran on the
    card), device time under each stage span, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = golden_batch((2 * SERVE_SEEDS[0], 2 * SERVE_SEEDS[0] + 1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.infer_depth(batch, OFFSETS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    # a stage span's device-side range covers its kernels: it is no work
    # of its own
    work = [e for e in on_card
            if not (e.is_user_annotation or e.name.startswith("stage_"))]
    if not work:
        raise RuntimeError("the profiler recorded no work on the card")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in work]) / 1e3
    stages = {}
    for e in events:
        if e.name.startswith("stage_"):
            side = "device" if e.device_type == DeviceType.CUDA else "host"
            stages.setdefault(e.name, {"host": 0.0, "device": 0.0})
            stages[e.name][side] += e.time_range.elapsed_us() / 1e3
    by_name = {}
    for e in work:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    log(f"  traced infer_depth {wall_ms:.1f} ms wall; device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of the window) "
        f"[{card}]")
    for k in sorted(stages):
        log(f"  {k:24s} host {stages[k]['host']:8.2f} ms, device "
            f"{stages[k]['device']:8.2f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, cnt) in top:
        log(f"  {ms:8.3f} ms x{cnt:<4d} {name[:90]}")
    # the port's own kernels on the main path, device time only (phase 2's
    # event timings of the small calls include the wrapper's host time)
    ported = {}
    for k in KERNEL_META:
        hits = [v for name, v in by_name.items() if f"{k}_kernel" in name]
        ported[k] = {"ms": sum(ms for ms, _ in hits),
                     "launches": sum(cnt for _, cnt in hits)}
        log(f"  port kernel {k:18s} {ported[k]['ms']:8.3f} ms device in "
            f"{ported[k]['launches']} launches")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "stages_ms": stages, "ported_kernels": ported}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tdvnet_torch.config import set_fp32_numerics
    from tdvnet_torch.kernels.build import library
    from tdvnet_torch.weights import load_threedvnet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")
    set_fp32_numerics()

    log("phase 1: build")
    info = library().build_info
    log(f"  built={info.built} in {info.seconds:.1f} s ({info.lib_path})")
    for line in info.ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())

    log("phase 2: kernels against their twins")
    k_ok, per_kernel = kernel_phase(device)

    log("phase 3: full-width infer_depth against the JAX golden")
    model = load_threedvnet(WEIGHTS, device=device)
    f_ok, counts, first_ms = full_path_phase(model, device)

    log("phase 4: serve")
    times, peak, n_refs = serve_phase(model, card)

    log("phase 5: trace")
    trace = profile_phase(model, card)

    kernels = []
    for name, k in per_kernel.items():
        src, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": bound_by(k["nbytes"], k["flops"]),
            "library_ms": k["library_ms"], "calls": k["calls"]})
    log(json.dumps({"serve_ms": times, "first_infer_ms": first_ms,
                    "ref_frames_per_s": [1e3 * n_refs / t for t in times],
                    "peak_bytes": peak, "card": card, "trace": trace}))
    if not (k_ok and f_ok):
        log(f"FAILED: kernels ok={k_ok}, full path ok={f_ok}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
