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
     and the device time of the port's own kernels;
  6. whole-scene inference, `FusedSceneInference` at the parity settings:
     (a) `predict_scene` on the golden scene against the JAX golden
     `tests/data/torch_golden_scene_synth48.npz` (depth, chosen grid, drop
     counters, launch counts); (b) `predict_scenes` over three scenes of 52
     views (48 refs, three chunks of 16), timed per scene; (c) one more
     scene traced as in phase 5.

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
SCENE_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_golden_scene_synth48.npz")
# the streamed scenes: 48 refs + 2 x 2 source-only views, three of them
STREAM_VIEWS = 52
STREAM_SEEDS = (7, 8, 9)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores

# golden tolerances on the full path (see PERF.md): the card sums in
# another order than the JAX CPU run, and the golden's final depth is f16
INIT_MAX_REL = 1e-3
FINAL_MEDIAN_ABS = 1e-3
ABS_REL_DELTA = 2e-3
STREAM_ABS_REL_SLACK = 5e-3

# kernel -> (source, the TPU op it replaces, its wrappers in
# tdvnet_torch.kernels.WRAPPERS)
KERNEL_META = {
    "source_variance": ("tdvnet_torch/csrc/source_variance.cu",
                        "tdvnet/ops/costvolume.py:36", ("source_variance",)),
    "trilinear_sample": ("tdvnet_torch/csrc/trilinear_sample.cu",
                         "tdvnet/ops/sampling.py:199", ("trilinear_sample",)),
    "propagation_blend": ("tdvnet_torch/csrc/propagation_blend.cu",
                          "tdvnet/kernels/depthops_pallas.py:83 (2df7997^)",
                          ("propagation_blend",)),
    "softargmax_depth": ("tdvnet_torch/csrc/softargmax_depth.cu",
                         "tdvnet/kernels/depthops_pallas.py:44 (2df7997^)",
                         ("softargmax_depth",)),
    "voxelize": ("tdvnet_torch/csrc/voxelize.cu", "tdvnet/ops/voxelize.py:60",
                 ("voxelize", "scatter_anchors_to_dense")),
    "segment_max": ("tdvnet_torch/csrc/segment_max.cu",
                    "tdvnet/models/pointnet.py:19",
                    ("segment_max", "gather_concat")),
    "masked_group_norm": ("tdvnet_torch/csrc/masked_group_norm.cu",
                          "tdvnet/models/layers.py:106",
                          ("masked_group_norm",)),
}


def group_norm_calls(unet_res):
    """(relu tails, skip tails) of the masked GroupNorm per U-Net level in
    one forward: a residual block has one of each; a level below the finest
    adds the down conv's; a level above the coarsest adds the up conv's and
    the merge conv's and runs its blocks a second time in the decoder."""
    L = len(unet_res)
    out = []
    for lvl, res in enumerate(unet_res):
        blocks = res * (2 if lvl < L - 1 else 1)
        out.append((blocks + (lvl > 0) + 2 * (lvl < L - 1), blocks))
    return out


def expected_launches(offsets_list, n_chunks, unet_res):
    """Launches per wrapper in one inference over `n_chunks` ref chunks
    (`infer_depth` is the one-chunk case), counted from the code: the cost
    volume per chunk; per refinement iteration one scene model (point
    cloud variance, voxelize, PointNet with 4 pools and 3 concat-backs,
    scatter, U-Net) and per chunk and offset pass one variance and three
    scale samplings; three propagation blends per chunk."""
    n_iters = len(offsets_list)
    passes = sum(len(o) for o in offsets_list)
    gn = sum(a + b for a, b in group_norm_calls(unet_res))
    return {"source_variance": n_chunks + n_iters + n_chunks * passes,
            "trilinear_sample": 3 * n_chunks * passes,
            "propagation_blend": 3 * n_chunks,
            "softargmax_depth": n_chunks,
            "voxelize": n_iters, "scatter_anchors_to_dense": n_iters,
            "segment_max": 4 * n_iters, "gather_concat": 3 * n_iters,
            "masked_group_norm": gn * n_iters}


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
    inputs on the card, which path makes the call ("infer_depth", or
    "scene" for whole-scene inference of a 48-ref scene)
    and how often per inference, the bytes it must move and the flops it
    does, its tolerance (0: every output tensor equal), and where one
    exists a single PyTorch call computing the same function. `run` and
    `ref` return a tensor or a tuple of tensors."""

    def __init__(self, kernel, label, per_infer, run, ref, tol, nbytes,
                 flops, library=None, path="infer_depth"):
        self.kernel, self.label, self.per_infer = kernel, label, per_infer
        self.run, self.ref, self.tol = run, ref, tol
        self.nbytes, self.flops, self.library = nbytes, flops, library
        self.path = path

    @property
    def bound_ms(self):
        return 1e3 * max(self.nbytes / HBM_BYTES_PER_S,
                         self.flops / FP32_FLOPS)


def scene_golden_record():
    import numpy as np

    with np.load(SCENE_GOLDEN) as z:
        return json.loads(str(z["record"]))


def scene_model_cases(device, gen, label, path, P, B, grid, A, unet):
    """The calls one scene modelling makes to the voxelize, segment-max and
    masked-GroupNorm kernels: P points of B scenes into `grid` with A
    anchors, on seeded random points in a box a little larger than the
    grid (some fall outside; a tenth are invalid)."""
    import torch

    from tdvnet_torch.kernels import groupnorm, segmax, voxelize as vox

    n_iters = len(OFFSETS)
    edge = 0.08
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    span = torch.tensor([g * edge * 1.02 for g in grid])
    pts = (torch.rand(P, 3, generator=gen) * span).to(device).contiguous()
    scene = torch.arange(P, device=device) * B // P
    valid = (torch.rand(P, generator=gen) > 0.1).to(device)
    vargs = (pts, scene, valid, edge, grid, A, B)
    # every field but the twin's sorted view, which the kernel leaves out
    fields = lambda vg: tuple(vg[:7]) + tuple(vg[9:])
    n_cells = B * grid[0] * grid[1] * grid[2]
    cases = [Case(
        "voxelize", f"voxelize {label} P={P} grid={grid} A={A}", n_iters,
        lambda a=vargs: fields(vox.voxelize(*a)),
        lambda a=vargs: fields(vox.voxelize_ref(*a)),
        0.0, P * (12 + 8 + 1) + P * (8 + 1) + A * (24 + 8 + 12 + 1),
        P * 12, path=path)]

    vg = vox.voxelize(*vargs)
    C = 64
    feats = rnd(A, C)
    flat = (vg.anchor_idx3[:, 0] * grid[1] + vg.anchor_idx3[:, 1]) \
        * grid[2] + vg.anchor_idx3[:, 2]
    seg_a = (vg.anchor_scene * (n_cells // B) + flat)[vg.anchor_valid]
    feats_a = feats[vg.anchor_valid]
    dense0 = torch.zeros(n_cells, C, device=device)
    cases.append(Case(
        "voxelize", f"scatter {label} [{A},{C}] -> {B}x{grid}", n_iters,
        lambda a=(feats, vg, grid, B): vox.scatter_anchors_to_dense(*a),
        lambda a=(feats, vg, grid, B): vox.scatter_anchors_to_dense_ref(*a),
        0.0, A * (4 * C + 24 + 8 + 1) + n_cells * 4 * (C + 1), 0,
        library=lambda: dense0.index_put_((seg_a,), feats_a), path=path))

    C = 128
    y = rnd(P, C)
    n_seg = A + 1
    p2a, pv = vg.point2anchor, vg.point_valid
    idx = p2a[:, None].expand(P, C).contiguous()
    pool0 = torch.full((n_seg, C), -1e30, device=device)
    cases.append(Case(
        "segment_max", f"pool {label} [{P},{C}] -> [{n_seg},{C}]",
        4 * n_iters,
        lambda a=(y, p2a, pv, n_seg): segmax.segment_max(*a),
        lambda a=(y, p2a, pv, n_seg): segmax.segment_max_ref(*a),
        0.0, P * (4 * C + 8 + 1) + n_seg * 4 * C, P * C,
        library=lambda: pool0.scatter_reduce(0, idx, y, "amax"), path=path))
    pooled = segmax.segment_max(y, p2a, pv, n_seg)
    cases.append(Case(
        "segment_max", f"concat-back {label} [{P},{C}] -> [{P},{2 * C}]",
        3 * n_iters,
        lambda a=(y, pooled, p2a): segmax.gather_concat(*a, relu=True),
        lambda a=(y, pooled, p2a): segmax.gather_concat_ref(*a, relu=True),
        0.0, P * (4 * C + 8) + min(P, n_seg) * 4 * C + P * 8 * C, P * 2 * C,
        path=path))

    dims_c, groups, res = unet
    for lvl, ((n_relu, n_skip), C, G) in enumerate(
            zip(group_norm_calls(res), dims_c, groups)):
        dims = tuple(d >> lvl for d in grid)
        V = dims[0] * dims[1] * dims[2]
        mask = (torch.rand(B, 1, *dims, generator=gen) > 0.85).float()
        if B > 1:
            mask[-1, :, dims[0] // 2:] = 0      # scenes differ in their count
        mask = mask.to(device)
        x = (rnd(B, C, *dims) * 2 + 1) * mask
        skip = rnd(B, C, *dims) * mask
        w, b = rnd(C), rnd(C)
        for tail, count, kw in (("relu", n_relu, {"relu": True}),
                                ("skip", n_skip, {"skip": skip})):
            a = (x, mask, G, w, b)
            n_in = 2 if tail == "skip" else 1
            cases.append(Case(
                "masked_group_norm",
                f"{tail} {label} [{B},{C},{dims[0]}x{dims[1]}x{dims[2]}] "
                f"G={G}", count * n_iters,
                lambda a=a, kw=kw: groupnorm.masked_group_norm(*a, **kw),
                lambda a=a, kw=kw: groupnorm.masked_group_norm_ref(*a, **kw),
                1e-4, 4 * (B * C * V * (n_in + 1) + B * V + 2 * C),
                B * C * V * 8, path=path))
    return cases


def kernel_cases(device, seed=0):
    """The calls the full-width main path makes, on the golden batch's
    cameras, with seeded random features, grids, logits and costs; and the
    calls whole-scene inference makes to the scene-modelling kernels at the
    golden scene's size."""
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

    # scene modelling at infer_depth's size and at the whole scene's: the
    # streamed scenes' refs, bucketed up to whole chunks, into the grid the
    # golden scene gets
    from tdvnet_torch.config import EvalConfig

    unet = (cfg.unet_dims, cfg.unet_groups, cfg.unet_res)
    P_ref = dc.size[0] * dc.size[1]
    cases += scene_model_cases(device, gen, "infer_depth", "infer_depth",
                               R * P_ref, B, g.grid_size, g.max_anchors, unet)
    ev, rec = EvalConfig(), scene_golden_record()
    n_refs = STREAM_VIEWS - 2 * ev.n_src_on_either_side
    n_slots = -(-n_refs // ev.fused_chunk) * ev.fused_chunk
    cases += scene_model_cases(device, gen, "scene", "scene",
                               n_slots * P_ref, 1, tuple(rec["grid_size"]),
                               ev.eval_max_anchors, unet)
    return cases


def check_case(case):
    """Max |kernel - twin| over the outputs and whether it is within the
    tolerance, which is relative to the twin's largest magnitude (at least
    1); a tolerance of 0 asks for equal tensors."""
    import torch

    got, want = case.run(), case.ref()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err, ok = 0.0, len(got) == len(want)
    for a, b in zip(got, want):
        ok &= a.shape == b.shape and a.dtype == b.dtype
        d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        err = max(err, d)
        if case.tol == 0.0:
            ok &= torch.equal(a, b)
        else:
            ok &= d <= case.tol * max(1.0, float(b.abs().max()))
    return err, bool(ok)


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
            f"x{case.per_infer} per {case.path}")
        ok &= good
        zero = lambda: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": None, "nbytes": 0.0, "flops": 0.0}
        k = per_kernel.setdefault(case.kernel, {
            "max_abs_err": 0.0, "calls": [], "infer_depth": zero(),
            "scene": None})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if k[case.path] is None:
            k[case.path] = zero()
        tot = k[case.path]            # sums over one inference of that path
        tot["ms"] += case.per_infer * ms
        tot["plain_ms"] += case.per_infer * plain
        tot["bound_ms"] += case.per_infer * case.bound_ms
        tot["nbytes"] += case.per_infer * case.nbytes
        tot["flops"] += case.per_infer * case.flops
        if lib is not None:
            tot["library_ms"] = (tot["library_ms"] or 0.0) \
                + case.per_infer * lib
        k["calls"].append({"shape": case.label, "path": case.path,
                           "per_infer": case.per_infer,
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
    expected = expected_launches(OFFSETS, 1, model.cfg.unet_res)

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
        f"(expected {json.dumps(expected)})")
    ok = (finite and init_rel <= INIT_MAX_REL and med <= FINAL_MEDIAN_ABS
          and abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
          and stats["n_overflow"] == rec["n_overflow"]
          and stats["n_out_of_grid"] == rec["n_out_of_grid"]
          and counts == expected and all(v > 0 for v in counts.values()))
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


# ---------------------------------------------------------------- whole scene
def scene_views(n_views, seed):
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.data import synthetic

    return synthetic.make_scene(n_views=n_views,
                                img_size=ModelConfig().img_size, seed=seed)


def scene_abs_rel(depth, views, k, device):
    import torch

    from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics

    gt = views["depth"][k:views["depth"].shape[0] - k]
    return float(calc_2d_depth_metrics(
        torch.from_numpy(depth).to(device),
        torch.from_numpy(gt).to(device))["abs_rel"])


def scene_golden_phase(inf, device):
    """`predict_scene` on the golden scene against the JAX golden."""
    import numpy as np
    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts

    rec = scene_golden_record()
    with np.load(SCENE_GOLDEN) as z:
        g_mm = z["depth_mm"].astype(np.float32) * 1e-3
    if [tuple(o) for o in rec["offsets"]] != [tuple(o) for o in OFFSETS]:
        raise RuntimeError(f"golden offsets {rec['offsets']} != {OFFSETS}")
    ev = inf.cfg.eval
    views = scene_views(rec["n_views"], rec["seed"])
    n_chunks = -(-rec["n_refs"] // ev.fused_chunk)

    torch.cuda.synchronize()
    reset_launch_counts()
    timings = {}
    t0 = time.perf_counter()
    depth = inf.predict_scene(views, timings)
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    expected = expected_launches(OFFSETS, n_chunks, inf.model.cfg.unet_res)

    finite = bool(np.isfinite(depth).all())
    d = np.abs(depth - g_mm)
    med, p99 = float(np.median(d)), float(np.percentile(d, 99))
    abs_rel = scene_abs_rel(depth, views, ev.n_src_on_either_side, device)
    stats, grid = inf.last_scene_stats, tuple(inf.last_grid_size)
    log(f"  first predict_scene {first_ms:.1f} ms ({rec['n_views']} views, "
        f"{rec['n_refs']} refs, {n_chunks} chunks; prep "
        f"{1e3 * timings['prep']:.1f} ms, refine "
        f"{1e3 * timings['refine']:.1f} ms); depth {depth.shape} "
        f"finite={finite}")
    log(f"  depth |d| vs golden: median {med:.3e} m (limit "
        f"{FINAL_MEDIAN_ABS:.0e}), p99 {p99:.3e} m")
    log(f"  abs_rel vs synthetic depth {abs_rel:.6f}, golden "
        f"{rec['abs_rel']:.6f} (limit +-{ABS_REL_DELTA})")
    log(f"  grid {grid} (golden {tuple(rec['grid_size'])}); stats "
        f"{json.dumps(stats)} (golden {json.dumps(rec['stats'])})")
    log(f"  launches in that predict_scene: {json.dumps(counts)} "
        f"(expected {json.dumps(expected)})")
    ok = (finite and depth.shape == g_mm.shape and med <= FINAL_MEDIAN_ABS
          and abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
          and grid == tuple(rec["grid_size"]) and stats == rec["stats"]
          and counts == expected and all(v > 0 for v in counts.values()))
    return ok, counts


def scene_stream_phase(inf, device, card):
    """`predict_scenes` over a stream of full-length scenes, timed from one
    result to the next. The golden records the JAX package's `abs_rel` on
    the first scene (the later views of these long synthetic scenes are
    harder than the golden scene's): the first scene is held to it and the
    others stay under it plus a slack."""
    import numpy as np
    import torch

    jax_first = scene_golden_record()["stream"]
    if (jax_first["n_views"], jax_first["seed"]) != (STREAM_VIEWS,
                                                     STREAM_SEEDS[0]):
        raise RuntimeError(f"golden stream scene {jax_first} is not the "
                           f"stream's first")
    abs_rel_limit = jax_first["abs_rel"] + STREAM_ABS_REL_SLACK
    k = inf.cfg.eval.n_src_on_either_side
    scenes = [scene_views(STREAM_VIEWS, s) for s in STREAM_SEEDS]
    n_refs = STREAM_VIEWS - 2 * k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, results = [], []
    t0 = time.perf_counter()
    for depth in inf.predict_scenes(iter(scenes)):
        now = time.perf_counter()
        secs.append(now - t0)
        results.append((depth, tuple(inf.last_grid_size),
                        dict(inf.last_scene_stats)))
        t0 = now
    torch.cuda.synchronize()
    total = sum(secs)
    peak = torch.cuda.max_memory_allocated()
    ok = len(results) == len(scenes)
    for seed, views, sec, (depth, grid, stats) in zip(STREAM_SEEDS, scenes,
                                                      secs, results):
        finite = bool(np.isfinite(depth).all())
        abs_rel = scene_abs_rel(depth, views, k, device)
        good = (finite and depth.shape[0] == n_refs
                and abs_rel <= abs_rel_limit)
        if seed == jax_first["seed"]:
            good &= (abs(abs_rel - jax_first["abs_rel"]) <= ABS_REL_DELTA
                     and stats == jax_first["stats"])
        ok &= good
        log(f"  scene seed {seed}: {sec:.3f} s after the result before it, "
            f"grid {grid}, stats {json.dumps(stats)}, abs_rel "
            f"{abs_rel:.6f} (limit {abs_rel_limit:.6f}), finite={finite} "
            f"{'ok' if good else 'FAIL'} [{card}]")
    log(f"  {len(secs)} scenes of {STREAM_VIEWS} views ({n_refs} refs) in "
        f"{total:.3f} s: {total / len(secs):.3f} s/scene, "
        f"{len(secs) * n_refs / total:.2f} ref-frames/s; peak memory "
        f"allocated {peak / 2**30:.2f} GiB [{card}]")
    return ok, {
        "scene_seconds": secs, "ref_frames_per_s": len(secs) * n_refs / total,
        "peak_bytes": peak, "n_refs": n_refs}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_phase(run, what, card):
    """One traced call of `run`: the device's busy share of the host's
    window (the union of the intervals in which a kernel, copy or set ran
    on the card), device time under each stage span, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    log(f"  traced {what} {wall_ms:.1f} ms wall; device busy "
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
        # a source file's kernels are all named <file>_..._kernel
        hits = [v for name, v in by_name.items() if f"{k}_" in name]
        ported[k] = {"ms": sum(ms for ms, _ in hits),
                     "launches": sum(cnt for _, cnt in hits)}
        log(f"  port kernel {k:18s} {ported[k]['ms']:8.3f} ms device in "
            f"{ported[k]['launches']} device kernels")
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
    batch = golden_batch((2 * SERVE_SEEDS[0], 2 * SERVE_SEEDS[0] + 1))
    trace = profile_phase(lambda: model.infer_depth(batch, OFFSETS),
                          "infer_depth", card)

    log("phase 6a: whole-scene predict_scene against the JAX golden")
    from tdvnet_torch.config import Config
    from tdvnet_torch.eval.fused_scene import FusedSceneInference

    inf = FusedSceneInference(model, Config(), offsets_list=OFFSETS,
                              fetch_mm=True)
    g_ok, scene_counts = scene_golden_phase(inf, device)
    log("phase 6b: predict_scenes over a stream of scenes")
    s_ok, stream = scene_stream_phase(inf, device, card)
    log("phase 6c: trace of one scene")
    views = scene_views(STREAM_VIEWS, STREAM_SEEDS[0])
    scene_trace = profile_phase(lambda: inf.predict_scene(views),
                                f"predict_scene ({STREAM_VIEWS} views)", card)

    # per kernel: sums over one infer_depth (the keys of the contract) and,
    # for the scene-modelling kernels, over one whole-scene inference
    kernels = []
    for name, k in per_kernel.items():
        src, replaces, wrappers = KERNEL_META[name]
        tot = k["infer_depth"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(counts[w] for w in wrappers),
            "max_abs_err": k["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by(tot["nbytes"], tot["flops"]),
            "library_ms": tot["library_ms"],
            "trace_ms": trace["ported_kernels"][name]["ms"],
            "scene_launches": sum(scene_counts[w] for w in wrappers),
            "scene": k["scene"] and {x: k["scene"][x] for x in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            "scene_trace_ms": scene_trace["ported_kernels"][name]["ms"],
            "calls": k["calls"]})
    log(json.dumps({"serve_ms": times, "first_infer_ms": first_ms,
                    "ref_frames_per_s": [1e3 * n_refs / t for t in times],
                    "peak_bytes": peak, "card": card, "trace": trace,
                    "scene_stream": stream, "scene_trace": scene_trace}))
    if not (k_ok and f_ok and g_ok and s_ok):
        log(f"FAILED: kernels ok={k_ok}, full path ok={f_ok}, scene golden "
            f"ok={g_ok}, scene stream ok={s_ok}")
        return 1
    if set(per_kernel) != set(KERNEL_META):
        log(f"FAILED: kernels without a case: "
            f"{sorted(set(KERNEL_META) - set(per_kernel))}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
