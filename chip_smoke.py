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
     scene traced as in phase 5;
  7. the same on the fast path (`EvalConfig(fast_path=True)`: merged,
     rank-96-projected int8 scene tables, patch-fan variance, the fast
     offsets): (a) against the JAX golden
     `tests/data/torch_golden_fastscene_synth48.npz` (depth, grid, drop
     counters, the projection's basis, launch counts); (b) the stream;
     (c) a trace;
  8. 3D evaluation on datasets written here (`data/synthetic_dataset.py`,
     52 views at 480x640, GT meshes fused on the card): (a) the 2D,
     fused-cloud and TSDF metrics of the golden scene's recipe predictions
     against the JAX golden `tests/data/torch_golden_eval3d_synth48.npz`
     (metrics, fused point count, GT mesh size, launch counts); (b)
     `harness.main` with the model's fast-path `pred_fn` over three scenes,
     per-stage shares, and a second call that reuses every cached file; (c)
     one scene's evaluation traced by stage span.

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
FAST_SCENE_GOLDEN = os.path.join(ROOT, "tests", "data",
                                 "torch_golden_fastscene_synth48.npz")
# the streamed scenes: 48 refs + 2 x 2 source-only views, three of them
STREAM_VIEWS = 52
STREAM_SEEDS = (7, 8, 9)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores

# golden tolerances on the full path (see PERF.md): the card sums in
# another order than the JAX CPU run, and the golden's final depth is f16
INIT_MAX_REL = 1e-3
FINAL_MEDIAN_ABS = 1e-3
FINAL_P99_ABS = 1e-2
ABS_REL_DELTA = 2e-3
STREAM_ABS_REL_SLACK = 5e-3
# the fast path's basis V against the golden's, column by column up to sign
# (the same numpy SVD of the same weights)
FAST_V_ABS = 1e-4
# a kernel case's tolerance that asks for every element within one bf16 ulp
# of the larger of the two magnitudes
BF16_ULP = "bf16_ulp"

# 3D evaluation (phase 8): the golden scene, the recipe of its predictions
# (GT depth of refs k..n-k-1, nearest-resized to the model's resolution,
# with seeded multiplicative noise and dropped pixels so that the
# consistency test rejects some) and the EvalConfig overrides; the streamed
# harness scenes
EVAL3D_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_golden_eval3d_synth48.npz")
EVAL3D = {"scene": "synth_eval3d", "seed": 21, "n_views": 52,
          "hw": [480, 640], "pred_hw": [256, 320], "k": 2,
          "noise_sigma": 0.002, "drop": 0.05, "noise_seed": 0}
EVAL3D_EVAL = {"run_tsdf_fusion": True}
EVAL3D_STREAM_SEEDS = (22, 23, 24)
# refs per consistency-fusion chunk (`fuse_point_cloud`'s, and JAX's)
FUSION_REF_CHUNK = 16
# the golden's limits: metrics in metres and fractions, counts relative
EVAL3D_ABS = {"acc": 1e-4, "comp": 1e-4, "prec": 2e-3, "recal": 2e-3,
              "fscore": 2e-3}
EVAL3D_REL_2D = 1e-5
EVAL3D_COUNT_REL = 1e-3
EVAL3D_MESH_REL = 5e-3
# kernel against twin: TSDF weights equal on this share of voxels (tsdf and
# colour within 1e-5 where they agree), fusion keep flags on this share of
# pixels (points within 1e-5 m where both keep)
TSDF_WEIGHT_SHARE = 0.9999
FUSE_KEEP_SHARE = 0.999
K9_ABS = 1e-5

# kernel -> (source, the TPU op it replaces, its wrappers in
# tdvnet_torch.kernels.WRAPPERS)
KERNEL_META = {
    "source_variance": ("tdvnet_torch/csrc/source_variance.cu",
                        "tdvnet/ops/costvolume.py:36", ("source_variance",)),
    "trilinear_sample": ("tdvnet_torch/csrc/trilinear_sample.cu",
                         "tdvnet/ops/sampling.py:199", ("trilinear_sample",)),
    "trilinear_sample_i8": ("tdvnet_torch/csrc/trilinear_sample_i8.cu",
                            "tdvnet/ops/sampling.py:306",
                            ("trilinear_sample_i8",)),
    "patch_fan_variance": ("tdvnet_torch/csrc/patch_fan_variance.cu",
                           "tdvnet/ops/costvolume.py:180",
                           ("patch_fan_variance",)),
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
    "tsdf_integrate": ("tdvnet_torch/csrc/tsdf_integrate.cu",
                       "tdvnet/ops/tsdf.py:42", ("tsdf_integrate",)),
    "consistency_fuse": ("tdvnet_torch/csrc/consistency_fuse.cu",
                         "tdvnet/ops/fusion.py:47", ("consistency_fuse",)),
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


def expected_launches(offsets_list, n_chunks, unet_res, fast_patch=False,
                      n_tables=None):
    """Launches per wrapper in one inference over `n_chunks` ref chunks
    (`infer_depth` is the one-chunk case), counted from the code: the cost
    volume per chunk; per refinement iteration one scene model (point
    cloud variance, voxelize, PointNet with 4 pools and 3 concat-backs,
    scatter, U-Net) and per chunk and offset pass one variance and three
    scale samplings; three propagation blends per chunk. On the fast path
    (`n_tables`, the int8 tables left per iteration: 1 when the scales
    merge into one grid) each pass samples every table with
    `trilinear_sample_i8` in place of the three fp32 samplings, and with
    `fast_patch` takes its variance from `patch_fan_variance`. The 3D
    evaluation's kernels do not run in inference."""
    n_iters = len(offsets_list)
    pf = n_chunks * sum(len(o) for o in offsets_list)   # chunk passes
    gn = sum(a + b for a, b in group_norm_calls(unet_res))
    return {"tsdf_integrate": 0, "consistency_fuse": 0,
            "source_variance": n_chunks + n_iters + (0 if fast_patch else pf),
            "trilinear_sample": 3 * pf if n_tables is None else 0,
            "trilinear_sample_i8": 0 if n_tables is None else n_tables * pf,
            "patch_fan_variance": pf if fast_patch else 0,
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
    inputs on the card, which path makes the call ("infer_depth", "scene"
    for whole-scene inference of a 48-ref scene, or "fast" for the same on
    the fast path) and how often per inference, the bytes it must move and
    the flops it does, its tolerance (0: every output tensor equal;
    BF16_ULP: every element within one bf16 ulp), and where one exists a
    single PyTorch call computing the same function. `run` and `ref`
    return a tensor or a tuple of tensors."""

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


def scene_golden_record(path=SCENE_GOLDEN):
    import numpy as np

    with np.load(path) as z:
        return json.loads(str(z["record"]))


# the kernels whose main path is the fast whole-scene path or one scene's
# 3D evaluation; the others' is infer_depth
MAIN_PATHS = {"trilinear_sample_i8": "fast", "patch_fan_variance": "fast",
              "tsdf_integrate": "eval3d", "consistency_fuse": "eval3d"}


def stream_chunk(device, k):
    """Cameras, ref depths, ref image indices and source index table of the
    first ref chunk of the first streamed scene (refs 0..15 over images
    0..19)."""
    import numpy as np
    import torch

    from tdvnet_torch.config import EvalConfig, ModelConfig
    from tdvnet_torch.ops.sampling import resize_nearest

    CH = EvalConfig().fused_chunk
    views = scene_views(STREAM_VIEWS, STREAM_SEEDS[0])
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[:CH + 2 * k], np.float32)).to(device)
    K, rot, tv = f32(views["K"]), f32(views["rotmats"]), f32(views["tvecs"])
    depth = resize_nearest(torch.from_numpy(views["depth"][k:k + CH]),
                           ModelConfig().depth_test.size).to(device)
    ri = torch.arange(CH, device=device) + k
    src_idx = ri[:, None] + torch.arange(-k, k + 1, device=device)[None]
    return K, rot, tv, depth, ri, src_idx


def fast_cases(device, gen):
    """The fast path's kernels at one chunk pass (16 refs) of the fast golden
    scene, counted per inference of that scene (its chunks x 4 passes, as
    phase 7a launches them): the patch-fan variance of a chunk's hypothesis
    fans, from the first streamed scene's cameras and depths, and the int8
    sampling of the merged, projected table of the golden scene's grid."""
    import torch

    from tdvnet_torch.config import EvalConfig, ModelConfig
    from tdvnet_torch.kernels import patch_fan_variance, trilinear_sample_i8
    from tdvnet_torch.kernels.patchfan import patch_fan_variance_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_i8_ref
    from tdvnet_torch.models.threedvnet import hypothesis_points
    from tdvnet_torch.ops import camera

    cfg, ev = ModelConfig(), EvalConfig()
    rec = scene_golden_record(FAST_SCENE_GOLDEN)
    k = ev.n_src_on_either_side
    per_scene = -(-rec["n_refs"] // ev.fused_chunk) * sum(
        len(o) for o in rec["offsets"])
    K, rot, tv, depth, ri, src_idx = stream_chunk(device, k)
    R, S, N = src_idx.shape[0], src_idx.shape[1], K.shape[0]
    pts = hypothesis_points(depth, K[ri], rot[ri], tv[ri], cfg.img_size,
                            0.05).contiguous()
    Hh, P = pts.shape[1:3]
    H, W = cfg.img_size
    f = cfg.feat_dim
    feats = torch.randn(N, H // 4, W // 4, f, generator=gen).to(device)
    P_all = camera.projection_matrix(K, rot, tv).contiguous()
    mask = torch.ones(R, S, dtype=torch.bool, device=device)
    args = (pts, feats, src_idx, mask, P_all, cfg.img_size)
    cases = [Case(
        "patch_fan_variance", f"[{R},{Hh},{P},{f}] from [{N},{H // 4},"
        f"{W // 4},{f}] x {S} sources", per_scene,
        lambda a=args: patch_fan_variance(*a),
        lambda a=args: patch_fan_variance_ref(*a), 1e-5,
        4 * (pts.numel() + feats.numel() + R * Hh * P * f + P_all.numel()
             + R * S * 3),
        R * S * Hh * P * (24 + 11 * f) + R * Hh * P * f * 4, path="fast")]

    # the merged grid of the golden scene, padded by 3 low-side nodes,
    # projected to fast_rank channels; a fifth of the cells active
    dims = tuple(d + 3 for d in rec["grid_size"])
    C = ev.fast_rank
    edge = cfg.grid.edge_len
    active = torch.rand(1, *dims, 1, generator=gen) < 0.2
    grid = (torch.randint(-127, 128, (1, *dims, C), generator=gen)
            * active).to(torch.int8).to(device).contiguous()
    scale = (torch.rand(1, C, generator=gen) * 0.05 + 1e-3).to(device)
    Q = R * Hh * P
    center0 = (torch.randn(1, 3, generator=gen) * 0.1).to(device)
    extent = torch.tensor(dims, dtype=torch.float32) * edge
    # queries over the grid and a margin around it, so some fall outside
    pts_q = (center0.cpu()[:, None, :] - 3.3 * edge
             + torch.rand(1, Q, 3, generator=gen) * (extent + 0.6)
             ).to(device).contiguous()
    out = torch.empty(1, Q, C, dtype=torch.bfloat16, device=device)
    a = (grid, scale, pts_q, center0, edge)
    cases.append(Case(
        "trilinear_sample_i8", f"int8 [1,{dims[0]}x{dims[1]}x{dims[2]},{C}]"
        f" x {Q} queries", per_scene,
        lambda a=a: trilinear_sample_i8(*a, out, 0, cell_offset=3.0),
        lambda a=a: trilinear_sample_i8_ref(*a, cell_offset=3.0), BF16_ULP,
        grid.numel() + 4 * (scale.numel() + pts_q.numel() + 3) + 2 * Q * C,
        Q * (30 + 17 * C), path="fast"))
    return cases


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
    return cases + fast_cases(device, gen) + eval3d_cases(device)


def eval3d_preds(poses, K0, depth_gt, scene):
    """The golden recipe's `preds.npz` arrays (numpy only, shared with the
    JAX golden's writer): refs k..n-k-1 of a scene with cam->world `poses`
    [n, 4, 4], intrinsics K0 at the GT resolution and the refs' GT depth
    [n - 2k, H, W]; the depth nearest-resized (index floor(dst * in / out) in
    fp32) to `pred_hw`, times 1 + N(0, noise_sigma), a `drop` share of
    pixels zeroed."""
    import numpy as np

    r = EVAL3D
    k, n = r["k"], poses.shape[0]
    img_idx = np.arange(k, n - k)
    R = poses[img_idx, :3, :3].transpose(0, 2, 1)
    t = -np.einsum("nij,nj->ni", R, poses[img_idx, :3, 3])
    (H, W), (h, w) = r["hw"], r["pred_hw"]
    K = np.repeat(np.asarray(K0, np.float32)[None], len(img_idx), 0)
    K[:, 0, :] *= w / W
    K[:, 1, :] *= h / H
    ys = np.floor(np.arange(h, dtype=np.float32) * np.float32(H / h))
    xs = np.floor(np.arange(w, dtype=np.float32) * np.float32(W / w))
    d = depth_gt[:, ys.astype(np.int64)[:, None], xs.astype(np.int64)[None]]
    rng = np.random.default_rng(r["noise_seed"])
    d = d * (1 + rng.normal(0, r["noise_sigma"], d.shape)).astype(np.float32)
    d[rng.random(d.shape) < r["drop"]] = 0
    return {"scene": scene, "depth_preds": d.astype(np.float32),
            "rotmats": R.astype(np.float32), "tvecs": t.astype(np.float32),
            "K": K, "img_idx": img_idx}


def tsdf_check(got, want):
    """K9a against its twin: the share of voxels whose weights are equal,
    and tsdf and colour within K9_ABS (relative to the largest magnitude,
    at least 1) where they are."""
    import torch

    (tt, tw, tc), (rt, rw, rc) = got, want
    agree = tw == rw
    share = float(agree.double().mean())
    err_t = float((tt - rt).abs()[agree].max())
    err_c = float((tc - rc).abs()[agree].max())
    ok = (share >= TSDF_WEIGHT_SHARE
          and err_t <= K9_ABS * max(1.0, float(rt.abs().max()))
          and err_c <= K9_ABS * max(1.0, float(rc.abs().max())))
    log(f"  tsdf_integrate: weights equal on {share:.7f} of "
        f"{agree.numel()} voxels (limit {TSDF_WEIGHT_SHARE}); where equal "
        f"max |d| tsdf {err_t:.3e}, colour {err_c:.3e}; "
        f"{int((rw > 0).sum())} voxels observed")
    return max(err_t, err_c), ok and bool(torch.isfinite(tt).all())


def fuse_check(got, want):
    """K9b against its twin: the share of pixels whose keep flags are equal
    (at least FUSE_KEEP_SHARE), and points within K9_ABS m where both
    keep."""
    (tp, tk), (rp, rk) = got, want
    share = float((tk == rk).double().mean())
    both = tk & rk
    err = float((tp - rp).abs()[both].max()) if bool(both.any()) else 0.0
    log(f"  consistency_fuse: keep equal on {share:.7f} of {tk.numel()} "
        f"pixels (limit {FUSE_KEEP_SHARE}), {int(rk.sum())} kept; points "
        f"max |d| {err:.3e} m where both keep")
    return err, share >= FUSE_KEEP_SHARE and err <= K9_ABS


def eval3d_cases(device):
    """K9a and K9b at the shapes phase 8a gives them, on the recipe's
    predictions of the golden scene rendered here (52 views at 480x640, 48
    refs): the TSDF of all 48 frames in the default EvalConfig's volume
    (voxel 0.04 m, margin 1.5 m) and the first 16-ref fusion chunk against
    all 48 views, the depths nearest-upsampled back to 480x640."""
    import numpy as np
    import torch

    from tdvnet_torch.config import EvalConfig
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.kernels import consistency_fuse, tsdf_integrate
    from tdvnet_torch.kernels.fusion import camera_table, consistency_fuse_ref
    from tdvnet_torch.kernels.tsdf import tsdf_integrate_ref
    from tdvnet_torch.ops.tsdf import volume_bounds

    r, ev = EVAL3D, EvalConfig(**EVAL3D_EVAL)
    k, n = r["k"], r["n_views"]
    sc = synthetic.make_scene(n, tuple(r["hw"]), seed=r["seed"],
                              normalize=False)
    preds = eval3d_preds(sc["poses"], sc["K"][0], sc["depth"][k:n - k],
                         r["scene"])
    depth = synthetic.resize_nearest_np(preds["depth_preds"], r["hw"])
    R, t, N = preds["rotmats"], preds["tvecs"], depth.shape[0]
    K = np.repeat(sc["K"][:1], N, 0)
    P = np.einsum("nij,njk->nik", K, np.concatenate(
        [R, t[..., None]], axis=2)).astype(np.float32)
    lo, dims = volume_bounds(depth, P, ev.tsdf_voxel_size,
                             ev.tsdf_bounds_quantile, ev.tsdf_margin,
                             ev.tsdf_img_batch)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    d_dev = up(depth)
    colors = up((sc["images"][k:n - k] * 255).astype(np.uint8)).float()
    P_dev, origin = up(P), torch.from_numpy(lo)
    H, W = r["hw"]
    V = dims[0] * dims[1] * dims[2]
    targs = (d_dev, colors, P_dev, origin, dims, ev.tsdf_voxel_size,
             ev.tsdf_trunc_ratio)
    cases = [Case(
        "tsdf_integrate", f"{dims[0]}x{dims[1]}x{dims[2]} = {V} voxels x "
        f"{N} frames of {H}x{W}", -(-N // ev.tsdf_img_batch),
        lambda a=targs: tsdf_integrate(*a), lambda a=targs:
            tsdf_integrate_ref(*a), tsdf_check,
        4 * N * H * W * (1 + 3) + 48 * N + 20 * V, 25 * V * N,
        path="eval3d")]

    C = min(FUSION_REF_CHUNK, N)
    cams = camera_table(up(K), up(R), up(t))
    idx = torch.arange(C, device=device)
    fargs = (d_dev[:C], d_dev, cams, idx, ev.z_thresh, ev.n_consistent_thresh)
    _, _, n_valid = consistency_fuse_ref(*fargs, return_counts=True)
    pairs = C * H * W * N
    cases.append(Case(
        "consistency_fuse", f"[{C},{H}x{W}] refs x {N} views",
        -(-N // C), lambda a=fargs: consistency_fuse(*a),
        lambda a=fargs: consistency_fuse_ref(*a), fuse_check,
        4 * N * H * W + 4 * 33 * N + C * H * W * 13,
        45 * pairs + 25 * int(n_valid.sum()), path="eval3d"))
    return cases


def bf16_ulp(m):
    """The spacing of bf16 values at magnitudes m (a tensor)."""
    import torch

    _, e = torch.frexp(m.double())
    return torch.ldexp(torch.ones_like(m, dtype=torch.float64), e - 8)


def check_case(case):
    """Max |kernel - twin| over the outputs and whether it is within the
    tolerance, which is relative to the twin's largest magnitude (at least
    1); a tolerance of 0 asks for equal tensors, BF16_ULP for every element
    within one bf16 ulp of the larger of its two magnitudes, and a callable
    one decides itself: (got, want) -> (max |d|, ok)."""
    import torch

    got, want = case.run(), case.ref()
    torch.cuda.synchronize()
    if callable(case.tol):
        return case.tol(got, want)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err, ok = 0.0, len(got) == len(want)
    for a, b in zip(got, want):
        ok &= a.shape == b.shape and a.dtype == b.dtype
        diff = (a.double() - b.double()).abs()
        d = float(diff.max()) if a.numel() else 0.0
        err = max(err, d)
        if case.tol == 0.0:
            ok &= torch.equal(a, b)
        elif case.tol == BF16_ULP:
            bad = diff > bf16_ulp(torch.maximum(a.abs(), b.abs()))
            if bad.any():
                i = int((diff * bad).argmax())
                log(f"  {int(bad.sum())} of {bad.numel()} elements over one "
                    f"bf16 ulp, worst {float(a.flatten()[i])} vs "
                    f"{float(b.flatten()[i])} at flat index {i}")
            ok &= not bool(bad.any())
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
        tol = getattr(case.tol, "__name__", case.tol)
        log(f"  {case.kernel:18s} {case.label:48s} max|d|={err:.3e} "
            f"{'ok' if good else 'FAIL (tol %s)' % tol} "
            f"kernel={ms:.4f} ms plain={plain:.4f} ms "
            f"library={'%.4f ms' % lib if lib is not None else '-'} "
            f"bound={case.bound_ms:.4f} ms "
            f"({bound_by(case.nbytes, case.flops)}) "
            f"x{case.per_infer} per {case.path}")
        ok &= good
        zero = lambda: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": None, "nbytes": 0.0, "flops": 0.0}
        k = per_kernel.setdefault(case.kernel, {
            "max_abs_err": 0.0, "calls": [], "paths": {}})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        # sums over one inference of that path
        tot = k["paths"].setdefault(case.path, zero())
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
          and counts == expected
          and all(counts[w] > 0 for w, n in expected.items() if n))
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


def scene_golden_phase(inf, device, golden=SCENE_GOLDEN):
    """`predict_scene` on the golden scene against the JAX golden; on the
    fast path also the projection's basis V against the golden's."""
    import numpy as np
    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts

    rec = scene_golden_record(golden)
    with np.load(golden) as z:
        g_mm = z["depth_mm"].astype(np.float32) * 1e-3
        g_V = z["V"] if inf.fast_path else None
    if [tuple(o) for o in rec["offsets"]] != list(inf.offsets_list) \
            or rec["fast_path"] != inf.fast_path:
        raise RuntimeError(f"golden offsets {rec['offsets']} (fast path "
                           f"{rec['fast_path']}) != {inf.offsets_list} "
                           f"(fast path {inf.fast_path})")
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
    # the fast golden's tables merged into one grid (JAX projects only then)
    expected = expected_launches(
        inf.offsets_list, n_chunks, inf.model.cfg.unet_res, inf.fast_patch,
        1 if inf.fast_path and rec["projected"] else None)

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
        f"{FINAL_MEDIAN_ABS:.0e}), p99 {p99:.3e} m (limit "
        f"{FINAL_P99_ABS:.0e})")
    log(f"  abs_rel vs synthetic depth {abs_rel:.6f}, golden "
        f"{rec['abs_rel']:.6f} (limit +-{ABS_REL_DELTA})")
    log(f"  grid {grid} (golden {tuple(rec['grid_size'])}); stats "
        f"{json.dumps(stats)} (golden {json.dumps(rec['stats'])})")
    log(f"  launches in that predict_scene: {json.dumps(counts)} "
        f"(expected {json.dumps(expected)})")
    ok = (finite and depth.shape == g_mm.shape and med <= FINAL_MEDIAN_ABS
          and p99 <= FINAL_P99_ABS
          and abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
          and grid == tuple(rec["grid_size"]) and stats == rec["stats"]
          and counts == expected
          and all(counts[w] > 0 for w, n in expected.items() if n))
    if inf.fast_path:
        V = inf._proj_V.cpu().numpy() if inf._proj_V is not None else None
        v_err = (float(np.minimum(np.abs(V - g_V), np.abs(V + g_V)).max(0)
                       .max()) if V is not None and V.shape == g_V.shape
                 else float("inf"))
        log(f"  fast path: projected={inf.last_projected} (golden "
            f"{rec['projected']}), tables per iteration {inf.last_n_tables},"
            f" V vs golden up to sign max |d| {v_err:.3e} (limit "
            f"{FAST_V_ABS:.0e}), golden tail {rec['tail']:.4f}")
        ok &= bool(rec["projected"] and inf.last_projected
                   and v_err <= FAST_V_ABS)
    return ok, counts


def scene_stream_phase(inf, device, card, golden=SCENE_GOLDEN):
    """`predict_scenes` over a stream of full-length scenes, timed from one
    result to the next. The golden records the JAX package's `abs_rel` on
    the first scene (the later views of these long synthetic scenes are
    harder than the golden scene's): the first scene is held to it and the
    others stay under it plus a slack."""
    import numpy as np
    import torch

    jax_first = scene_golden_record(golden)["stream"]
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
            # the fast path's int8 rounding, bf16 sums and patch anchors
            # flip on smaller differences than the parity path's fp32
            lim = STREAM_ABS_REL_SLACK if inf.fast_path else ABS_REL_DELTA
            good &= (abs(abs_rel - jax_first["abs_rel"]) <= lim
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


def profile_phase(run, what, card, prefix="stage_"):
    """One traced call of `run`: the device's busy share of the host's
    window (the union of the intervals in which a kernel, copy or set ran
    on the card), host and device time under each span named `prefix`...,
    and the top kernels."""
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
            if not (e.is_user_annotation
                    or e.name.startswith(("stage_", "eval_")))]
    if not work:
        raise RuntimeError("the profiler recorded no work on the card")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in work]) / 1e3
    stages = {}
    for e in events:
        if e.name.startswith(prefix):
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
    # event timings of the small calls include the wrapper's host time); a
    # source file's kernels are all named <file>_..._kernel, and a device
    # kernel belongs to the longest file name it holds
    ported = {k: {"ms": 0.0, "launches": 0} for k in KERNEL_META}
    for name, (ms, cnt) in by_name.items():
        owners = [k for k in KERNEL_META if f"{k}_" in name]
        if owners:
            k = max(owners, key=len)
            ported[k]["ms"] += ms
            ported[k]["launches"] += cnt
    for k in KERNEL_META:
        log(f"  port kernel {k:18s} {ported[k]['ms']:8.3f} ms device in "
            f"{ported[k]['launches']} device kernels")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "stages_ms": stages, "ported_kernels": ported}


# ----------------------------------------------------------- 3D evaluation
# the files `harness.main` writes per scene and beside the scenes
EVAL3D_SCENE_FILES = ("preds.npz", "metrics_2d.json",
                      "metrics_3d_0.010_3v_masked.json",
                      "fused_0.010_3v_masked.ply", "tsdf_mesh_masked.ply",
                      "metrics_tsdf_masked.json")
EVAL3D_AVG_FILES = ("metrics_2d.json", "metrics_3d_0.010_3v_masked.json",
                    "metrics_tsdf_masked.json")


def eval3d_record(path=EVAL3D_GOLDEN):
    import numpy as np

    with np.load(path) as z:
        return json.loads(str(z["record"]))


def eval3d_expected_launches(n_refs, ecfg):
    """Launches per wrapper in one scene's depth-3D and TSDF evaluation:
    one fusion per chunk of FUSION_REF_CHUNK refs, one TSDF integration per
    `tsdf_img_batch` frames."""
    from tdvnet_torch.kernels import WRAPPERS

    out = {w: 0 for w in WRAPPERS}
    out["consistency_fuse"] = -(-n_refs // FUSION_REF_CHUNK)
    out["tsdf_integrate"] = -(-n_refs // ecfg.tsdf_img_batch)
    return out


class recording_fused_points:
    """Within the block, every `fuse_point_cloud` of `fusion_module`
    appends its point count (before the downsample) to `counts`."""

    def __init__(self, fusion_module, counts):
        self.mod, self.counts = fusion_module, counts

    def __enter__(self):
        self.inner = inner = self.mod.fuse_point_cloud

        def recorded(*args, **kwargs):
            pts, rgb = inner(*args, **kwargs)
            self.counts.append(int(pts.shape[0]))
            return pts, rgb
        self.mod.fuse_point_cloud = recorded
        return self.counts

    def __exit__(self, *exc):
        self.mod.fuse_point_cloud = self.inner
        return False


def eval3d_metrics_ok(name, want, got):
    """One metrics file against the golden's, with the limits above."""
    ok = set(got) == set(want)
    for k, w in want.items():
        g = got.get(k, float("nan"))
        if k in EVAL3D_ABS:
            good = abs(g - w) <= EVAL3D_ABS[k]
        elif k.startswith("n_") or k == "n":
            good = abs(g - w) <= EVAL3D_COUNT_REL * max(abs(w), 1)
        else:
            good = abs(g - w) <= EVAL3D_REL_2D * max(abs(w), 1e-12)
        if not good:
            log(f"  {name} {k}: {g!r} against the golden's {w!r}")
        ok &= good
    return ok


def eval3d_golden_phase(root, device):
    """The golden scene written here, the recipe's predictions, then the 2D,
    fused-cloud and TSDF metrics with the GT-mesh masking, held to the JAX
    golden; K9 launches counted over the evaluation."""
    import numpy as np
    import torch

    from tdvnet_torch.config import EvalConfig
    from tdvnet_torch.data.synthetic_dataset import make_scene_dir
    from tdvnet_torch.eval import processresults as PR
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.ops import fusion, ply

    rec = eval3d_record()
    if rec["recipe"] != EVAL3D or rec["eval_overrides"] != EVAL3D_EVAL:
        raise RuntimeError(f"golden recipe {rec['recipe']} "
                           f"{rec['eval_overrides']} != {EVAL3D} "
                           f"{EVAL3D_EVAL}")
    r = EVAL3D
    t0 = time.perf_counter()
    scene = make_scene_dir(root, r["scene"], r["n_views"], r["hw"], r["seed"],
                           device)
    write_s = time.perf_counter() - t0
    with open(os.path.join(scene, "info.json")) as f:
        info = json.load(f)
    verts, faces, _ = ply.read_ply(info["gt_mesh"])
    poses = np.stack([np.asarray(fr["pose"], np.float32)
                      for fr in info["frames"]])
    k, n = r["k"], r["n_views"]
    preds = eval3d_preds(poses, info["intrinsics"],
                         PR.load_gt_depth(np.arange(k, n - k), scene),
                         r["scene"])
    save = os.path.join(root, "eval3d_golden")
    os.makedirs(save)
    np.savez(os.path.join(save, "preds.npz"), **preds)
    ecfg = EvalConfig(**EVAL3D_EVAL)
    fused, timings = [], {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recording_fused_points(fusion, fused):
        got = {"metrics_2d.json": PR.process_scene_2d_metrics(
            scene, save, device=device, timings=timings)}
        name3 = (f"metrics_3d_{ecfg.z_thresh:.3f}_"
                 f"{ecfg.n_consistent_thresh}v_masked.json")
        got[name3] = PR.process_depth_3d_metrics(
            scene, save, ecfg, True, device=device, timings=timings)
    eval_s = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(save, "metrics_tsdf_masked.json")) as f:
        got["metrics_tsdf_masked.json"] = json.load(f)
    expected = eval3d_expected_launches(len(preds["img_idx"]), ecfg)

    ok = set(got) == set(rec["metrics"])
    for name, want in rec["metrics"].items():
        m_ok = eval3d_metrics_ok(name, want, got.get(name, {}))
        log(f"  {name}: {json.dumps(got.get(name))} "
            f"{'ok' if m_ok else 'FAIL'}")
        ok &= m_ok
    n_fused = fused[0] if fused else -1
    fused_ok = abs(n_fused - rec["n_fused_points"]) \
        <= EVAL3D_COUNT_REL * rec["n_fused_points"]
    mesh_ok = abs(len(verts) - rec["gt_mesh_vertices"]) \
        <= EVAL3D_MESH_REL * rec["gt_mesh_vertices"]
    log(f"  scene written in {write_s:.2f} s (GT mesh {len(verts)} vertices,"
        f" {len(faces)} faces; golden {rec['gt_mesh_vertices']}, limit "
        f"{EVAL3D_MESH_REL:.1%}); evaluated in {eval_s:.2f} s; fused points "
        f"before the downsample {n_fused} (golden {rec['n_fused_points']})")
    log(f"  stage host seconds: {json.dumps(timings)}")
    log(f"  launches in that evaluation: {json.dumps(counts)} (expected "
        f"{json.dumps(expected)})")
    ok &= fused_ok and mesh_ok and counts == expected
    return ok, counts


def eval3d_config(save_dir):
    import dataclasses

    from tdvnet_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, fast_path=True, save_dir=save_dir, **EVAL3D_EVAL))


def eval3d_stream_phase(model, root, device, card):
    """`harness.main` with the model's fast-path `pred_fn` over three
    scenes written here: s/scene end to end, each stage's share of the
    summed stage seconds, the averaged metrics, every reference-named file;
    then a second call, which must reuse every cached file."""
    import math

    import torch

    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir
    from tdvnet_torch.eval import harness

    cfg = eval3d_config(os.path.join(root, "results"))
    t0 = time.perf_counter()
    scenes = [ensure_scene_dir(root, f"synth_{s:04d}", STREAM_VIEWS,
                               EVAL3D["hw"], s, device)
              for s in EVAL3D_STREAM_SEEDS]
    write_s = time.perf_counter() - t0
    inner = harness.make_3dvnet_pred_fn(model, cfg)
    calls = []

    def pred_fn(views, scene_dir, dset):
        calls.append(scene_dir)
        return inner(views, scene_dir, dset)

    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = harness.main("fast", pred_fn, cfg, scenes=scenes, device=device,
                       timings=timings)
    wall = time.perf_counter() - t0
    save = os.path.join(cfg.eval.save_dir, "fast")
    missing = [os.path.join(os.path.basename(sc), f) for sc in scenes
               for f in EVAL3D_SCENE_FILES
               if not os.path.exists(os.path.join(save, "scenes",
                                                  os.path.basename(sc), f))]
    missing += [f for f in EVAL3D_AVG_FILES
                if not os.path.exists(os.path.join(save, f))]
    total = sum(timings.values())
    shares = {k: v / total for k, v in sorted(timings.items())}
    finite = all(math.isfinite(v) for m in avg.values() for v in m.values())
    log(f"  {len(scenes)} scenes of {STREAM_VIEWS} views written in "
        f"{write_s:.2f} s; harness.main {wall:.3f} s: "
        f"{wall / len(scenes):.3f} s/scene end to end [{card}]")
    log(f"  stage host seconds {json.dumps(timings)}; shares "
        f"{json.dumps({k: round(v, 4) for k, v in shares.items()})}")
    for name, m in sorted(avg.items()):
        log(f"  averaged {name}: {json.dumps(m)}")

    stamp = lambda: {os.path.join(d, f): os.stat(os.path.join(
        save, "scenes", d, f)).st_mtime_ns
        for d in os.listdir(os.path.join(save, "scenes"))
        for f in os.listdir(os.path.join(save, "scenes", d))}
    before, n_calls = stamp(), len(calls)
    t0 = time.perf_counter()
    again = harness.main("fast", pred_fn, cfg, scenes=scenes, device=device)
    again_s = time.perf_counter() - t0
    reused = stamp() == before and len(calls) == n_calls and again == avg
    log(f"  second call {again_s:.3f} s, every cached file reused: {reused};"
        f" missing files: {missing}")
    ok = (not missing and reused and finite and len(calls) == len(scenes)
          and set(avg) == set(EVAL3D_AVG_FILES))
    return ok, {"seconds": wall, "s_per_scene": wall / len(scenes),
                "stage_seconds": timings, "stage_shares": shares,
                "metrics": avg, "second_call_s": again_s}, scenes


def eval3d_trace_phase(model, scene, root, device, card):
    """One scene's evaluation in this thread under the profiler (the
    harness runs the metrics on a thread the profiler does not see): load,
    predict, the 2D, fused-cloud and TSDF metrics, by stage span."""
    from tdvnet_torch.data import frameselector
    from tdvnet_torch.data.dataset import Dataset
    from tdvnet_torch.eval import harness
    from tdvnet_torch.eval.stages import stage

    cfg = eval3d_config(os.path.join(root, "trace"))
    e = cfg.eval
    dset = Dataset([scene], frameselector.NextPoseDistSelector(e.pdist, 20),
                   None, depth_img_size=e.depth_img_size,
                   img_size=cfg.batch.img_size,
                   n_src_on_either_side=e.n_src_on_either_side)
    save = os.path.join(e.save_dir, os.path.basename(scene))
    os.makedirs(save)
    pred_fn = harness.make_3dvnet_pred_fn(model, cfg)

    def run():
        with stage("eval_load"):
            views = dset.load_views(0, seed_idx=0)
        harness.write_scene_preds(views, scene, save, pred_fn, dset, e)
        harness.scene_metrics(scene, save, e, device=device)

    return profile_phase(run, f"3D evaluation of {os.path.basename(scene)}",
                         card, prefix="eval_")


def main():
    import tempfile

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

    log("phase 7a: fast-path predict_scene against the JAX fast golden")
    import dataclasses

    cfg = Config()
    fast = FusedSceneInference(
        model, dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, fast_path=True)), fetch_mm=True)
    fg_ok, fast_counts = scene_golden_phase(fast, device, FAST_SCENE_GOLDEN)
    log("phase 7b: fast-path predict_scenes over the stream")
    fs_ok, fast_stream = scene_stream_phase(fast, device, card,
                                            FAST_SCENE_GOLDEN)
    log("phase 7c: trace of one fast-path scene")
    fast_trace = profile_phase(lambda: fast.predict_scene(views),
                               f"fast predict_scene ({STREAM_VIEWS} views)",
                               card)

    # the datasets of phase 8 live in a temporary directory, removed at the
    # end whatever happens
    with tempfile.TemporaryDirectory(prefix="tdvnet_eval3d_") as root:
        log("phase 8a: 3D evaluation of the golden scene against the JAX "
            "golden")
        e_ok, eval3d_counts = eval3d_golden_phase(root, device)
        log("phase 8b: harness.main over a stream of scenes (fast path, "
            "TSDF on)")
        es_ok, eval3d_stream, scenes = eval3d_stream_phase(model, root,
                                                           device, card)
        log("phase 8c: trace of one scene's 3D evaluation")
        eval3d_trace = eval3d_trace_phase(model, scenes[0], root, device,
                                          card)

    # per kernel, over one run of its main path (the keys of the contract):
    # infer_depth, the fast whole scene for the fast path's kernels, one
    # scene's 3D evaluation for K9; beside them the launches of every
    # wrapper on that path and the launches and sums of the other paths
    kernels = []
    runs = {"infer_depth": (counts, trace), "scene": (scene_counts,
                                                      scene_trace),
            "fast": (fast_counts, fast_trace),
            "eval3d": (eval3d_counts, eval3d_trace)}
    sums = lambda t: t and {x: t[x] for x in (
        "ms", "plain_ms", "bound_ms", "library_ms")}
    for name, k in per_kernel.items():
        src, replaces, wrappers = KERNEL_META[name]
        main_path = MAIN_PATHS.get(name, "infer_depth")
        tot = k["paths"][main_path]
        launches = {p: sum(c[w] for w in wrappers)
                    for p, (c, _) in runs.items()}
        traced = {p: t["ported_kernels"][name]["ms"]
                  for p, (_, t) in runs.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "main_path": main_path,
            "wrappers": {w: runs[main_path][0][w] for w in wrappers},
            "launches": launches[main_path],
            "max_abs_err": k["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by(tot["nbytes"], tot["flops"]),
            "library_ms": tot["library_ms"],
            "trace_ms": traced[main_path],
            "scene_launches": launches["scene"],
            "fast_scene_launches": launches["fast"],
            "eval3d_launches": launches["eval3d"],
            "scene": sums(k["paths"].get("scene")),
            "scene_trace_ms": traced["scene"],
            "fast_scene_trace_ms": traced["fast"],
            "calls": k["calls"]})
    log(json.dumps({"serve_ms": times, "first_infer_ms": first_ms,
                    "ref_frames_per_s": [1e3 * n_refs / t for t in times],
                    "peak_bytes": peak, "card": card, "trace": trace,
                    "scene_stream": stream, "scene_trace": scene_trace,
                    "fast_scene_stream": fast_stream,
                    "fast_scene_trace": fast_trace,
                    "eval3d_stream": eval3d_stream,
                    "eval3d_trace": eval3d_trace}))
    phases = {"kernels": k_ok, "full path": f_ok, "scene golden": g_ok,
              "scene stream": s_ok, "fast scene golden": fg_ok,
              "fast scene stream": fs_ok, "eval3d golden": e_ok,
              "eval3d stream": es_ok}
    if not all(phases.values()):
        log(f"FAILED: {json.dumps(phases)}")
        return 1
    if set(per_kernel) != set(KERNEL_META):
        log(f"FAILED: kernels without a case: "
            f"{sorted(set(KERNEL_META) - set(per_kernel))}")
        return 1
    from tdvnet_torch.kernels import WRAPPERS

    listed = [w for k in kernels for w in k["wrappers"]]
    if sorted(listed) != sorted(WRAPPERS):
        log(f"FAILED: the kernels line lists wrappers {sorted(listed)}, the "
            f"package has {sorted(WRAPPERS)}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
