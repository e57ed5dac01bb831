"""Time K4's forward (the PointNet's pools `segment_max` and concat-backs
`gather_concat`) and K6-int8 (`trilinear_sample_i8`) on the card at their
main-path shapes, with a digest of every output, for comparing trees.

    python -m tdvnet_torch.tools.time_pool_i8 [--iters 20] [--no-captured]
        [--profile]

K4 runs at the batch's size (2 scenes of 7 refs x 56x56 points, a 64^3
grid, 16384 anchors) and at a 52-view scene's (48 refs, the grid
`FusedSceneInference` sizes for the scene cloud, 262144 anchors), C = 128.
Its inputs: "uniform", seeded points in a box a little larger than the
grid, a tenth invalid (`chip_smoke.py`'s uniform cases); "cloud", the scene
cloud at ground-truth depth (the golden batch's; the first streamed
scene's), voxelized by K3 as `ThreeDVNet.scene_dense` voxelizes it, with
seeded features (`chip_smoke.py`'s counted cases); "captured", the first
pool and concat-back of a full-width `infer_depth` of the golden batch and
of a parity `predict_scene` of the streamed scene, from the synth48
weights. A tree whose K4 takes a segment plan (`segmax.segment_plan`)
times the plan once and the pool with the plan built, as `PointNet`
calls it; "standalone_ms" is a pool that builds its own plan.

K6-int8 runs at one chunk pass of the fast path (16 refs x 7 hypotheses x
56x56 queries, C = 96, a merged grid padded by 3 low-side nodes,
`cell_offset` 3): "uniform", seeded queries over the golden scene's grid
and a margin around it with a seeded table, a fifth of its cells active;
"hypothesis", the chunk's hypothesis points of the first streamed scene at
ground-truth depth in the grid `FusedSceneInference` sizes for it, with a
seeded table (`chip_smoke.py`'s counted case); "captured", the first call
of a fast `predict_scene` of the streamed scene.

Per case: the wrapper's mean ms over `--iters` calls (CUDA events), its
byte bound (each input read once, each output written once, at 3.35 TB/s;
K4's pool counts the valid rows of y, its output and the plan, K6-int8 the
grid nodes its taps touch) and a sha256 digest of the output. K4's cases
add the segments' statistics (non-empty segments; valid rows per
non-empty segment: median, p99, largest; the share of rows in segments of
more than 256), K6-int8's the share of queries whose anchor and tap set
equal their predecessor's. `--profile` adds each K4 case's device time per
kernel (torch.profiler), and the plan alone: its device us and device
kernels a call, and beside it the launch floor, where the tree's library
has it (`tdv_segment_plan_floor`): an empty one-block kernel, and an empty
cooperative launch at the plan's own grid with none and with two grid
barriers (device us a call). Every K4 case adds a digest of its plan that
does not depend on the kernel's free orders (`plan_digest`). The last line
is one JSON object. Run it from
each tree's root with that root first on the path, alternating, to read
bit-equality and speed in one call:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_pool_i8.py)
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S

POOL_C = 128                  # 4f: the PointNet's hidden width
I8_C = 96                     # the fast path's rank
I8_PAD = 3                    # the merged grid's low-side nodes
GOLDEN_SCENE_GRID = (64, 48, 32)
LONG_SEGMENT = 256


def digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:            # numpy has no bf16
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


# ------------------------------------------------------------- K4 inputs
def _voxelized(pts, scene, valid, grid, A, B):
    """(point2anchor, point_valid) of K3's voxelization, as the main path
    routes its points."""
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import voxelize_points

    vg = voxelize_points(pts.contiguous(), scene, valid,
                         ModelConfig().grid.edge_len, tuple(grid), A, B)
    return vg.point2anchor, vg.point_valid


def uniform_pool_case(device, gen, P, B, grid, A):
    """K4's args on seeded points in a box a little larger than the grid
    (some fall outside; a tenth are invalid), with seeded features."""
    from tdvnet_torch.config import ModelConfig

    edge = ModelConfig().grid.edge_len
    span = torch.tensor([g * edge * 1.02 for g in grid])
    pts = (torch.rand(P, 3, generator=gen) * span).to(device)
    scene = torch.arange(P, device=device) * B // P
    valid = (torch.rand(P, generator=gen) > 0.1).to(device)
    seg, ok = _voxelized(pts, scene, valid, grid, A, B)
    y = torch.randn(P, POOL_C, generator=gen).to(device)
    return y, seg, ok, A + 1


def batch_cloud(device):
    """The golden batch's scene cloud at its ground-truth depth [R * P, 3]
    with each point's scene and validity, as `scene_dense` flattens it."""
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.models.threedvnet import hypothesis_points
    from tdvnet_torch.ops.sampling import resize_nearest
    from tdvnet_torch.tools.time_variance import golden_batch

    cfg = ModelConfig()
    b = golden_batch().to(device)
    ri = b.ref_idx
    depth = resize_nearest(b.depth_gt, cfg.depth_test.size)
    cloud = hypothesis_points(depth, b.K[ri], b.rotmats[ri], b.tvecs[ri],
                              cfg.img_size, 0.0, n=0)[:, 0]
    P = cloud.shape[1]
    return (cloud.reshape(-1, 3), b.ref_scene.repeat_interleave(P),
            b.ref_mask.repeat_interleave(P), b.n_scenes)


def scene_cloud(inputs):
    """The 48-ref scene cloud of the first streamed scene [R * P, 3] (from
    `time_variance.scene_inputs`) and the grid `FusedSceneInference` sizes
    for it."""
    from tdvnet_torch.tools.time_sampling_gn import scene_grid

    cloud = inputs["scene_cloud"][0].reshape(-1, 3)
    extent = (cloud.amax(dim=0) - cloud.amin(dim=0)).tolist()
    return cloud, scene_grid(extent)


def cloud_pool_cases(device, gen, inputs):
    """{name: (y, seg, valid, n_seg)}: the batch's and the streamed scene's
    clouds voxelized by K3 into the main path's grids, seeded features."""
    from tdvnet_torch.config import EvalConfig, ModelConfig

    g, ev = ModelConfig().grid, EvalConfig()
    out = {}
    pts, scene, valid, B = batch_cloud(device)
    seg, ok = _voxelized(pts, scene, valid, g.grid_size, g.max_anchors, B)
    out["cloud/infer_depth"] = (
        torch.randn(len(pts), POOL_C, generator=gen).to(device), seg, ok,
        g.max_anchors + 1)
    pts, grid = scene_cloud(inputs)
    P = len(pts)
    seg, ok = _voxelized(pts, torch.zeros(P, dtype=torch.int64,
                                          device=device),
                         torch.ones(P, dtype=torch.bool, device=device),
                         grid, ev.eval_max_anchors, 1)
    out["cloud/scene"] = (torch.randn(P, POOL_C, generator=gen).to(device),
                          seg, ok, ev.eval_max_anchors + 1)
    return out


def pool_cases(device, gen, inputs):
    """The uniform and cloud K4 cases at the batch's and the scene's size:
    {name: (y, seg, valid, n_seg)}."""
    from tdvnet_torch.config import EvalConfig, ModelConfig

    cfg, ev = ModelConfig(), EvalConfig()
    g = cfg.grid
    P_ref = cfg.depth_test.size[0] * cfg.depth_test.size[1]
    n_refs = inputs["scene_cloud"][0].shape[0]
    out = {"uniform/infer_depth": uniform_pool_case(
               device, gen, 14 * P_ref, 2, g.grid_size, g.max_anchors),
           "uniform/scene": uniform_pool_case(
               device, gen, n_refs * P_ref, 1, GOLDEN_SCENE_GRID,
               ev.eval_max_anchors)}
    out.update(cloud_pool_cases(device, gen, inputs))
    return out


# --------------------------------------------------------- K6-int8 inputs
def i8_table(gen, dims, device, active=0.2):
    """A seeded [1, *dims, I8_C] int8 table, `active` of its cells non-zero,
    and its per-channel scale [1, I8_C]."""
    on = torch.rand(1, *dims, 1, generator=gen) < active
    grid = (torch.randint(-127, 128, (1, *dims, I8_C), generator=gen) * on
            ).to(torch.int8).to(device).contiguous()
    scale = (torch.rand(1, I8_C, generator=gen) * 0.05 + 1e-3).to(device)
    return grid, scale


def i8_cases(device, gen, inputs):
    """{name: (grid, scale, pts, center0, cell, Ctot, ch_off, cell_offset)}:
    one fast chunk pass on uniform queries over the golden scene's merged
    grid and on the streamed scene's hypothesis points in the grid sized
    for its cloud."""
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.tools.time_sampling_gn import scene_hypothesis_points

    edge = ModelConfig().grid.edge_len
    pts_h, c0_h, dims_h = scene_hypothesis_points(inputs)
    Q = pts_h.shape[1]
    dims = tuple(d + I8_PAD for d in GOLDEN_SCENE_GRID)
    grid, scale = i8_table(gen, dims, device)
    center0 = (torch.randn(1, 3, generator=gen) * 0.1).to(device)
    extent = torch.tensor(dims, dtype=torch.float32) * edge
    pts = (center0.cpu()[:, None, :] - I8_PAD * edge - 0.3
           + torch.rand(1, Q, 3, generator=gen) * (extent + 0.6)
           ).to(device).contiguous()
    out = {"uniform/fast": (grid, scale, pts, center0, edge, I8_C, 0,
                            float(I8_PAD))}
    grid, scale = i8_table(gen, tuple(d + I8_PAD for d in dims_h), device)
    out["hypothesis/fast"] = (grid, scale, pts_h, c0_h, edge, I8_C, 0,
                              float(I8_PAD))
    return out


# ---------------------------------------------------------- captured calls
def captured_inputs(weights, device, views):
    """The first pool and concat-back of a full-width `infer_depth` of the
    golden batch and of a parity `predict_scene` of the streamed scene,
    and the first int8 sampling of a fast `predict_scene` of it, with real
    features and tables from `weights`: ({name: pool args}, {name: concat
    args}, {name: K6-int8 args})."""
    import dataclasses

    from tdvnet_torch.config import Config
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.models import hypothesis, pointnet
    from tdvnet_torch.tools.time_variance import golden_batch
    from tdvnet_torch.weights import load_threedvnet

    sm, gc, i8 = (pointnet.segment_max, pointnet.gather_concat,
                  hypothesis.trilinear_sample_i8)
    pools, concats, samples = {}, {}, {}
    path = ["infer_depth"]
    clone = lambda a: a.clone() if torch.is_tensor(a) else a

    # the fast path's PointNet sees the parity path's first cloud again
    def keep_pool(y, seg, valid, n_seg, *a, **kw):
        if path[0] != "fast":
            pools.setdefault(f"captured/{path[0]}", tuple(
                clone(x) for x in (y, seg, valid)) + (n_seg,))
        return sm(y, seg, valid, n_seg, *a, **kw)

    def keep_concat(y, pooled, seg, relu=False):
        if path[0] != "fast":
            concats.setdefault(f"captured/{path[0]}", tuple(
                clone(x) for x in (y, pooled, seg)) + (relu,))
        return gc(y, pooled, seg, relu)

    def keep_i8(grid, scale, pts, center0, cell, out, ch_off,
                cell_offset=0.0):
        samples.setdefault(f"captured/{path[0]}", tuple(
            clone(x) for x in (grid, scale, pts, center0)) + (
                cell, out.shape[-1], ch_off, cell_offset))
        return i8(grid, scale, pts, center0, cell, out, ch_off, cell_offset)

    model = load_threedvnet(weights, device=device)
    cfg = Config()
    offsets = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
    fast = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, fast_path=True))
    pointnet.segment_max, pointnet.gather_concat = keep_pool, keep_concat
    hypothesis.trilinear_sample_i8 = keep_i8
    try:
        with torch.no_grad():
            model.infer_depth(golden_batch().to(device), offsets)
            path[0] = "scene"
            FusedSceneInference(model, cfg,
                                offsets_list=offsets).predict_scene(views)
            path[0] = "fast"
            FusedSceneInference(model, fast).predict_scene(views)
            torch.cuda.synchronize()
    finally:
        pointnet.segment_max, pointnet.gather_concat = sm, gc
        hypothesis.trilinear_sample_i8 = i8
    return pools, concats, samples


# --------------------------------------------------------- counts, bounds
def segment_stats(seg, valid, n_seg) -> dict:
    """The pool's segments: rows that count (valid, id in range), non-empty
    segments, valid rows per non-empty segment (median, p99, largest) and
    the share of counted rows in segments of more than LONG_SEGMENT."""
    ok = valid & (seg >= 0) & (seg < n_seg)
    counts = torch.bincount(seg[ok], minlength=n_seg)
    nz = counts[counts > 0].double()
    rows = int(ok.sum())
    if not rows:
        return {"n_seg": n_seg, "rows": 0, "non_empty": 0}
    return {"n_seg": n_seg, "rows": rows, "non_empty": int(nz.numel()),
            "median": float(nz.median()),
            "p99": float(torch.quantile(nz, 0.99)), "max": int(nz.max()),
            "share_over_long": float(nz[nz > LONG_SEGMENT].sum()) / rows}


def pool_bytes(y, seg, valid, n_seg) -> int:
    """A pool's bound: the counted rows of y read once, the output written
    once, and the plan (offsets and row list) read once."""
    rows = int((valid & (seg >= 0) & (seg < n_seg)).sum())
    C = y.shape[1]
    return 4 * (rows * C + n_seg * C + n_seg + 1 + rows)


def plan_bytes(seg, valid, n_seg) -> int:
    """The plan's bound: ids and flags read once, offsets and row list
    written once."""
    rows = int((valid & (seg >= 0) & (seg < n_seg)).sum())
    return 9 * seg.numel() + 4 * (n_seg + 1 + rows)


def concat_bytes(y, pooled, seg) -> int:
    """A concat-back's bound: y and the ids read once, each pooled row a
    point names read once, the [P, 2C] output written once."""
    P, C = y.shape
    used = torch.unique(seg.clamp(0, pooled.shape[0] - 1)).numel()
    return 4 * (P * C + 2 * P + used * C + 2 * P * C)


def i8_coords(pts, center0, cell, cell_offset):
    """Node coordinates (pts - center0) / cell + cell_offset, as the kernel
    computes them (a true division by a tensor, then the add)."""
    cell_t = torch.tensor(cell, dtype=torch.float32, device=pts.device)
    return (pts - center0[:, None, :]) / cell_t + cell_offset


def i8_anchor_keys(grid_shape, pts, center0, cell, cell_offset):
    """Per query [B * Q]: the anchor's flat node index (-1 when it is out of
    range or a coordinate is not finite) and the mask of its in-grid
    taps."""
    B, X, Y, Z = grid_shape[:4]
    dims = torch.tensor([X, Y, Z], device=pts.device)
    f = torch.floor(i8_coords(pts, center0, cell, cell_offset))
    ok = torch.isfinite(f).all(-1) & (f >= -1).all(-1) \
        & (f <= (dims - 1)).all(-1)
    a = torch.where(ok[..., None], f, torch.zeros_like(f)).long()
    b = torch.arange(B, device=pts.device)[:, None]
    key = torch.where(ok, ((b * X + a[..., 0]) * Y + a[..., 1]) * Z
                      + a[..., 2], torch.full_like(a[..., 0], -1))
    mask = torch.zeros_like(key)
    for k in range(8):
        i = a + torch.tensor([k >> 2, k >> 1 & 1, k & 1], device=a.device)
        inb = ((i >= 0) & (i < dims)).all(-1) & ok
        mask |= inb.long() << k
    return key.reshape(-1), mask.reshape(-1)


def i8_repeat_share(grid_shape, pts, center0, cell, cell_offset) -> float:
    """Share of queries (in the kernel's flat order) whose anchor and tap
    set equal their predecessor's."""
    key, mask = i8_anchor_keys(grid_shape, pts, center0, cell, cell_offset)
    if key.numel() < 2:
        return 0.0
    same = (key[1:] == key[:-1]) & (mask[1:] == mask[:-1]) & (key[1:] >= 0)
    return float(same.double().sum()) / key.numel()


def i8_touched(grid_shape, pts, center0, cell, cell_offset) -> int:
    """Distinct in-grid nodes that the queries' taps read."""
    B, X, Y, Z = grid_shape[:4]
    key, mask = i8_anchor_keys(grid_shape, pts, center0, cell, cell_offset)
    keys = []
    for k in range(8):
        on = (mask >> k & 1).bool()
        keys.append(key[on] + (k >> 2) * Y * Z + (k >> 1 & 1) * Z + (k & 1))
    return int(torch.unique(torch.cat(keys)).numel())


def i8_bytes(args) -> int:
    """K6-int8's bound: the touched int8 nodes, the points, centres and
    scales read once, the bf16 samples written once."""
    grid, scale, pts, center0, cell, _, _, cell_offset = args
    B, Q = pts.shape[:2]
    C = grid.shape[-1]
    return (i8_touched(grid.shape, pts, center0, cell, cell_offset) * C
            + 4 * (pts.numel() + center0.numel() + scale.numel())
            + 2 * B * Q * C)


def plan_digest(plan) -> str:
    """sha256 over what a segment plan fixes: the offsets, the work
    partition up to its last specified entry, the number of long segments
    and their sorted ids, and each segment's rows sorted (the kernel places
    rows within a segment, and lists the long ids, in a free order)."""
    from tdvnet_torch.kernels.segmax import SEGMENT_WORK

    offsets = plan.offsets.long().cpu()
    n_seg = len(offsets) - 1
    total = int(offsets[-1])
    ids = torch.repeat_interleave(torch.arange(n_seg), offsets.diff())
    P = len(plan.rows)
    rows = torch.sort(ids * P + plan.rows[:total].long().cpu())[0] % max(P, 1)
    n_long = int(plan.longs[0])
    longs = torch.sort(plan.longs[1:1 + n_long].cpu())[0]
    last = (total + n_seg) // SEGMENT_WORK + 1
    h = hashlib.sha256()
    for t in (plan.offsets.cpu(), plan.first[:last + 1].cpu(),
              plan.longs[:1].cpu(), longs, rows.to(torch.int32)):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# ------------------------------------------------------------------ timing
def profile_calls(fn, n=5, tries=3) -> dict:
    """{kernel name: (device microseconds a call, launches a call)} of the
    kernels `fn` launches, over n traced calls. A trace that holds no
    kernel at all is taken again, up to `tries` times (the profiler now
    and then drops every kernel of a short trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                us, k = out.get(e.name, (0.0, 0.0))
                out[e.name] = (us + e.time_range.elapsed_us() / n, k + 1 / n)
        if out:
            break
    return out


def profile_us(fn, n=5) -> dict:
    """Device microseconds per call of each kernel `fn` launches, over n
    traced calls."""
    return {k: us for k, (us, _) in profile_calls(fn, n).items()}


def launch_floor(P, n_seg, iters) -> dict:
    """The launch floor of a plan call where the library has it: device us
    a call (torch.profiler) and event ms of an empty one-block kernel, and
    of an empty cooperative launch at the plan's grid for (P, n_seg) with
    none and with two grid barriers; {} for a tree without it."""
    from tdvnet_torch.kernels._launch import launch
    from tdvnet_torch.kernels.build import library
    from tdvnet_torch.tools.timing import time_ms

    if not hasattr(library(), "tdv_segment_plan_floor"):
        return {}
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, args in (("empty_one_block", (0, 0, 0)),
                       ("empty_plan_grid", (P, n_seg, 0)),
                       ("plan_grid_2_barriers", (P, n_seg, 2))):
        run = lambda a=args: launch("tdv_segment_plan_floor", dev, *a)
        out[name] = {"device_us": sum(profile_us(run).values()),
                     "ms": time_ms(run, iters=iters, warmup=3)}
    return out


def time_pools(named, iters, profile):
    from tdvnet_torch.kernels import segmax
    from tdvnet_torch.tools.timing import time_ms

    planned = hasattr(segmax, "segment_plan")
    rec = {}
    for name, (y, seg, valid, n_seg) in named.items():
        stand = lambda: segmax.segment_max(y, seg, valid, n_seg)
        r = {"standalone_ms": time_ms(stand, iters=iters, warmup=3),
             "bound_ms": 1e3 * pool_bytes(y, seg, valid, n_seg)
             / HBM_BYTES_PER_S,
             "plan_bound_ms": 1e3 * plan_bytes(seg, valid, n_seg)
             / HBM_BYTES_PER_S,
             "stats": segment_stats(seg, valid, n_seg),
             "shape": [list(y.shape), n_seg]}
        run = stand
        if planned:
            plan = segmax.segment_plan(seg, valid, n_seg)
            run = lambda: segmax.segment_max(y, seg, valid, n_seg, plan=plan)
            r["plan_ms"] = time_ms(
                lambda: segmax.segment_plan(seg, valid, n_seg), iters=iters,
                warmup=3)
            r["plan_digest"] = plan_digest(plan)
        r["ms"] = time_ms(run, iters=iters, warmup=3)
        r["digest"] = digest(run())
        idx = seg.clamp(0, n_seg - 1)[:, None].expand(y.shape)
        yv = torch.where(valid[:, None], y, torch.full_like(y, -1e30))
        base = torch.full((n_seg, y.shape[1]), -1e30, device=y.device)
        r["library_ms"] = time_ms(lambda: base.scatter_reduce(
            0, idx, yv, "amax"), iters=iters, warmup=3)
        if profile:
            r["profile_us"] = profile_us(run)
            if planned:
                calls = profile_calls(
                    lambda: segmax.segment_plan(seg, valid, n_seg))
                r["plan_profile_us"] = {k: us for k, (us, _) in
                                        calls.items()}
                r["plan_device_us"] = sum(us for us, _ in calls.values())
                r["plan_device_kernels"] = sum(k for _, k in calls.values())
                r["launch_floor"] = launch_floor(len(seg), n_seg, iters)
        rec[name] = r
    return rec


def time_concats(named, iters, profile):
    from tdvnet_torch.kernels import segmax
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for name, (y, pooled, seg, relu) in named.items():
        run = lambda: segmax.gather_concat(y, pooled, seg, relu)
        rec[name] = {"ms": time_ms(run, iters=iters, warmup=3),
                     "bound_ms": 1e3 * concat_bytes(y, pooled, seg)
                     / HBM_BYTES_PER_S, "digest": digest(run()),
                     "shape": [list(y.shape), pooled.shape[0]]}
        if profile:
            rec[name]["profile_us"] = profile_us(run)
    return rec


def time_i8(named, iters):
    from tdvnet_torch.kernels import trilinear
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for name, a in named.items():
        grid, scale, pts, center0, cell, n_ch, off, c_off = a
        out = torch.zeros(*pts.shape[:2], n_ch, dtype=torch.bfloat16,
                          device=grid.device)
        run = lambda: trilinear.trilinear_sample_i8(
            grid, scale, pts, center0, cell, out, off, cell_offset=c_off)
        ms = time_ms(run, iters=iters, warmup=3)
        out.zero_()
        run()
        C = grid.shape[-1]
        rec[name] = {"ms": ms, "bound_ms": 1e3 * i8_bytes(a)
                     / HBM_BYTES_PER_S,
                     "repeat_share": i8_repeat_share(grid.shape, pts,
                                                     center0, cell, c_off),
                     "digest": digest(out[..., off:off + C]),
                     "shape": [list(grid.shape), list(pts.shape)]}
    return rec


def concat_cases(pools):
    """Each pool case's concat-back (ReLU on, as `PointNet` calls it) on the
    pool's own output."""
    from tdvnet_torch.kernels import segmax

    return {name: (y, segmax.segment_max(y, seg, valid, n_seg), seg, True)
            for name, (y, seg, valid, n_seg) in pools.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-captured", action="store_true",
                    help="time the seeded inputs only")
    ap.add_argument("--profile", action="store_true",
                    help="add K4's device time per kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_pool_i8: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    import tdvnet_torch
    from tdvnet_torch.config import set_fp32_numerics
    from tdvnet_torch.tools.time_variance import scene_inputs, stream_views
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tdvnet_torch.__file__)))
    device = torch.device("cuda")
    set_fp32_numerics()
    gen = torch.Generator().manual_seed(0)
    views = stream_views()
    inputs = scene_inputs(device, gen, views)
    pools = pool_cases(device, gen, inputs)
    i8 = i8_cases(device, gen, inputs)
    concats = concat_cases(pools)
    if not args.no_captured:
        p, c, s = captured_inputs(
            os.path.join(root, "weights", "3dvnet_synth48.npz"), device,
            views)
        pools.update(p)
        concats.update(c)
        i8.update(s)
    rec = {"root": root, "card": card,
           "pool": time_pools(pools, args.iters, args.profile),
           "concat": time_concats(concats, args.iters, args.profile),
           "i8": time_i8(i8, args.iters)}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
