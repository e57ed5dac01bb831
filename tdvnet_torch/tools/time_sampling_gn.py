"""Time the scene sampling K6 (`trilinear_sample`, forward) and the masked
GroupNorm K5 (`masked_group_norm`, forward) on the card at their main-path
shapes, with a digest of every output, for comparing trees.

    python -m tdvnet_torch.tools.time_sampling_gn [--iters 20]
        [--no-captured]

K6 runs at the three U-Net scales of one offset pass: `infer_depth`'s on
the golden batch (2 scenes, 7 refs each, 64^3 grid) and the whole
scene's at a 16-ref chunk. Its inputs: "uniform", seeded points over the
golden scene's 64x48x32 grid (and the batch's) and a margin around it
(the cases of `chip_smoke.py`'s first rows, which reach the out-of-grid
taps); "hypothesis", the PointFlow hypothesis points of the golden batch
and of one chunk of the first streamed 52-view scene at their
ground-truth depth (`time_variance.scene_inputs`), in (ref, hypothesis,
pixel) order, each grid's origin at its scene cloud's bounding-box
minimum as voxelization places it, the scene's grid sized as
`FusedSceneInference` sizes it; "captured", the first call of each shape
in a full-width `infer_depth` of the golden batch and a `predict_scene`
of the streamed scene, from the synth48 weights. K5 runs at every U-Net
level of both shapes with its two tails: "synthetic", seeded masks (15%
active) and features; "captured", the same two runs' calls.

The last line is one JSON object: per case the wrapper's mean ms over
`--iters` calls (CUDA events), its byte bound (inputs read once, outputs
written once, at 3.35 TB/s), a sha256 digest of its output and, for K5,
the [B*G, 4] statistics it returned. Run it from each tree's root with
that root first on the path, alternating, to read bit-equality and speed
in one call:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_sampling_gn.py)
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S

SCENE_GRID = (64, 48, 32)        # the golden scene's grid
GN_ACTIVE = 0.15


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


# ------------------------------------------------------------- K6 inputs
def _scales(device, gen, B, dims0, pts, center0, label):
    """{label/s=k: (grid, pts, center0, cell, Ctot, ch_off)} over the three
    U-Net scales, seeded normal grids."""
    from tdvnet_torch.config import ModelConfig

    cfg = ModelConfig()
    edge = cfg.grid.edge_len
    n_ch = sum(cfg.unet_dims)
    out, off = {}, 0
    for stride, C in zip((1, 2, 4), cfg.unet_dims):
        dims = tuple(d // stride for d in dims0)
        grid = torch.randn(B, *dims, C, generator=gen).to(device)
        out[f"{label}/s={stride}"] = (grid, pts, center0, stride * edge,
                                      n_ch, off)
        off += C
    return out


def uniform_points(device, gen, B, Q, dims0):
    """(pts [B, Q, 3], center0 [B, 3]): points over the grid and a 0.3 m
    margin around it, as `chip_smoke.py`'s uniform cases place them."""
    from tdvnet_torch.config import ModelConfig

    edge = ModelConfig().grid.edge_len
    origins = torch.randn(B, 3, generator=gen) * 0.1
    extent = torch.tensor(dims0, dtype=torch.float32) * edge
    pts = origins[:, None, :] - 0.3 + torch.rand(B, Q, 3, generator=gen) \
        * (extent + 0.6)
    return (pts.to(device).contiguous(),
            (origins + 0.5 * edge).to(device).contiguous())


def _bbox_min(cloud):
    """[B, 3] the minimum of each scene's cloud [B, P, 3] (every point
    valid), where voxelization puts the grid's origin."""
    return cloud.amin(dim=1)


def batch_hypothesis_points(device):
    """The golden batch's PointFlow points at its ground-truth depth
    [2, 7 refs * 7 * 3136, 3] and the grid's node-0 centre [2, 3]."""
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.models.threedvnet import hypothesis_points
    from tdvnet_torch.ops.sampling import resize_nearest
    from tdvnet_torch.tools.time_variance import HYP_OFFSET, golden_batch

    cfg = ModelConfig()
    b = golden_batch().to(device)
    ri = b.ref_idx
    depth = resize_nearest(b.depth_gt, cfg.depth_test.size)
    cams = (b.K[ri], b.rotmats[ri], b.tvecs[ri])
    hyp = hypothesis_points(depth, *cams, cfg.img_size, HYP_OFFSET)
    cloud = hypothesis_points(depth, *cams, cfg.img_size, 0.0, n=0)
    B = b.n_scenes
    origins = _bbox_min(cloud.reshape(B, -1, 3))
    return (hyp.reshape(B, -1, 3).contiguous(),
            (origins + 0.5 * cfg.grid.edge_len).contiguous())


def scene_grid(extent):
    """The grid dims `FusedSceneInference` picks for a scene cloud of this
    bbox extent (its `_grid_from_extent`: `grid_bucket` multiples, capped
    at `eval_grid_size`)."""
    import math

    from tdvnet_torch.config import EvalConfig, ModelConfig

    ev, edge = EvalConfig(), ModelConfig().grid.edge_len
    b = ev.grid_bucket
    dims = []
    for e, cap in zip(extent, ev.eval_grid_size):
        need = math.ceil(e / edge) + 2
        dims.append(min(-(-need // b) * b, max(cap // b * b, b)))
    return tuple(dims)


def scene_hypothesis_points(inputs):
    """From `time_variance.scene_inputs`' dict: one 16-ref chunk's PointFlow
    points of the streamed scene [1, 16 * 7 * 3136, 3], the node-0 centre
    [1, 3] of a grid at the 48-ref scene cloud's minimum, and the grid's
    dims as `FusedSceneInference` sizes them for that cloud (64x64x32 for
    the first streamed scene, whose cloud spans 4.03 m along y: the golden
    scene's 64x48x32 would leave 63% of the chunk's points outside)."""
    from tdvnet_torch.config import ModelConfig

    pts = inputs["pointflow"][0].reshape(1, -1, 3).contiguous()
    cloud = inputs["scene_cloud"][0].reshape(1, -1, 3)
    origin = _bbox_min(cloud)
    dims = scene_grid((cloud.amax(dim=1) - origin)[0].tolist())
    return (pts, (origin + 0.5 * ModelConfig().grid.edge_len).contiguous(),
            dims)


def k6_inputs(device, gen, views=None):
    """{name: (grid, pts, center0, cell, Ctot, ch_off)}: the batch's and a
    scene chunk's three scales on uniform and on hypothesis points."""
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.tools.time_variance import scene_inputs

    cfg = ModelConfig()
    g = cfg.grid
    out = {}
    pts_b, c0_b = batch_hypothesis_points(device)
    pts_s, c0_s, dims_s = scene_hypothesis_points(
        scene_inputs(device, gen, views))
    for label, B, dims, hyp in (
            ("infer_depth", 2, g.grid_size, (pts_b, c0_b, g.grid_size)),
            ("scene", 1, SCENE_GRID, (pts_s, c0_s, dims_s))):
        Q = hyp[0].shape[1]
        out.update(_scales(device, gen, B, dims,
                           *uniform_points(device, gen, B, Q, dims),
                           f"uniform/{label}"))
        out.update(_scales(device, gen, B, hyp[2], *hyp[:2],
                           f"hypothesis/{label}"))
    return out


def touched_cells(grid_shape, pts, center0, cell) -> int:
    """Distinct in-grid nodes that the points' 8 taps read (the grid bytes
    this data needs: the rest of the grid is never read)."""
    B, X, Y, Z = grid_shape[:4]
    cell_t = torch.tensor(cell, dtype=torch.float32, device=pts.device)
    q = torch.floor((pts - center0[:, None, :]) / cell_t)
    ok = torch.isfinite(q).all(-1)
    q = torch.where(ok[..., None], q, torch.full_like(q, -2.0)).long()
    b = torch.arange(B, device=pts.device)[:, None].expand(q.shape[:2])
    keys = []
    for k in range(8):
        i = q + torch.tensor([k >> 2, k >> 1 & 1, k & 1], device=q.device)
        inb = ((i >= 0) & (i < torch.tensor([X, Y, Z],
                                             device=q.device))).all(-1)
        key = ((b * X + i[..., 0]) * Y + i[..., 1]) * Z + i[..., 2]
        keys.append(key[inb])
    return int(torch.unique(torch.cat(keys)).numel())


def k6_bytes(args) -> int:
    """The byte bound's count: the touched grid nodes, the points and the
    node-0 centres read once, the [B, Q, C] samples written once."""
    grid, pts, center0, cell, _, _ = args
    B, Q = pts.shape[:2]
    C = grid.shape[-1]
    return 4 * (touched_cells(grid.shape, pts, center0, cell) * C
                + pts.numel() + center0.numel() + B * Q * C)


# ------------------------------------------------------------- K5 inputs
def k5_inputs(device, gen):
    """{name: (x, mask, G, weight, bias, kwargs)} at every U-Net level of
    the batch (2 x 64^3) and of the golden scene (64x48x32), each tail."""
    from tdvnet_torch.config import ModelConfig

    cfg = ModelConfig()
    out = {}
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    for label, B, grid in (("infer_depth", 2, cfg.grid.grid_size),
                           ("scene", 1, SCENE_GRID)):
        for lvl, (C, G) in enumerate(zip(cfg.unet_dims, cfg.unet_groups)):
            dims = tuple(d >> lvl for d in grid)
            mask = (torch.rand(B, 1, *dims, generator=gen)
                    < GN_ACTIVE).float()
            if B > 1:
                mask[-1, :, dims[0] // 2:] = 0   # scenes differ in count
            mask = mask.to(device)
            x = (rnd(B, C, *dims) * 2 + 1) * mask
            skip = rnd(B, C, *dims) * mask
            w, b = rnd(C), rnd(C)
            for tail, kw in (("relu", {"relu": True}), ("skip",
                                                        {"skip": skip})):
                out[f"synthetic/{label}/L{lvl}/{tail}"] = (x, mask, G, w, b,
                                                          kw)
    return out


def k5_bytes(args) -> int:
    x, mask, _, w, _, kw = args
    n_in = 2 if kw.get("skip") is not None else 1
    return 4 * (x.numel() * (n_in + 1) + mask.numel() + 2 * w.numel())


# ---------------------------------------------------------- captured calls
def captured_inputs(weights, device, views=None):
    """The first call of each shape that a full-width `infer_depth` of the
    golden batch and a parity `predict_scene` of the streamed scene make to
    K6 and K5, with real grids and features from `weights`:
    ({name: K6 args}, {name: K5 args})."""
    from tdvnet_torch.config import Config
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.models import hypothesis, layers
    from tdvnet_torch.tools.time_variance import golden_batch, stream_views
    from tdvnet_torch.weights import load_threedvnet

    tri, gn = hypothesis.trilinear_sample, layers.masked_group_norm
    k6, k5 = {}, {}
    path = ["infer_depth"]
    clone = lambda a: a.clone() if torch.is_tensor(a) else a

    def keep_tri(grid, pts, center0, cell, out, ch_off):
        name = (f"captured/{path[0]}/[{grid.shape[0]},{grid.shape[1]}x"
                f"{grid.shape[2]}x{grid.shape[3]},{grid.shape[4]}]")
        k6.setdefault(name, tuple(clone(a) for a in (
            grid, pts, center0, cell)) + (out.shape[-1], ch_off))
        return tri(grid, pts, center0, cell, out, ch_off)

    def keep_gn(x, mask, num_groups, weight, bias, eps=1e-5, relu=False,
                skip=None):
        tail = "skip" if skip is not None else ("relu" if relu else "none")
        name = (f"captured/{path[0]}/[{x.shape[0]},{x.shape[1]},"
                f"{x.shape[2]}x{x.shape[3]}x{x.shape[4]}]/{tail}")
        kw = {"skip": clone(skip)} if skip is not None else {"relu": relu}
        k5.setdefault(name, (clone(x), clone(mask), num_groups,
                             clone(weight), clone(bias), kw))
        return gn(x, mask, num_groups, weight, bias, eps, relu, skip)

    model = load_threedvnet(weights, device=device)
    views = stream_views() if views is None else views
    offsets = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
    hypothesis.trilinear_sample, layers.masked_group_norm = keep_tri, keep_gn
    try:
        with torch.no_grad():
            model.infer_depth(golden_batch().to(device), offsets)
            path[0] = "scene"
            FusedSceneInference(model, Config(),
                                offsets_list=offsets).predict_scene(views)
            torch.cuda.synchronize()
    finally:
        hypothesis.trilinear_sample, layers.masked_group_norm = tri, gn
    return k6, k5


# ------------------------------------------------------------------ timing
def time_k6(named, iters):
    from tdvnet_torch.kernels.trilinear import trilinear_sample
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for name, a in named.items():
        grid, pts, center0, cell, n_ch, off = a
        out = torch.zeros(*pts.shape[:2], n_ch, device=grid.device)
        run = lambda: trilinear_sample(grid, pts, center0, cell, out, off)
        ms = time_ms(run, iters=iters, warmup=3)
        out.zero_()
        run()
        C = grid.shape[-1]
        rec[name] = {"ms": ms, "bound_ms": 1e3 * k6_bytes(a)
                     / HBM_BYTES_PER_S,
                     "digest": digest(out[..., off:off + C]),
                     "shape": [list(grid.shape), list(pts.shape)]}
    return rec


def time_k5(named, iters):
    from tdvnet_torch.kernels import groupnorm
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for name, (x, mask, G, w, b, kw) in named.items():
        run = lambda: groupnorm._masked_group_norm(
            x, mask, G, w, b, 1e-5, kw.get("relu", False), kw.get("skip"))
        ms = time_ms(run, iters=iters, warmup=3)
        out, stats = run()
        rec[name] = {"ms": ms, "bound_ms": 1e3 * k5_bytes(
            (x, mask, G, w, b, kw)) / HBM_BYTES_PER_S,
            "digest": digest(out), "stats": stats.cpu().tolist(),
            "shape": list(x.shape)}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-captured", action="store_true",
                    help="time the seeded inputs only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sampling_gn: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    import tdvnet_torch
    from tdvnet_torch.config import set_fp32_numerics
    from tdvnet_torch.tools.time_variance import stream_views
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tdvnet_torch.__file__)))
    device = torch.device("cuda")
    set_fp32_numerics()
    gen = torch.Generator().manual_seed(0)
    views = stream_views()
    rec = {"root": root, "card": card,
           "k6": time_k6(k6_inputs(device, gen, views), args.iters),
           "k5": time_k5(k5_inputs(device, gen), args.iters)}
    if not args.no_captured:
        k6, k5 = captured_inputs(
            os.path.join(root, "weights", "3dvnet_synth48.npz"), device,
            views)
        rec["k6"].update(time_k6(k6, args.iters))
        rec["k5"].update(time_k5(k5, args.iters))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
