"""Time the two variance kernels, K1 `source_variance` and K7
`patch_fan_variance`, on the card at their main-path shapes, for comparing
trees.

    python -m tdvnet_torch.tools.time_variance [--iters 20] [--ablate]
        [--no-captured]

Shapes: K1 at `infer_depth`'s three calls on the golden batch (the cost
volume [14, 96*3136, 32], the scene cloud [14, 3136, 32], the PointFlow
hypotheses [14, 7*3136, 32]; 3 sources) and at the whole scene's three on a
52-view stream scene (a 16-ref chunk's cost volume and PointFlow pass, the
48-ref scene cloud; 5 sources); K7 at the fast path's chunk pass
[16, 7, 3136, 32]. Inputs: "synthetic", seeded normal feature maps over
those cameras and the scene's ground-truth depth (the inputs of
`chip_smoke.py`'s cases), and "captured", the arguments of the first call
of each shape in a full-width `infer_depth` of the golden batch and in a
`predict_scene` of the stream scene on the parity and the fast path, from
the synth48 weights. Its last line is one JSON object: per input set and
shape the kernel's mean ms over `--iters` calls (CUDA events), its byte
bound (inputs read once, the output written once, at 3.35 TB/s) and a
sha256 digest of its output (K1's variance and mean), which must match
between trees whose kernels keep their bits.

`--ablate` adds each shape with every source masked as padding: the
projections, the per-source loop and the stores without a tap read. To
compare two trees in one call, run it from each tree's root with that root
first on the path, alternating:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_variance.py)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S

STREAM_VIEWS = 52
STREAM_SEED = 7
GOLDEN_SEEDS = (0, 1)
HYP_OFFSET = 0.05


def golden_batch(seeds=GOLDEN_SEEDS):
    from tdvnet_torch.config import BatchConfig
    from tdvnet_torch.data import batch as B, synthetic

    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(
        bc.n_views, bc.img_size, bc.depth_img_size, seed=s,
        n_src_on_either_side=bc.n_src_on_either_side) for s in seeds]
    return B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                            bc.n_src_on_either_side)


def stream_views(n_views=STREAM_VIEWS, seed=STREAM_SEED):
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.data import synthetic

    return synthetic.make_scene(n_views=n_views,
                                img_size=ModelConfig().img_size, seed=seed)


def scene_refs(views, device, first, n_refs, k):
    """Cameras of images first .. first + n_refs + 2k - 1 of a scene, the
    ground-truth depth of its refs (images first + k ..) at the depth map's
    size, the refs' image indices and their source index table (k either
    side, as `FusedSceneInference` builds it)."""
    import numpy as np

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.ops.sampling import resize_nearest

    sl = slice(first, first + n_refs + 2 * k)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[sl], np.float32)).to(device)
    K, rot, tv = f32(views["K"]), f32(views["rotmats"]), f32(views["tvecs"])
    depth = resize_nearest(
        torch.from_numpy(views["depth"][first + k:first + k + n_refs]),
        ModelConfig().depth_test.size).to(device)
    ri = torch.arange(n_refs, device=device) + k
    src_idx = ri[:, None] + torch.arange(-k, k + 1, device=device)[None]
    return K, rot, tv, depth, ri, src_idx


def _variance_args(pts, feats, src_idx, P_all):
    from tdvnet_torch.config import ModelConfig

    mask = torch.ones(src_idx.shape, dtype=torch.bool, device=feats.device)
    return (pts.contiguous(), feats, src_idx, mask, P_all.contiguous(),
            ModelConfig().img_size)


def variance_bytes(args) -> int:
    """The byte bound's count: points, feature maps and projections read
    once, the source table read once, the output written once."""
    pts, feats, src_idx, _, P_all = args[:5]
    out = pts[..., 0].numel() * feats.shape[-1]
    return 4 * (pts.numel() + feats.numel() + out + P_all.numel()
                + src_idx.numel() * 3)


def infer_depth_inputs(device, gen):
    """K1's three `infer_depth` calls on the golden batch's cameras:
    {name: args}."""
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.ops import camera

    cfg = ModelConfig()
    dc = cfg.depth_test
    b = golden_batch().to(device)
    H, W = cfg.img_size
    feats = torch.randn(b.n_imgs, H // 4, W // 4, cfg.feat_dim,
                        generator=gen).to(device)
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs)
    ri = b.ref_idx
    out = {}
    for name, planes in (("cost_volume", dc.n_intervals), ("scene_cloud", 1),
                         ("pointflow", 7)):
        interval = dc.depth_interval * (dc.n_intervals - 1) / max(planes - 1,
                                                                   1)
        pts = camera.plane_sweep_points(
            dc.depth_start, interval, planes, b.rotmats[ri], b.tvecs[ri],
            b.K[ri], cfg.img_size, dc.size)
        out[name] = _variance_args(pts, feats, b.src_idx, P_all)
    return out


def scene_inputs(device, gen, views=None):
    """K1's three whole-scene calls on the stream scene (a chunk's cost
    volume and PointFlow pass, the 48-ref scene cloud at the refs'
    ground-truth depth) and K7's chunk pass: {name: args}."""
    from tdvnet_torch.config import EvalConfig, ModelConfig
    from tdvnet_torch.models.threedvnet import hypothesis_points
    from tdvnet_torch.ops import camera

    cfg, ev = ModelConfig(), EvalConfig()
    dc = cfg.depth_test
    k = ev.n_src_on_either_side
    views = stream_views() if views is None else views
    H, W = cfg.img_size
    f = cfg.feat_dim
    out = {}
    n_refs = views["K"].shape[0] - 2 * k
    for name, n in (("chunk", ev.fused_chunk), ("scene", n_refs)):
        K, rot, tv, depth, ri, src_idx = scene_refs(views, device, 0, n, k)
        feats = torch.randn(K.shape[0], H // 4, W // 4, f,
                            generator=gen).to(device)
        P_all = camera.projection_matrix(K, rot, tv)
        if name == "scene":
            pts = hypothesis_points(depth, K[ri], rot[ri], tv[ri],
                                    cfg.img_size, 0.0, n=0)
            out["scene_cloud"] = _variance_args(pts[:, 0], feats, src_idx,
                                                P_all)
            continue
        pts = camera.plane_sweep_points(
            dc.depth_start, dc.depth_interval, dc.n_intervals, rot[ri],
            tv[ri], K[ri], cfg.img_size, dc.size)
        out["cost_volume"] = _variance_args(pts, feats, src_idx, P_all)
        hyp = hypothesis_points(depth, K[ri], rot[ri], tv[ri], cfg.img_size,
                                HYP_OFFSET)
        R, Hh, P, _ = hyp.shape
        out["pointflow"] = _variance_args(hyp.reshape(R, Hh * P, 3), feats,
                                          src_idx, P_all)
        out["patch_fan"] = _variance_args(hyp, feats, src_idx, P_all)
    return out


def captured_inputs(weights, device, views=None):
    """The arguments of the first call of each shape that a full-width
    `infer_depth` of the golden batch and a `predict_scene` of the stream
    scene (parity, then fast path) make to the two variance kernels, with
    real feature maps from `weights`: {name: args}."""
    import dataclasses

    from tdvnet_torch.config import Config
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.ops import costvolume
    from tdvnet_torch.weights import load_threedvnet

    sv, pf = costvolume.source_variance, costvolume.patch_fan_variance
    calls = []

    def keep(kernel, fn):
        def run(*args, **kw):
            calls.append((kernel, tuple(a.clone() if torch.is_tensor(a)
                                        else a for a in args)))
            return fn(*args, **kw)
        return run

    model = load_threedvnet(weights, device=device)
    cfg = Config()
    views = stream_views() if views is None else views
    offsets = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
    out = {}
    costvolume.source_variance = keep("source_variance", sv)
    costvolume.patch_fan_variance = keep("patch_fan_variance", pf)
    try:
        with torch.no_grad():
            for path, run in (
                    ("infer_depth", lambda: model.infer_depth(
                        golden_batch().to(device), offsets)),
                    ("scene", lambda: FusedSceneInference(
                        model, cfg, offsets_list=offsets).predict_scene(
                            views)),
                    ("fast", lambda: FusedSceneInference(
                        model, dataclasses.replace(cfg, eval=dataclasses
                                                   .replace(cfg.eval,
                                                            fast_path=True))
                    ).predict_scene(views))):
                calls.clear()
                run()
                torch.cuda.synchronize()
                out.update(_name_calls(path, calls))
    finally:
        costvolume.source_variance, costvolume.patch_fan_variance = sv, pf
    return out


def _name_calls(path, calls):
    """The first call of each shape on a path, named as the synthetic
    inputs are: K1's by their point count (D planes, one, or 7 hypotheses
    a pixel), K7's "patch_fan"."""
    out = {}
    for kernel, args in calls:
        if kernel == "patch_fan_variance":
            name = "patch_fan"
        else:
            R, P = args[0].shape[:2]
            per_pixel = P // (56 * 56)
            name = {1: "scene_cloud", 7: "pointflow"}.get(per_pixel,
                                                          "cost_volume")
        out.setdefault(f"{path}/{name}", (kernel, args))
    return out


def time_inputs(named, iters, ablate):
    """{label: {"ms", "bound_ms", "shape", "digest"}} for each (kernel,
    args); K1's digest covers its variance and its mean (the forward's
    output in training)."""
    from tdvnet_torch.kernels import patchfan, variance
    from tdvnet_torch.tools.time_depthops import digest
    from tdvnet_torch.tools.timing import time_ms

    modules = {"source_variance": variance, "patch_fan_variance": patchfan}
    rec = {}
    for label, (kernel, args) in named.items():
        mod = modules[kernel]
        fn = getattr(mod, kernel)
        # a synthetic call takes a plane of all its points (the forward
        # does not read it); a captured one has the caller's
        if kernel == "source_variance" and len(args) == 6:
            args = args + ((1, args[0].shape[1]),)
        shape = list(args[0].shape[:-1]) + [args[1].shape[-1]]
        bound = 1e3 * variance_bytes(args) / HBM_BYTES_PER_S
        runs = [("", args)]
        if ablate:
            masked = list(args)
            masked[3] = torch.zeros_like(args[3])
            runs.append(("/masked", tuple(masked)))
        for alabel, a in runs:
            ms = time_ms(lambda a=a: fn(*a), iters=iters, warmup=3)
            out = (variance._source_variance(*a[:6], True)
                   if kernel == "source_variance" else fn(*a))
            rec[label + alabel] = {"ms": ms, "bound_ms": bound,
                                   "shape": shape, "digest": digest(out)}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--no-captured", action="store_true",
                    help="time the synthetic inputs only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_variance: no CUDA device")
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
    gen = torch.Generator().manual_seed(0)
    views = stream_views()
    synthetic = {f"infer_depth/{k}": ("source_variance", a)
                 for k, a in infer_depth_inputs(device, gen).items()}
    for k, a in scene_inputs(device, gen, views).items():
        path = "fast" if k == "patch_fan" else "scene"
        kernel = ("patch_fan_variance" if k == "patch_fan"
                  else "source_variance")
        synthetic[f"{path}/{k}"] = (kernel, a)
    rec = {"root": root, "card": card,
           "synthetic": time_inputs(synthetic, args.iters, args.ablate)}
    del synthetic
    if not args.no_captured:
        captured = captured_inputs(
            os.path.join(root, "weights", "3dvnet_synth48.npz"), device,
            views)
        torch.cuda.empty_cache()
        rec["captured"] = time_inputs(captured, args.iters, args.ablate)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
