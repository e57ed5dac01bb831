"""Time the 3D evaluation's kernels, K9a (`tsdf_integrate`) and K9b
(`consistency_fuse`), on the card at their main-path inputs, with a digest
of every output, for comparing trees.

    python -m tdvnet_torch.tools.time_eval3d [--iters 20] [--no-captured]
        [--profile] [--harness ROUNDS]

"golden": the inputs of `chip_smoke.eval3d_cases`, the golden scene's
recipe predictions (52 views at 480x640, 48 refs): K9a integrates all 48
frames into the default EvalConfig's volume (voxel 0.04 m, margin 1.5 m),
K9b fuses each of the three 16-ref chunks against all 48 views.
"captured": the first K9a and K9b calls of `harness.main` (phase 8's fast
path, synth48 weights) on the 52-view stream scene of seed 22, written
into a temporary directory.

Per case: the wrapper's mean ms over `--iters` calls (CUDA events), with
the inputs as the main path hands them (uint8 colours and each view's
largest depth reduced once, where the tree's wrapper takes them); the
bound of `chip_smoke.py` (K9a: depth and colour read once, the
accumulators written once, 25 flops a (voxel, frame) pair; K9b: the
depths read once, points and flags written once, 45 flops a (pixel,
view) pair and 25 more a valid one) and, where the tree has the cull's
twin, the bound over what the pairs that the cull leaves touch; a sha256
digest of every output; K9b's shares of pairs inside the view's frustum
(x in [0, W-1], y in [0, H-1], z > 1e-4) and valid, K9a's shares of pairs
with an in-range pixel and pz > 0 and valid, and its observed voxels; the
share of pairs the cull skips. `--profile` adds device us per kernel
(torch.profiler). `--harness ROUNDS` adds phase 8b's end-to-end time:
`harness.main` on the fast path over the stream scenes of seeds 22-24
(written once), ROUNDS times after a warm-up scene, each into a fresh
results directory, in seconds per scene. The last line is one JSON
object. Run it from each
tree's root with that root first on the path, alternating, to read
bit-equality and speed in one call:

    (cd parent && PYTHONPATH=. python ../change/tdvnet_torch/tools/time_eval3d.py)
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import tempfile

import torch

from tdvnet_torch.tools.timing import HBM_BYTES_PER_S

FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
CAPTURED_SEED = 22           # phase 8's first stream scene
FUSE_FLOPS, FUSE_VALID_FLOPS = 45, 25
TSDF_FLOPS = 25


def digest(t: torch.Tensor) -> str:
    from tdvnet_torch.tools.time_pool_i8 import digest as d

    return d(t)


def bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


# ------------------------------------------------------------------ inputs
def golden_inputs(device):
    """({name: K9a args}, {name: K9b args}) of the golden scene, as
    `chip_smoke.eval3d_cases` builds them; K9a's colours are uint8, as
    `processresults` hands them over."""
    import numpy as np

    import chip_smoke
    from tdvnet_torch.config import EvalConfig
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.kernels.fusion import camera_table
    from tdvnet_torch.ops.tsdf import volume_bounds

    r, ev = chip_smoke.EVAL3D, EvalConfig(**chip_smoke.EVAL3D_EVAL)
    k, n = r["k"], r["n_views"]
    sc = synthetic.make_scene(n, tuple(r["hw"]), seed=r["seed"],
                              normalize=False)
    preds = chip_smoke.eval3d_preds(sc["poses"], sc["K"][0],
                                    sc["depth"][k:n - k], r["scene"])
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
    colors = up((sc["images"][k:n - k] * 255).astype(np.uint8))
    tsdf = {"golden": (d_dev, colors, up(P), torch.from_numpy(lo), dims,
                       ev.tsdf_voxel_size, ev.tsdf_trunc_ratio)}
    cams = camera_table(up(K), up(R), up(t))
    chunk = chip_smoke.FUSION_REF_CHUNK
    fuse = {f"golden_{c0 // chunk}": (
        d_dev[c0:c0 + chunk], d_dev, cams,
        torch.arange(c0, min(c0 + chunk, N), device=device), ev.z_thresh,
        ev.n_consistent_thresh) for c0 in range(0, N, chunk)}
    return tsdf, fuse


def captured_inputs(weights, device, root):
    """The first K9a and K9b calls of `harness.main` over the stream scene
    of CAPTURED_SEED written under `root`: ({"captured": K9a args},
    {"captured": (K9b args, kwargs)})."""
    import chip_smoke
    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir
    from tdvnet_torch.eval import harness
    from tdvnet_torch.ops import fusion, tsdf
    from tdvnet_torch.weights import load_threedvnet

    clone = lambda a: a.clone() if torch.is_tensor(a) else a
    k9a, k9b = tsdf.tsdf_integrate, fusion.consistency_fuse
    got_a, got_b = {}, {}

    def keep_a(*args, **kw):
        if not got_a:
            got_a["captured"] = tuple(clone(a) for a in args) + tuple(
                clone(kw.get(n)) for n in ("init",) if kw.get(n) is not None)
        return k9a(*args, **kw)

    def keep_b(*args, **kw):
        if not got_b:
            got_b["captured"] = (tuple(clone(a) for a in args),
                                 {n: clone(v) for n, v in kw.items()})
        return k9b(*args, **kw)

    scene = ensure_scene_dir(root, f"synth_{CAPTURED_SEED:04d}",
                             chip_smoke.STREAM_VIEWS, chip_smoke.EVAL3D["hw"],
                             CAPTURED_SEED, device)
    cfg = chip_smoke.eval3d_config(os.path.join(root, "results"))
    model = load_threedvnet(weights, device=device)
    tsdf.tsdf_integrate, fusion.consistency_fuse = keep_a, keep_b
    try:
        with torch.no_grad():
            harness.main("fast", harness.make_3dvnet_pred_fn(model, cfg),
                         cfg, scenes=[scene], device=device)
        torch.cuda.synchronize()
    finally:
        tsdf.tsdf_integrate, fusion.consistency_fuse = k9a, k9b
    return got_a, got_b


def harness_seconds(weights, device, root, rounds) -> dict:
    """s/scene of `harness.main` (phase 8b) over the stream scenes written
    under `root`, `rounds` times after one warm-up scene."""
    import time

    import chip_smoke
    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir
    from tdvnet_torch.eval import harness
    from tdvnet_torch.weights import load_threedvnet

    scenes = [ensure_scene_dir(root, f"synth_{s:04d}",
                               chip_smoke.STREAM_VIEWS,
                               chip_smoke.EVAL3D["hw"], s, device)
              for s in chip_smoke.EVAL3D_STREAM_SEEDS]
    model = load_threedvnet(weights, device=device)
    out = []
    for r in range(rounds + 1):
        cfg = chip_smoke.eval3d_config(os.path.join(root, f"results_{r}"))
        fn = harness.make_3dvnet_pred_fn(model, cfg)
        run = scenes[:1] if r == 0 else scenes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            harness.main("fast", fn, cfg, scenes=run, device=device)
        torch.cuda.synchronize()
        if r:
            out.append((time.perf_counter() - t0) / len(run))
    return {"s_per_scene": out, "scenes": len(scenes)}


# ------------------------------------------------------- counts and bounds
def fuse_pair_stats(args, depth_max=None) -> dict:
    """K9b's (pixel, view) pairs: all, inside the view's frustum (x in [0,
    W-1], y in [0, H-1], z > 1e-4, the ref's own view included), valid
    (the ref's own view excluded), and the distinct source pixels the
    valid pairs tap; where the tree has the cull's twin
    (`fusion.fuse_skip_ref`), the pairs it leaves (`run`) and the source
    pixels those tap in the map (`run_taps`)."""
    from tdvnet_torch.kernels import fusion as F

    ref_depth, all_depth, cams, self_idx, z_thresh = args[:5]
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    zt = torch.tensor(z_thresh, dtype=torch.float32, device=ref_depth.device)
    gx, gy = F.pixel_grid(H, W, ref_depth.device)
    pw = F._backproject(cams[self_idx][:, None, :], gx.repeat(H)[None],
                        gy.repeat_interleave(W)[None],
                        ref_depth.reshape(C, H * W))
    cull = getattr(F, "fuse_skip_ref", None)
    if cull is not None:
        skip, _, tile, group = cull(*args[:5], depth_max=depth_max)
        rows = torch.arange(C, device=ref_depth.device)[:, None]
    out = {"pairs": C * H * W * N, "frustum": 0, "valid": 0}
    taps_valid = taps_run = 0
    if cull is not None:
        out["run"] = 0
    for s in range(N):
        X, Y, z = (F._row3(cams[s, 4 * i], cams[s, 4 * i + 1],
                           cams[s, 4 * i + 2], *pw) + cams[s, 4 * i + 3]
                   for i in range(3))
        x, y = X / z, Y / z
        fr = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (z > 1e-4)
        xi, yi = torch.round(x), torch.round(y)
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        tap = torch.where(inb, yi * W + xi, torch.zeros_like(xi)).long()
        zs = torch.where(inb, all_depth[s].reshape(-1)[tap],
                         torch.zeros_like(z))
        valid = (fr & ((z - zs).abs() < zt) & (zs > 0)
                 & (self_idx != s)[:, None])
        out["frustum"] += int(fr.sum())
        out["valid"] += int(valid.sum())
        taps_valid += int(torch.unique(tap[valid]).numel())
        if cull is not None:
            run = ~skip[rows, tile[None], group, s]
            out["run"] += int(run.sum())
            taps_run += int(torch.unique(tap[run & inb]).numel())
    out["valid_taps"] = taps_valid
    if cull is not None:
        out["run_taps"] = taps_run
    return out


def fuse_bytes(args) -> int:
    """K9b's byte count in `chip_smoke.py`: the source depths and the
    camera table read once, the points and flags written once."""
    ref_depth, all_depth = args[:2]
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    return 4 * N * H * W + 4 * 33 * N + C * H * W * 13


def fuse_touched_bytes(args, stats) -> int:
    """K9b's bytes over what its un-culled pairs touch: the refs' depths,
    the camera table and the source pixels those pairs tap read once, the
    points and flags written once."""
    ref_depth, all_depth = args[:2]
    C, H, W = ref_depth.shape
    return 4 * C * H * W + 4 * 33 * all_depth.shape[0] + C * H * W * 13 \
        + 4 * stats["run_taps"]


def tsdf_pair_stats(args) -> dict:
    """K9a's (voxel, frame) pairs: all, with an in-range pixel and pz > 0,
    valid, the observed voxels (weight > 0), the distinct depth pixels the
    in-range pairs tap and colour pixels the valid pairs tap; where the tree
    has the cull's twin (`tsdf.tsdf_skip_ref`), the pairs it leaves
    (`run`) and the depth pixels those tap (`run_taps`)."""
    from tdvnet_torch.kernels import tsdf as T

    depths, colors, P, origin, dims, voxel, trunc = args[:7]
    N, H, W = depths.shape
    dev = depths.device
    world = T.voxel_centers(dims, voxel, origin.to(dev))
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    V = world.shape[0]
    it = torch.tensor(T._inv_trunc(voxel, trunc), device=dev)
    cull = getattr(T, "tsdf_skip_ref", None)
    if cull is not None:
        skip, brick = cull(depths, P, origin, dims, voxel, trunc)
    seen = torch.zeros(V, dtype=torch.bool, device=dev)
    out = {"pairs": V * N, "in_range": 0, "valid": 0, "voxels": V}
    taps = ctaps = rtaps = 0
    if cull is not None:
        out["run"] = 0
    for f in range(N):
        cx, cy, pz = T._project_rows(P[f], x, y, z)
        px, py = torch.round(cx / pz), torch.round(cy / pz)
        inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (pz > 0)
        pix = torch.where(inb, py * W + px, torch.zeros_like(px)).long()
        d = depths[f].reshape(-1)[pix]
        sdf = torch.minimum((d - pz) * it, torch.ones_like(d))
        valid = inb & (d > 0) & (sdf > -1)
        out["in_range"] += int(inb.sum())
        out["valid"] += int(valid.sum())
        seen |= valid
        taps += int(torch.unique(pix[inb]).numel())
        ctaps += int(torch.unique(pix[valid]).numel())
        if cull is not None:
            run = ~skip[brick, f]
            out["run"] += int(run.sum())
            rtaps += int(torch.unique(pix[run & inb]).numel())
    out.update(observed=int(seen.sum()), taps=taps, colour_taps=ctaps)
    if cull is not None:
        out["run_taps"] = rtaps
    return out


def tsdf_bytes(args, colour_bytes=12) -> int:
    """K9a's byte count in `chip_smoke.py`: depth and colour read once, the
    projections read once, the accumulators written once (fp32 colour:
    colour_bytes 12 a pixel; uint8: 3)."""
    depths, _, _, _, dims = args[:5]
    N, H, W = depths.shape
    V = dims[0] * dims[1] * dims[2]
    return (4 + colour_bytes) * N * H * W + 48 * N + 20 * V


def tsdf_touched_bytes(args, stats, colour_bytes=12) -> int:
    """K9a's bytes over what its un-culled pairs touch: the accumulators
    written once (68 MB at the golden volume), the projections, the depth
    pixels those pairs tap and the colour pixels the valid pairs tap read
    once."""
    depths, _, _, _, dims = args[:5]
    V = dims[0] * dims[1] * dims[2]
    return 20 * V + 48 * depths.shape[0] + 4 * stats["run_taps"] \
        + colour_bytes * stats["colour_taps"]


# ------------------------------------------------------------------ timing
def profile_us(fn) -> dict:
    from tdvnet_torch.tools.time_pool_i8 import profile_us as p

    return p(fn)


def _takes_depth_max() -> bool:
    from tdvnet_torch.kernels import fusion as F

    return "depth_max" in inspect.signature(F.consistency_fuse).parameters


def _reads_uint8() -> bool:
    from tdvnet_torch.kernels import tsdf as T

    return torch.uint8 in getattr(T, "COLOR_DTYPES", ())


def time_tsdf(named, iters, profile):
    from tdvnet_torch.kernels import tsdf as T
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for name, a in named.items():
        depths, colors = a[:2]
        forms = {"float32": colors.to(torch.float32)}
        if colors.dtype == torch.uint8 and _reads_uint8():
            forms["uint8"] = colors
        stats = tsdf_pair_stats(a)
        r = {"shape": [list(depths.shape), list(a[4])], "stats": stats}
        for form, cols in forms.items():
            args = (depths, cols) + tuple(a[2:])
            run = lambda args=args: T.tsdf_integrate(*args)
            cb = 3 if form == "uint8" else 12
            f = {"ms": time_ms(run, iters=iters, warmup=3),
                 "digest": [digest(o) for o in run()],
                 "bound_ms": bound_ms(tsdf_bytes(a, cb),
                                      TSDF_FLOPS * stats["pairs"])}
            if "run" in stats:
                f["touched_bound_ms"] = bound_ms(
                    tsdf_touched_bytes(a, stats, cb),
                    TSDF_FLOPS * stats["run"])
            if profile:
                f["profile_us"] = profile_us(run)
            r[form] = f
        rec[name] = r
    return rec


def time_fuse(named, iters, profile):
    from tdvnet_torch.kernels import fusion as F
    from tdvnet_torch.tools.timing import time_ms

    rec = {}
    for name, (a, kw) in named.items():
        kw = dict(kw)
        all_depth = a[1]
        dmax = kw.get("depth_max")
        if _takes_depth_max() and dmax is None:
            # reduced once per `fuse_point_cloud`, not per chunk
            dmax = kw["depth_max"] = all_depth.reshape(
                all_depth.shape[0], -1).amax(1)
        run = lambda: F.consistency_fuse(*a, **kw)
        stats = fuse_pair_stats(a, dmax)
        flops = FUSE_FLOPS * stats["pairs"] + FUSE_VALID_FLOPS * stats["valid"]
        r = {"ms": time_ms(run, iters=iters, warmup=3),
             "digest": [digest(o) for o in run()],
             "bound_ms": bound_ms(fuse_bytes(a), flops), "stats": stats,
             "shape": [list(a[0].shape), all_depth.shape[0]]}
        if "run" in stats:
            r["touched_bound_ms"] = bound_ms(
                fuse_touched_bytes(a, stats),
                FUSE_FLOPS * stats["run"]
                + FUSE_VALID_FLOPS * stats["valid"])
        if profile:
            r["profile_us"] = profile_us(run)
        rec[name] = r
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-captured", action="store_true",
                    help="time the golden inputs only")
    ap.add_argument("--profile", action="store_true",
                    help="add device time per kernel")
    ap.add_argument("--harness", type=int, default=0, metavar="ROUNDS",
                    help="add harness.main's s/scene over ROUNDS rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_eval3d: no CUDA device")
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
    tsdf, fuse = golden_inputs(device)
    fuse = {k: (a, {}) for k, a in fuse.items()}
    if not args.no_captured:
        with tempfile.TemporaryDirectory(prefix="tdvnet_k9_") as tmp:
            a, b = captured_inputs(
                os.path.join(root, "weights", "3dvnet_synth48.npz"), device,
                tmp)
        tsdf.update(a)
        fuse.update(b)
    rec = {"root": root, "card": card,
           "tsdf": time_tsdf(tsdf, args.iters, args.profile),
           "fuse": time_fuse(fuse, args.iters, args.profile)}
    if args.harness:
        with tempfile.TemporaryDirectory(prefix="tdvnet_k9_") as tmp:
            rec["harness"] = harness_seconds(
                os.path.join(root, "weights", "3dvnet_synth48.npz"), device,
                tmp, args.harness)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
