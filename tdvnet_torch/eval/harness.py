"""Whole-scene evaluation harness (port of `tdvnet/eval/harness.py`).

`main` runs a method callback over every scene of the selected dataset,
caches `preds.npz` per scene (idempotent re-runs), computes 2D metrics and
depth- or volume-3D metrics, and aggregates. Any method plugs in through
`pred_fn(views, scene_dir, dset)`, which returns depth maps [R, H, W]
(depth=True) or a mesh (verts, faces) (depth=False).
`make_3dvnet_pred_fn` is the model's. `write_scene_preds` and
`scene_metrics` are one scene's two halves, which `main` runs on two
threads.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from tdvnet_torch.config import Config, EvalConfig, resolve_device
from tdvnet_torch.data import frameselector, scenelists
from tdvnet_torch.data.dataset import Dataset
from tdvnet_torch.eval import processresults
from tdvnet_torch.eval.fused_scene import FusedSceneInference
from tdvnet_torch.eval.stages import stage
from tdvnet_torch.ops import ply, raster


def write_scene_preds(views, scene: str, scene_save_dir: str,
                      pred_fn: Callable, dset: Dataset, e: EvalConfig,
                      depth: bool = True, timings=None) -> None:
    """Run `pred_fn` on one scene's loaded views and write its `preds.npz`
    (and, for a mesh method, `mesh.ply` and the depths rendered from it)."""
    k = dset.k
    n_imgs = views["images"].shape[0]
    ref_sel = np.arange(k, n_imgs - k)

    init_prob = final_prob = None
    with stage("eval_predict", timings):
        if depth:
            result = pred_fn(views, scene, dset)
            if isinstance(result, tuple):
                depth_preds, init_prob, final_prob = result
            else:
                depth_preds = result
        else:
            verts, faces = pred_fn(views, scene, dset)
            ply.write_ply(os.path.join(scene_save_dir, "mesh.ply"), verts,
                          faces)
            poses = np.repeat(np.eye(4, dtype=np.float32)[None], n_imgs, 0)
            poses[:, :3, :3] = views["rotmats"]
            poses[:, :3, 3] = views["tvecs"]
            # render at depth_img_size: K rescaled from the image resolution
            K_r = views["K"][ref_sel].copy()
            K_r[:, 0, :] *= e.depth_img_size[1] / views["images"].shape[2]
            K_r[:, 1, :] *= e.depth_img_size[0] / views["images"].shape[1]
            depth_preds = raster.render_scene_depths(
                verts, faces, poses[ref_sel], K_r, e.depth_img_size)

    # rescale K to the prediction resolution (ref main.py:74-81)
    old_h, old_w = views["images"].shape[1:3]
    new_h, new_w = depth_preds.shape[-2:]
    K = views["K"][ref_sel].copy()
    K[:, 0, :] *= new_w / old_w
    K[:, 1, :] *= new_h / old_h

    preds = dict(
        scene=os.path.basename(scene),
        depth_preds=np.asarray(depth_preds, np.float32),
        rotmats=views["rotmats"][ref_sel],
        tvecs=views["tvecs"][ref_sel],
        K=K,
        img_idx=views["img_idx"][ref_sel],
    )
    if init_prob is not None:
        preds["init_prob"] = init_prob
    if final_prob is not None:
        preds["final_prob"] = final_prob
    with stage("eval_write", timings):
        np.savez(os.path.join(scene_save_dir, "preds.npz"), **preds)


def scene_metrics(scene: str, scene_save_dir: str, e: EvalConfig,
                  depth: bool = True, mask_using_gt_mesh: bool = True,
                  overwrite: bool = False, device=None, timings=None) -> None:
    """The 2D metrics and the depth-3D (with `e.run_tsdf_fusion`, TSDF) or
    volume-3D metrics of one scene whose `preds.npz` is written."""
    processresults.process_scene_2d_metrics(scene, scene_save_dir, overwrite,
                                            device=device, timings=timings)
    if depth:
        processresults.process_depth_3d_metrics(
            scene, scene_save_dir, e, mask_using_gt_mesh, overwrite,
            device=device, timings=timings)
    else:
        processresults.process_volume_3d_metrics(
            scene, scene_save_dir, e, mask_using_gt_mesh, overwrite,
            device=device)


def main(save_dirname: str, pred_fn: Callable, cfg: Config,
         depth: bool = True, overwrite: bool = False,
         scenes: Optional[Sequence[str]] = None,
         mask_using_gt_mesh: bool = True, start_idx: int = 0, device=None,
         timings: Optional[Dict[str, float]] = None):
    """Evaluate `pred_fn` over the scenes; 3D evaluation runs on `device`
    (the card unless the caller names another). Returns the averaged
    metrics per file name, also written beside the `scenes` folder. With
    `timings`, the host seconds of each stage (`eval/stages.py`) are added
    there, summed over the scenes and the three threads."""
    device = resolve_device(device)
    e = cfg.eval
    save_dir = os.path.join(e.save_dir, save_dirname)
    os.makedirs(save_dir, exist_ok=True)

    if scenes is None:
        scenes = scenelists.get_scenes(e.dataset_type, cfg.data)

    selector = frameselector.NextPoseDistSelector(e.pdist, 20)
    dset = Dataset(scenes, selector, None,
                   depth_img_size=e.depth_img_size,
                   img_size=cfg.batch.img_size, augment=False,
                   n_src_on_either_side=e.n_src_on_either_side)

    def load(idx):
        with stage("eval_load", timings):
            return dset.load_views(idx, seed_idx=0)

    # scene-level pipelining: the next scene's frames load on a worker
    # thread while the device predicts the current one, and the metric
    # stages (rasterization, fusion, KD-trees) run on another
    load_pool = cf.ThreadPoolExecutor(1)
    metrics_pool = cf.ThreadPoolExecutor(1)
    metric_futs = []
    try:
        views_fut = (None, None)                 # (scene index, future)
        for j, scene in enumerate(scenes[start_idx:]):
            idx = j + start_idx
            print(f"{idx + 1} / {len(scenes)}: {os.path.basename(scene)}")
            scene_save_dir = os.path.join(save_dir, "scenes",
                                          os.path.basename(scene))
            os.makedirs(scene_save_dir, exist_ok=True)
            pred_path = os.path.join(scene_save_dir, "preds.npz")
            if not os.path.exists(pred_path) or overwrite:
                views = views_fut[1].result() if views_fut[0] == idx \
                    else load(idx)
                if idx + 1 < len(scenes):
                    views_fut = (idx + 1, load_pool.submit(load, idx + 1))
                write_scene_preds(views, scene, scene_save_dir, pred_fn,
                                  dset, e, depth, timings)
            metric_futs.append(metrics_pool.submit(
                scene_metrics, scene, scene_save_dir, e, depth,
                mask_using_gt_mesh, overwrite, device, timings))

        for f in metric_futs:
            f.result()                           # surface worker exceptions
    finally:
        load_pool.shutdown()
        metrics_pool.shutdown()
    return processresults.calc_avg_metrics(save_dir)


def make_3dvnet_pred_fn(model, cfg: Config):
    """The model's `pred_fn(views, scene_dir, dset)`: whole-scene inference
    through `FusedSceneInference` on the model's device, on the fast path
    when `cfg.eval.fast_path` says so. Result depths are millimetre-quantized
    on fetch (+-0.5 mm, far below every metric threshold)."""
    inf = FusedSceneInference(model, cfg)

    def pred_fn(views, scene_dir, dset):
        out = inf.predict_scene(maybe_drop_u8(views))
        if inf.last_scene_stats:
            print(f"  scene volume stats: {inf.last_scene_stats}")
        return out

    return pred_fn


def maybe_drop_u8(views):
    """With TDVNET_U8_UPLOAD=0 in the environment, normalize u8 images on
    the host and upload floats (4x the image bytes; the same mean/std
    arithmetic in fp32 as the on-device ingest)."""
    if os.environ.get("TDVNET_U8_UPLOAD", "1") != "0" \
            or "images_u8" not in views:
        return views
    views = dict(views)
    u8 = views.pop("images_u8")
    sc = np.float32(views.pop("rgb_scale", 255.0))
    mean = np.asarray(views.pop("rgb_mean"), np.float32)
    std = np.asarray(views.pop("rgb_std"), np.float32)
    views["images"] = ((u8.astype(np.float32) / sc) - mean) / std
    return views
