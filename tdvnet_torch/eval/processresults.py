"""Per-scene metric computation and aggregation over the `preds.npz`
contract (port of `tdvnet/eval/processresults.py`).

- 2D metrics against full-resolution GT depth with nearest-upsampled
  predictions and a prediction-validity mask, on the device;
- depth-3D: GT-mesh visibility masking (host rasterizer), consistency
  fusion on the K9b kernel, voxel downsample and bidirectional F-score on
  the host;
- TSDF: the depths fused on the K9a kernel, meshed on the host, scored;
- volume-3D: mesh -> trim via re-render + TSDF refusion -> metrics;
- aggregation: n-weighted means for 2D, plain means for 3D.

File names are the reference's (`metrics_3d_0.010_3v_masked.json`,
`fused_0.010_3v_masked.ply`, `tsdf_mesh_masked.ply`, ...). The
probability-map masking of the PointMVSNet and FastMVSNet baselines
(`init_prob` / `final_prob` in `preds.npz`) arrives with those baselines.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from tdvnet_torch.config import EvalConfig, resolve_device
from tdvnet_torch.data import imageio
from tdvnet_torch.eval import metrics3d
from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics
from tdvnet_torch.eval.stages import stage
from tdvnet_torch.ops import fusion, marching, ply, pointcloud, raster, tsdf
from tdvnet_torch.ops.sampling import resize_nearest


def _info(scene_dir: str) -> Dict:
    with open(os.path.join(scene_dir, "info.json")) as f:
        return json.load(f)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_gt_depth(img_idx, scene_dir):
    info = _info(scene_dir)
    out = [imageio.imread_depth(info["frames"][int(i)]["filename_depth"])
           .astype(np.float64) / 1000.0 for i in img_idx]
    return np.stack(out).astype(np.float32)


def load_images(img_idx, scene_dir):
    """RGB uint8 [N, H, W, 3] of the frames."""
    info = _info(scene_dir)
    return np.stack([
        imageio.imread(info["frames"][int(i)]["filename_color"])[..., ::-1]
        for i in img_idx])


def _resize_nearest_np(x: np.ndarray, hw) -> np.ndarray:
    """`resize_nearest`'s index rule on a host array."""
    return resize_nearest(torch.from_numpy(np.ascontiguousarray(x)),
                          hw).numpy()


def _check_no_prob_maps(data) -> None:
    for key in ("init_prob", "final_prob"):
        if key in data:
            raise NotImplementedError(
                f"preds.npz holds {key!r}: the probability-map masking of "
                f"the PointMVSNet/FastMVSNet baselines is not ported yet")


def process_scene_2d_metrics(scene_dir: str, scene_save_dir: str,
                             overwrite: bool = False, device=None,
                             timings=None) -> Optional[Dict]:
    """2D depth metrics vs full-res GT (reference :153-169)."""
    pred_path = os.path.join(scene_save_dir, "preds.npz")
    out_path = os.path.join(scene_save_dir, "metrics_2d.json")
    if os.path.exists(out_path) and not overwrite:
        return _load_json(out_path)
    device = resolve_device(device)
    data = np.load(pred_path)
    with stage("eval_load", timings):
        depth_gt = load_gt_depth(data["img_idx"], scene_dir)
    with stage("eval_2d", timings):
        metrics = _metrics_2d(data["depth_preds"], depth_gt, device)
    with stage("eval_write", timings):
        _dump_json(metrics, out_path)
    return metrics


def _metrics_2d(depth_preds, depth_gt, device) -> Dict:
    preds = _resize_nearest_np(depth_preds, depth_gt.shape[-2:])
    valid = (preds != 0) & np.isfinite(preds)
    # batch over images to bound memory (the reference uses batches of 100)
    mets_list, ns = [], []
    B = 100
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    for i in range(0, preds.shape[0], B):
        m = calc_2d_depth_metrics(up(preds[i:i + B]), up(depth_gt[i:i + B]),
                                  pred_valid=up(valid[i:i + B]))
        mets_list.append({k: float(v) for k, v in m.items()})
        ns.append(preds[i:i + B].shape[0])
    n_sum = float(np.sum(ns))
    metrics = {k: float(np.sum([n * m[k] for n, m in zip(ns, mets_list)])
                        / n_sum)
               for k in mets_list[0]}
    metrics["n"] = int(n_sum)
    return metrics


def _gt_mesh_points(scene_dir: str, voxel: float):
    verts, _, _ = ply.read_ply(_info(scene_dir)["gt_mesh"])
    return pointcloud.voxel_downsample(verts, voxel)


def _mask_using_gt_mesh(depth_preds, poses_w2c, K, scene_dir, timings=None):
    with stage("eval_mask_raster", timings):
        verts, faces, _ = ply.read_ply(_info(scene_dir)["gt_mesh"])
        if faces is None:
            return depth_preds
        gt_reproj = raster.render_scene_depths(verts, faces, poses_w2c, K,
                                               depth_preds.shape[-2:])
        return np.where(gt_reproj == 0.0, 0.0, depth_preds)


def _score(pts, scene_dir, ecfg, timings, n=None) -> Dict:
    """Voxel-downsampled GT mesh points against `pts` (already
    downsampled): the 3D metrics, with the ref count `n` when given."""
    with stage("eval_downsample_kdtree", timings):
        pts_gt = _gt_mesh_points(scene_dir, ecfg.voxel_downsample)
        metrics = metrics3d.eval_point_clouds(pts, pts_gt, ecfg.fscore_thresh)
    if n is not None:
        metrics["n"] = int(n)
    return metrics


def _poses(rotmats, tvecs) -> np.ndarray:
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], rotmats.shape[0], 0)
    poses[:, :3, :3] = rotmats
    poses[:, :3, 3] = tvecs
    return poses


def process_depth_3d_metrics(scene_dir: str, scene_save_dir: str,
                             ecfg: EvalConfig, mask_using_gt_mesh: bool = True,
                             overwrite: bool = False, device=None,
                             timings=None) -> Optional[Dict]:
    """Fused-point-cloud 3D metrics (reference :203-295); with
    `ecfg.run_tsdf_fusion`, the TSDF metrics of the same depths too."""
    pred_path = os.path.join(scene_save_dir, "preds.npz")
    suffix = "_masked" if mask_using_gt_mesh else ""
    tag = f"{ecfg.z_thresh:.3f}_{ecfg.n_consistent_thresh}v{suffix}"
    pcd_path = os.path.join(scene_save_dir, f"fused_{tag}.ply")
    out_path = os.path.join(scene_save_dir, f"metrics_3d_{tag}.json")
    if os.path.exists(out_path) and not overwrite:
        return _load_json(out_path)
    if not ecfg.run_pc_fusion:
        return None
    device = resolve_device(device)

    data = np.load(pred_path)
    _check_no_prob_maps(data)
    depth_preds = np.array(data["depth_preds"])
    K = np.array(data["K"])
    rotmats, tvecs = data["rotmats"], data["tvecs"]
    n = depth_preds.shape[0]
    with stage("eval_load", timings):
        depth_gt = load_gt_depth(data["img_idx"], scene_dir)
        images = load_images(data["img_idx"], scene_dir)

    # bring preds to GT resolution
    if depth_preds.shape[-2:] != depth_gt.shape[-2:]:
        x_f = depth_gt.shape[-1] / depth_preds.shape[-1]
        y_f = depth_gt.shape[-2] / depth_preds.shape[-2]
        depth_preds = _resize_nearest_np(depth_preds, depth_gt.shape[-2:])
        K = K.copy()
        K[:, 0, :] *= x_f
        K[:, 1, :] *= y_f

    if mask_using_gt_mesh:
        depth_preds = _mask_using_gt_mesh(depth_preds, _poses(rotmats, tvecs),
                                          K, scene_dir, timings)

    with stage("eval_pc_fusion", timings):
        pts, rgb = fusion.fuse_point_cloud(depth_preds, images, rotmats,
                                           tvecs, K, ecfg.z_thresh,
                                           ecfg.n_consistent_thresh,
                                           device=device)
    with stage("eval_downsample_kdtree", timings):
        pts, rgb = pointcloud.voxel_downsample(pts, ecfg.voxel_downsample,
                                               rgb)
    metrics = _score(pts, scene_dir, ecfg, timings, n)
    with stage("eval_write", timings):
        ply.write_ply(pcd_path, pts, colors=rgb)
        _dump_json(metrics, out_path)

    if ecfg.run_tsdf_fusion:
        process_depth_tsdf_metrics(scene_dir, scene_save_dir, ecfg,
                                   mask_using_gt_mesh, overwrite,
                                   depth_preds=depth_preds, K=K,
                                   rotmats=rotmats, tvecs=tvecs,
                                   images=images, device=device,
                                   timings=timings)
    return metrics


def process_depth_tsdf_metrics(scene_dir: str, scene_save_dir: str,
                               ecfg: EvalConfig,
                               mask_using_gt_mesh: bool = True,
                               overwrite: bool = False, *, depth_preds=None,
                               K=None, rotmats=None, tvecs=None,
                               images=None, device=None,
                               timings=None) -> Optional[Dict]:
    """TSDF-fuse the predicted depths into a mesh and score it (the
    reference's RUN_TSDF_FUSION branch, `processresults.py:297-397`,
    filenames `tsdf_mesh*.ply` / `metrics_tsdf*.json`). The depths are
    masked by the GT mesh again, as the JAX package does (the result is the
    same)."""
    suffix = "_masked" if mask_using_gt_mesh else ""
    mesh_path = os.path.join(scene_save_dir, f"tsdf_mesh{suffix}.ply")
    out_path = os.path.join(scene_save_dir, f"metrics_tsdf{suffix}.json")
    if os.path.exists(out_path) and not overwrite:
        return _load_json(out_path)
    device = resolve_device(device)
    if depth_preds is None:
        data = np.load(os.path.join(scene_save_dir, "preds.npz"))
        _check_no_prob_maps(data)
        depth_preds = np.array(data["depth_preds"])
        K, rotmats, tvecs = data["K"], data["rotmats"], data["tvecs"]
        with stage("eval_load", timings):
            images = load_images(data["img_idx"], scene_dir)
    n = depth_preds.shape[0]
    if mask_using_gt_mesh:
        depth_preds = _mask_using_gt_mesh(depth_preds, _poses(rotmats, tvecs),
                                          K, scene_dir, timings)

    if images.shape[1:3] != depth_preds.shape[1:3]:
        images = np.stack([imageio.resize_linear_u8(im,
                                                    depth_preds.shape[-2:])
                           for im in images])
    P = np.einsum("nij,njk->nik", K,
                  np.concatenate([rotmats, tvecs[..., None]], axis=2))
    with stage("eval_tsdf", timings):
        vol = tsdf.fuse_scene(depth_preds, images, P.astype(np.float32),
                              voxel_size=ecfg.tsdf_voxel_size,
                              trunc_ratio=ecfg.tsdf_trunc_ratio,
                              quantile=ecfg.tsdf_bounds_quantile,
                              margin=ecfg.tsdf_margin,
                              frame_batch=ecfg.tsdf_img_batch, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the stage owns its device time
    with stage("eval_marching", timings):
        verts, faces = marching.tsdf_to_mesh(vol)
    with stage("eval_downsample_kdtree", timings):
        pts = pointcloud.voxel_downsample(verts, ecfg.voxel_downsample)
    metrics = _score(pts, scene_dir, ecfg, timings, n)
    with stage("eval_write", timings):
        ply.write_ply(mesh_path, verts, faces)
        _dump_json(metrics, out_path)
    return metrics


def trim_mesh(verts, faces, scene_dir: str, ecfg: EvalConfig,
              mask_using_gt_mesh: bool = True, device=None):
    """Re-render a predicted mesh into every scene frame and TSDF-refuse it
    within the observed bounds (reference `trim_mesh`, :71-150)."""
    info = _info(scene_dir)
    all_poses = np.stack([np.asarray(f["pose"], np.float32)
                          for f in info["frames"]])
    K0 = np.asarray(info["intrinsics"], np.float32)
    n = all_poses.shape[0]
    R = all_poses[:, :3, :3].transpose(0, 2, 1)
    t = -np.einsum("nij,nj->ni", R, all_poses[:, :3, 3])
    poses_w2c = _poses(R, t)
    K = np.repeat(K0[None], n, 0)

    # render at the dataset's native depth resolution (the reference
    # hardcodes 480x640, which only matches ScanNet)
    size = imageio.imread_depth(info["frames"][0]["filename_depth"]).shape[:2]
    depths = raster.render_scene_depths(verts, faces, poses_w2c, K, size)
    if mask_using_gt_mesh:
        gverts, gfaces, _ = ply.read_ply(info["gt_mesh"])
        if gfaces is not None:
            gt_r = raster.render_scene_depths(gverts, gfaces, poses_w2c, K,
                                              size)
            depths = np.where(gt_r == 0.0, 0.0, depths)
    colors = np.zeros((*depths.shape, 3), np.float32)
    P = np.einsum("nij,njk->nik", K,
                  np.concatenate([R, t[..., None]], axis=2))
    vol = tsdf.fuse_scene(depths, colors, P.astype(np.float32),
                          voxel_size=ecfg.tsdf_voxel_size,
                          trunc_ratio=ecfg.tsdf_trunc_ratio,
                          quantile=ecfg.tsdf_bounds_quantile,
                          margin=ecfg.tsdf_margin,
                          frame_batch=ecfg.tsdf_img_batch, device=device)
    return marching.tsdf_to_mesh(vol)


def process_volume_3d_metrics(scene_dir: str, scene_save_dir: str,
                              ecfg: EvalConfig,
                              mask_using_gt_mesh: bool = True,
                              overwrite: bool = False,
                              device=None) -> Optional[Dict]:
    """Mesh-based 3D metrics for volumetric methods (reference :172-200)."""
    suffix = "_masked" if mask_using_gt_mesh else ""
    out_path = os.path.join(scene_save_dir, f"metrics_3d{suffix}.json")
    mesh_path = os.path.join(scene_save_dir, "mesh.ply")
    trimmed_path = os.path.join(scene_save_dir, f"trimmed_mesh{suffix}.ply")
    if os.path.exists(out_path) and not overwrite:
        return _load_json(out_path)
    if not os.path.exists(mesh_path):
        raise FileNotFoundError(mesh_path)
    verts, faces, _ = ply.read_ply(mesh_path)
    tverts, tfaces = trim_mesh(verts, faces, scene_dir, ecfg,
                               mask_using_gt_mesh, device=device)
    ply.write_ply(trimmed_path, tverts, tfaces)
    pts = pointcloud.voxel_downsample(tverts, ecfg.voxel_downsample)
    pts_gt = _gt_mesh_points(scene_dir, ecfg.voxel_downsample)
    metrics = metrics3d.eval_point_clouds(pts, pts_gt, ecfg.fscore_thresh)
    _dump_json(metrics, out_path)
    return metrics


def calc_avg_metrics(save_dir: str) -> Dict[str, Dict]:
    """Aggregate every metrics*.json across scenes (reference :402-427)."""
    scenes_dir = os.path.join(save_dir, "scenes")
    scene_dirs = sorted(os.listdir(scenes_dir))
    if not scene_dirs:
        return {}
    first = os.path.join(scenes_dir, scene_dirs[0])
    names = [os.path.basename(f)
             for f in glob.glob(os.path.join(first, "metrics*.json"))]
    out = {}
    for name in names:
        all_m = [_load_json(os.path.join(scenes_dir, s, name))
                 for s in scene_dirs
                 if os.path.exists(os.path.join(scenes_dir, s, name))]
        if not all_m:
            continue
        n_sum = np.sum([m.get("n", 1) for m in all_m])
        avg = {}
        for k in all_m[0]:
            if k == "n":
                continue
            if k in ("acc", "comp", "prec", "recal", "fscore"):
                avg[k] = float(np.mean([m[k] for m in all_m]))
            else:
                avg[k] = float(np.sum([m.get("n", 1) * m[k]
                                       for m in all_m]) / n_sum)
        _dump_json(avg, os.path.join(save_dir, name))
        out[name] = avg
    return out
