"""Write synthetic `info.json` scenes that exercise the real data pipeline
(the port's counterpart of `tools/make_synthetic_dataset.py`).

Each scene holds PNG colour (BGR as OpenCV writes it), 16-bit PNG depth in
millimetres, poses, and a GT mesh made by TSDF-fusing the GT depth maps
(voxel 0.04 m, margin 0.2 m, frame batches of 8), as the reference builds
GT meshes for ICL-NUIM and TUM-RGBD. The fusion runs on `device`, the card
unless the caller names another.
"""
from __future__ import annotations

import json
import os

import numpy as np

from tdvnet_torch.config import resolve_device
from tdvnet_torch.data import imageio, synthetic
from tdvnet_torch.ops import marching, ply, tsdf


def make_scene_dir(dst: str, name: str, n_views: int, hw, seed: int,
                   device=None) -> str:
    device = resolve_device(device)
    sc = synthetic.make_scene(n_views, tuple(hw), seed=seed, normalize=False)
    scene_dir = os.path.join(dst, name)
    os.makedirs(os.path.join(scene_dir, "color"), exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "depth"), exist_ok=True)

    frames = []
    for i in range(n_views):
        cpath = os.path.join(scene_dir, "color", f"{i:05d}.png")
        dpath = os.path.join(scene_dir, "depth", f"{i:05d}.png")
        imageio.imwrite(cpath, (sc["images"][i][..., ::-1] * 255)
                        .astype(np.uint8))
        imageio.imwrite(dpath, (sc["depth"][i] * 1000).astype(np.uint16))
        frames.append({
            "filename_color": cpath,
            "filename_depth": dpath,
            "pose": sc["poses"][i].tolist(),
        })

    P = np.einsum("nij,njk->nik", sc["K"],
                  np.concatenate([sc["rotmats"], sc["tvecs"][..., None]],
                                 axis=2)).astype(np.float32)
    colors = (sc["images"] * 255).astype(np.float32)
    vol = tsdf.fuse_scene(sc["depth"], colors, P, voxel_size=0.04,
                          margin=0.2, frame_batch=8, device=device)
    verts, faces = marching.tsdf_to_mesh(vol)
    mesh_path = os.path.join(scene_dir, "gt_mesh.ply")
    ply.write_ply(mesh_path, verts, faces)

    info = {
        "scene": name,
        "path": scene_dir,
        "gt_mesh": mesh_path,
        "intrinsics": sc["K"][0].tolist(),
        "frames": frames,
    }
    with open(os.path.join(scene_dir, "info.json"), "w") as f:
        json.dump(info, f)
    return scene_dir


def ensure_scene_dir(root: str, name: str, n_views: int, hw, seed: int,
                     device=None) -> str:
    """The scene's directory, written first unless its info.json exists."""
    d = os.path.join(root, name)
    if not os.path.exists(os.path.join(d, "info.json")):
        make_scene_dir(root, name, n_views, hw, seed, device)
    return d
