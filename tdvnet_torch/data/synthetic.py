"""Synthetic posed-RGBD scenes (numpy copy of `tdvnet/data/synthetic.py`).

Renders a procedurally textured axis-aligned box "room" analytically
(ray/plane intersection): multi-view-consistent RGB, exact GT depth and
exact poses, with no assets or I/O. For a given seed the arrays are
bit-identical to the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _texture(p: np.ndarray) -> np.ndarray:
    """Smooth procedural RGB texture of world position p [..., 3] -> [..., 3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.45 * np.sin(2.1 * x + 0.7 * y) * np.cos(1.3 * z)
    g = 0.5 + 0.45 * np.cos(1.7 * y + 0.3 * z) * np.sin(0.9 * x + 1.0)
    b = 0.5 + 0.45 * np.sin(1.1 * z + 1.9 * x + 0.5)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _render_box(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                img_size: Tuple[int, int], box_min: np.ndarray,
                box_max: np.ndarray):
    """Render depth + RGB of the inside of an axis-aligned box.

    R, t are world->cam. Returns (rgb [H,W,3] in [0,1], depth [H,W] in m).
    """
    H, W = img_size
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    rays_cam = pix @ np.linalg.inv(K).T
    cam_center = -R.T @ t
    rays_world = rays_cam @ R

    tbest = np.full((H, W), np.inf, np.float32)
    for axis in range(3):
        for bound in (box_min[axis], box_max[axis]):
            denom = rays_world[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                tt = (bound - cam_center[axis]) / denom
            pt = cam_center[None, None] + tt[..., None] * rays_world
            ok = (tt > 1e-4) & np.isfinite(tt)
            for oa in range(3):
                if oa != axis:
                    ok &= (pt[..., oa] >= box_min[oa] - 1e-4) & \
                          (pt[..., oa] <= box_max[oa] + 1e-4)
            tbest = np.where(ok & (tt < tbest), tt, tbest)

    hit = np.isfinite(tbest)
    tbest = np.where(hit, tbest, 0.0)
    pts = cam_center[None, None] + tbest[..., None] * rays_world
    rgb = np.where(hit[..., None], _texture(pts), 0.0)
    z = (pts @ R.T + t)[..., 2]
    depth = np.where(hit, z, 0.0).astype(np.float32)
    return rgb.astype(np.float32), depth


def make_scene(n_views: int = 9, img_size: Tuple[int, int] = (64, 80),
               seed: int = 0, normalize: bool = True,
               box: Tuple[float, float] = (4.0, 2.6)):
    """One synthetic scene: a camera trajectory inside a box room.

    Returns a dict with images [V,H,W,3] (ImageNet-normalized if requested),
    depth [V,H,W], rotmats/tvecs (world->cam), K [V,3,3], poses [V,4,4]
    (cam->world).
    """
    rng = np.random.default_rng(seed)
    H, W = img_size
    extent, height = box
    box_min = np.array([-extent / 2, -extent / 2, 0.0], np.float32)
    box_max = np.array([extent / 2, extent / 2, height], np.float32)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float32)

    images, images_u8, depths, rotmats, tvecs, poses = [], [], [], [], [], []
    for i in range(n_views):
        ang = 0.1 * i + rng.normal(0, 0.02)
        radius = extent * 0.22
        c = np.array([radius * np.cos(ang), radius * np.sin(ang),
                      height * 0.45 + rng.normal(0, 0.02)], np.float32)
        look = c + np.array([np.cos(ang), np.sin(ang), 0.0], np.float32)
        look += rng.normal(0, 0.03, 3).astype(np.float32)
        fwd = look - c
        fwd /= np.linalg.norm(fwd)
        up = np.array([0, 0, 1], np.float32)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        # camera axes: x=right, y=down, z=forward (OpenCV convention)
        R_c2w = np.stack([right, down, fwd], axis=1).astype(np.float32)
        R = R_c2w.T
        t = (-R @ c).astype(np.float32)

        rgb, depth = _render_box(K, R, t, img_size, box_min, box_max)
        images_u8.append(np.clip(np.round(rgb * 255.0), 0, 255)
                         .astype(np.uint8))
        if normalize:
            rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD
        images.append(rgb)
        depths.append(depth)
        rotmats.append(R)
        tvecs.append(t)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R_c2w
        pose[:3, 3] = c
        poses.append(pose)

    out = {
        "images": np.stack(images),
        "depth": np.stack(depths),
        "rotmats": np.stack(rotmats),
        "tvecs": np.stack(tvecs),
        "K": np.repeat(K[None], n_views, 0),
        "poses": np.stack(poses),
    }
    if normalize:
        out["images_u8"] = np.stack(images_u8)
        out["rgb_scale"] = 255.0
        out["rgb_mean"] = IMAGENET_MEAN
        out["rgb_std"] = IMAGENET_STD
    return out


def resize_nearest_np(x: np.ndarray, out_hw) -> np.ndarray:
    """Nearest resize of [..., H, W]: src index = floor(dst * H_in / H_out),
    computed in float32 as the JAX package does."""
    H, W = x.shape[-2], x.shape[-1]
    h, w = out_hw
    ys = np.floor(np.arange(h, dtype=np.float32) * np.float32(H / h))
    xs = np.floor(np.arange(w, dtype=np.float32) * np.float32(W / w))
    ys, xs = ys.astype(np.int64), xs.astype(np.int64)
    return x[..., ys[:, None], xs[None, :]]


def make_batch_scene(n_views: int, img_size, depth_size, seed: int,
                     n_src_on_either_side: int = 1):
    """Scene dict shaped for `collate_scenes` (GT depth on ref views only)."""
    sc = make_scene(n_views, img_size, seed)
    k = n_src_on_either_side
    depth_ref = sc["depth"][k: n_views - k] if k > 0 else sc["depth"]
    if tuple(depth_size) != tuple(img_size):
        depth_ref = resize_nearest_np(depth_ref, depth_size)
    return {
        "images": sc["images"],
        "rotmats": sc["rotmats"],
        "tvecs": sc["tvecs"],
        "K": sc["K"],
        "depth_gt": depth_ref.astype(np.float32),
        "poses": sc["poses"],
        "depth_full": sc["depth"],
    }
