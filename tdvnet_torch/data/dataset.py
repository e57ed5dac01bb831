"""`info.json` scene dataset: loading, preprocessing, augmentation (port of
`tdvnet/data/dataset.py`, host numpy).

Images are read and resized by `data/imageio.py` (PNG only; OpenCV's
uint8 `INTER_LINEAR` and `INTER_NEAREST` reproduced bit for bit) in place
of `cv2`. The `info.json` contract is the reference preprocessors':
  {"scene": str, "path": str, "gt_mesh": str, "intrinsics": [3x3],
   "frames": [{"filename_color": str, "filename_depth": str,
               "pose": [4x4 cam->world]}]}
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from tdvnet_torch.data import imageio
from tdvnet_torch.data.batch import (FrameBatch, collate_scenes,
                                     single_scene_views)
from tdvnet_torch.data.frameselector import FrameSelector
from tdvnet_torch.data.synthetic import resize_nearest_np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
DEPTH_INVALID_ABOVE = 65.0   # 7-scenes stores invalid depth as 65_535 mm


def compute_crop_and_intrinsics(K: np.ndarray, old_hw: Tuple[int, int],
                                new_hw: Tuple[int, int], crop: bool,
                                distortion_crop: int = 0):
    """Aspect-preserving center-crop geometry + rescaled intrinsics
    (reference `PreprocessImage`, `dataset.py:21-96`)."""
    oh, ow = old_hw
    nh, nw = new_hw
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if crop:
        ch, cw = oh - 2 * distortion_crop, ow - 2 * distortion_crop
        old_ar, new_ar = cw / ch, nw / nh
        if old_ar > new_ar:
            target_w = ch * new_ar
            crop_x = int(np.floor((cw - target_w) / 2.0)) + distortion_crop
            crop_y = distortion_crop
        else:
            target_h = cw / new_ar
            crop_x = distortion_crop
            crop_y = int(np.floor((ch - target_h) / 2.0)) + distortion_crop
        cx, cy = cx - crop_x, cy - crop_y
        ih, iw = oh - 2 * crop_y, ow - 2 * crop_x
        sx, sy = nw / iw, nh / ih
    else:
        crop_x = crop_y = 0
        sx, sy = nw / ow, nh / oh
    K_new = np.array([[fx * sx, 0, cx * sx], [0, fy * sy, cy * sy],
                      [0, 0, 1]], np.float32)
    return crop_x, crop_y, K_new


def _adjust_gamma(x, g):
    return np.clip(x, 0, 1) ** g


def _adjust_contrast(x, c):
    return np.clip(x * c, 0, 1)


def _adjust_brightness(x, b):
    return np.clip(x + b, 0, 1)


class Dataset:
    """Per-scene loader (reference `Dataset`, `dataset.py:99-237`)."""

    def __init__(self, scene_dirs: Sequence[str], frame_selector: FrameSelector,
                 n_ref_imgs: Optional[int] = None,
                 depth_img_size: Tuple[int, int] = (56, 56),
                 img_size: Tuple[int, int] = (256, 320), augment: bool = False,
                 scale_rgb: float = 255.0, mean_rgb=IMAGENET_MEAN,
                 std_rgb=IMAGENET_STD, n_src_on_either_side: int = 1,
                 crop: bool = False, rng: Optional[np.random.Generator] = None):
        self.scene_dirs = list(scene_dirs)
        self.frame_selector = frame_selector
        self.n_ref_imgs = n_ref_imgs
        self.depth_img_size = tuple(depth_img_size)
        self.img_size = tuple(img_size)
        self.augment = augment
        self.scale_rgb = scale_rgb
        self.mean_rgb = np.asarray(mean_rgb, np.float32)
        self.std_rgb = np.asarray(std_rgb, np.float32)
        self.k = n_src_on_either_side
        self.crop = crop
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.scene_dirs)

    def scene_info(self, idx: int) -> Dict:
        with open(os.path.join(self.scene_dirs[idx], "info.json")) as f:
            return json.load(f)

    def load_views(self, idx: int, seed_idx: Optional[int] = None):
        """Select frames and load preprocessed views.

        Returns a dict: images [V,H,W,3] (normalized), images_u8 and the
        normalization constants, depth [V,H,W] (at img resolution,
        invalid->0), rotmats/tvecs (world->cam), K [V,3,3], poses [V,4,4],
        img_idx [V].
        """
        info = self.scene_info(idx)
        poses = np.stack([np.asarray(f["pose"], np.float32)
                          for f in info["frames"]])
        K = np.asarray(info["intrinsics"], np.float32)

        n_imgs = (self.n_ref_imgs + 2 * self.k
                  if self.n_ref_imgs is not None else 100_000)
        img_idx = self.frame_selector.select_frames(poses, n_imgs, seed_idx)

        images, depths = [], []
        crop_x = crop_y = 0
        K_new = K
        rgb_sum = 0.0
        for j, i in enumerate(img_idx):
            fr = info["frames"][int(i)]
            color = imageio.imread(fr["filename_color"])
            depth = imageio.imread_depth(fr["filename_depth"])
            depth = depth.astype(np.float32) / 1000.0
            invalid = (~np.isfinite(depth)) | (depth > DEPTH_INVALID_ABOVE)
            depth[invalid] = 0.0
            if j == 0:
                crop_x, crop_y, K_new = compute_crop_and_intrinsics(
                    K, color.shape[:2], self.img_size, self.crop)
            if crop_y or crop_x:
                color = color[crop_y:color.shape[0] - crop_y,
                              crop_x:color.shape[1] - crop_x]
                depth = depth[crop_y:depth.shape[0] - crop_y,
                              crop_x:depth.shape[1] - crop_x]
            color = imageio.resize_linear_u8(color, self.img_size)
            depth = imageio.resize_nearest(depth, self.img_size)
            color = color[..., ::-1].astype(np.float32)  # BGR -> RGB
            rgb_sum += color.sum()
            images.append(color)
            depths.append(depth)

        rgb_avg = rgb_sum / (len(images) * self.img_size[0]
                             * self.img_size[1] * 3)

        # color augmentation in random order (reference `dataset.py:179-205`)
        transforms = []
        if self.augment and 55.0 < rgb_avg < 200.0:
            transforms = [(_adjust_gamma, self.rng.uniform(0.8, 1.2)),
                          (_adjust_contrast, self.rng.uniform(0.8, 1.2)),
                          (_adjust_brightness, self.rng.uniform(-0.03, 0.03))]
            self.rng.shuffle(transforms)

        out_images, out_u8 = [], []
        for img in images:
            x = img / 255.0
            for fn, val in transforms:
                x = fn(x, val)
            # the raw uint8 image beside the normalized floats: inference
            # uploads this 4x smaller stack and normalizes on the device
            out_u8.append(np.clip(np.round(x * 255.0), 0, 255)
                          .astype(np.uint8))
            x = x * 255.0 / self.scale_rgb
            x = (x - self.mean_rgb) / self.std_rgb
            out_images.append(x.astype(np.float32))

        rotmats = poses[img_idx, :3, :3].transpose(0, 2, 1)       # R = P^T
        cam_centers = poses[img_idx, :3, 3]
        tvecs = -np.einsum("nij,nj->ni", rotmats, cam_centers)

        depth_all = np.stack(depths)
        # geometric augmentation: gravity-axis rotation + metric scale
        if self.augment:
            theta = self.rng.uniform(-np.pi, np.pi)
            c, s = np.cos(theta), np.sin(theta)
            R_aug = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            rotmats = rotmats @ R_aug.T
            S_aug = self.rng.uniform(0.9, 1.1)
            depth_all = depth_all * S_aug
            tvecs = tvecs * S_aug

        return {
            "images": np.stack(out_images),
            "images_u8": np.stack(out_u8),
            "rgb_scale": float(self.scale_rgb),
            "rgb_mean": self.mean_rgb,
            "rgb_std": self.std_rgb,
            "depth": depth_all.astype(np.float32),
            "rotmats": rotmats.astype(np.float32),
            "tvecs": tvecs.astype(np.float32),
            "K": np.repeat(K_new[None], len(img_idx), 0),
            "poses": poses[img_idx],
            "img_idx": np.asarray(img_idx),
        }

    def _ref_depth(self, v: Dict) -> np.ndarray:
        nv, k = v["images"].shape[0], self.k
        return v["depth"][k: nv - k] if k > 0 else v["depth"]

    def get_scene_dict(self, idx: int, seed_idx: Optional[int] = None) -> Dict:
        """Scene dict shaped for `collate_scenes` (GT depth on refs only)."""
        v = self.load_views(idx, seed_idx)
        depth_ref = self._ref_depth(v)
        if self.depth_img_size != self.img_size:
            depth_ref = resize_nearest_np(depth_ref, self.depth_img_size)
        return {**v, "depth_gt": depth_ref}

    def get_batch(self, scene_indices: Sequence[int], n_views: int,
                  n_ref: int) -> FrameBatch:
        scenes = [self.get_scene_dict(i) for i in scene_indices]
        return collate_scenes(scenes, n_views, n_ref, self.k)

    def get_whole_scene(self, idx: int, seed_idx: int = 0):
        """Whole-scene FrameBatch for eval (all keyframes, exact shapes).

        Returns (batch, scene_dict): GT depth at image resolution.
        """
        v = self.load_views(idx, seed_idx)
        fb = single_scene_views(v["images"], v["rotmats"], v["tvecs"],
                                v["K"], None, self.k)
        fb = dataclasses.replace(fb, depth_gt=None)
        return fb, {**v, "depth_gt": self._ref_depth(v)}
