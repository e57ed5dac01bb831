"""Camera geometry: projection, back-projection, plane-sweep frustum points
(port of `tdvnet/ops/camera.py`, fp32).

Conventions:
- ``rotmat`` R is world->camera rotation, ``tvec`` t the world->camera
  translation: ``x_cam = R @ x_world + t``.
- Pixel grids sample ``linspace(0, W-1, w_out)``: a coarse h x w grid spans
  the full image including both edge pixel centers.
- Projections divide by ``|z| + 1e-8``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

EPS_Z = 1e-8


def linspace_f32(start: float, stop: float, num: int, device=None):
    """`jnp.linspace` in float32 as XLA compiles it for constant bounds:
    start * (1 - i * c) + i * (stop * c) with c = 1 / (num - 1), each
    product rounded to float32, and the last value pinned to `stop`."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    c = np.float32(1) / np.float32(div)
    c_stop = np.float32(stop) * c
    i = torch.arange(div, dtype=torch.float32, device=device)
    head = float(np.float32(start)) * (1 - i * float(c)) + i * float(c_stop)
    tail = torch.full((1,), float(np.float32(stop)), dtype=torch.float32,
                      device=device)
    return torch.cat([head, tail])


def build_img_grid(img_size: Tuple[int, int], plane_size: Tuple[int, int],
                   device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates (x, y, 1) of a coarse grid over the
    image, [h*w, 3] float32, x varying fastest."""
    H, W = img_size
    h, w = plane_size
    xs = linspace_f32(0.0, W - 1.0, w, device)
    ys = linspace_f32(0.0, H - 1.0, h, device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1).reshape(-1, 3)


def projection_matrix(K: torch.Tensor, rotmat: torch.Tensor,
                      tvec: torch.Tensor) -> torch.Tensor:
    """P = K @ [R | t], shape [..., 3, 4]."""
    Rt = torch.cat([rotmat, tvec[..., None]], dim=-1)
    return K @ Rt


def project_points(pts_world: torch.Tensor, P: torch.Tensor):
    """Project world points [..., N, 3] with P [..., 3, 4].

    Returns (xy [..., N, 2] pixel coords, z [..., N] camera depth).
    """
    xyz = pts_world @ P[..., :3].transpose(-1, -2) + P[..., None, :, 3]
    z = xyz[..., 2]
    denom = z.abs() + EPS_Z
    return xyz[..., :2] / denom[..., None], z


def backproject_grid(depth: torch.Tensor, K: torch.Tensor,
                     rotmat: torch.Tensor, tvec: torch.Tensor,
                     img_size: Tuple[int, int]) -> torch.Tensor:
    """Back-project per-pixel depths [N, h, w] to world points [N, h*w, 3]."""
    n, h, w = depth.shape
    grid = build_img_grid(img_size, (h, w), depth.device)
    rays = grid @ torch.linalg.inv(K).transpose(-1, -2)        # [N, P, 3]
    pts_cam = rays * depth.reshape(n, h * w, 1)
    return (pts_cam - tvec[:, None, :]) @ rotmat


def plane_sweep_points(depth_start: float, depth_interval: float,
                       n_planes: int, rotmat: torch.Tensor,
                       tvec: torch.Tensor, K: torch.Tensor,
                       img_size: Tuple[int, int],
                       plane_size: Tuple[int, int]) -> torch.Tensor:
    """World-space frustum points of a fronto-parallel plane sweep,
    [N, D*h*w, 3] in plane-major (d, y, x) order."""
    grid = build_img_grid(img_size, plane_size, K.device)
    depth_end = depth_start + (n_planes - 1) * depth_interval
    depths = linspace_f32(depth_start, depth_end, n_planes, K.device)
    pts_img = (grid[None, :, :] * depths[:, None, None]).reshape(-1, 3)
    pts_cam = pts_img @ torch.linalg.inv(K).transpose(-1, -2)
    return (pts_cam - tvec[:, None, :]) @ rotmat


def camera_center(rotmat: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """World-space camera center c = -R^T t, shape [..., 3]."""
    return -(rotmat.transpose(-1, -2) @ tvec[..., None])[..., 0]


def world_to_cam(pose: torch.Tensor):
    """Convert a cam->world 4x4 pose into world->camera (R, t)."""
    R = pose[..., :3, :3].transpose(-1, -2)
    t = -(R @ pose[..., :3, 3:4])[..., 0]
    return R, t


def normalize_pixel_coords(xy: torch.Tensor,
                           img_size: Tuple[int, int]) -> torch.Tensor:
    """Map pixel coords to [-1, 1] with align-corners semantics."""
    H, W = img_size
    x = xy[..., 0] / (W - 1.0) * 2.0 - 1.0
    y = xy[..., 1] / (H - 1.0) * 2.0 - 1.0
    return torch.stack([x, y], dim=-1)


def scale_intrinsics(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale intrinsics for a resized image (row 0 *= sx, row 1 *= sy)."""
    scale = torch.tensor([[sx], [sy], [1.0]], dtype=K.dtype, device=K.device)
    return K * scale
