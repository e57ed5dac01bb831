"""TSDF fusion (port of `tdvnet/ops/tsdf.py`): integration on the K9a
kernel, bounds on the host.

Semantics of the JAX package's `integrate_frames` (the reference's
`tsdf_atlas.TSDFFusion.integrate`): every voxel centre is projected into
each frame at the rounded pixel, sdf = (depth - voxel_z) / trunc clamped
to at most 1; voxels with sdf > -1 and a valid projection accumulate tsdf
+= sdf, weight += 1 and the pixel's colour; `finalize` divides by the
weight. The accumulators stay on the device across frame batches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tdvnet_torch.config import resolve_device
from tdvnet_torch.kernels.tsdf import Accumulators, tsdf_integrate


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor      # [V] normalized sdf (1 where unobserved)
    weight: torch.Tensor    # [V]
    color: torch.Tensor     # [V, 3]
    origin: np.ndarray      # [3]
    voxel_size: float
    dims: Tuple[int, int, int]


def integrate_frames(depths: torch.Tensor, colors: torch.Tensor,
                     projections: torch.Tensor, origin,
                     dims: Tuple[int, int, int], voxel_size: float,
                     trunc_ratio: float = 3.0,
                     init: Optional[Accumulators] = None) -> Accumulators:
    """Integrate a stack of frames into a TSDF on the frames' device.

    depths [N, H, W]; colors [N, H, W, 3] (fp32 or uint8); projections
    [N, 3, 4] (K[R|t], world to pixel); origin [3]. Returns (tsdf [V],
    weight [V], color [V, 3]), added to `init` when given.
    """
    origin = torch.as_tensor(np.asarray(origin, np.float32))
    return tsdf_integrate(depths, colors, projections, origin, tuple(dims),
                          float(voxel_size), float(trunc_ratio), init)


def finalize(tsdf, weight, color, origin, dims, voxel_size) -> TSDFVolume:
    """Normalize the accumulators; unobserved voxels get tsdf = 1 (empty)."""
    w = weight.clamp(min=1e-8)
    seen = weight > 0
    vals = torch.where(seen, tsdf / w, torch.ones_like(tsdf))
    cols = torch.where(seen[:, None], color / w[:, None],
                       torch.zeros_like(color))
    return TSDFVolume(tsdf=vals, weight=weight, color=cols,
                      origin=np.asarray(origin, np.float32),
                      voxel_size=voxel_size, dims=tuple(dims))


def compute_bounds(pts: np.ndarray, quantile: float = 0.995,
                   margin: float = 1.5) -> Tuple[np.ndarray, np.ndarray]:
    """Robust volume bounds from a point set (reference
    `processresults.py:102-105`: quantile bounds +- margin)."""
    lo = np.quantile(pts, 1 - quantile, axis=0) - margin
    hi = np.quantile(pts, quantile, axis=0) + margin
    return lo.astype(np.float32), hi.astype(np.float32)


def _bounds_points(depths: np.ndarray, projections: np.ndarray,
                   frame_batch: int) -> np.ndarray:
    """World points of every 4th pixel of every frame with a positive
    depth, by inverting the lifted 4x4 projection (host numpy, as in JAX)."""
    N, H, W = depths.shape
    pts_all = []
    for i in range(0, N, frame_batch):
        dd = depths[i:i + frame_batch]
        P = projections[i:i + frame_batch]
        P4 = np.concatenate([P, np.tile(np.array([[[0, 0, 0, 1.0]]],
                                                 np.float32),
                                        (P.shape[0], 1, 1))], axis=1)
        Pinv = np.linalg.inv(P4)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        stride = 4
        xs, ys = xs[::stride, ::stride], ys[::stride, ::stride]
        dd = np.asarray(dd)[:, ::stride, ::stride]
        w_h = 1.0 / np.maximum(dd, 1e-9)
        pix = np.stack([np.broadcast_to(xs, dd.shape),
                        np.broadcast_to(ys, dd.shape),
                        np.ones_like(dd), w_h], axis=1)   # [B, 4, h, w]
        pix = pix.reshape(pix.shape[0], 4, -1)
        p = np.einsum("nij,njk->nik", Pinv, pix)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = p[:, :3] / p[:, 3:]
        mask = (dd.reshape(dd.shape[0], -1) > 0)
        pts_all.append(p.transpose(0, 2, 1)[mask])
    pts_all = np.concatenate(pts_all, axis=0)
    return pts_all[np.isfinite(pts_all).all(axis=1)]


def volume_bounds(depths: np.ndarray, projections: np.ndarray,
                  voxel_size: float = 0.04, quantile: float = 0.995,
                  margin: float = 1.5, frame_batch: int = 100,
                  max_dim: int = 416):
    """(origin [3], dims) of the volume `fuse_scene` integrates: quantile
    bounds of the back-projected depths plus the margin, at most max_dim
    and at least 8 voxels per axis."""
    pts_all = _bounds_points(depths, projections, frame_batch)
    if pts_all.shape[0] == 0:
        # all-empty depth maps (e.g. an untrained method renders nothing):
        # integrate over a minimal unit volume -> empty mesh, not a crash
        pts_all = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
    lo, hi = compute_bounds(pts_all, quantile, margin)
    dims = np.minimum(np.ceil((hi - lo) / voxel_size).astype(int), max_dim)
    return lo, tuple(int(x) for x in np.maximum(dims, 8))


def fuse_scene(depths: np.ndarray, colors: np.ndarray,
               projections: np.ndarray, voxel_size: float = 0.04,
               trunc_ratio: float = 3.0, quantile: float = 0.995,
               margin: float = 1.5, frame_batch: int = 100,
               max_dim: int = 416, device=None) -> TSDFVolume:
    """End-to-end TSDF fusion of a scene with automatic bounds.

    Bounds come from back-projecting the depth maps on the host (quantile +
    margin like the reference); the volume is capped at max_dim voxels per
    axis. Frames go to the device a batch at a time (colors in their own
    dtype; uint8 colours stay uint8 for the kernel, which widens them
    exactly, others are converted to fp32 there), where the accumulators
    stay.
    """
    device = resolve_device(device)
    lo, dims = volume_bounds(depths, projections, voxel_size, quantile,
                             margin, frame_batch, max_dim)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    acc = None
    for i in range(0, depths.shape[0], frame_batch):
        sl = slice(i, i + frame_batch)
        cols = up(colors[sl])
        if cols.dtype != torch.uint8:
            cols = cols.to(torch.float32)
        acc = integrate_frames(up(depths[sl].astype(np.float32)), cols,
                               up(projections[sl].astype(np.float32)), lo,
                               dims, voxel_size, trunc_ratio, init=acc)
    return finalize(*acc, origin=lo, dims=dims, voxel_size=voxel_size)
