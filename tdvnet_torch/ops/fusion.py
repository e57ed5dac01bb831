"""Multi-view consistency point-cloud fusion (port of `tdvnet/ops/fusion.py`)
on the K9b kernel.

For every pixel of every ref view: back-project at its predicted depth,
reproject into every view, nearest-sample that view's depth, count the
views with |z_reproj - z_sampled| < z_thresh; keep pixels seen
consistently by >= n_consistent views; the fused point is the mean of the
ref point and the consistent views' back-projected sample points. Refs go
through the kernel in chunks of `ref_chunk` against all views.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tdvnet_torch.config import resolve_device
from tdvnet_torch.kernels.fusion import camera_table, consistency_fuse


def fuse_point_cloud(depth_preds: np.ndarray, images: np.ndarray,
                     rotmats: np.ndarray, tvecs: np.ndarray, K: np.ndarray,
                     z_thresh: float = 0.01, n_consistent: int = 3,
                     ref_chunk: int = 16, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse a whole scene's depth maps into a consistent point cloud.

    depth_preds: [N, H, W]; images: [N, H, W, 3] (uint8 or float);
    rotmats/tvecs/K: world->cam cameras at depth resolution.
    Returns (points [M, 3], colors [M, 3]) as host numpy arrays, in
    ref-major pixel order: the kept points are compacted on the device by
    boolean indexing, which keeps that order, and the colours with the same
    mask on the host.
    """
    device = resolve_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(device)
    N = depth_preds.shape[0]
    all_depth = up(depth_preds)
    cams = camera_table(up(K), up(rotmats), up(tvecs))
    depth_max = all_depth.reshape(N, -1).amax(1)     # the kernel's cull
    pts_out, rgb_out = [], []
    for c0 in range(0, N, ref_chunk):
        c1 = min(c0 + ref_chunk, N)
        idx = torch.arange(c0, c1, device=device)
        pts, keep = consistency_fuse(all_depth[c0:c1], all_depth, cams, idx,
                                     float(z_thresh), int(n_consistent),
                                     depth_max=depth_max)
        keep = keep.reshape(-1)
        pts_out.append(pts.reshape(-1, 3)[keep].cpu().numpy())
        rgb = np.asarray(images[c0:c1]).reshape(-1, 3)
        rgb_out.append(rgb[keep.cpu().numpy()])
    return np.concatenate(pts_out, axis=0), np.concatenate(rgb_out, axis=0)
