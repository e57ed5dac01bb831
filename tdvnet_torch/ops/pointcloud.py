"""Point-cloud utilities on the host: voxel downsample, nearest-neighbor
correspondence (numpy copy of `tdvnet/ops/pointcloud.py`).

Replaces the reference's Open3D C++ calls:
- `voxel_down_sample` (`mv3d/eval/processresults.py:191,284`) → hash-dedup
  averaging (same semantics: one point per occupied voxel, mean of members);
- `KDTreeFlann.search_knn_vector_3d` (`mv3d/eval/metricfunctions.py:117-123`)
  → scipy cKDTree (C-backed).
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(pts: np.ndarray, voxel_size: float,
                     colors: np.ndarray | None = None):
    """Average points (and colors) within each voxel."""
    if pts.shape[0] == 0:
        return (pts, colors) if colors is not None else pts
    idx = np.floor(pts / voxel_size).astype(np.int64)
    # lexicographic unique via structured view
    key, inv = np.unique(idx, axis=0, return_inverse=True)
    n = key.shape[0]
    cnt = np.bincount(inv, minlength=n).astype(np.float64)
    out = np.stack([np.bincount(inv, pts[:, i], n) for i in range(3)],
                   axis=1) / cnt[:, None]
    if colors is not None:
        cols = np.stack([np.bincount(inv, colors[:, i].astype(np.float64), n)
                         for i in range(colors.shape[1])], axis=1) / cnt[:, None]
        return out.astype(np.float32), cols
    return out.astype(np.float32)


def nn_distances(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    """For each point in `from_pts`, distance to nearest point in `to_pts`."""
    if from_pts.shape[0] == 0 or to_pts.shape[0] == 0:
        return np.zeros((0,), np.float32)
    from scipy.spatial import cKDTree

    tree = cKDTree(to_pts)
    d, _ = tree.query(from_pts, k=1, workers=-1)
    return np.asarray(d, np.float32)
