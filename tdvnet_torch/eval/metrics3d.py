"""3D reconstruction metrics: accuracy / completeness / precision / recall /
F-score via bidirectional nearest-neighbor distances (copy of
`tdvnet/eval/metrics3d.py`, host numpy).

Same definitions as the reference (`mv3d/eval/metricfunctions.py:70-123`):
dist1 = pred→gt NN distances (accuracy / precision), dist2 = gt→pred
(completeness / recall), F = 2PR/(P+R+1e-8), threshold default 5 cm.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from tdvnet_torch.ops.pointcloud import nn_distances


def eval_point_clouds(pts_pred: np.ndarray, pts_gt: np.ndarray,
                      threshold: float = 0.05) -> Dict[str, float]:
    dist1 = nn_distances(pts_pred, pts_gt)
    dist2 = nn_distances(pts_gt, pts_pred)
    precision = float(np.mean((dist1 < threshold).astype(np.float64))) \
        if dist1.size else 0.0
    recall = float(np.mean((dist2 < threshold).astype(np.float64))) \
        if dist2.size else 0.0
    fscore = 2 * precision * recall / (precision + recall + 1e-8)
    return {
        "acc": float(np.mean(dist1)) if dist1.size else 0.0,
        "comp": float(np.mean(dist2)) if dist2.size else 0.0,
        "prec": precision,
        "recal": recall,          # reference spelling, kept for parity
        "fscore": fscore,
        # point counts so a 0.000 score from an EMPTY prediction cloud is
        # distinguishable from a real zero; extra keys, reference metrics
        # unchanged
        "n_pred_points": int(pts_pred.shape[0]),
        "n_gt_points": int(pts_gt.shape[0]),
    }
