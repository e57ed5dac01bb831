"""2D depth metrics and the training loss (port of
`tdvnet/eval/metrics2d.py`): per-image masked means over GT in [0.5, 65) m,
then a weighted mean over images; `mae_loss` over GT != 0."""
from __future__ import annotations

from typing import Dict, Optional

import torch

GT_MIN = 0.5
GT_MAX = 65.0


def calc_2d_depth_metrics(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                          img_weight: Optional[torch.Tensor] = None,
                          pred_valid: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """depth_pred/depth_gt [N, H, W]; img_weight [N] (0 for padded slots)."""
    out = {}
    valid = (depth_gt >= GT_MIN) & (depth_gt < GT_MAX)
    if pred_valid is not None:
        valid = valid & pred_valid
        out["perc_valid"] = (pred_valid.sum(dim=(1, 2)).float()
                             / (pred_valid.shape[1] * pred_valid.shape[2])
                             ).mean()
    valid = valid.to(torch.float32)
    denom = valid.sum(dim=(1, 2)) + 1e-7
    if img_weight is None:
        img_weight = torch.ones(depth_pred.shape[0], dtype=torch.float32,
                                device=depth_pred.device)
    wsum = img_weight.sum().clamp(min=1e-7)

    def img_mean(per_img):
        return (per_img * img_weight).sum() / wsum

    abs_diff = (depth_pred - depth_gt).abs()
    abs_inv = (1.0 / depth_pred - 1.0 / depth_gt).abs()
    abs_inv = torch.where(torch.isfinite(abs_inv), abs_inv,
                          torch.zeros_like(abs_inv))

    out["abs_rel"] = img_mean((abs_diff / (depth_gt + 1e-7) * valid)
                              .sum(dim=(1, 2)) / denom)
    out["sq_rel"] = img_mean((abs_diff ** 2 / (depth_gt + 1e-7) * valid)
                             .sum(dim=(1, 2)) / denom)
    out["rmse"] = img_mean(torch.sqrt((abs_diff ** 2 * valid)
                                      .sum(dim=(1, 2)) / denom))
    out["abs_diff"] = img_mean((abs_diff * valid).sum(dim=(1, 2)) / denom)
    out["abs_inv"] = img_mean((abs_inv * valid).sum(dim=(1, 2)) / denom)

    safe_gt = torch.where(depth_gt > 0, depth_gt, torch.ones_like(depth_gt))
    safe_pred = torch.where(depth_pred > 0, depth_pred,
                            torch.full_like(depth_pred, 1e-7))
    rel_max = torch.maximum(safe_pred / safe_gt, safe_gt / safe_pred)
    for name, thr in [("d_125", 1.25), ("d_125_2", 1.25 ** 2),
                      ("d_125_3", 1.25 ** 3)]:
        out[name] = img_mean(((rel_max < thr) * valid).sum(dim=(1, 2))
                             / denom)
    return out


def mae_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
             depth_interval: float,
             img_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean absolute error in units of depth intervals (the JAX
    package's `mae_loss`); GT == 0 pixels are invalid. Per image over its
    valid pixels, then the mean over images, or their `img_weight`-weighted
    mean."""
    mask = (depth_gt != 0.0).to(torch.float32)
    denom = mask.sum(dim=(1, 2)) + 1e-7
    per_img = (mask * (depth_pred - depth_gt).abs()).sum(dim=(1, 2))
    per_img = per_img / depth_interval / denom
    if img_weight is None:
        return per_img.mean()
    return (per_img * img_weight).sum() / img_weight.sum().clamp(min=1e-7)
