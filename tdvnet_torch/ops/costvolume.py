"""Plane-sweep variance cost volume and per-point variance features
(port of `tdvnet/ops/costvolume.py`, exact gather warp only).

The cost volume and the point variance reduce to one call of the
`source_variance` kernel over world points, the fast path's hypothesis-fan
variance to one call of `patch_fan_variance`. The card holds the result
whole, so nothing is chunked.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tdvnet_torch.kernels import patch_fan_variance, source_variance
from tdvnet_torch.ops import camera


def plane_sweep_cost_volume(feats: torch.Tensor, rotmats: torch.Tensor,
                            tvecs: torch.Tensor, K: torch.Tensor,
                            ref_idx: torch.Tensor, src_idx: torch.Tensor,
                            src_mask: torch.Tensor, depth_start: float,
                            depth_interval: float, n_planes: int,
                            img_size: Tuple[int, int],
                            plane_size: Tuple[int, int]) -> torch.Tensor:
    """Variance cost volume for each ref view.

    feats [N, Hf, Wf, C] (quarter-res features); ref_idx [R];
    src_idx/src_mask [R, S]. Returns [R, D, h, w, C] fp32, or bf16 for bf16
    features: the kernel rounds the fp32 variance once as it writes it, the
    JAX package's cast before CostRegNet.
    """
    h, w = plane_size
    pts = camera.plane_sweep_points(depth_start, depth_interval, n_planes,
                                    rotmats[ref_idx], tvecs[ref_idx],
                                    K[ref_idx], img_size, plane_size)
    P_all = camera.projection_matrix(K, rotmats, tvecs)
    var = source_variance(pts.contiguous(), feats.contiguous(), src_idx,
                          src_mask, P_all.contiguous(), img_size, (h, w),
                          out_dtype=feats.dtype)
    return var.reshape(ref_idx.shape[0], n_planes, h, w, -1)


def hypothesis_point_variance(pts_world: torch.Tensor, feats: torch.Tensor,
                              src_idx: torch.Tensor, src_mask: torch.Tensor,
                              rotmats: torch.Tensor, tvecs: torch.Tensor,
                              K: torch.Tensor,
                              img_size: Tuple[int, int],
                              plane: Tuple[int, int]) -> torch.Tensor:
    """Variance feature [R, P, C] fp32 (from fp32 or bf16 features) at
    world points [R, P, 3] owned by ref r; `plane` (h, w): the points are
    planes of an h x w pixel grid (see `source_variance`)."""
    P_all = camera.projection_matrix(K, rotmats, tvecs)
    return source_variance(pts_world.contiguous(), feats.contiguous(),
                           src_idx, src_mask, P_all.contiguous(), img_size,
                           plane)


def hypothesis_patch_variance(pts_hyp: torch.Tensor, feats: torch.Tensor,
                              src_idx: torch.Tensor, src_mask: torch.Tensor,
                              rotmats: torch.Tensor, tvecs: torch.Tensor,
                              K: torch.Tensor,
                              img_size: Tuple[int, int]) -> torch.Tensor:
    """Fast-path variance over hypothesis fans: pts_hyp [R, Hh, P, 3] (the
    Hh hypotheses of P pixels, the centre one at Hh // 2) -> [R, Hh, P, C],
    each hypothesis sampled from one 4x4 patch per (pixel, source) around
    the centre's anchor (see `patch_fan_variance_ref`)."""
    P_all = camera.projection_matrix(K, rotmats, tvecs)
    return patch_fan_variance(pts_hyp.contiguous(), feats.contiguous(),
                              src_idx, src_mask, P_all.contiguous(), img_size)
