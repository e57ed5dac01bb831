"""Plane-sweep variance cost volume and per-point variance features
(port of `tdvnet/ops/costvolume.py`, exact gather warp only).

Both reduce to one call of the `source_variance` kernel over world points.
The card holds the [R, P, C] result whole, so nothing is chunked.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tdvnet_torch.kernels import source_variance
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
    src_idx/src_mask [R, S]. Returns [R, D, h, w, C] fp32.
    """
    h, w = plane_size
    pts = camera.plane_sweep_points(depth_start, depth_interval, n_planes,
                                    rotmats[ref_idx], tvecs[ref_idx],
                                    K[ref_idx], img_size, plane_size)
    P_all = camera.projection_matrix(K, rotmats, tvecs)
    var = source_variance(pts.contiguous(), feats.contiguous(), src_idx,
                          src_mask, P_all.contiguous(), img_size)
    return var.reshape(ref_idx.shape[0], n_planes, h, w, -1)


def hypothesis_point_variance(pts_world: torch.Tensor, feats: torch.Tensor,
                              src_idx: torch.Tensor, src_mask: torch.Tensor,
                              rotmats: torch.Tensor, tvecs: torch.Tensor,
                              K: torch.Tensor,
                              img_size: Tuple[int, int]) -> torch.Tensor:
    """Variance feature [R, P, C] at world points [R, P, 3] owned by ref r."""
    P_all = camera.projection_matrix(K, rotmats, tvecs)
    return source_variance(pts_world.contiguous(), feats.contiguous(),
                           src_idx, src_mask, P_all.contiguous(), img_size)
