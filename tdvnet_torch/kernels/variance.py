"""Masked per-point feature variance over each ref view's sources (K1+K2).

Kernel: `csrc/source_variance.cu` (see its header for the TPU op it
replaces, its bound and its design). `source_variance_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tdvnet_torch.kernels._launch import check, launch, on_cpu
from tdvnet_torch.ops import camera
from tdvnet_torch.ops.sampling import bilinear_sample_batched


def _feature_scale(feats: torch.Tensor, img_size: Tuple[int, int]):
    """Pixel -> feature-grid factors (align corners: x_f = x*(Wf-1)/(W-1))."""
    Hf, Wf = feats.shape[1:3]
    H, W = img_size
    return (Wf - 1.0) / (W - 1.0), (Hf - 1.0) / (H - 1.0)


def source_variance_ref(pts_world: torch.Tensor, feats: torch.Tensor,
                        src_idx: torch.Tensor, src_mask: torch.Tensor,
                        P_all: torch.Tensor,
                        img_size: Tuple[int, int]) -> torch.Tensor:
    """pts_world [R, P, 3]; feats [N, Hf, Wf, C]; src_idx/src_mask [R, S];
    P_all [N, 3, 4] (full-image pixel units). Returns var [R, P, C] fp32:
    E[f^2] - E[f]^2 over the real sources, with cnt = max(sum(mask), 1)."""
    R, P, _ = pts_world.shape
    S = src_idx.shape[1]
    C = feats.shape[-1]
    sx, sy = _feature_scale(feats, img_size)
    scale = torch.tensor([sx, sy], dtype=torch.float32, device=feats.device)
    mask = src_mask.to(torch.float32)
    cnt = mask.sum(dim=1).clamp(min=1.0)[:, None, None]
    acc = torch.zeros((R, P, C), dtype=torch.float32, device=feats.device)
    acc_sq = torch.zeros_like(acc)
    for s in range(S):
        idx = src_idx[:, s]
        xy, _ = camera.project_points(pts_world, P_all[idx])
        f = bilinear_sample_batched(feats[idx], xy * scale)
        m = mask[:, s, None, None]
        acc = acc + f * m
        acc_sq = acc_sq + f * f * m
    mean = acc / cnt
    return acc_sq / cnt - mean * mean


def source_variance(pts_world: torch.Tensor, feats: torch.Tensor,
                    src_idx: torch.Tensor, src_mask: torch.Tensor,
                    P_all: torch.Tensor,
                    img_size: Tuple[int, int]) -> torch.Tensor:
    """Same contract as `source_variance_ref`; launches the CUDA kernel for
    CUDA tensors."""
    if on_cpu(pts_world, feats, src_idx, src_mask, P_all):
        return source_variance_ref(pts_world, feats, src_idx, src_mask,
                                   P_all, img_size)
    R, P, _ = pts_world.shape
    N, Hf, Wf, C = feats.shape
    S = src_idx.shape[1]
    if C % 4:
        raise ValueError(f"source_variance: C={C} must be a multiple of 4")
    check(pts_world, "pts_world", torch.float32, (R, P, 3))
    check(feats, "feats", torch.float32, (N, Hf, Wf, C))
    check(src_idx, "src_idx", torch.int64, (R, S))
    check(P_all, "P_all", torch.float32, (N, 3, 4))
    check(src_mask, "src_mask", src_mask.dtype, (R, S), contiguous=False)
    src_w = src_mask.to(torch.float32).contiguous()
    sx, sy = _feature_scale(feats, img_size)
    out = torch.empty((R, P, C), dtype=torch.float32, device=feats.device)
    launch("tdv_source_variance", feats.device, feats.data_ptr(),
           pts_world.data_ptr(), src_idx.data_ptr(), src_w.data_ptr(),
           P_all.data_ptr(), out.data_ptr(), R, P, S, Hf, Wf, C, sx, sy)
    source_variance.launches += 1
    return out


source_variance.launches = 0
