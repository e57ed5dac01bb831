"""Masked GroupNorm with the scene U-Net's ReLU / residual tails (K5).

Kernel: `csrc/masked_group_norm.cu` (see its header for the TPU op it
replaces, its bound and its design). `masked_group_norm_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import (check, launch, no_backward,
                                          on_cpu)

CHUNK = 4096              # voxels per block of the statistics pass


def masked_group_norm_ref(x: torch.Tensor, mask: torch.Tensor,
                          num_groups: int, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5,
                          relu: bool = False,
                          skip: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """GroupNorm over active voxels only.

    x [B, C, gx, gy, gz]; mask [B, 1, gx, gy, gz] in {0, 1}. Statistics are
    per (batch, group) over the active sites and the group's channels: the
    count is that of the batch element's own mask times C/G. The result is
    y = (normalized * weight + bias) * mask, then `relu(y) * mask` with
    `relu`, or `relu(y + skip) * mask` with a `skip` of x's shape.
    """
    B, C = x.shape[:2]
    G = num_groups
    xg = x.reshape(B, G, C // G, -1).to(torch.float32)        # [B, G, c, V]
    m = mask.reshape(B, 1, 1, -1).to(torch.float32)
    cnt = (m.sum(dim=(2, 3)) * (C // G)).clamp(min=1.0)        # [B, 1]
    s1 = (xg * m).sum(dim=(2, 3))                              # [B, G]
    s2 = (xg * xg * m).sum(dim=(2, 3))
    mean = s1 / cnt
    var = s2 / cnt - mean * mean
    xn = (xg - mean[..., None, None]) * torch.rsqrt(
        var.clamp(min=0.0) + eps)[..., None, None]
    xn = xn.reshape(x.shape).to(x.dtype)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = (xn * weight.reshape(shape) + bias.reshape(shape)) * mask
    if skip is not None:
        return F.relu(y + skip) * mask
    return F.relu(y) * mask if relu else y


def masked_group_norm(x: torch.Tensor, mask: torch.Tensor, num_groups: int,
                      weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5, relu: bool = False,
                      skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    tensors = (x, mask, weight, bias) + (() if skip is None else (skip,))
    if on_cpu(*tensors):
        return masked_group_norm_ref(x, mask, num_groups, weight, bias, eps,
                                     relu, skip)
    no_backward("masked_group_norm", *tensors)
    B, C = x.shape[:2]
    G = num_groups
    if C % G:
        raise ValueError(f"masked_group_norm: C={C} not divisible by G={G}")
    dims = tuple(x.shape[2:])
    V = 1
    for d in dims:
        V *= d
    check(x, "x", torch.float32)
    check(mask, "mask", torch.float32, (B, 1, *dims))
    check(weight, "weight", torch.float32, (C,))
    check(bias, "bias", torch.float32, (C,))
    if skip is not None:
        check(skip, "skip", torch.float32, tuple(x.shape))
    dev = x.device
    out = torch.empty_like(x)
    n_chunks = -(-V // CHUNK)
    partial = torch.empty((B * G, n_chunks, 3), dtype=torch.float32,
                          device=dev)
    stats = torch.empty((B * G, 2), dtype=torch.float32, device=dev)
    mode = 2 if skip is not None else int(relu)
    launch("tdv_masked_group_norm", dev, x.data_ptr(), mask.data_ptr(),
           weight.data_ptr(), bias.data_ptr(),
           skip.data_ptr() if skip is not None else None, out.data_ptr(),
           partial.data_ptr(), stats.data_ptr(), B, C, G, V, float(eps), mode,
           CHUNK)
    masked_group_norm.launches += 1
    return out


masked_group_norm.launches = 0
