"""Shared conv blocks (NCHW / NCDHW inside) and masked GroupNorm (port of
`tdvnet/models/layers.py`).

Submodule names mirror the flax parameter tree (`Conv_0`, `BatchNorm_0`,
...), so each checkpoint key maps one to one onto a state-dict key.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_BN = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


def batch_norm(nd: int, features: int) -> nn.Module:
    # flax BatchNorm momentum 0.9 (weight of the old statistic) is torch's 0.1
    return _BN[nd](features, eps=1e-5, momentum=0.1)


def same_pads(in_sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """XLA 'SAME' padding (lo, hi) per spatial dim."""
    out = []
    for i, k, s in zip(in_sizes, kernel, strides):
        o = -(-i // s)
        total = max((o - 1) * s + k - i, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


class ConvBnRelu(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU, 2D or 3D. Pads k//2 on both sides
    at every stride, as torch does and as the JAX package does explicitly."""

    def __init__(self, in_ch: int, features: int, kernel_size=(3, 3),
                 strides=None):
        super().__init__()
        nd = len(kernel_size)
        strides = strides or (1,) * nd
        self.Conv_0 = _CONV[nd](in_ch, features, tuple(kernel_size),
                                stride=tuple(strides),
                                padding=tuple(k // 2 for k in kernel_size),
                                bias=False)
        self.BatchNorm_0 = batch_norm(nd, features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def up_conv3d(in_ch: int, features: int):
    """The JAX package's input-dilated conv (lhs dilation 2, padding (1, 2),
    kernel 3): a stride-2 transposed conv with output_padding 1. The
    checkpoint's kernel is flipped and transposed into this layout."""
    return nn.ConvTranspose3d(in_ch, features, 3, stride=2, padding=1,
                              output_padding=1, bias=False)


class ConvTransposeUp3d(nn.Module):
    """Stride-2 3D transposed conv x2 upsampling + BN + ReLU."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = up_conv3d(in_ch, features)
        self.BatchNorm_0 = batch_norm(3, features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def masked_group_norm(x: torch.Tensor, mask: torch.Tensor, num_groups: int,
                      weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over active voxels only.

    x [B, C, gx, gy, gz]; mask [B, 1, gx, gy, gz] in {0, 1}. Statistics are
    per (batch, group) over the active sites and the group's channels: the
    count is that of the batch element's own mask times C/G.
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
    return (xn * weight.reshape(shape) + bias.reshape(shape)) * mask


class MaskedGroupNorm(nn.Module):
    """Masked GroupNorm with an affine; `weight`/`bias` are the flax
    `scale`/`bias`."""

    def __init__(self, num_groups: int, features: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask):
        return masked_group_norm(x, mask, self.num_groups, self.weight,
                                 self.bias)


def downsample_mask(mask: torch.Tensor) -> torch.Tensor:
    """2x max-pool of a [B, 1, gx, gy, gz] occupancy mask: the active set of
    a stride-2 sparse conv."""
    return F.max_pool3d(mask, 2, 2)
