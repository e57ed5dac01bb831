"""Shared conv blocks (NCHW / NCDHW inside), BatchNorm with flax's
training rules and masked GroupNorm (port of `tdvnet/models/layers.py`).

Submodule names mirror the flax parameter tree (`Conv_0`, `BatchNorm_0`,
...), so each checkpoint key maps one to one onto a state-dict key.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.kernels.groupnorm import masked_group_norm

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class _FlaxBatchNorm:
    """BatchNorm with flax's train-mode rules. The output normalises with
    the batch mean and the biased batch variance, as torch's does, but the
    running variance averages the biased variance too (torch averages the
    unbiased one). The running statistics move by `momentum` (torch's
    0.1 is flax's 0.9, the weight of the old statistic). In eval mode it is
    torch's BatchNorm."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


_BN = {1: BatchNorm1d, 2: BatchNorm2d, 3: BatchNorm3d}


def batch_norm(nd: int, features: int) -> nn.Module:
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


class MaskedGroupNorm(nn.Module):
    """Masked GroupNorm with an affine (the `masked_group_norm` kernel);
    `weight`/`bias` are the flax `scale`/`bias`. `relu` and `skip` select
    the kernel's fused tails `relu(y) * mask` and `relu(y + skip) * mask`."""

    def __init__(self, num_groups: int, features: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask, relu: bool = False, skip=None):
        return masked_group_norm(x, mask, self.num_groups, self.weight,
                                 self.bias, relu=relu, skip=skip)


def downsample_mask(mask: torch.Tensor) -> torch.Tensor:
    """2x max-pool of a [B, 1, gx, gy, gz] occupancy mask: the active set of
    a stride-2 sparse conv."""
    return F.max_pool3d(mask, 2, 2)
