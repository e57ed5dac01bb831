"""MNASNet-1.0-contract image backbone (port of `tdvnet/models/backbone.py`).

Five scales with channels (16, 24, 40, 96, 320) at strides (2, 4, 8, 16,
32). Every stride-2 conv pads k//2 on both sides, as torch does.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.models.layers import batch_norm


class _MBConv(nn.Module):
    """Inverted residual: expand 1x1 -> depthwise kxk -> project 1x1."""

    def __init__(self, in_ch: int, features: int, expansion: int,
                 stride: int, kernel: int):
        super().__init__()
        mid = in_ch * expansion
        self.Conv_0 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = batch_norm(2, mid)
        self.Conv_1 = nn.Conv2d(mid, mid, kernel, stride=stride,
                                padding=kernel // 2, groups=mid, bias=False)
        self.BatchNorm_1 = batch_norm(2, mid)
        self.Conv_2 = nn.Conv2d(mid, features, 1, bias=False)
        self.BatchNorm_2 = batch_norm(2, features)
        self.residual = stride == 1 and in_ch == features

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return y + x if self.residual else y


class _Stack(nn.Module):
    def __init__(self, in_ch: int, features: int, expansion: int, stride: int,
                 kernel: int, n_blocks: int):
        super().__init__()
        for i in range(n_blocks):
            setattr(self, f"_MBConv_{i}",
                    _MBConv(in_ch if i == 0 else features, features,
                            expansion, stride if i == 0 else 1, kernel))
        self.n_blocks = n_blocks

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"_MBConv_{i}")(x)
        return x


# (features, expansion, stride, kernel, blocks) of _Stack_0 .. _Stack_5
_STACKS = ((24, 3, 2, 3, 3), (40, 3, 2, 5, 3), (80, 6, 2, 5, 3),
           (96, 6, 1, 3, 2), (192, 6, 2, 5, 4), (320, 6, 1, 3, 1))


class MnasMulti(nn.Module):
    """images [N, 3, H, W] -> (c1 /2 16ch, c2 /4 24ch, c3 /8 40ch,
    c4 /16 96ch, c5 /32 320ch), NCHW."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.BatchNorm_0 = batch_norm(2, 32)
        self.Conv_1 = nn.Conv2d(32, 32, 3, padding=1, groups=32, bias=False)
        self.BatchNorm_1 = batch_norm(2, 32)
        self.Conv_2 = nn.Conv2d(32, 16, 1, bias=False)
        self.BatchNorm_2 = batch_norm(2, 16)
        in_ch = 16
        for i, (f, e, s, k, n) in enumerate(_STACKS):
            setattr(self, f"_Stack_{i}", _Stack(in_ch, f, e, s, k, n))
            in_ch = f

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        c1 = self.BatchNorm_2(self.Conv_2(y))
        c2 = self._Stack_0(c1)
        c3 = self._Stack_1(c2)
        c4 = self._Stack_3(self._Stack_2(c3))
        c5 = self._Stack_5(self._Stack_4(c4))
        return c1, c2, c3, c4, c5
