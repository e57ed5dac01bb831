"""Feature pyramid over the 5 backbone scales (port of
`tdvnet/models/fpn.py`): lateral 1x1 convs to `feat_dim`, top-down nearest
upsample + add, then a 3x3 smoothing conv per level. NCHW."""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from tdvnet_torch.ops.sampling import resize_nearest

BACKBONE_CHANNELS = (16, 24, 40, 96, 320)


class FPN(nn.Module):
    def __init__(self, feat_dim: int = 32,
                 in_channels: Sequence[int] = BACKBONE_CHANNELS):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, feat_dim, 1))
            setattr(self, f"smooth{i}", nn.Conv2d(feat_dim, feat_dim, 3,
                                                  padding=1))

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        merged = [None] * self.n
        merged[-1] = laterals[-1]
        for i in range(self.n - 2, -1, -1):
            merged[i] = laterals[i] + resize_nearest(merged[i + 1],
                                                     laterals[i].shape[2:])
        return tuple(getattr(self, f"smooth{i}")(m)
                     for i, m in enumerate(merged))
