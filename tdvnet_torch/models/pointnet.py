"""Per-voxel PointNet encoder over the compact anchor set (port of
`tdvnet/models/pointnet.py`).

Four linear blocks, each followed by a segment-max pool over the points of
each voxel and a concat-back (the `segment_max` and `gather_concat`
kernels; the ReLU before the next linear layer is part of the concat's
write). Points route to their anchor through `point2anchor`, in any order;
invalid points live in the dump slot (index `n_anchors`), which is dropped
from the output. The segmentation is the same for all four pools, so one
`segment_plan` a call serves them all.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.kernels import gather_concat, segment_max, segment_plan
from tdvnet_torch.models.layers import Linear


class PointNet(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        h = hidden_dim
        self.fc_pos = Linear(in_dim, h)
        self.fc1 = Linear(h, h)
        self.fc2 = Linear(2 * h, h)
        self.fc3 = Linear(2 * h, h)
        self.fc4 = Linear(2 * h, h)
        self.fc_out = Linear(h, out_dim)

    def forward(self, x, point2anchor, point_valid, n_anchors: int):
        """x [P, in_dim]; point2anchor [P] in [0, n_anchors] (n_anchors =
        dump slot); point_valid [P]. Returns [n_anchors, out_dim]."""
        n_seg = n_anchors + 1
        plan = segment_plan(point2anchor, point_valid, n_seg)
        y = self.fc1(F.relu(self.fc_pos(x)))
        for fc in (self.fc2, self.fc3, self.fc4):
            pooled = segment_max(y, point2anchor, point_valid, n_seg, plan)
            y = fc(gather_concat(y, pooled, point2anchor, relu=True))
        pooled = segment_max(y, point2anchor, point_valid, n_seg, plan)
        return self.fc_out(F.relu(pooled))[:n_anchors]
