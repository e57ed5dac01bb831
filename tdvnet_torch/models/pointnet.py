"""Per-voxel PointNet encoder over the compact anchor set (port of
`tdvnet/models/pointnet.py`; plain PyTorch).

Four linear blocks, each followed by a segment-max pool over the points of
each voxel and a concat-back. Points route to their anchor through
`point2anchor`; invalid points live in the dump slot (index `n_anchors`),
which is dropped from the output.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG = -1e30


def _segmax(x: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Max of the rows of x [P, C] per segment id; empty segments (and
    segments of masked rows only, which hold NEG) give 0."""
    out = x.new_full((n_seg, x.shape[1]), NEG)
    out = out.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax",
                             include_self=True)
    return torch.where(out <= NEG / 2, torch.zeros_like(out), out)


class PointNet(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        h = hidden_dim
        self.fc_pos = nn.Linear(in_dim, h)
        self.fc1 = nn.Linear(h, h)
        self.fc2 = nn.Linear(2 * h, h)
        self.fc3 = nn.Linear(2 * h, h)
        self.fc4 = nn.Linear(2 * h, h)
        self.fc_out = nn.Linear(h, out_dim)

    def forward(self, x, point2anchor, point_valid, n_anchors: int):
        """x [P, in_dim]; point2anchor [P] in [0, n_anchors] (n_anchors =
        dump slot); point_valid [P]. Returns [n_anchors, out_dim]."""
        n_seg = n_anchors + 1
        valid = point_valid[:, None]
        y = self.fc1(F.relu(self.fc_pos(x)))
        for fc in (self.fc2, self.fc3, self.fc4):
            pooled = _segmax(torch.where(valid, y, torch.full_like(y, NEG)),
                             point2anchor, n_seg)
            y = fc(F.relu(torch.cat([y, pooled[point2anchor]], dim=-1)))
        pooled = _segmax(torch.where(valid, y, torch.full_like(y, NEG)),
                         point2anchor, n_seg)
        return self.fc_out(F.relu(pooled))[:n_anchors]
