"""PointFlow hypothesis decoder and scene-feature sampling (port of
`tdvnet/models/hypothesis.py`, unpacked path only).

For every depth pixel the 2n+1 hypothesis points are scored by sampling
each scene U-Net scale at the points (the `trilinear_sample` kernel),
concatenating the per-hypothesis image variance, and running a small conv
stack along the hypothesis axis that ends in a softmax.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.kernels import trilinear_sample
from tdvnet_torch.models.layers import batch_norm


def sample_scales(scales, pts: torch.Tensor, origins: torch.Tensor,
                  edge_len: float) -> torch.Tensor:
    """Trilinear-sample every U-Net scale at world points, concat channels.

    scales: coarsest-first list of {"grid": [B, x, y, z, C], "stride": s}.
    pts [B, Q, 3] world points grouped per scene; origins [B, 3]. Nodes of
    the stride-s scale sit at origin + edge/2 + s*i*edge. Returns
    [B, Q, sum C] with the finest scale first; each scale's kernel launch
    writes its own channel slice.
    """
    center0 = (origins + 0.5 * edge_len).contiguous()
    B, Q, _ = pts.shape
    fine_first = scales[::-1]
    n_ch = sum(sc["grid"].shape[-1] for sc in scales)
    out = torch.empty((B, Q, n_ch), dtype=torch.float32, device=pts.device)
    pts = pts.contiguous()
    off = 0
    for sc in fine_first:
        trilinear_sample(sc["grid"], pts, center0, sc["stride"] * edge_len,
                         out, off)
        off += sc["grid"].shape[-1]
    return out


class HypothesisDecoder(nn.Module):
    def __init__(self, in_ch: int, hidden: int = 128, ksize: int = 3):
        super().__init__()
        p = ksize // 2    # SAME for an odd kernel at stride 1
        self.Conv_0 = nn.Conv1d(in_ch, hidden, ksize, padding=p, bias=False)
        self.BatchNorm_0 = batch_norm(1, hidden)
        self.Conv_1 = nn.Conv1d(hidden, hidden, ksize, padding=p, bias=False)
        self.BatchNorm_1 = batch_norm(1, hidden)
        self.Conv_2 = nn.Conv1d(hidden, hidden, ksize, padding=p, bias=False)
        self.BatchNorm_2 = batch_norm(1, hidden)
        self.Conv_3 = nn.Conv1d(hidden, 1, ksize, padding=p)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [M, n_hyp, C] -> softmax scores [M, n_hyp]."""
        y = feats.transpose(1, 2)
        for conv, bn in ((self.Conv_0, self.BatchNorm_0),
                         (self.Conv_1, self.BatchNorm_1),
                         (self.Conv_2, self.BatchNorm_2)):
            y = F.relu(bn(conv(y)))
        return torch.softmax(self.Conv_3(y)[:, 0].to(torch.float32), dim=-1)
