"""2D stage: features -> plane-sweep variance cost volume -> 3D
regularization -> soft-argmax initial depth (port of
`tdvnet/models/mvsnet.py`)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from tdvnet_torch.kernels import softargmax_depth
from tdvnet_torch.models.backbone import MnasMulti
from tdvnet_torch.models.fpn import FPN
from tdvnet_torch.models.layers import ConvBnRelu, ConvTransposeUp3d
from tdvnet_torch.ops import camera, costvolume


class CostRegNet(nn.Module):
    """3-level 3D U-Net cost regularizer, [R, C, D, h, w] -> [R, 1, D, h, w].

    The flax names follow construction order: in `c3(2b, 1)(c3(2b, 2)(x))`
    the outer (stride-1) block is built first, so ConvBnRelu_1 is the
    stride-1 block and ConvBnRelu_2 the stride-2 block before it.
    """

    def __init__(self, in_ch: int, base: int = 8):
        super().__init__()
        b = base
        c3 = lambda i, o, s: ConvBnRelu(i, o, (3, 3, 3), (s, s, s))
        self.ConvBnRelu_0 = c3(in_ch, b, 1)
        self.ConvBnRelu_1 = c3(2 * b, 2 * b, 1)
        self.ConvBnRelu_2 = c3(b, 2 * b, 2)
        self.ConvBnRelu_3 = c3(4 * b, 4 * b, 1)
        self.ConvBnRelu_4 = c3(2 * b, 4 * b, 2)
        self.ConvBnRelu_5 = c3(8 * b, 8 * b, 1)
        self.ConvBnRelu_6 = c3(4 * b, 8 * b, 2)
        self.ConvTransposeUp3d_0 = ConvTransposeUp3d(8 * b, 4 * b)
        self.ConvTransposeUp3d_1 = ConvTransposeUp3d(4 * b, 2 * b)
        self.ConvTransposeUp3d_2 = ConvTransposeUp3d(2 * b, b)
        self.Conv_0 = nn.Conv3d(b, 1, 3, padding=1)

    def forward(self, x):
        conv0 = self.ConvBnRelu_0(x)
        conv2 = self.ConvBnRelu_1(self.ConvBnRelu_2(conv0))
        conv4 = self.ConvBnRelu_3(self.ConvBnRelu_4(conv2))
        y = self.ConvBnRelu_5(self.ConvBnRelu_6(conv4))
        y = conv4 + self.ConvTransposeUp3d_0(y)
        y = conv2 + self.ConvTransposeUp3d_1(y)
        y = conv0 + self.ConvTransposeUp3d_2(y)
        return self.Conv_0(y)


class MVSNet(nn.Module):
    """Initial depth predictor."""

    def __init__(self, feat_dim: int = 32,
                 img_size: Tuple[int, int] = (256, 320), cost_base: int = 8):
        super().__init__()
        self.img_size = tuple(img_size)
        self.backbone = MnasMulti()
        self.fpn = FPN(feat_dim)
        self.cost_reg = CostRegNet(feat_dim, cost_base)

    def extract_features(self, images: torch.Tensor):
        """images [N, H, W, 3] -> (half, quarter, eighth) FPN features,
        each [N, h, w, C] contiguous."""
        c = self.backbone(images.permute(0, 3, 1, 2))
        p = self.fpn(c)
        return tuple(f.permute(0, 2, 3, 1).contiguous() for f in p[:3])

    def predict_depth(self, feats_quarter, rotmats, tvecs, K, ref_idx,
                      src_idx, src_mask, depth_start, depth_interval,
                      n_planes, depth_size) -> torch.Tensor:
        """Cost volume -> regularization -> soft-argmax. Returns depth
        [R, h, w] (the probability volume is not kept)."""
        var = costvolume.plane_sweep_cost_volume(
            feats_quarter, rotmats, tvecs, K, ref_idx, src_idx, src_mask,
            depth_start, depth_interval, n_planes, self.img_size, depth_size)
        # [R, D, h, w, C] -> [R, C, D, h, w] as a view (channels-last-3d)
        cost = self.cost_reg(var.permute(0, 4, 1, 2, 3))[:, 0]
        depth_end = depth_start + depth_interval * (n_planes - 1)
        depth_vals = camera.linspace_f32(depth_start, depth_end, n_planes,
                                         cost.device)
        return softargmax_depth(cost.contiguous(), depth_vals)
