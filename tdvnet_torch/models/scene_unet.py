"""Scene-level 3D U-Net over a masked dense voxel grid (port of
`tdvnet/models/scene_unet.py`, without the spatially sharded branch).

A stride-1 conv over a zero-filled grid, multiplied by the occupancy mask,
has the semantics of a sparse conv at the active sites; the stride-2 active
set is the 2x max-pooled mask; GroupNorm statistics run over active voxels
only (the `masked_group_norm` kernel, which also applies the ReLU and
residual tails). NCDHW inside; the public grids are [B, gx, gy, gz, C].
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.models.layers import (Conv3d, MaskedGroupNorm,
                                        downsample_mask, same_pads,
                                        up_conv3d)


class MaskedConv3d(nn.Module):
    """Conv with XLA 'SAME' padding, then times the output mask. At stride 2
    on even extents SAME pads (0, 1), which `F.pad` applies before an
    unpadded conv."""

    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 kernel: int = 3, use_bias: bool = False):
        super().__init__()
        self.kernel, self.strides = kernel, strides
        self.Conv_0 = Conv3d(in_ch, features, kernel, stride=strides,
                             bias=use_bias)

    def forward(self, x, mask_out):
        k, s = self.kernel, self.strides
        pads = same_pads(x.shape[2:], (k,) * 3, (s,) * 3)
        x, w, b = self.Conv_0.cast(x)
        if all(lo == hi for lo, hi in pads):
            y = F.conv3d(x, w, b, s, tuple(lo for lo, _ in pads))
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            y = F.conv3d(x, w, b, s)
        return y * mask_out


class MaskedUpConv3d(nn.Module):
    """2x transposed conv onto a finer active set."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = up_conv3d(in_ch, features)

    def forward(self, x, mask_out):
        return self.Conv_0(x) * mask_out


class SparseResidual3d(nn.Module):
    """conv-gn-relu-conv-gn + skip, masked."""

    def __init__(self, features: int, num_groups: int):
        super().__init__()
        self.MaskedConv3d_0 = MaskedConv3d(features, features)
        self.MaskedGroupNorm_0 = MaskedGroupNorm(num_groups, features)
        self.MaskedConv3d_1 = MaskedConv3d(features, features)
        self.MaskedGroupNorm_1 = MaskedGroupNorm(num_groups, features)

    def forward(self, x, mask):
        y = self.MaskedGroupNorm_0(self.MaskedConv3d_0(x, mask), mask,
                                   relu=True)
        return self.MaskedGroupNorm_1(self.MaskedConv3d_1(y, mask), mask,
                                      skip=x)


class SceneUNet(nn.Module):
    """3-scale masked dense U-Net. Submodules carry the flax names, numbered
    per class in the order the flax module builds them; the lists below
    hold the same modules in forward order."""

    def __init__(self, dims: Sequence[int] = (64, 128, 128),
                 n_groups: Sequence[int] = (4, 8, 8),
                 n_res: Sequence[int] = (1, 2, 3)):
        super().__init__()
        L = len(dims)
        count = {}

        def add(module):
            kind = type(module).__name__
            name = f"{kind}_{count.setdefault(kind, 0)}"
            count[kind] += 1
            setattr(self, name, module)
            return module

        res = lambda lvl: [add(SparseResidual3d(dims[lvl], n_groups[lvl]))
                           for _ in range(n_res[lvl])]
        self.down, self.enc_res, self.up, self.dec_res = {}, {}, {}, {}
        for lvl in range(L):
            if lvl > 0:
                self.down[lvl] = (
                    add(MaskedConv3d(dims[lvl - 1], dims[lvl], 2,
                                     use_bias=True)),
                    add(MaskedGroupNorm(n_groups[lvl], dims[lvl])))
            self.enc_res[lvl] = res(lvl)
        for lvl in range(L - 2, -1, -1):
            d, g = dims[lvl], n_groups[lvl]
            self.up[lvl] = (add(MaskedUpConv3d(dims[lvl + 1], d)),
                            add(MaskedGroupNorm(g, d)),
                            add(MaskedConv3d(2 * d, d, kernel=1,
                                             use_bias=True)),
                            add(MaskedGroupNorm(g, d)))
            self.dec_res[lvl] = res(lvl)
        self.levels = L

    def forward(self, grid: torch.Tensor, mask: torch.Tensor):
        """grid [B, gx, gy, gz, dims[0]]; mask [B, gx, gy, gz, 1].

        Returns the scales coarsest first, each {"grid": [B, x, y, z, C]
        contiguous, "mask": [B, x, y, z, 1], "stride": int}.
        """
        L = self.levels
        masks = [mask.permute(0, 4, 1, 2, 3).to(grid.dtype)]
        for _ in range(L - 1):
            masks.append(downsample_mask(masks[-1]))
        scale = lambda x, lvl: {
            "grid": x.permute(0, 2, 3, 4, 1).contiguous(),
            "mask": masks[lvl].permute(0, 2, 3, 4, 1), "stride": 2 ** lvl}

        # NCDHW-contiguous from here on: the GroupNorm kernel wants a
        # channel contiguous over the voxels, and a strided input would
        # make cuDNN answer in channels-last
        x = (grid.permute(0, 4, 1, 2, 3) * masks[0]).contiguous()
        skips = []
        for lvl in range(L):
            m = masks[lvl]
            if lvl > 0:
                conv, gn = self.down[lvl]
                x = gn(conv(x, m), m, relu=True)
            for block in self.enc_res[lvl]:
                x = block(x, m)
            skips.append(x)

        out = [scale(skips[-1], L - 1)]
        for lvl in range(L - 2, -1, -1):
            m = masks[lvl]
            upconv, gn_up, conv, gn = self.up[lvl]
            x = gn_up(upconv(x, m), m, relu=True)
            x = torch.cat([x, skips[lvl]], dim=1)
            x = gn(conv(x, m), m, relu=True)
            for block in self.dec_res[lvl]:
                x = block(x, m)
            out.append(scale(x, lvl))
        return out
