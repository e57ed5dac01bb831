"""Guided depth upsampling via a learned 3x3 neighbour-weight softmax (port
of `tdvnet/models/upsampling.py`): 4 conv-BN-ReLU blocks over [guide,
depth] give 9 logits, and the `propagation_blend` kernel takes their
softmax times the edge-replicated 3x3 depth neighbourhood."""
from __future__ import annotations

import torch
import torch.nn as nn

from tdvnet_torch.kernels import propagation_blend
from tdvnet_torch.kernels.propagation import unfold3x3
from tdvnet_torch.models.layers import ConvBnRelu

__all__ = ["PropagationNet", "unfold3x3"]


class PropagationNet(nn.Module):
    def __init__(self, guide_ch: int, hidden: int = 32):
        super().__init__()
        self.ConvBnRelu_0 = ConvBnRelu(guide_ch + 1, hidden)
        self.ConvBnRelu_1 = ConvBnRelu(hidden, hidden)
        self.ConvBnRelu_2 = ConvBnRelu(hidden, hidden)
        self.ConvBnRelu_3 = ConvBnRelu(hidden, 9)

    def forward(self, guide: torch.Tensor, depth: torch.Tensor):
        """guide [N, H, W, C]; depth [N, H, W] -> refined depth [N, H, W]."""
        x = torch.cat([guide.permute(0, 3, 1, 2), depth[:, None]], dim=1)
        x = self.ConvBnRelu_3(self.ConvBnRelu_2(self.ConvBnRelu_1(
            self.ConvBnRelu_0(x))))
        # logits pass through BN and ReLU before the softmax, as in the
        # JAX package; [N, 9, H, W] is handed over as an [N, H, W, 9] view
        # (a bf16 model's logits widen to fp32, as there: K8a is fp32)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return propagation_blend(x.permute(0, 2, 3, 1), depth.contiguous())
