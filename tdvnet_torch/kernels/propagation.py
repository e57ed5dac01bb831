"""Learned 3x3 neighbour blend of a depth map (K8a).

Kernel: `csrc/propagation_blend.cu` (see its header for the TPU kernel it
replaces, its bound and its design). `propagation_blend_ref` is the plain
PyTorch twin (the JAX package's XLA form); the wrapper runs it only for CPU
tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import check, launch, on_cpu


def unfold3x3(depth: torch.Tensor) -> torch.Tensor:
    """depth [N, H, W] -> [N, H, W, 9] edge-replicated 3x3 neighbourhoods in
    `nn.Unfold` row-major (dy, dx) order."""
    H, W = depth.shape[1:]
    p = F.pad(depth[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=-1)


def propagation_blend_ref(logits: torch.Tensor,
                          depth: torch.Tensor) -> torch.Tensor:
    """logits [N, H, W, 9]; depth [N, H, W] -> softmax(logits) . unfold3x3."""
    w = torch.softmax(logits.to(torch.float32), dim=-1)
    return (w * unfold3x3(depth)).sum(dim=-1)


def propagation_blend(logits: torch.Tensor,
                      depth: torch.Tensor) -> torch.Tensor:
    """Same contract as `propagation_blend_ref`. `logits` may be any strided
    [N, H, W, 9] view (the kernel reads it through its strides)."""
    if on_cpu(logits, depth):
        return propagation_blend_ref(logits, depth)
    N, H, W = depth.shape
    check(logits, "logits", torch.float32, (N, H, W, 9), contiguous=False)
    check(depth, "depth", torch.float32, (N, H, W))
    out = torch.empty((N, H, W), dtype=torch.float32, device=depth.device)
    sn, sh, sw, sk = logits.stride()
    launch("tdv_propagation_blend", depth.device, logits.data_ptr(),
           depth.data_ptr(), out.data_ptr(), N, H, W, sn, sh, sw, sk)
    propagation_blend.launches += 1
    return out


propagation_blend.launches = 0
