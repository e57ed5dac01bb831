"""Soft-argmax depth over the plane axis of a cost volume (K8b).

Kernel: `csrc/softargmax_depth.cu` (see its header for the TPU kernel it
replaces, its bound and its design). `softargmax_depth_ref` is the plain
PyTorch twin (the JAX package's XLA form); the wrapper runs it only for CPU
tensors.
"""
from __future__ import annotations

import torch

from tdvnet_torch.kernels._launch import check, launch, on_cpu


def softargmax_depth_ref(cost: torch.Tensor,
                         depth_vals: torch.Tensor) -> torch.Tensor:
    """cost [R, D, h, w] (before negation); depth_vals [D] ->
    depth [R, h, w] = sum_d softmax_d(-cost) * depth_vals[d]."""
    prob = torch.softmax(-cost.to(torch.float32), dim=1)
    return (prob * depth_vals[None, :, None, None]).sum(dim=1)


def softargmax_depth(cost: torch.Tensor,
                     depth_vals: torch.Tensor) -> torch.Tensor:
    """Same contract as `softargmax_depth_ref`."""
    if on_cpu(cost, depth_vals):
        return softargmax_depth_ref(cost, depth_vals)
    R, D, h, w = cost.shape
    check(cost, "cost", torch.float32, (R, D, h, w))
    check(depth_vals, "depth_vals", torch.float32, (D,))
    out = torch.empty((R, h, w), dtype=torch.float32, device=cost.device)
    launch("tdv_softargmax_depth", cost.device, cost.data_ptr(),
           depth_vals.data_ptr(), out.data_ptr(), R, D, h * w)
    softargmax_depth.launches += 1
    return out


softargmax_depth.launches = 0
