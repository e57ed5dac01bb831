"""Soft-argmax depth over the plane axis of a cost volume (K8b), and its
gradient with respect to the cost volume.

Kernels: `csrc/softargmax_depth.cu` and `csrc/softargmax_depth_backward.cu`
(see their headers for the TPU kernel each replaces, its bound and its
design). `softargmax_depth_ref` (the JAX package's XLA form) and
`softargmax_depth_backward_ref` are the plain PyTorch twins; the wrappers
run them only for CPU tensors. When autograd records a call,
`softargmax_depth` goes through `SoftargmaxDepthFn`, whose backward is
`softargmax_depth_backward`; otherwise it launches directly. Each kernel
has two forms: up to `max_planes()` (384) planes a block holds them in its
warps' registers, at most 12 planes a warp and 32 warps; past that one
thread a pixel walks the planes from device memory, with the same
operations in the same order, so the two forms give the same bits where
both run (the tests launch the second at small D through `long_form`).
"""
from __future__ import annotations

import functools

import torch

from tdvnet_torch.kernels._launch import (at_least_fp32, check, launch,
                                          on_cpu, wants_grad)


def softargmax_depth_ref(cost: torch.Tensor,
                         depth_vals: torch.Tensor) -> torch.Tensor:
    """cost [R, D, h, w] (before negation); depth_vals [D] ->
    depth [R, h, w] = sum_d softmax_d(-cost) * depth_vals[d]."""
    prob = torch.softmax(-at_least_fp32(cost), dim=1)
    return (prob * depth_vals[None, :, None, None]).sum(dim=1)


def softargmax_depth_backward_ref(grad: torch.Tensor, cost: torch.Tensor,
                                  depth_vals: torch.Tensor,
                                  depth: torch.Tensor) -> torch.Tensor:
    """d loss / d cost [R, D, h, w] from grad = d loss / d depth [R, h, w]
    and the forward's output depth: -grad * p_d * (depth_vals[d] - depth)
    with p = softmax_d(-cost)."""
    prob = torch.softmax(-at_least_fp32(cost), dim=1)
    return -grad[:, None] * prob * (depth_vals[None, :, None, None]
                                    - depth[:, None])


@functools.lru_cache(maxsize=None)
def max_planes() -> int:
    """The largest plane count the register form of either kernel takes:
    its warps' bands of planes, held in registers."""
    from tdvnet_torch.kernels.build import library

    return library().tdv_softargmax_depth_max_planes()


def _entry(name: str, D: int, long_form: bool) -> str:
    """The C entry point of the form that takes D planes: the register form
    up to `max_planes()`, else (or when a test asks) the any-D form."""
    return f"{name}_long" if long_form or D > max_planes() else name


def _softargmax_depth(cost, depth_vals, long_form=False):
    if on_cpu(cost, depth_vals):
        return softargmax_depth_ref(cost, depth_vals)
    R, D, h, w = cost.shape
    check(cost, "cost", torch.float32, (R, D, h, w))
    check(depth_vals, "depth_vals", torch.float32, (D,))
    out = torch.empty((R, h, w), dtype=torch.float32, device=cost.device)
    launch(_entry("tdv_softargmax_depth", D, long_form), cost.device,
           cost.data_ptr(), depth_vals.data_ptr(), out.data_ptr(), R, D,
           h * w)
    softargmax_depth.launches += 1
    return out


class SoftargmaxDepthFn(torch.autograd.Function):
    """`softargmax_depth` with its hand backward (the gradient to `cost`)."""

    @staticmethod
    def forward(ctx, cost, depth_vals):
        depth = _softargmax_depth(cost, depth_vals)
        ctx.save_for_backward(cost, depth_vals, depth)
        return depth

    @staticmethod
    def backward(ctx, grad):
        cost, depth_vals, depth = ctx.saved_tensors
        return softargmax_depth_backward(grad.contiguous(), cost, depth_vals,
                                         depth), None


def softargmax_depth(cost: torch.Tensor,
                     depth_vals: torch.Tensor) -> torch.Tensor:
    """Same contract as `softargmax_depth_ref`. Differentiable in `cost`;
    the plane depths are constants."""
    if not wants_grad(cost, depth_vals):
        return _softargmax_depth(cost, depth_vals)
    if wants_grad(depth_vals):
        raise NotImplementedError(
            "softargmax_depth: no gradient with respect to depth_vals")
    return SoftargmaxDepthFn.apply(cost, depth_vals)


softargmax_depth.launches = 0


def softargmax_depth_backward(grad: torch.Tensor, cost: torch.Tensor,
                              depth_vals: torch.Tensor,
                              depth: torch.Tensor) -> torch.Tensor:
    """Same contract as `softargmax_depth_backward_ref`; one launch for
    CUDA tensors."""
    return _softargmax_depth_backward(grad, cost, depth_vals, depth)


def _softargmax_depth_backward(grad, cost, depth_vals, depth,
                               long_form=False):
    if on_cpu(grad, cost, depth_vals, depth):
        return softargmax_depth_backward_ref(grad, cost, depth_vals, depth)
    R, D, h, w = cost.shape
    check(cost, "cost", torch.float32, (R, D, h, w))
    check(depth_vals, "depth_vals", torch.float32, (D,))
    check(grad, "grad", torch.float32, (R, h, w))
    check(depth, "depth", torch.float32, (R, h, w))
    out = torch.empty_like(cost)
    launch(_entry("tdv_softargmax_depth_backward", D, long_form),
           cost.device, grad.data_ptr(), cost.data_ptr(),
           depth_vals.data_ptr(), depth.data_ptr(), out.data_ptr(), R, D,
           h * w)
    softargmax_depth_backward.launches += 1
    return out


softargmax_depth_backward.launches = 0
