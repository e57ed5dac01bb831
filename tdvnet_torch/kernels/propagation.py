"""Learned 3x3 neighbour blend of a depth map (K8a), and its gradients with
respect to the logits and the depth.

Kernels: `csrc/propagation_blend.cu` and `csrc/propagation_blend_backward.cu`
(see their headers for the TPU kernel each replaces, its bound and its
design). `propagation_blend_ref` (the JAX package's XLA form) and
`propagation_blend_backward_ref` are the plain PyTorch twins; the wrappers
run them only for CPU tensors. When autograd records a call,
`propagation_blend` goes through `PropagationBlendFn`, whose backward is
`propagation_blend_backward`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import at_least_fp32, check, launch, on_cpu


def unfold3x3(depth: torch.Tensor) -> torch.Tensor:
    """depth [N, H, W] -> [N, H, W, 9] edge-replicated 3x3 neighbourhoods in
    `nn.Unfold` row-major (dy, dx) order."""
    H, W = depth.shape[1:]
    p = F.pad(depth[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=-1)


def fold3x3(cols: torch.Tensor) -> torch.Tensor:
    """The adjoint of `unfold3x3`: [N, H, W, 9] -> [N, H, W], each entry
    added onto the pixel its edge-clamped tap reads."""
    N, H, W, _ = cols.shape
    p = cols.new_zeros((N, H + 2, W + 2))
    for dy in range(3):
        for dx in range(3):
            p[:, dy:dy + H, dx:dx + W] += cols[..., 3 * dy + dx]
    # the padding ring replicates the edge: fold it back onto the edge
    p[:, 1] += p[:, 0]
    p[:, H] += p[:, H + 1]
    p[:, :, 1] += p[:, :, 0]
    p[:, :, W] += p[:, :, W + 1]
    return p[:, 1:H + 1, 1:W + 1]


def propagation_blend_ref(logits: torch.Tensor,
                          depth: torch.Tensor) -> torch.Tensor:
    """logits [N, H, W, 9]; depth [N, H, W] -> softmax(logits) . unfold3x3."""
    w = torch.softmax(at_least_fp32(logits), dim=-1)
    return (w * unfold3x3(depth)).sum(dim=-1)


def propagation_blend_backward_ref(grad: torch.Tensor, logits: torch.Tensor,
                                   depth: torch.Tensor, out: torch.Tensor):
    """(d loss / d logits [N, H, W, 9], d loss / d depth [N, H, W]) from
    grad = d loss / d out and the forward's output: grad * w_k * (u_k - out)
    for the logits, and `fold3x3` of grad * w_k for the depth."""
    w = torch.softmax(at_least_fp32(logits), dim=-1)
    gw = grad[..., None] * w
    return gw * (unfold3x3(depth) - out[..., None]), fold3x3(gw)


def _propagation_blend(logits, depth):
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


class PropagationBlendFn(torch.autograd.Function):
    """`propagation_blend` with its hand backward (both inputs)."""

    @staticmethod
    def forward(ctx, logits, depth):
        out = _propagation_blend(logits, depth)
        ctx.save_for_backward(logits, depth, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, depth, out = ctx.saved_tensors
        return propagation_blend_backward(grad.contiguous(), logits, depth,
                                          out)


def propagation_blend(logits: torch.Tensor,
                      depth: torch.Tensor) -> torch.Tensor:
    """Same contract as `propagation_blend_ref`. `logits` may be any strided
    [N, H, W, 9] view (the kernel reads it through its strides).
    Differentiable in both inputs."""
    return PropagationBlendFn.apply(logits, depth)


propagation_blend.launches = 0


def propagation_blend_backward(grad: torch.Tensor, logits: torch.Tensor,
                               depth: torch.Tensor, out: torch.Tensor):
    """Same contract as `propagation_blend_backward_ref`; the logits'
    gradient has the logits' strides (a permuted view gets its own layout
    back)."""
    if on_cpu(grad, logits, depth, out):
        return propagation_blend_backward_ref(grad, logits, depth, out)
    N, H, W = depth.shape
    check(logits, "logits", torch.float32, (N, H, W, 9), contiguous=False)
    check(depth, "depth", torch.float32, (N, H, W))
    check(out, "out", torch.float32, (N, H, W))
    check(grad, "grad", torch.float32, (N, H, W))
    # preserve_format keeps the strides of a dense permuted view
    grad_logits = torch.empty_like(logits)
    grad_depth = torch.empty_like(depth)
    scratch = torch.empty((N, 9, H, W), dtype=torch.float32,
                          device=depth.device)
    launch("tdv_propagation_blend_backward", depth.device, grad.data_ptr(),
           logits.data_ptr(), depth.data_ptr(), out.data_ptr(),
           grad_logits.data_ptr(), scratch.data_ptr(), grad_depth.data_ptr(),
           N, H, W, *logits.stride(), *grad_logits.stride())
    propagation_blend_backward.launches += 1
    return grad_logits, grad_depth


propagation_blend_backward.launches = 0
