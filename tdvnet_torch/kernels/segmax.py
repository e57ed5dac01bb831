"""The PointNet's per-voxel max pool and its concat-back (K4), and their
gradients.

Kernels: `csrc/segment_max.cu` and `csrc/segment_max_backward.cu` (see
their headers for the TPU ops they replace, their bounds and their
designs). `segment_max_ref`, `gather_concat_ref` and their `*_backward_ref`
are the plain PyTorch twins; the wrappers run them only for CPU tensors.
When autograd records a pool or a concat-back (grad mode on and an input
requiring grad), it goes through `SegmentMaxFn` or `GatherConcatFn`, whose
backwards are `segment_max_backward` and `gather_concat_backward`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import check, launch, on_cpu, wants_grad

NEG = -1e30


def segment_max_ref(y: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                    n_seg: int) -> torch.Tensor:
    """Max of the valid rows of y [P, C] per segment id, [n_seg, C]; 0 for a
    segment with no valid row. As in the JAX package, masked rows hold NEG
    and a maximum at or below NEG / 2 reads as empty."""
    x = torch.where(valid[:, None], y, torch.full_like(y, NEG))
    out = x.new_full((n_seg, x.shape[1]), NEG)
    out = out.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax",
                             include_self=True)
    return torch.where(out <= NEG / 2, torch.zeros_like(out), out)


def segment_max_backward_ref(grad: torch.Tensor, y: torch.Tensor,
                             seg: torch.Tensor, valid: torch.Tensor,
                             pooled: torch.Tensor) -> torch.Tensor:
    """d loss / d y [P, C] from grad = d loss / d pooled [n_seg, C] and the
    forward's result `pooled`: a valid row equal to its segment's maximum
    takes the segment's gradient divided by the number of rows tied there
    (JAX's scatter-max rule); every other row takes nothing, as do all rows
    of a segment that reads 0 for want of a valid row."""
    hit = valid[:, None] & (y == pooled[seg])
    ties = torch.zeros_like(pooled).index_add_(0, seg, hit.to(pooled.dtype))
    share = grad[seg] / ties[seg].clamp(min=1.0)
    return torch.where(hit, share, torch.zeros_like(share))


def gather_concat_ref(y: torch.Tensor, pooled: torch.Tensor,
                      seg: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """cat([y, pooled[seg]], -1), [P, 2C]; with `relu`, the ReLU that the
    PointNet applies before its next linear layer is part of the write."""
    out = torch.cat([y, pooled[seg]], dim=-1)
    return F.relu(out) if relu else out


def gather_concat_backward_ref(grad: torch.Tensor, y: torch.Tensor,
                               pooled: torch.Tensor, seg: torch.Tensor,
                               relu: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d loss / d y [P, C], d loss / d pooled [n_seg, C]) from grad =
    d loss / d out [P, 2C]: the first half passes to y, the second is summed
    into each row's segment; with `relu`, only where the output is
    positive."""
    C = y.shape[1]
    gy, gp = grad[:, :C], grad[:, C:]
    if relu:
        gy = torch.where(y > 0, gy, torch.zeros_like(gy))
        gp = torch.where(pooled[seg] > 0, gp, torch.zeros_like(gp))
    return gy, torch.zeros_like(pooled).index_add_(0, seg, gp)


def _check_rows(y, seg, P, C, name):
    if C % 4:
        raise ValueError(f"{name}: C={C} must be a multiple of 4")
    check(y, "y", torch.float32, (P, C))
    check(seg, "seg", torch.int64, (P,))


def _segment_max(y, seg, valid, n_seg):
    P, C = y.shape
    _check_rows(y, seg, P, C, "segment_max")
    check(valid, "valid", torch.bool, (P,))
    out = torch.empty((n_seg, C), dtype=torch.float32, device=y.device)
    launch("tdv_segment_max", y.device, y.data_ptr(), seg.data_ptr(),
           valid.data_ptr(), out.data_ptr(), P, C, n_seg)
    segment_max.launches += 1
    return out


class SegmentMaxFn(torch.autograd.Function):
    """`segment_max` with its hand backward."""

    @staticmethod
    def forward(ctx, y, seg, valid, n_seg):
        pooled = _segment_max(y, seg, valid, n_seg)
        ctx.save_for_backward(y, seg, valid, pooled)
        return pooled

    @staticmethod
    def backward(ctx, grad):
        return (segment_max_backward(grad.contiguous(), *ctx.saved_tensors),
                None, None, None)


def segment_max(y: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    if on_cpu(y, seg, valid):
        return segment_max_ref(y, seg, valid, n_seg)
    if wants_grad(y):
        return SegmentMaxFn.apply(y, seg, valid, n_seg)
    return _segment_max(y, seg, valid, n_seg)


segment_max.launches = 0


def segment_max_backward(grad: torch.Tensor, y: torch.Tensor,
                         seg: torch.Tensor, valid: torch.Tensor,
                         pooled: torch.Tensor) -> torch.Tensor:
    """Same contract as `segment_max_backward_ref`; launches the CUDA kernel
    for CUDA tensors."""
    if on_cpu(grad, y, seg, valid, pooled):
        return segment_max_backward_ref(grad, y, seg, valid, pooled)
    P, C = y.shape
    n_seg = pooled.shape[0]
    _check_rows(y, seg, P, C, "segment_max_backward")
    check(valid, "valid", torch.bool, (P,))
    check(pooled, "pooled", torch.float32, (n_seg, C))
    check(grad, "grad", torch.float32, (n_seg, C))
    ties = torch.empty((n_seg, C), dtype=torch.int32, device=y.device)
    out = torch.empty_like(y)
    launch("tdv_segment_max_backward", y.device, grad.data_ptr(),
           y.data_ptr(), seg.data_ptr(), valid.data_ptr(), pooled.data_ptr(),
           ties.data_ptr(), out.data_ptr(), P, C, n_seg)
    segment_max_backward.launches += 1
    return out


segment_max_backward.launches = 0


def _gather_concat(y, pooled, seg, relu):
    P, C = y.shape
    _check_rows(y, seg, P, C, "gather_concat")
    n_seg = pooled.shape[0]
    check(pooled, "pooled", torch.float32, (n_seg, C))
    out = torch.empty((P, 2 * C), dtype=torch.float32, device=y.device)
    launch("tdv_gather_concat", y.device, y.data_ptr(), pooled.data_ptr(),
           seg.data_ptr(), out.data_ptr(), P, C, n_seg, int(relu))
    gather_concat.launches += 1
    return out


class GatherConcatFn(torch.autograd.Function):
    """`gather_concat` with its hand backward."""

    @staticmethod
    def forward(ctx, y, pooled, seg, relu):
        out = _gather_concat(y, pooled, seg, relu)
        ctx.save_for_backward(y, pooled, seg)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, grad):
        y, pooled, seg = ctx.saved_tensors
        gy, gp = gather_concat_backward(grad.contiguous(), y, pooled, seg,
                                        ctx.relu)
        return gy, gp, None, None


def gather_concat(y: torch.Tensor, pooled: torch.Tensor, seg: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    if on_cpu(y, pooled, seg):
        return gather_concat_ref(y, pooled, seg, relu)
    if wants_grad(y, pooled):
        return GatherConcatFn.apply(y, pooled, seg, relu)
    return _gather_concat(y, pooled, seg, relu)


gather_concat.launches = 0


def gather_concat_backward(grad: torch.Tensor, y: torch.Tensor,
                           pooled: torch.Tensor, seg: torch.Tensor,
                           relu: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as `gather_concat_backward_ref`; launches the CUDA
    kernel for CUDA tensors (the segment sum in fixed point, so it is the
    same bits on every launch)."""
    if on_cpu(grad, y, pooled, seg):
        return gather_concat_backward_ref(grad, y, pooled, seg, relu)
    P, C = y.shape
    n_seg = pooled.shape[0]
    _check_rows(y, seg, P, C, "gather_concat_backward")
    check(pooled, "pooled", torch.float32, (n_seg, C))
    check(grad, "grad", torch.float32, (P, 2 * C))
    gy = torch.empty_like(y)
    gp = torch.empty_like(pooled)
    acc = torch.empty((n_seg, C), dtype=torch.int64, device=y.device)
    fxw = torch.empty((2,), dtype=torch.int32, device=y.device)
    launch("tdv_gather_concat_backward", y.device, grad.data_ptr(),
           y.data_ptr(), pooled.data_ptr(), seg.data_ptr(), gy.data_ptr(),
           gp.data_ptr(), acc.data_ptr(), fxw.data_ptr(), P, C, n_seg,
           int(relu))
    gather_concat_backward.launches += 1
    return gy, gp


gather_concat_backward.launches = 0
