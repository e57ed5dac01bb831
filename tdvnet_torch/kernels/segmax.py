"""The PointNet's per-voxel max pool and its concat-back (K4).

Kernel: `csrc/segment_max.cu` (see its header for the TPU op it replaces,
its bound and its design). `segment_max_ref` and `gather_concat_ref` are
the plain PyTorch twins; the wrappers run them only for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import (check, launch, no_backward,
                                          on_cpu)

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


def gather_concat_ref(y: torch.Tensor, pooled: torch.Tensor,
                      seg: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """cat([y, pooled[seg]], -1), [P, 2C]; with `relu`, the ReLU that the
    PointNet applies before its next linear layer is part of the write."""
    out = torch.cat([y, pooled[seg]], dim=-1)
    return F.relu(out) if relu else out


def _check_rows(y, seg, P, C, name):
    if C % 4:
        raise ValueError(f"{name}: C={C} must be a multiple of 4")
    check(y, "y", torch.float32, (P, C))
    check(seg, "seg", torch.int64, (P,))


def segment_max(y: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    if on_cpu(y, seg, valid):
        return segment_max_ref(y, seg, valid, n_seg)
    no_backward("segment_max", y)
    P, C = y.shape
    _check_rows(y, seg, P, C, "segment_max")
    check(valid, "valid", torch.bool, (P,))
    out = torch.empty((n_seg, C), dtype=torch.float32, device=y.device)
    launch("tdv_segment_max", y.device, y.data_ptr(), seg.data_ptr(),
           valid.data_ptr(), out.data_ptr(), P, C, n_seg)
    segment_max.launches += 1
    return out


segment_max.launches = 0


def gather_concat(y: torch.Tensor, pooled: torch.Tensor, seg: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    if on_cpu(y, pooled, seg):
        return gather_concat_ref(y, pooled, seg, relu)
    no_backward("gather_concat", y, pooled)
    P, C = y.shape
    _check_rows(y, seg, P, C, "gather_concat")
    n_seg = pooled.shape[0]
    check(pooled, "pooled", torch.float32, (n_seg, C))
    out = torch.empty((P, 2 * C), dtype=torch.float32, device=y.device)
    launch("tdv_gather_concat", y.device, y.data_ptr(), pooled.data_ptr(),
           seg.data_ptr(), out.data_ptr(), P, C, n_seg, int(relu))
    gather_concat.launches += 1
    return out


gather_concat.launches = 0
