"""The port's counterparts of the two Mosaic probes' kernels: a batch of
small bf16 matrix products with fp32 sums (`batched_dot`) and
`take_along_axis` over fp32 values with int32 indices.

Kernels: `csrc/batched_dot.cu` and `csrc/take_along_axis.cu` (see their
headers for the probe kernels each replaces, its bound and its design).
`batched_dot_ref` and `take_along_axis_ref` are the plain PyTorch twins;
the wrappers run them only for CPU tensors. The probe entry points are
`tdvnet_torch.tools.probe_batched_dot` and `tdvnet_torch.tools.probe_gather`.
"""
from __future__ import annotations

import torch

from tdvnet_torch.kernels._launch import check, launch, no_backward, on_cpu

# the dynamic shared memory a block may take without an opt-in attribute
_SMEM_DEFAULT = 48 * 1024


def batched_dot_ref(Wm: torch.Tensor, Fm: torch.Tensor) -> torch.Tensor:
    """Wm [..., Q, Y] bf16 @ Fm [..., Y, C] bf16 -> [..., Q, C] bf16, summed
    in fp32 and rounded to bf16 once."""
    return torch.matmul(Wm.float(), Fm.float()).to(torch.bfloat16)


def batched_dot(Wm: torch.Tensor, Fm: torch.Tensor) -> torch.Tensor:
    """Same contract as `batched_dot_ref`; the leading dims of both inputs
    must match (no broadcasting)."""
    if on_cpu(Wm, Fm):
        return batched_dot_ref(Wm, Fm)
    no_backward("batched_dot", Wm, Fm)
    *lead, Q, Y = Wm.shape
    C = Fm.shape[-1]
    check(Wm, "Wm", torch.bfloat16)
    check(Fm, "Fm", torch.bfloat16, (*lead, Y, C))
    if 4 * (Q * Y + Y * C) > _SMEM_DEFAULT:
        raise ValueError(f"batched_dot: a [{Q},{Y}] @ [{Y},{C}] product "
                         f"does not fit one block's shared memory")
    B = 1
    for d in lead:
        B *= d
    out = torch.empty((*lead, Q, C), dtype=torch.bfloat16, device=Wm.device)
    launch("tdv_batched_dot", Wm.device, Wm.data_ptr(), Fm.data_ptr(),
           out.data_ptr(), B, Q, Y, C)
    batched_dot.launches += 1
    return out


batched_dot.launches = 0


def _check_indices(values, idx, axis):
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis={axis}, must be 0 or 1")
    if values.dim() != 2 or idx.dim() != 2:
        raise ValueError("take_along_axis: values and indices must be 2-D")
    other = 1 - axis
    if idx.shape[other] != values.shape[other]:
        raise ValueError(f"take_along_axis: indices {tuple(idx.shape)} and "
                         f"values {tuple(values.shape)} differ on axis "
                         f"{other}")
    n = values.shape[axis]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"take_along_axis: an index outside [0, {n})")


def take_along_axis_ref(values: torch.Tensor, idx: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """values [A, B] fp32, idx int32 of the same extent on the other axis,
    entries in [0, values.shape[axis]) -> values gathered along `axis`
    (`numpy.take_along_axis` without broadcasting)."""
    _check_indices(values, idx, axis)
    return torch.gather(values, axis, idx.long())


def take_along_axis(values: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Same contract as `take_along_axis_ref`; the index range is checked on
    the host before the launch."""
    if on_cpu(values, idx):
        return take_along_axis_ref(values, idx, axis)
    no_backward("take_along_axis", values)
    _check_indices(values, idx, axis)
    check(values, "values", torch.float32)
    check(idx, "idx", torch.int32)
    rows, cols = idx.shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=values.device)
    launch("tdv_take_along_axis", values.device, values.data_ptr(),
           idx.data_ptr(), out.data_ptr(), values.shape[0], values.shape[1],
           rows, cols, axis)
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0
