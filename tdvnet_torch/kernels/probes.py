"""The port's counterparts of the two Mosaic probes' kernels: a batch of
small bf16 matrix products with one rounding to bf16 (`batched_dot`) and
`take_along_axis` over fp32 values with int32 indices.

Kernels: `csrc/batched_dot.cu` and `csrc/take_along_axis.cu` (see their
headers for the probe kernels each replaces, its bound and its design).
`batched_dot_ref` and `take_along_axis_ref` are the plain PyTorch twins;
the wrappers run them only for CPU tensors. The probe entry points are
`tdvnet_torch.tools.probe_batched_dot` and `tdvnet_torch.tools.probe_gather`.
"""
from __future__ import annotations

from typing import Optional

import torch

from tdvnet_torch.kernels._launch import check, launch, no_backward, on_cpu


def batched_dot_shape_error(Q: int, Y: int, C: int, B: int = 1
                            ) -> Optional[str]:
    """Why the card's kernel refuses B products [Q, Y] @ [Y, C], or None
    when it takes them: 1 <= Q <= 256 (one tensor-map box of W's rows), Y
    in {16, 32, 64} and C in {8, 16, 32, 64} (rows of 32 to 128 bytes and
    16 to 128 bytes, the widths the maps' swizzles cover), B < 2^31 (a
    box coordinate)."""
    if not 1 <= Q <= 256:
        return f"Q={Q} must be from 1 to 256"
    if Y not in (16, 32, 64):
        return f"Y={Y} must be 16, 32 or 64"
    if C not in (8, 16, 32, 64):
        return f"C={C} must be 8, 16, 32 or 64"
    if B >= 2 ** 31:
        return f"{B} products, at most 2^31 - 1"
    return None


def batched_dot_ref(Wm: torch.Tensor, Fm: torch.Tensor) -> torch.Tensor:
    """Wm [..., Q, Y] bf16 @ Fm [..., Y, C] bf16 -> [..., Q, C] bf16: each
    sum taken in float64, rounded to fp32 and then to bf16. A bf16 product
    has 16 significant bits, so the float64 sum is exact unless the
    products' magnitudes span more than about 2^30: the twin is the exact
    product rounded, whatever order a library sums it in."""
    return torch.matmul(Wm.double(), Fm.double()).float().to(torch.bfloat16)


def batched_dot(Wm: torch.Tensor, Fm: torch.Tensor) -> torch.Tensor:
    """Same contract as `batched_dot_ref`; the leading dims of both inputs
    must match (no broadcasting), both contiguous and 16-byte aligned, and
    the product's shape one that `batched_dot_shape_error` accepts."""
    if on_cpu(Wm, Fm):
        return batched_dot_ref(Wm, Fm)
    no_backward("batched_dot", Wm, Fm)
    *lead, Q, Y = Wm.shape
    C = Fm.shape[-1]
    check(Wm, "Wm", torch.bfloat16)
    check(Fm, "Fm", torch.bfloat16, (*lead, Y, C))
    B = Wm.numel() // max(Q * Y, 1)
    why = batched_dot_shape_error(Q, Y, C, B)
    if why is not None:
        raise ValueError(f"batched_dot: {why}")
    if Wm.data_ptr() % 16 or Fm.data_ptr() % 16:
        raise ValueError("batched_dot: Wm and Fm must be 16-byte aligned")
    out = torch.empty((*lead, Q, C), dtype=torch.bfloat16, device=Wm.device)
    if B:
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


def take_along_axis_ref(values: torch.Tensor, idx: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """values [A, B] fp32, idx int32 of the same extent on the other axis ->
    values gathered along `axis` by `jnp.take_along_axis`'s rule: an index
    in [-n, 0) counts from the end (n = values.shape[axis]), and one outside
    [-n, n) gives NaN. No host sync."""
    _check_indices(values, idx, axis)
    n = values.shape[axis]
    if n == 0:
        return torch.full(idx.shape, float("nan"), dtype=values.dtype,
                          device=values.device)
    k = torch.where(idx < 0, idx + n, idx)
    got = torch.gather(values, axis, k.clamp(0, n - 1).long())
    return torch.where((k >= 0) & (k < n), got, float("nan"))


def take_along_axis(values: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Same contract as `take_along_axis_ref`; the kernel applies the index
    rule itself, so the wrapper checks only shapes and types."""
    if on_cpu(values, idx):
        return take_along_axis_ref(values, idx, axis)
    no_backward("take_along_axis", values)
    _check_indices(values, idx, axis)
    check(values, "values", torch.float32)
    check(idx, "idx", torch.int32)
    rows, cols = idx.shape
    out = torch.empty_like(idx, dtype=torch.float32)
    if out.numel():
        vec = cols % 4 == 0 and idx.data_ptr() % 16 == 0
        launch("tdv_take_along_axis", values.device, values.data_ptr(),
               idx.data_ptr(), out.data_ptr(), values.shape[0],
               values.shape[1], rows, cols, axis, vec)
        take_along_axis.launches += 1
    return out


take_along_axis.launches = 0
