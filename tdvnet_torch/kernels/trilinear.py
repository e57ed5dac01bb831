"""Trilinear sampling of a dense scene grid at world points (K6).

Kernel: `csrc/trilinear_sample.cu` (see its header for the TPU op it
replaces, its bound and its design). `trilinear_sample_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors.
"""
from __future__ import annotations

import torch

from tdvnet_torch.kernels._launch import check, launch, on_cpu
from tdvnet_torch.ops.sampling import trilinear_sample_batched


def trilinear_sample_ref(grid: torch.Tensor, pts: torch.Tensor,
                         center0: torch.Tensor, cell: float) -> torch.Tensor:
    """grid [B, X, Y, Z, C]; pts [B, Q, 3] world points; center0 [B, 3] the
    world position of node 0; cell the node spacing in meters. Returns
    [B, Q, C]: trilinear samples at node coords (pts - center0) / cell,
    zero outside the grid."""
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and the JAX package's) true division
    cell_t = torch.tensor(cell, dtype=torch.float32, device=pts.device)
    q = (pts - center0[:, None, :]) / cell_t
    return trilinear_sample_batched(grid, q)


def trilinear_sample(grid: torch.Tensor, pts: torch.Tensor,
                     center0: torch.Tensor, cell: float, out: torch.Tensor,
                     ch_off: int) -> torch.Tensor:
    """Write `trilinear_sample_ref(grid, pts, center0, cell)` into channels
    [ch_off, ch_off + C) of `out` [B, Q, Ctot] and return `out`."""
    if on_cpu(grid, pts, center0, out):
        C = grid.shape[-1]
        out[..., ch_off:ch_off + C] = trilinear_sample_ref(grid, pts, center0,
                                                           cell)
        return out
    B, X, Y, Z, C = grid.shape
    Q = pts.shape[1]
    Ctot = out.shape[-1]
    if C % 4 or Ctot % 4 or ch_off % 4 or ch_off + C > Ctot:
        raise ValueError(f"trilinear_sample: channels C={C}, Ctot={Ctot}, "
                         f"ch_off={ch_off} must be multiples of 4 that fit")
    check(grid, "grid", torch.float32, (B, X, Y, Z, C))
    check(pts, "pts", torch.float32, (B, Q, 3))
    check(center0, "center0", torch.float32, (B, 3))
    check(out, "out", torch.float32, (B, Q, Ctot))
    launch("tdv_trilinear_sample", grid.device, grid.data_ptr(),
           pts.data_ptr(), center0.data_ptr(), out.data_ptr(), B, Q, X, Y, Z,
           C, float(cell), Ctot, ch_off)
    trilinear_sample.launches += 1
    return out


trilinear_sample.launches = 0
