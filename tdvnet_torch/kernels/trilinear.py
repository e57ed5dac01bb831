"""Trilinear sampling of a dense scene grid at world points: fp32 grids
(K6) and the fast path's per-channel int8 grids (K6-int8).

Kernels: `csrc/trilinear_sample.cu` and `csrc/trilinear_sample_i8.cu` (see
their headers for the TPU ops they replace, their bounds and their
designs). `trilinear_sample_ref` and `trilinear_sample_i8_ref` are the
plain PyTorch twins; the wrappers run them only for CPU tensors.
"""
from __future__ import annotations

import torch

from tdvnet_torch.kernels._launch import check, launch, on_cpu
from tdvnet_torch.ops.sampling import trilinear_sample_batched


def _node_coords(pts, center0, cell, cell_offset):
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and the JAX package's) true division
    cell_t = torch.tensor(cell, dtype=torch.float32, device=pts.device)
    q = (pts - center0[:, None, :]) / cell_t
    return q + cell_offset if cell_offset else q


def trilinear_sample_ref(grid: torch.Tensor, pts: torch.Tensor,
                         center0: torch.Tensor, cell: float) -> torch.Tensor:
    """grid [B, X, Y, Z, C]; pts [B, Q, 3] world points; center0 [B, 3] the
    world position of node 0; cell the node spacing in meters. Returns
    [B, Q, C]: trilinear samples at node coords (pts - center0) / cell, zero
    outside the grid."""
    return trilinear_sample_batched(grid, _node_coords(pts, center0, cell,
                                                       0.0))


def trilinear_sample_i8_ref(grid: torch.Tensor, scale: torch.Tensor,
                            pts: torch.Tensor, center0: torch.Tensor,
                            cell: float,
                            cell_offset: float = 0.0) -> torch.Tensor:
    """`trilinear_sample_ref` over an int8 grid [B, X, Y, Z, C] with its
    per-channel scale [B, C], at node coords (pts - center0) / cell +
    cell_offset (a merged grid's low-side pad): the 8 taps summed in fp32
    with fp32 weights, multiplied by the channel's scale once after the sum
    (interpolation is linear, so that is exact), rounded once to bf16.
    Returns [B, Q, C] bf16."""
    acc = trilinear_sample_batched(
        grid.to(torch.float32), _node_coords(pts, center0, cell, cell_offset))
    return (acc * scale[:, None, :]).to(torch.bfloat16)


def _check_slice(name, C, Ctot, ch_off):
    if C % 4 or Ctot % 4 or ch_off % 4 or ch_off + C > Ctot:
        raise ValueError(f"{name}: channels C={C}, Ctot={Ctot}, "
                         f"ch_off={ch_off} must be multiples of 4 that fit")


def trilinear_sample(grid: torch.Tensor, pts: torch.Tensor,
                     center0: torch.Tensor, cell: float, out: torch.Tensor,
                     ch_off: int) -> torch.Tensor:
    """Write `trilinear_sample_ref(grid, pts, center0, cell)` into channels
    [ch_off, ch_off + C) of `out` [B, Q, Ctot] fp32 and return `out`."""
    if on_cpu(grid, pts, center0, out):
        C = grid.shape[-1]
        out[..., ch_off:ch_off + C] = trilinear_sample_ref(grid, pts, center0,
                                                           cell)
        return out
    B, X, Y, Z, C = grid.shape
    Q = pts.shape[1]
    Ctot = out.shape[-1]
    _check_slice("trilinear_sample", C, Ctot, ch_off)
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


def trilinear_sample_i8(grid: torch.Tensor, scale: torch.Tensor,
                        pts: torch.Tensor, center0: torch.Tensor, cell: float,
                        out: torch.Tensor, ch_off: int,
                        cell_offset: float = 0.0) -> torch.Tensor:
    """Write `trilinear_sample_i8_ref(grid, scale, pts, center0, cell,
    cell_offset)` into channels [ch_off, ch_off + C) of `out` [B, Q, Ctot]
    bf16 and return `out`."""
    if on_cpu(grid, scale, pts, center0, out):
        C = grid.shape[-1]
        out[..., ch_off:ch_off + C] = trilinear_sample_i8_ref(
            grid, scale, pts, center0, cell, cell_offset)
        return out
    B, X, Y, Z, C = grid.shape
    Q = pts.shape[1]
    Ctot = out.shape[-1]
    _check_slice("trilinear_sample_i8", C, Ctot, ch_off)
    check(grid, "grid", torch.int8, (B, X, Y, Z, C))
    check(scale, "scale", torch.float32, (B, C))
    check(pts, "pts", torch.float32, (B, Q, 3))
    check(center0, "center0", torch.float32, (B, 3))
    check(out, "out", torch.bfloat16, (B, Q, Ctot))
    launch("tdv_trilinear_sample_i8", grid.device, grid.data_ptr(),
           scale.data_ptr(), pts.data_ptr(), center0.data_ptr(),
           out.data_ptr(), B, Q, X, Y, Z, C, float(cell), float(cell_offset),
           Ctot, ch_off)
    trilinear_sample_i8.launches += 1
    return out


trilinear_sample_i8.launches = 0
