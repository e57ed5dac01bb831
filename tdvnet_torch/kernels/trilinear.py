"""Trilinear sampling of a dense scene grid at world points: fp32 grids
(K6, with its gradient for the grid) and the fast path's per-channel int8
grids (K6-int8, inference only).

Kernels: `csrc/trilinear_sample.cu`, `csrc/trilinear_sample_backward.cu`
and `csrc/trilinear_sample_i8.cu` (see their headers for the TPU ops they
replace, their bounds and their designs). The fp32 forward computes each
query's coordinates once, in a lane of a warp that takes 32 consecutive
queries, hands them to the C/4 lanes that sample its channels, and keeps a
query's 8 taps in registers for the next query that shares its anchor; its
sums are bit-equal to those of one thread per (query, 4 channels). The int8
forward has the same design (a lane's taps are 16 int8 channels of a cell
row where C allows, C = 96 six lanes a query), bit-equal to its first form.
`trilinear_sample_ref`, `trilinear_sample_backward_ref` and
`trilinear_sample_i8_ref` are the plain PyTorch twins; the wrappers run
them only for CPU tensors. `trilinear_sample` writes into a channel slice
of a wider output, which autograd cannot follow: a sampling that must carry
the grid's gradient goes through `trilinear_sample_scale`, which returns
the scale's own [B, Q, C] from `TrilinearSampleFn` (backward:
`trilinear_sample_backward`, which sums each brick of BRICK^3 nodes in one
block's shared memory, in fixed point so that it repeats bit for bit; see
the kernel's header). The fp32 forward takes any channel slice: 4
channels a lane, or one where C, the output's width or the channel offset
is not a multiple of 4 (the same operations per channel). The grid
backward and K6-int8 take 4-channel groups: for another C their wrappers
add zero channels (`_launch.pad_channels`) to the incoming gradient, or to
the int8 grid and its scales (sampled into a whole-group scratch copied
into the slice), and slice the real channels out; every channel's sum is
its own, so those are exact.

A bf16 grid goes to the forward's bf16 form: it reads the bf16 taps, sums
in fp32 in the fp32 form's order and rounds once to bf16 into a bf16
output's channel slice (the JAX package sums in bf16: each product and
partial sum rounded, up to ~180 bf16 ulps off where taps cancel). Its
launches count in `trilinear_sample.bf16_launches`. The grid backward's
bf16 form (a bf16 model in training) reads a bf16 incoming gradient, sums
in the fp32 form's fixed point and rounds each node's gradient once to
bf16 (`trilinear_sample_backward.bf16_launches`).
"""
from __future__ import annotations

import torch

from tdvnet_torch.kernels._launch import (check, launch, no_backward,
                                          on_cpu, pad_channels, quad,
                                          wants_grad)
from tdvnet_torch.ops.sampling import _floor_in, trilinear_sample_batched

# the backward kernel's bricks of BRICK^3 nodes, each summed in one block's
# shared memory, GROUP channels at a time; a brick whose list holds more
# than one chunk of entries (at least MIN_CHUNK) adds into an int64 copy
BRICK = 8
GROUP = 32
MIN_CHUNK = 1024


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
    outside the grid; a bf16 grid is summed in fp32 and rounded once."""
    out = trilinear_sample_batched(grid, _node_coords(pts, center0, cell,
                                                      0.0))
    return out.to(grid.dtype)


def trilinear_sample_backward_ref(grad: torch.Tensor, pts: torch.Tensor,
                                  center0: torch.Tensor, cell: float,
                                  grid_shape) -> torch.Tensor:
    """d loss / d grid [B, X, Y, Z, C] from grad = d loss / d samples
    [B, Q, C] (`trilinear_sample_ref`'s): each point adds g * w into each of
    its 8 taps with the forward's weights; taps outside the grid take
    nothing, nor does a point whose coordinates are not finite. The points
    take no gradient. A bf16 grad (a bf16 grid's) sums in fp32 and the
    result is rounded once to bf16."""
    if grad.dtype == torch.bfloat16:
        return trilinear_sample_backward_ref(
            grad.float(), pts, center0, cell, grid_shape).to(torch.bfloat16)
    B, X, Y, Z, C = grid_shape
    dims = (X, Y, Z)
    q = _node_coords(pts, center0, cell, 0.0)
    f, ok, i0 = zip(*[_floor_in(q[..., a], dims[a] - 1) for a in range(3)])
    w = [q[..., a] - f[a] for a in range(3)]
    anchor_ok = ok[0] & ok[1] & ok[2] & torch.isfinite(q).all(dim=-1)
    base = torch.arange(B, device=grad.device)[:, None]
    out = torch.zeros((B * X * Y * Z, C), dtype=grad.dtype,
                      device=grad.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = [i0[0] + dx, i0[1] + dy, i0[2] + dz]
                wgt = ((w[0] if dx else 1 - w[0])
                       * (w[1] if dy else 1 - w[1])
                       * (w[2] if dz else 1 - w[2]))
                inb = anchor_ok
                for a in range(3):
                    inb = inb & (idx[a] >= 0) & (idx[a] <= dims[a] - 1)
                xi, yi, zi = [idx[a].clamp(0, dims[a] - 1) for a in range(3)]
                rows = ((base * X + xi) * Y + yi) * Z + zi
                val = torch.where(inb[..., None], grad * wgt[..., None],
                                  torch.zeros_like(grad))
                out.index_add_(0, rows.reshape(-1), val.reshape(-1, C))
    return out.reshape(B, X, Y, Z, C)


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
    """Whether channels [ch_off, ch_off + C) of a Ctot-wide output are
    whole 4-channel groups; raises where they do not fit."""
    if ch_off < 0 or ch_off + C > Ctot:
        raise ValueError(f"{name}: channels [{ch_off}, {ch_off + C}) do "
                         f"not fit an output of {Ctot}")
    return C % 4 == 0 and Ctot % 4 == 0 and ch_off % 4 == 0


def trilinear_sample(grid: torch.Tensor, pts: torch.Tensor,
                     center0: torch.Tensor, cell: float, out: torch.Tensor,
                     ch_off: int) -> torch.Tensor:
    """Write `trilinear_sample_ref(grid, pts, center0, cell)` into channels
    [ch_off, ch_off + C) of `out` [B, Q, Ctot] (fp32, or bf16 for a bf16
    grid) and return `out`. On the card the in-place write carries no
    gradient: a grid that requires grad raises (`trilinear_sample_scale`
    differentiates)."""
    if on_cpu(grid, pts, center0, out):
        C = grid.shape[-1]
        out[..., ch_off:ch_off + C] = trilinear_sample_ref(grid, pts, center0,
                                                           cell)
        return out
    no_backward("trilinear_sample", grid, pts, center0)
    return _trilinear_sample(grid, pts, center0, cell, out, ch_off)


def _trilinear_sample(grid, pts, center0, cell, out, ch_off):
    B, X, Y, Z, C = grid.shape
    Q = pts.shape[1]
    Ctot = out.shape[-1]
    _check_slice("trilinear_sample", C, Ctot, ch_off)
    if B * X * Y * Z >= 2 ** 31:
        raise ValueError(f"trilinear_sample: {B} grids of {X}x{Y}x{Z} nodes "
                         f"are outside the kernel's int32 cell indices")
    half = grid.dtype == torch.bfloat16
    dtype = torch.bfloat16 if half else torch.float32
    check(grid, "grid", dtype, (B, X, Y, Z, C))
    check(pts, "pts", torch.float32, (B, Q, 3))
    check(center0, "center0", torch.float32, (B, 3))
    check(out, "out", dtype, (B, Q, Ctot))
    if half and (grid.data_ptr() % 8 or out.data_ptr() % 8):
        raise ValueError("trilinear_sample: a bf16 grid and output must "
                         "start on 8 bytes")
    launch("tdv_trilinear_sample_bf16" if half else "tdv_trilinear_sample",
           grid.device, grid.data_ptr(), pts.data_ptr(), center0.data_ptr(),
           out.data_ptr(), B, Q, X, Y, Z, C, float(cell), Ctot, ch_off)
    if half:
        trilinear_sample.bf16_launches += 1
    else:
        trilinear_sample.launches += 1
    return out


trilinear_sample.launches = 0
trilinear_sample.bf16_launches = 0


class TrilinearSampleFn(torch.autograd.Function):
    """One scale's sampling into its own [B, Q, C] (the grid's dtype), with
    the hand backward for the grid."""

    @staticmethod
    def forward(ctx, grid, pts, center0, cell):
        B, Q = pts.shape[:2]
        out = torch.empty((B, Q, grid.shape[-1]), dtype=grid.dtype,
                          device=grid.device)
        _trilinear_sample(grid, pts, center0, cell, out, 0)
        ctx.save_for_backward(pts, center0)
        ctx.cell, ctx.grid_shape = cell, tuple(grid.shape)
        return out

    @staticmethod
    def backward(ctx, grad):
        pts, center0 = ctx.saved_tensors
        g = trilinear_sample_backward(grad.contiguous(), pts, center0,
                                      ctx.cell, ctx.grid_shape)
        return g, None, None, None


def trilinear_sample_scale(grid: torch.Tensor, pts: torch.Tensor,
                           center0: torch.Tensor,
                           cell: float) -> torch.Tensor:
    """`trilinear_sample_ref(grid, pts, center0, cell)` as a new [B, Q, C]
    tensor of the grid's dtype, differentiable in the grid (the points take
    no gradient)."""
    if on_cpu(grid, pts, center0):
        return trilinear_sample_ref(grid, pts, center0, cell)
    if wants_grad(pts, center0):
        raise NotImplementedError(
            "trilinear_sample: no gradient with respect to the points (the "
            "JAX package stops it); detach them")
    if wants_grad(grid):
        return TrilinearSampleFn.apply(grid, pts, center0, cell)
    out = torch.empty((*pts.shape[:2], grid.shape[-1]), dtype=grid.dtype,
                      device=grid.device)
    return _trilinear_sample(grid, pts, center0, cell, out, 0)


def trilinear_sample_backward(grad: torch.Tensor, pts: torch.Tensor,
                              center0: torch.Tensor, cell: float,
                              grid_shape) -> torch.Tensor:
    """Same contract as `trilinear_sample_backward_ref`; launches the CUDA
    kernel for CUDA tensors (fixed-point integer sums: the same bits on
    every launch, whatever order the points come in; its bf16 form for a
    bf16 grad)."""
    if on_cpu(grad, pts, center0):
        return trilinear_sample_backward_ref(grad, pts, center0, cell,
                                             grid_shape)
    B, X, Y, Z, C = grid_shape
    Q = pts.shape[1]
    if C % 4:
        return trilinear_sample_backward(
            pad_channels(grad, quad(C)), pts, center0, cell,
            (B, X, Y, Z, quad(C)))[..., :C].contiguous()
    if 8 * B * Q >= 2 ** 31:
        raise ValueError(f"trilinear_sample_backward: {B} x {Q} points are "
                         f"outside the kernel's int32 entry space")
    half = grad.dtype == torch.bfloat16
    dtype = torch.bfloat16 if half else torch.float32
    check(grad, "grad", dtype, (B, Q, C))
    check(pts, "pts", torch.float32, (B, Q, 3))
    check(center0, "center0", torch.float32, (B, 3))
    dev = grad.device
    n_bricks = brick_count(grid_shape)
    # every element of the output is written by the kernel
    out = torch.empty(tuple(grid_shape), dtype=dtype, device=dev)
    n_groups = -(-C // GROUP)
    scratch = torch.empty((4 * n_bricks + 4 + n_bricks * n_groups + 2,),
                          dtype=torch.int32, device=dev)
    # one 16-byte entry per (point, brick): at most 8 a point
    entries = torch.empty((8 * B * Q, 4), dtype=torch.float32, device=dev)
    # an int64 copy of each brick whose entries fill several chunks (of at
    # least MIN_CHUNK + 1 entries each); only those bricks are touched
    n_multi = min(n_bricks, 8 * B * Q // (MIN_CHUNK + 1) + 1)
    multi = torch.empty((n_multi, BRICK ** 3 * C), dtype=torch.int64,
                        device=dev)
    launch("tdv_trilinear_sample_backward_bf16" if half
           else "tdv_trilinear_sample_backward", dev, grad.data_ptr(),
           pts.data_ptr(), center0.data_ptr(), out.data_ptr(),
           scratch.data_ptr(), entries.data_ptr(), multi.data_ptr(), B, Q, X,
           Y, Z, C, float(cell))
    if half:
        trilinear_sample_backward.bf16_launches += 1
    else:
        trilinear_sample_backward.launches += 1
    return out


def brick_count(grid_shape) -> int:
    """Bricks of BRICK^3 nodes over the B grids of `grid_shape`
    [B, X, Y, Z, C] (partial bricks at the high faces)."""
    B, X, Y, Z, _ = grid_shape
    return B * -(-X // BRICK) * -(-Y // BRICK) * -(-Z // BRICK)


trilinear_sample_backward.launches = 0
trilinear_sample_backward.bf16_launches = 0


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
    no_backward("trilinear_sample_i8", scale, pts, center0)
    B, X, Y, Z, C = grid.shape
    Q = pts.shape[1]
    Ctot = out.shape[-1]
    if not _check_slice("trilinear_sample_i8", C, Ctot, ch_off):
        check(out, "out", torch.bfloat16, (B, Q, Ctot), contiguous=False)
        tmp = torch.empty((B, Q, quad(C)), dtype=torch.bfloat16,
                          device=grid.device)
        trilinear_sample_i8(pad_channels(grid, quad(C)),
                            pad_channels(scale, quad(C)), pts, center0, cell,
                            tmp, 0, cell_offset)
        out[..., ch_off:ch_off + C] = tmp[..., :C]
        return out
    if B * X * Y * Z >= 2 ** 31 or B >= 2 ** 23:
        raise ValueError(f"trilinear_sample_i8: {B} grids of {X}x{Y}x{Z} "
                         f"nodes are outside the kernel's int32 cell "
                         f"indices")
    check(grid, "grid", torch.int8, (B, X, Y, Z, C))
    check(scale, "scale", torch.float32, (B, C))
    check(pts, "pts", torch.float32, (B, Q, 3))
    check(center0, "center0", torch.float32, (B, 3))
    check(out, "out", torch.bfloat16, (B, Q, Ctot))
    if out.data_ptr() % 8:
        raise ValueError("trilinear_sample_i8: out must start on 8 bytes")
    launch("tdv_trilinear_sample_i8", grid.device, grid.data_ptr(),
           scale.data_ptr(), pts.data_ptr(), center0.data_ptr(),
           out.data_ptr(), B, Q, X, Y, Z, C, float(cell), float(cell_offset),
           Ctot, ch_off)
    trilinear_sample_i8.launches += 1
    return out


trilinear_sample_i8.launches = 0
