"""TSDF integration of a batch of depth frames into a dense volume (K9a).

Kernel: `csrc/tsdf_integrate.cu` (see its header for the TPU op it
replaces, its bound and its design). `tsdf_integrate_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors. `tsdf_skip_ref` is
the plain twin of the kernel's cull: the (brick, frame) pairs whose bounds
prove that no voxel of the brick can take the frame, which the kernel
never runs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tdvnet_torch.kernels._launch import (check, launch, no_backward,
                                          on_cpu)
from tdvnet_torch.kernels.fusion import (QUOT, TINY, box_cull,
                                          frustum_planes)
from tdvnet_torch.kernels.patchfan import _fma

Accumulators = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
BRICK = (2, 8, 16)     # a block's brick of voxels along (x, y, z)
# the colour types the kernel reads (uint8 widens exactly)
COLOR_DTYPES = (torch.float32, torch.uint8)


def voxel_centers(dims: Tuple[int, int, int], voxel_size: float,
                  origin: torch.Tensor) -> torch.Tensor:
    """World centres of the voxels of a [nx, ny, nz] grid in (i, j, k)
    row-major order, [V, 3]: fma(coord, voxel_size, origin) in fp32, the
    form XLA's CPU backend gives `coords * voxel_size + origin` for x and y
    (for z it contracts only some grids; the difference is one ulp)."""
    nx, ny, nz = dims
    dev = origin.device
    axes = [torch.arange(n, dtype=torch.float32, device=dev)
            for n in (nx, ny, nz)]
    coords = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                         dim=-1).reshape(-1, 3)
    vs = torch.tensor(np.float32(voxel_size), device=dev)
    return _fma(coords, vs, origin.to(torch.float32)[None, :])


def _inv_trunc(voxel_size: float, trunc_ratio: float) -> np.float32:
    """1 / trunc in fp32, trunc = f32(voxel_size * trunc_ratio): XLA's CPU
    backend divides by the constant trunc as a product with its fp32
    reciprocal, so the port does too."""
    return np.float32(1) / np.float32(voxel_size * trunc_ratio)


def _project_rows(M: torch.Tensor, x, y, z):
    """fma(m2, z, fma(m1, y, m0 * x)) + m3 for each row of M [3, 4]: the
    order of XLA's CPU dot and of the kernel."""
    return [_fma(M[i, 2], z, _fma(M[i, 1], y, M[i, 0] * x)) + M[i, 3]
            for i in range(3)]


def _tsdf_frame(M: torch.Tensor, x, y, z, depth_f, inv_trunc):
    """Voxel centres (x, y, z) projected into one frame (projection M [3,
    4], depth map depth_f [H, W]): (valid, sdf, flat pixel)."""
    H, W = depth_f.shape
    cx, cy, pz = _project_rows(M, x, y, z)
    px, py = torch.round(cx / pz), torch.round(cy / pz)
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (pz > 0)
    pix = torch.where(inb, py * W + px, torch.zeros_like(px)).long()
    d = depth_f.reshape(-1)[pix]
    sdf = torch.minimum((d - pz) * inv_trunc, torch.ones_like(d))
    return inb & (d > 0) & (sdf > -1), sdf, pix


def tsdf_integrate_ref(depths: torch.Tensor, colors: torch.Tensor,
                       projections: torch.Tensor, origin: torch.Tensor,
                       dims: Tuple[int, int, int], voxel_size: float,
                       trunc_ratio: float = 3.0,
                       init: Optional[Accumulators] = None) -> Accumulators:
    """depths [N, H, W], colors [N, H, W, 3] (fp32 or uint8), projections
    [N, 3, 4] (K[R|t], world to pixel), origin [3]. Each voxel centre is
    projected into every frame in order at the rounded pixel (half to
    even); where the pixel is inside, in front of the camera and its depth
    d > 0, sdf = min((d - z) * (1 / trunc), 1) with trunc = f32(voxel_size *
    trunc_ratio) is added to the voxel's tsdf, 1 to its weight and the
    pixel's colour to its colour, if sdf > -1. Returns (tsdf [V], weight
    [V], color [V, 3]) fp32, added to `init` when given."""
    N, H, W = depths.shape
    dev = depths.device
    world = voxel_centers(dims, voxel_size, origin.to(dev))
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    inv_trunc = torch.tensor(_inv_trunc(voxel_size, trunc_ratio), device=dev)
    V = world.shape[0]
    if init is None:
        tsdf = torch.zeros(V, dtype=torch.float32, device=dev)
        weight = torch.zeros_like(tsdf)
        color = torch.zeros((V, 3), dtype=torch.float32, device=dev)
    else:
        tsdf, weight, color = (a.clone() for a in init)
    for f in range(N):
        valid, sdf, pix = _tsdf_frame(projections[f], x, y, z, depths[f],
                                      inv_trunc)
        rgb = colors[f].reshape(-1, 3)[pix].to(torch.float32)
        tsdf = torch.where(valid, tsdf + sdf, tsdf)
        weight = torch.where(valid, weight + 1, weight)
        color = torch.where(valid[:, None], color + rgb, color)
    return tsdf, weight, color


# ------------------------------------------------------------------ the cull
def tsdf_planes(projections: torch.Tensor, depth_max: torch.Tensor, W: int,
                H: int, inv_trunc: float) -> torch.Tensor:
    """K9a's half-spaces per frame (`fusion.frustum_planes`): no voxel
    centre of a box can take the frame where pz <= 0, or the rounded pixel
    lies left of 0 (the quotient below -0.5), right of W - 1 (above W -
    0.5), above 0 or below H - 1 for every pz > 0 (each quotient two ulps
    past its edge), or pz exceeds the frame's largest depth by more than
    trunc (1 / inv_trunc, with a margin, so sdf <= -1), or the frame has no
    positive depth."""
    it = float(inv_trunc)
    gap = (1 / it) * (1 + 2.0 ** -20) if 0 < it < float("inf") \
        else float("nan")
    return frustum_planes(projections, 0.0, 0.5 * QUOT + TINY,
                          (W - 0.5) * QUOT + TINY, (H - 0.5) * QUOT + TINY,
                          depth_max, gap)


def tsdf_cull(lo: torch.Tensor, hi: torch.Tensor, projections: torch.Tensor,
              depth_max: torch.Tensor, W: int, H: int,
              inv_trunc: float) -> torch.Tensor:
    """Whether the bounds prove that no voxel centre of a box can take a
    frame: float64 boxes lo/hi [..., 1, 3] against projections [N, 3, 4]
    with the frames' largest depths [N] (NaN disables the depth test) ->
    [..., N] (`tsdf_planes`, `fusion.box_cull`). A box with a non-finite
    or huge bound is never skipped."""
    return box_cull(lo, hi, tsdf_planes(projections, depth_max, W, H,
                                        inv_trunc))


def brick_boxes(dims: Tuple[int, int, int], voxel_size: float,
                origin: torch.Tensor):
    """The kernel's bricks of BRICK voxels: (lo, hi [n_bricks, 3] float64
    over the voxel centres of each brick, brick [V] of each voxel), bricks
    in row-major (x, y, z) order."""
    world = voxel_centers(dims, voxel_size, origin).double()
    dev = world.device
    nb = [-(-n // b) for n, b in zip(dims, BRICK)]
    axes = [torch.arange(n, device=dev) // b for n, b in zip(dims, BRICK)]
    bi, bj, bk = torch.meshgrid(*axes, indexing="ij")
    brick = ((bi * nb[1] + bj) * nb[2] + bk).reshape(-1)
    n = nb[0] * nb[1] * nb[2]
    inf = torch.full((n, 3), float("inf"), dtype=torch.float64, device=dev)
    idx = brick[:, None].expand(-1, 3)
    bad = ~torch.isfinite(world).all(-1)
    lo = inf.scatter_reduce(0, idx, world, "amin")
    hi = (-inf).scatter_reduce(0, idx, world, "amax")
    nonfinite = torch.zeros(n, dtype=torch.long, device=dev).scatter_add(
        0, brick, bad.long()) > 0
    lo = torch.where(nonfinite[:, None], -inf, lo)
    hi = torch.where(nonfinite[:, None], inf, hi)
    return lo, hi, brick


def tsdf_skip_ref(depths: torch.Tensor, projections: torch.Tensor,
                  origin: torch.Tensor, dims: Tuple[int, int, int],
                  voxel_size: float, trunc_ratio: float = 3.0):
    """The kernel's cull in plain torch: (skip [n_bricks, N] for every
    (brick, frame) that the kernel never runs, brick [V] of each voxel)."""
    N, H, W = depths.shape
    lo, hi, brick = brick_boxes(dims, voxel_size, origin.to(depths.device))
    dmax = depths.reshape(N, -1).amax(1)
    skip = tsdf_cull(lo[:, None, :], hi[:, None, :], projections, dmax, W,
                     H, _inv_trunc(voxel_size, trunc_ratio))
    return skip, brick


def tsdf_integrate(depths: torch.Tensor, colors: torch.Tensor,
                   projections: torch.Tensor, origin: torch.Tensor,
                   dims: Tuple[int, int, int], voxel_size: float,
                   trunc_ratio: float = 3.0,
                   init: Optional[Accumulators] = None) -> Accumulators:
    """Same contract as `tsdf_integrate_ref`; launches the CUDA kernel for
    CUDA tensors. `origin` may live on either device (its three values are
    kernel arguments)."""
    carried = tuple(init) if init is not None else ()
    if on_cpu(depths, colors, projections, *carried):
        return tsdf_integrate_ref(depths, colors, projections,
                                  origin.cpu(), dims, voxel_size,
                                  trunc_ratio, init)
    no_backward("tsdf_integrate", depths, colors, projections, origin,
                *carried)
    N, H, W = depths.shape
    nx, ny, nz = (int(d) for d in dims)
    V = nx * ny * nz
    check(depths, "depths", torch.float32, (N, H, W))
    if colors.dtype not in COLOR_DTYPES:
        raise TypeError(f"colors: expected one of {COLOR_DTYPES}, got "
                        f"{colors.dtype}")
    check(colors, "colors", colors.dtype, (N, H, W, 3))
    check(projections, "projections", torch.float32, (N, 3, 4))
    if init is not None:
        for a, name, shape in zip(init, ("tsdf", "weight", "color"),
                                  ((V,), (V,), (V, 3))):
            check(a, f"init {name}", torch.float32, shape)
    dev = depths.device
    tsdf = torch.empty(V, dtype=torch.float32, device=dev)
    weight = torch.empty_like(tsdf)
    color = torch.empty((V, 3), dtype=torch.float32, device=dev)
    depth_max = depths.reshape(N, -1).amax(1)
    planes = torch.empty((7 * 8, N), dtype=torch.float64, device=dev)
    ins = [a.data_ptr() for a in init] if init is not None else [None] * 3
    ox, oy, oz = (float(v) for v in np.asarray(
        origin.detach().cpu(), np.float32))
    launch("tdv_tsdf_integrate", dev, depths.data_ptr(), colors.data_ptr(),
           int(colors.dtype == torch.uint8), projections.data_ptr(),
           depth_max.data_ptr(), planes.data_ptr(), *ins, tsdf.data_ptr(),
           weight.data_ptr(), color.data_ptr(), N, H, W, nx, ny, nz, ox, oy,
           oz,
           float(np.float32(voxel_size)),
           float(_inv_trunc(voxel_size, trunc_ratio)))
    tsdf_integrate.launches += 1
    return tsdf, weight, color


tsdf_integrate.launches = 0
