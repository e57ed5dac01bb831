"""Voxelization of a batched point cloud and the scatter of anchor rows into
the dense scene grid (K3).

Kernel: `csrc/voxelize.cu` (see its header for the TPU op it replaces, its
bound and its design). `scene_origins_ref`, `voxelize_ref` and
`scatter_anchors_to_dense_ref` are the plain PyTorch twins; the wrappers run
them only for CPU tensors. When autograd records a scatter (grad mode on
and the anchor features requiring grad), it goes through
`ScatterDenseFn`, whose backward is `scatter_anchors_to_dense_backward`
(`csrc/scatter_dense_backward.cu`, twin
`scatter_anchors_to_dense_backward_ref`).

  1. quantize points into a fixed per-scene grid anchored at the masked
     bbox minimum;
  2. key = scene_id * n_cells + flat cell index;
  3. anchors are the occupied cells, numbered in ascending key order and
     capped at `max_anchors`;
  4. overflow and invalid points land in a dump slot (index `max_anchors`)
     that every consumer masks out.

The twin finds the numbering as the JAX package does, with a stable sort of
the keys, and so also returns the sorted view (`order`, `p2a_sorted`). The
kernel ranks the occupied cells of the grid with a prefix sum and sorts
nothing: on the card those two fields are None and points keep their input
order.

bf16 anchor rows go to the scatter's bf16 form, which writes a bf16 grid
and a bf16 occupancy (the JAX package's `segment_sum` in the features'
dtype): a copy, bit-equal to the JAX package's. Its launches count in
`scatter_anchors_to_dense.bf16_launches`; its backward's bf16 form (a bf16
model in training), a gather of the bf16 grid's gradient, in
`scatter_anchors_to_dense_backward.bf16_launches`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tdvnet_torch.kernels._launch import (check, launch, no_backward,
                                          on_cpu, pad_channels, quad,
                                          wants_grad)

SCAN_TILE = 1024          # cells per block of the kernel's prefix sum


class VoxelGrid(NamedTuple):
    point2anchor: torch.Tensor   # [P] int64 in [0, max_anchors]; max = dump
    anchor_idx3: torch.Tensor    # [A, 3] int64 cell coords (0 where invalid)
    anchor_scene: torch.Tensor   # [A] int64
    anchor_center: torch.Tensor  # [A, 3] world coords of voxel centers
    anchor_valid: torch.Tensor   # [A] bool
    origins: torch.Tensor        # [n_scenes, 3] grid origin per scene
    point_valid: torch.Tensor    # [P] bool: in-grid and input-valid
    order: Optional[torch.Tensor]        # [P] int64 anchor-sorted permutation
    p2a_sorted: Optional[torch.Tensor]   # [P] int64, nondecreasing
    n_out_of_grid: torch.Tensor  # [] int64: input-valid points outside
    n_overflow: torch.Tensor     # [] int64: points dropped by the capacity


# ---------------------------------------------------------------------- twins
def scene_origins_ref(pts: torch.Tensor, pt_scene: torch.Tensor,
                      pt_valid: torch.Tensor, n_scenes: int) -> torch.Tensor:
    """Masked per-scene bbox minimum, [n_scenes, 3] (0 for an empty scene)."""
    big = 1e9
    masked = torch.where(pt_valid[:, None], pts, torch.full_like(pts, big))
    mins = torch.full((n_scenes, 3), big, dtype=pts.dtype, device=pts.device)
    mins = mins.scatter_reduce(0, pt_scene[:, None].expand(-1, 3), masked,
                               "amin", include_self=True)
    return torch.where(torch.isfinite(mins) & (mins < big), mins,
                       torch.zeros_like(mins))


def voxelize_ref(pts: torch.Tensor, pt_scene: torch.Tensor,
                 pt_valid: torch.Tensor, edge_len: float,
                 grid_size: Tuple[int, int, int], max_anchors: int,
                 n_scenes: int,
                 origins: Optional[torch.Tensor] = None) -> VoxelGrid:
    dev = pts.device
    gx, gy, gz = grid_size
    n_cells = gx * gy * gz
    if origins is None:
        origins = scene_origins_ref(pts, pt_scene, pt_valid, n_scenes)

    # true division, as the JAX package does (PyTorch's CUDA division by a
    # Python scalar multiplies by the reciprocal and can move a point
    # across a voxel face)
    rel = (pts - origins[pt_scene]) / torch.tensor(edge_len,
                                                   dtype=torch.float32,
                                                   device=dev)
    fl = torch.floor(rel)
    lim = torch.tensor([gx, gy, gz], dtype=fl.dtype, device=dev)
    # bounds on the float cell index, before any float->int conversion (a
    # NaN coordinate fails them)
    in_grid = ((fl >= 0) & (fl < lim)).all(dim=1)
    valid = in_grid & pt_valid
    idx3 = torch.where(valid[:, None], fl, torch.zeros_like(fl)).long()

    flat = (idx3[:, 0] * gy + idx3[:, 1]) * gz + idx3[:, 2]
    sentinel = n_scenes * n_cells
    key = torch.where(valid, pt_scene * n_cells + flat,
                      torch.full_like(flat, sentinel))

    order = torch.argsort(key, stable=True)
    sk = key[order]
    is_real = sk != sentinel
    first = torch.cat([is_real[:1], (sk[1:] != sk[:-1]) & is_real[1:]])
    aid_sorted = torch.cumsum(first.long(), dim=0) - 1
    keep = is_real & (aid_sorted < max_anchors)
    aid_sorted = torch.where(keep, aid_sorted,
                             torch.full_like(aid_sorted, max_anchors))
    point2anchor = torch.empty_like(aid_sorted)
    point2anchor[order] = aid_sorted

    # each anchor's key is the key of its members (all equal); the dump
    # slot and empty slots keep the identity of min, which is invalid
    big_key = torch.iinfo(torch.int64).max
    anchor_key = torch.full((max_anchors + 1,), big_key, dtype=torch.int64,
                            device=dev)
    anchor_key = anchor_key.scatter_reduce(0, aid_sorted, sk, "amin",
                                           include_self=True)[:max_anchors]
    anchor_valid = (anchor_key < sentinel) & (anchor_key >= 0)
    anchor_key_safe = torch.where(anchor_valid, anchor_key,
                                  torch.zeros_like(anchor_key))
    anchor_scene = anchor_key_safe // n_cells
    aflat = anchor_key_safe % n_cells
    anchor_idx3 = torch.stack([aflat // (gy * gz), (aflat // gz) % gy,
                               aflat % gz], dim=-1)
    anchor_center = (origins[anchor_scene]
                     + (anchor_idx3.to(torch.float32) + 0.5) * edge_len)

    n_out_of_grid = (pt_valid & ~in_grid).sum()
    n_overflow = (is_real & (aid_sorted >= max_anchors)).sum()
    return VoxelGrid(point2anchor=point2anchor, anchor_idx3=anchor_idx3,
                     anchor_scene=anchor_scene, anchor_center=anchor_center,
                     anchor_valid=anchor_valid, origins=origins,
                     point_valid=valid, order=order, p2a_sorted=aid_sorted,
                     n_out_of_grid=n_out_of_grid, n_overflow=n_overflow)


def _anchor_cells(vg: VoxelGrid, grid_size: Tuple[int, int, int]):
    """Each anchor's flat cell index in the [B, gx, gy, gz] key space."""
    gx, gy, gz = grid_size
    flat = ((vg.anchor_idx3[:, 0] * gy + vg.anchor_idx3[:, 1]) * gz
            + vg.anchor_idx3[:, 2])
    return vg.anchor_scene * (gx * gy * gz) + flat


def scatter_anchors_to_dense_ref(anchor_feats: torch.Tensor, vg: VoxelGrid,
                                 grid_size: Tuple[int, int, int],
                                 n_scenes: int):
    """Anchor keys are unique, so each cell is written at most once: an
    index write (deterministic), not a float accumulation. Invalid anchors
    write zeros into a dump row that is sliced off."""
    gx, gy, gz = grid_size
    n_cells = gx * gy * gz
    C = anchor_feats.shape[-1]
    cells = _anchor_cells(vg, grid_size)
    seg = torch.where(vg.anchor_valid, cells,
                      torch.full_like(cells, n_scenes * n_cells))
    feats = torch.where(vg.anchor_valid[:, None], anchor_feats,
                        torch.zeros_like(anchor_feats))
    dense = anchor_feats.new_zeros((n_scenes * n_cells + 1, C))
    dense[seg] = feats
    occ = anchor_feats.new_zeros((n_scenes * n_cells + 1,))
    occ[seg] = vg.anchor_valid.to(anchor_feats.dtype)
    dense = dense[:-1].reshape(n_scenes, gx, gy, gz, C)
    occ = occ[:-1].reshape(n_scenes, gx, gy, gz, 1)
    return dense, occ


def scatter_anchors_to_dense_backward_ref(grad_dense: torch.Tensor,
                                          vg: VoxelGrid,
                                          grid_size: Tuple[int, int, int],
                                          n_scenes: int) -> torch.Tensor:
    """d loss / d anchor_feats [A, C] from grad_dense = d loss / d dense
    [B, gx, gy, gz, C]: each valid anchor's cell row, zeros for an invalid
    anchor (the scatter's dump row is sliced off). Occupancy takes no
    gradient."""
    C = grad_dense.shape[-1]
    rows = grad_dense.reshape(-1, C)[
        torch.where(vg.anchor_valid, _anchor_cells(vg, grid_size), 0)]
    return torch.where(vg.anchor_valid[:, None], rows,
                       torch.zeros_like(rows))


# ------------------------------------------------------------------- wrappers
def voxelize(pts: torch.Tensor, pt_scene: torch.Tensor,
             pt_valid: torch.Tensor, edge_len: float,
             grid_size: Tuple[int, int, int], max_anchors: int,
             n_scenes: int, origins: Optional[torch.Tensor] = None
             ) -> VoxelGrid:
    """pts [P, 3] world points; pt_scene [P] int64 scene ids; pt_valid [P]
    bool. Returns the compact anchor set of capacity `max_anchors`."""
    if on_cpu(pts, pt_scene, pt_valid):
        return voxelize_ref(pts, pt_scene, pt_valid, edge_len, grid_size,
                            max_anchors, n_scenes, origins)
    no_backward("voxelize", pts, origins)
    P = pts.shape[0]
    gx, gy, gz = grid_size
    n_all = n_scenes * gx * gy * gz
    if n_all >= 2 ** 31 or n_all <= 0 or max_anchors <= 0:
        raise ValueError(f"voxelize: {n_scenes} grids of {grid_size} with "
                         f"{max_anchors} anchors is outside the int32 key "
                         f"space")
    check(pts, "pts", torch.float32, (P, 3))
    check(pt_scene, "pt_scene", torch.int64, (P,))
    check(pt_valid, "pt_valid", torch.bool, (P,))
    dev = pts.device
    if origins is None:
        origins = torch.empty((n_scenes, 3), dtype=torch.float32, device=dev)
        keys = torch.empty((n_scenes * 3,), dtype=torch.int32, device=dev)
        launch("tdv_scene_origins", dev, pts.data_ptr(), pt_scene.data_ptr(),
               pt_valid.data_ptr(), keys.data_ptr(), origins.data_ptr(), P,
               n_scenes)
    else:
        check(origins, "origins", torch.float32, (n_scenes, 3))
    A = max_anchors
    cell = torch.zeros((n_all,), dtype=torch.int32, device=dev)
    tile_sums = torch.empty((-(-n_all // SCAN_TILE) + 1,), dtype=torch.int32,
                            device=dev)
    pkey = torch.empty((P,), dtype=torch.int32, device=dev)
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    point2anchor = torch.empty((P,), dtype=torch.int64, device=dev)
    point_valid = torch.empty((P,), dtype=torch.bool, device=dev)
    anchor_idx3 = torch.empty((A, 3), dtype=torch.int64, device=dev)
    anchor_scene = torch.empty((A,), dtype=torch.int64, device=dev)
    anchor_center = torch.empty((A, 3), dtype=torch.float32, device=dev)
    anchor_valid = torch.empty((A,), dtype=torch.bool, device=dev)
    launch("tdv_voxelize", dev, pts.data_ptr(), pt_scene.data_ptr(),
           pt_valid.data_ptr(), origins.data_ptr(), cell.data_ptr(),
           tile_sums.data_ptr(), pkey.data_ptr(), point2anchor.data_ptr(),
           point_valid.data_ptr(), anchor_idx3.data_ptr(),
           anchor_scene.data_ptr(), anchor_center.data_ptr(),
           anchor_valid.data_ptr(), counters.data_ptr(), P, n_scenes, gx, gy,
           gz, float(edge_len), A)
    voxelize.launches += 1
    return VoxelGrid(point2anchor=point2anchor, anchor_idx3=anchor_idx3,
                     anchor_scene=anchor_scene, anchor_center=anchor_center,
                     anchor_valid=anchor_valid, origins=origins,
                     point_valid=point_valid, order=None, p2a_sorted=None,
                     n_out_of_grid=counters[0], n_overflow=counters[1])


voxelize.launches = 0


def _check_anchor_table(vg: VoxelGrid, A: int) -> None:
    check(vg.anchor_idx3, "anchor_idx3", torch.int64, (A, 3))
    check(vg.anchor_scene, "anchor_scene", torch.int64, (A,))
    check(vg.anchor_valid, "anchor_valid", torch.bool, (A,))


def _scatter_dense(anchor_feats, vg, grid_size, n_scenes):
    gx, gy, gz = grid_size
    A, C = anchor_feats.shape
    if C % 4:
        # the kernel moves float4 channel groups: a copy, exact per channel
        dense, occ = _scatter_dense(pad_channels(anchor_feats, quad(C)), vg,
                                    grid_size, n_scenes)
        return dense[..., :C].contiguous(), occ
    half = anchor_feats.dtype == torch.bfloat16
    dtype = torch.bfloat16 if half else torch.float32
    check(anchor_feats, "anchor_feats", dtype, (A, C))
    _check_anchor_table(vg, A)
    dev = anchor_feats.device
    n_all = n_scenes * gx * gy * gz
    if n_all * C // 4 >= 2 ** 31:
        raise ValueError(f"scatter_anchors_to_dense: {n_scenes} grids of "
                         f"{grid_size} x {C} channels are outside the "
                         f"kernel's int32 index space")
    # the kernel writes every element of both outputs once; its cell map is
    # never filled. Three allocations and no views: the host path is most
    # of this call's time at the per-scene shape
    dense = torch.empty((n_scenes, gx, gy, gz, C), dtype=dtype, device=dev)
    occ = torch.empty((n_scenes, gx, gy, gz, 1), dtype=dtype, device=dev)
    cell_anchor = torch.empty((n_all,), dtype=torch.int32, device=dev)
    launch("tdv_scatter_dense_bf16" if half else "tdv_scatter_dense", dev,
           anchor_feats.data_ptr(), vg.anchor_idx3.data_ptr(),
           vg.anchor_scene.data_ptr(), vg.anchor_valid.data_ptr(),
           dense.data_ptr(), occ.data_ptr(), cell_anchor.data_ptr(), A, C,
           n_scenes, gx, gy, gz)
    if half:
        scatter_anchors_to_dense.bf16_launches += 1
    else:
        scatter_anchors_to_dense.launches += 1
    return dense, occ


class ScatterDenseFn(torch.autograd.Function):
    """`scatter_anchors_to_dense` with its hand backward; the occupancy is
    not differentiable."""

    @staticmethod
    def forward(ctx, anchor_feats, anchor_idx3, anchor_scene, anchor_valid,
                grid_size, n_scenes):
        vg = _anchor_table(anchor_idx3, anchor_scene, anchor_valid)
        dense, occ = _scatter_dense(anchor_feats, vg, grid_size, n_scenes)
        ctx.save_for_backward(anchor_idx3, anchor_scene, anchor_valid)
        ctx.grid_size, ctx.n_scenes = grid_size, n_scenes
        ctx.mark_non_differentiable(occ)
        return dense, occ

    @staticmethod
    def backward(ctx, grad_dense, _grad_occ):
        vg = _anchor_table(*ctx.saved_tensors)
        g = scatter_anchors_to_dense_backward(grad_dense.contiguous(), vg,
                                              ctx.grid_size, ctx.n_scenes)
        return g, None, None, None, None, None


def _anchor_table(anchor_idx3, anchor_scene, anchor_valid) -> VoxelGrid:
    """A VoxelGrid holding only the anchor table, all the scatter reads."""
    return VoxelGrid(None, anchor_idx3, anchor_scene, None, anchor_valid,
                     None, None, None, None, None, None)


def scatter_anchors_to_dense(anchor_feats: torch.Tensor, vg: VoxelGrid,
                             grid_size: Tuple[int, int, int], n_scenes: int):
    """Scatter anchor features [A, C] into a dense [B, gx, gy, gz, C] grid.
    Returns (grid, occupancy [B, gx, gy, gz, 1]); differentiable in the
    anchor features."""
    if on_cpu(anchor_feats, vg.anchor_idx3, vg.anchor_scene, vg.anchor_valid):
        return scatter_anchors_to_dense_ref(anchor_feats, vg, grid_size,
                                            n_scenes)
    if wants_grad(anchor_feats):
        return ScatterDenseFn.apply(anchor_feats, vg.anchor_idx3,
                                    vg.anchor_scene, vg.anchor_valid,
                                    grid_size, n_scenes)
    return _scatter_dense(anchor_feats, vg, grid_size, n_scenes)


scatter_anchors_to_dense.launches = 0
scatter_anchors_to_dense.bf16_launches = 0


def scatter_anchors_to_dense_backward(grad_dense: torch.Tensor,
                                      vg: VoxelGrid,
                                      grid_size: Tuple[int, int, int],
                                      n_scenes: int) -> torch.Tensor:
    """Same contract as `scatter_anchors_to_dense_backward_ref`; launches
    the CUDA kernel for CUDA tensors (its bf16 form, a copy too, for a bf16
    grad: a bf16 model's grid)."""
    if on_cpu(grad_dense, vg.anchor_idx3, vg.anchor_scene, vg.anchor_valid):
        return scatter_anchors_to_dense_backward_ref(grad_dense, vg,
                                                     grid_size, n_scenes)
    gx, gy, gz = grid_size
    C = grad_dense.shape[-1]
    A = vg.anchor_idx3.shape[0]
    if C % 4:
        return scatter_anchors_to_dense_backward(
            pad_channels(grad_dense, quad(C)), vg, grid_size,
            n_scenes)[:, :C].contiguous()
    half = grad_dense.dtype == torch.bfloat16
    dtype = torch.bfloat16 if half else torch.float32
    check(grad_dense, "grad_dense", dtype, (n_scenes, gx, gy, gz, C))
    _check_anchor_table(vg, A)
    out = torch.empty((A, C), dtype=dtype, device=grad_dense.device)
    launch("tdv_scatter_dense_backward_bf16" if half
           else "tdv_scatter_dense_backward", grad_dense.device,
           grad_dense.data_ptr(), vg.anchor_idx3.data_ptr(),
           vg.anchor_scene.data_ptr(), vg.anchor_valid.data_ptr(),
           out.data_ptr(), A, C, gx, gy, gz)
    if half:
        scatter_anchors_to_dense_backward.bf16_launches += 1
    else:
        scatter_anchors_to_dense_backward.launches += 1
    return out


scatter_anchors_to_dense_backward.launches = 0
scatter_anchors_to_dense_backward.bf16_launches = 0
