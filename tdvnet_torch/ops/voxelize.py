"""Static-capacity voxelization of a batched point cloud (port of
`tdvnet/ops/voxelize.py`; plain PyTorch).

  1. quantize points into a fixed per-scene grid anchored at the masked
     bbox minimum;
  2. key = scene_id * n_cells + flat cell index; invalid and out-of-grid
     points get a sentinel key that sorts last;
  3. stable argsort of the keys, mark first occurrences, prefix sum ->
     compact anchor ids;
  4. overflow and invalid points land in a dump slot (index `max_anchors`)
     that every consumer masks out.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class VoxelGrid(NamedTuple):
    point2anchor: torch.Tensor   # [P] int64 in [0, max_anchors]; max = dump
    anchor_idx3: torch.Tensor    # [A, 3] int64 cell coords (0 where invalid)
    anchor_scene: torch.Tensor   # [A] int64
    anchor_center: torch.Tensor  # [A, 3] world coords of voxel centers
    anchor_valid: torch.Tensor   # [A] bool
    origins: torch.Tensor        # [n_scenes, 3] grid origin per scene
    point_valid: torch.Tensor    # [P] bool: in-grid and input-valid
    order: torch.Tensor          # [P] int64 permutation (anchor-sorted)
    p2a_sorted: torch.Tensor     # [P] int64, nondecreasing
    n_out_of_grid: torch.Tensor  # [] int64: input-valid points outside
    n_overflow: torch.Tensor     # [] int64: points dropped by the capacity


def scene_origins(pts: torch.Tensor, pt_scene: torch.Tensor,
                  pt_valid: torch.Tensor, n_scenes: int) -> torch.Tensor:
    """Masked per-scene bbox minimum, [n_scenes, 3] (0 for an empty scene)."""
    big = 1e9
    masked = torch.where(pt_valid[:, None], pts, torch.full_like(pts, big))
    mins = torch.full((n_scenes, 3), big, dtype=pts.dtype, device=pts.device)
    mins = mins.scatter_reduce(0, pt_scene[:, None].expand(-1, 3), masked,
                               "amin", include_self=True)
    return torch.where(torch.isfinite(mins) & (mins < big), mins,
                       torch.zeros_like(mins))


def voxelize(pts: torch.Tensor, pt_scene: torch.Tensor,
             pt_valid: torch.Tensor, edge_len: float,
             grid_size: Tuple[int, int, int], max_anchors: int,
             n_scenes: int, origins: torch.Tensor | None = None) -> VoxelGrid:
    """pts [P, 3] world points; pt_scene [P] scene ids; pt_valid [P] bool."""
    P = pts.shape[0]
    dev = pts.device
    gx, gy, gz = grid_size
    n_cells = gx * gy * gz
    if origins is None:
        origins = scene_origins(pts, pt_scene, pt_valid, n_scenes)

    # true division, as the JAX package does (PyTorch's CUDA division by a
    # Python scalar multiplies by the reciprocal and can move a point
    # across a voxel face)
    rel = (pts - origins[pt_scene]) / torch.tensor(edge_len,
                                                   dtype=torch.float32,
                                                   device=dev)
    fl = torch.floor(rel)
    lim = torch.tensor([gx, gy, gz], dtype=fl.dtype, device=dev)
    # bounds on the float cell index, before any float->int conversion
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


def scatter_anchors_to_dense(anchor_feats: torch.Tensor, vg: VoxelGrid,
                             grid_size: Tuple[int, int, int], n_scenes: int):
    """Scatter anchor features [A, C] into a dense [B, gx, gy, gz, C] grid.

    Anchor keys are unique, so each cell is written at most once: an index
    write (deterministic), not a float accumulation. Invalid anchors write
    zeros into a dump row that is sliced off. Returns (grid, occupancy
    [B, gx, gy, gz, 1]).
    """
    gx, gy, gz = grid_size
    n_cells = gx * gy * gz
    C = anchor_feats.shape[-1]
    flat = ((vg.anchor_idx3[:, 0] * gy + vg.anchor_idx3[:, 1]) * gz
            + vg.anchor_idx3[:, 2])
    seg = torch.where(vg.anchor_valid, vg.anchor_scene * n_cells + flat,
                      torch.full_like(flat, n_scenes * n_cells))
    feats = torch.where(vg.anchor_valid[:, None], anchor_feats,
                        torch.zeros_like(anchor_feats))
    dense = anchor_feats.new_zeros((n_scenes * n_cells + 1, C))
    dense[seg] = feats
    occ = anchor_feats.new_zeros((n_scenes * n_cells + 1,))
    occ[seg] = vg.anchor_valid.to(anchor_feats.dtype)
    dense = dense[:-1].reshape(n_scenes, gx, gy, gz, C)
    occ = occ[:-1].reshape(n_scenes, gx, gy, gz, 1)
    return dense, occ
