"""Iso-surface extraction from a TSDF volume: vectorized marching
tetrahedra on the host (numpy copy of `tdvnet/ops/marching.py`).

Replaces skimage `marching_cubes` (used by the reference at
`mv3d/eval/tsdf_atlas.py:263` and the Atlas/NeuralRecon adapters; skimage is
not in this image).  Each cube splits into 6 tetrahedra sharing the 0-6
diagonal; each tet contributes 0-2 triangles with vertices linearly
interpolated along sign-crossing edges.  Produces a denser triangulation
than marching cubes but the identical zero-level surface — downstream
metrics voxel-downsample vertices anyway (`processresults.py:284`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# cube corner offsets (x, y, z)
_CUBE = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                  (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32)
# 6-tetrahedra decomposition sharing the 0-6 diagonal
_TETS = np.array([(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
                  (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int32)


def _interp(p0, p1, v0, v1, level):
    t = (level - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p0 + t * (p1 - p0)


def marching_tetrahedra(vol: np.ndarray, level: float = 0.0,
                        mask: np.ndarray | None = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` iso-surface of a [X, Y, Z] scalar field.

    mask (optional): [X, Y, Z] bool of valid samples; cubes touching invalid
    samples are skipped (the reference skips unobserved voxels implicitly
    because they hold tsdf=1).
    Returns (verts [M, 3] in voxel coordinates, faces [T, 3]).
    """
    X, Y, Z = vol.shape
    # gather the 8 corner values of every cube: [8, X-1, Y-1, Z-1]
    corners = np.stack([
        vol[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        for dx, dy, dz in _CUBE], axis=0)
    if mask is not None:
        ok = np.stack([
            mask[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
            for dx, dy, dz in _CUBE], axis=0).all(axis=0)
    else:
        ok = np.ones(corners.shape[1:], bool)

    base = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                np.arange(Z - 1), indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float32)
    vals = corners.reshape(8, -1).T                     # [n_cubes, 8]
    okf = ok.reshape(-1)
    # only keep cubes whose value range crosses the level
    cross = okf & (vals.min(1) < level) & (vals.max(1) >= level)
    vals = vals[cross]
    base = base[cross]

    tris = []
    corner_pos = _CUBE.astype(np.float32)
    for tet in _TETS:
        tv = vals[:, tet]                               # [n, 4]
        tp = base[:, None, :] + corner_pos[tet][None]   # [n, 4, 3]
        inside = tv < level
        code = (inside[:, 0].astype(np.int32)
                + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3])

        def emit(sel, edges):
            # edges: list of 3 (a, b) pairs → one triangle per selected tet
            if not sel.any():
                return
            v = tv[sel]
            p = tp[sel]
            pts = [_interp(p[:, a], p[:, b], v[:, a], v[:, b], level)
                   for a, b in edges]
            tris.append(np.stack(pts, axis=1))

        # single-vertex-inside cases (and complements) → 1 triangle
        for vi, c_in, c_out in [(0, 1, 14), (1, 2, 13), (2, 4, 11),
                                (3, 8, 7)]:
            others = [o for o in range(4) if o != vi]
            e = [(vi, others[0]), (vi, others[1]), (vi, others[2])]
            emit(code == c_in, e)
            emit(code == c_out, e)
        # two-inside cases → 2 triangles (quad split)
        for (a, b), c_code in [((0, 1), 3), ((0, 2), 5), ((0, 3), 9),
                               ((1, 2), 6), ((1, 3), 10), ((2, 3), 12)]:
            others = [o for o in range(4) if o not in (a, b)]
            c, d2 = others
            emit(code == c_code, [(a, c), (a, d2), (b, c)])
            emit(code == c_code, [(b, c), (a, d2), (b, d2)])

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    soup = np.concatenate(tris, axis=0)                 # [T, 3, 3]
    verts = soup.reshape(-1, 3)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    return dedup_vertices(verts, faces)


def dedup_vertices(verts: np.ndarray, faces: np.ndarray,
                   decimals: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicate vertices (rounded) and reindex faces."""
    key = np.round(verts * 10 ** decimals).astype(np.int64)
    _, idx, inv = np.unique(key, axis=0, return_index=True,
                            return_inverse=True)
    return verts[idx], inv[faces].astype(np.int32)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def tsdf_to_mesh(tsdf_vol, level: float = 0.0):
    """Mesh a finalized TSDFVolume (world coordinates); its tensors may lie
    on any device."""
    dims = tsdf_vol.dims
    vol = _host(tsdf_vol.tsdf).reshape(dims)
    w = _host(tsdf_vol.weight).reshape(dims)
    verts, faces = marching_tetrahedra(vol, level, mask=w > 0)
    verts = verts * tsdf_vol.voxel_size + _host(tsdf_vol.origin)[None]
    return verts.astype(np.float32), faces
