"""Minimal PLY mesh / point-cloud I/O on the host (numpy copy of
`tdvnet/ops/ply.py`).

The reference round-trips every reconstruction artifact through Open3D
(`o3d.io.write_triangle_mesh` / `read_point_cloud`, e.g.
`mv3d/eval/processresults.py:184-194`); this module covers that contract
with binary-little-endian PLY (and ASCII read for foreign files).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    verts = np.asarray(verts, np.float32)
    n = verts.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors if colors.max() > 1.001 else colors * 255,
                             0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = verts
            rec["rgb"] = colors
            rec.tofile(f)
        else:
            verts.astype("<f4").tofile(f)
        if faces is not None:
            faces = np.asarray(faces, np.int32)
            rec = np.zeros(len(faces), dtype=[("k", np.uint8),
                                              ("idx", np.int32, 3)])
            rec["k"] = 3
            rec["idx"] = faces
            rec.tofile(f)


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray],
                                 Optional[np.ndarray]]:
    """Returns (verts [N,3], faces [T,3] or None, colors [N,3] uint8 or None).

    Supports binary_little_endian and ascii, float/double xyz, uchar rgb.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or ('list',...)])
        cur = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[1], parts[2]))
        data = f.read()

    tmap = {"float": ("<f4", 4), "float32": ("<f4", 4),
            "double": ("<f8", 8), "float64": ("<f8", 8),
            "uchar": ("u1", 1), "uint8": ("u1", 1),
            "char": ("i1", 1), "int8": ("i1", 1),
            "short": ("<i2", 2), "ushort": ("<u2", 2),
            "int": ("<i4", 4), "int32": ("<i4", 4),
            "uint": ("<u4", 4), "uint32": ("<u4", 4)}

    verts = faces = colors = None
    if fmt == "ascii":
        text = data.decode().split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(text[pos:pos + count * width],
                               np.float64).reshape(count, width)
                pos += count * width
                names = [p[1] for p in props]
                verts = arr[:, [names.index(c) for c in "xyz"]].astype(np.float32)
                if "red" in names:
                    colors = arr[:, [names.index(c) for c in
                                     ("red", "green", "blue")]].astype(np.uint8)
            elif name == "face":
                fl = []
                for _ in range(count):
                    k = int(text[pos]); pos += 1
                    fl.append([int(x) for x in text[pos:pos + k]][:3])
                    pos += k
                faces = np.asarray(fl, np.int32)
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[1], tmap[p[0]][0]) for p in props])
                arr = np.frombuffer(data, dt, count, off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                 axis=1).astype(np.float32)
                if "red" in arr.dtype.names:
                    colors = np.stack([arr["red"], arr["green"], arr["blue"]],
                                      axis=1).astype(np.uint8)
            elif name == "face" and props and props[0][0] == "list":
                cnt_t, cnt_sz = tmap[props[0][1]]
                idx_t, idx_sz = tmap[props[0][2]]
                fl = np.empty((count, 3), np.int32)
                for i in range(count):
                    k = int(np.frombuffer(data, cnt_t, 1, off)[0])
                    off += cnt_sz
                    fl[i] = np.frombuffer(data, idx_t, k, off)[:3]
                    off += idx_sz * k
                faces = fl
    return verts, faces, colors
