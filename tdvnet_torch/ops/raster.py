"""Mesh to per-view depth maps on the host (port of `tdvnet/ops/raster.py`).

The z-buffer rasterizer is the repo's `native/rasterizer.cpp`, read as it
is and compiled with `g++ -O3 -shared -fPIC` into
`build/tdvnet_torch/<hash of the source>/librasterizer.so` at first use,
then bound through ctypes. A failed build raises: there is no silent
fallback. `rasterize_depth_ref` is a numpy twin of the same arithmetic that
the tests hold the library to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "native", "rasterizer.cpp")
BUILD_ROOT = os.path.join(_ROOT, "build", "tdvnet_torch")
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


class RasterBuildError(RuntimeError):
    pass


@functools.lru_cache(maxsize=None)
def library():
    """The loaded rasterizer (compiled first if its build is missing)."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"raster-{digest}")
    so = os.path.join(out_dir, "librasterizer.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_so = os.path.join(tmp, "librasterizer.so")
            try:
                r = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o",
                                    tmp_so, SRC], capture_output=True,
                                   text=True)
            except FileNotFoundError as e:
                raise RasterBuildError(f"g++ not found: {e}") from e
            if r.returncode != 0:
                raise RasterBuildError(f"g++ failed on {SRC}:\n{r.stderr}")
            os.replace(tmp_so, so)      # atomic: readers see all or none
    lib = ctypes.CDLL(so)
    lib.rasterize_depth.argtypes = [_FP, ctypes.c_int, _IP, ctypes.c_int,
                                    _FP, _FP, ctypes.c_int, ctypes.c_int, _FP]
    lib.rasterize_depth.restype = None
    return lib


def rasterize_depth_ref(verts_cam, faces, K, H, W):
    """numpy twin of the native rasterizer for camera-space vertices (the
    JAX package's fallback; triangles crossing the near plane are dropped
    here, where the library clips them)."""
    depth = np.zeros((H, W), np.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    tris = verts_cam[faces]                       # [T, 3, 3]
    tris = tris[(tris[:, :, 2] > 1e-4).all(axis=1)]
    for tri in tris:
        w = 1.0 / tri[:, 2]
        px = fx * tri[:, 0] * w + cx
        py = fy * tri[:, 1] * w + cy
        x0 = max(0, int(np.floor(px.min())))
        x1 = min(W - 1, int(np.ceil(px.max())))
        y0 = max(0, int(np.floor(py.min())))
        y1 = min(H - 1, int(np.ceil(py.max())))
        if x0 > x1 or y0 > y1:
            continue
        ax, ay = px[1] - px[0], py[1] - py[0]
        bx, by = px[2] - px[0], py[2] - py[0]
        det = ax * by - ay * bx
        if abs(det) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        qx = xs - px[0]
        qy = ys - py[0]
        l1 = (qx * by - qy * bx) / det
        l2 = (ax * qy - ay * qx) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
        wz = l0 * w[0] + l1 * w[1] + l2 * w[2]
        inside &= wz > 0
        z = np.where(inside, 1.0 / np.maximum(wz, 1e-12), np.inf)
        sub = depth[y0:y1 + 1, x0:x1 + 1]
        old = np.where(sub == 0, np.inf, sub)
        depth[y0:y1 + 1, x0:x1 + 1] = np.where(z < old, z, sub)
    return depth


def render_depth(verts: np.ndarray, faces: np.ndarray, K: np.ndarray,
                 pose_w2c: np.ndarray, img_size: Tuple[int, int]
                 ) -> np.ndarray:
    """Render one depth map. pose_w2c: [4, 4] world to camera; K: [3, 3]."""
    H, W = img_size
    lib = library()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    k = np.ascontiguousarray(K, np.float32)
    p = np.ascontiguousarray(pose_w2c, np.float32)
    out = np.zeros((H, W), np.float32)
    lib.rasterize_depth(v.ctypes.data_as(_FP), len(v), f.ctypes.data_as(_IP),
                        len(f), k.ctypes.data_as(_FP), p.ctypes.data_as(_FP),
                        H, W, out.ctypes.data_as(_FP))
    return out


def render_scene_depths(verts: np.ndarray, faces: np.ndarray,
                        poses_w2c: np.ndarray, K: np.ndarray,
                        img_size: Tuple[int, int] = (480, 640)) -> np.ndarray:
    """Render all views. poses_w2c: [N, 4, 4]; K: [N, 3, 3]."""
    out = np.empty((poses_w2c.shape[0], *img_size), np.float32)
    for i in range(poses_w2c.shape[0]):
        out[i] = render_depth(verts, faces, K[i], poses_w2c[i], img_size)
    return out
