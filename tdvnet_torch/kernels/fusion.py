"""Multi-view consistency fusion of a chunk of ref depth maps (K9b).

Kernel: `csrc/consistency_fuse.cu` (see its header for the TPU op it
replaces, its bound and its design). `consistency_fuse_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors. Both take the
per-view camera table of `camera_table`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tdvnet_torch.kernels._launch import check, launch, on_cpu
from tdvnet_torch.kernels.patchfan import _fma
from tdvnet_torch.ops.camera import linspace_f32

CAM = 33   # P [3, 4], K^-1 [3, 3], R [3, 3], t [3] per view


def _row3(m0, m1, m2, a, b, c):
    """fma(m2, c, fma(m1, b, m0 * a)): a 3-term row in the order of XLA's
    CPU dot (and of the kernel)."""
    return _fma(m2, c, _fma(m1, b, m0 * a))


def camera_table(K: torch.Tensor, R: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """[N, 33] fp32 rows (P = K[R|t], K^-1, R, t) of N world-to-camera
    views, K/R [N, 3, 3], t [N, 3]. P's entries are 3-term rows in XLA's
    CPU order, as JAX's `projection_matrix` gives them; K^-1 is inverted in
    fp64 and rounded once (JAX inverts in fp32)."""
    Rt = torch.cat([R, t[..., None]], dim=-1)                  # [N, 3, 4]
    P = _row3(K[:, :, 0, None], K[:, :, 1, None], K[:, :, 2, None],
              Rt[:, None, 0, :], Rt[:, None, 1, :], Rt[:, None, 2, :])
    K_inv = torch.linalg.inv(K.double()).to(torch.float32)
    n = K.shape[0]
    return torch.cat([P.reshape(n, 12), K_inv.reshape(n, 9),
                      R.reshape(n, 9), t.reshape(n, 3)],
                     dim=1).to(torch.float32).contiguous()


def pixel_grid(H: int, W: int, device=None):
    """The pixel x of each column and y of each row, as the JAX package's
    `build_img_grid` at full resolution gives them under jit."""
    return (linspace_f32(0.0, W - 1.0, W, device),
            linspace_f32(0.0, H - 1.0, H, device))


def _backproject(cam: torch.Tensor, x, y, d):
    """World points of pixels (x, y) at depth d seen by the views of `cam`
    rows [..., 33] (broadcast against x): R^T (K^-1 [x, y, 1] d - t)."""
    Ki = [cam[..., 12 + i] for i in range(9)]
    Rm = [cam[..., 21 + i] for i in range(9)]
    q = [_row3(Ki[3 * i], Ki[3 * i + 1], Ki[3 * i + 2], x, y,
               torch.ones_like(x)) * d - cam[..., 30 + i] for i in range(3)]
    return [_row3(Rm[i], Rm[3 + i], Rm[6 + i], q[0], q[1], q[2])
            for i in range(3)]


def consistency_fuse_ref(ref_depth: torch.Tensor, all_depth: torch.Tensor,
                         cams: torch.Tensor, self_idx: torch.Tensor,
                         z_thresh: float, n_consistent: int,
                         return_counts: bool = False):
    """ref_depth [C, H, W] (refs self_idx [C] of the N views), all_depth
    [N, H, W], cams [N, 33] from `camera_table`. Every ref pixel is
    back-projected at its depth and reprojected into every view in order;
    a view counts where the nearest tap (half to even, zero outside) of its
    depth d_s is positive, |z - d_s| < z_thresh, the pixel lies in [0, W-1]
    x [0, H-1], z > 1e-4, and the view is not the ref itself; its
    back-projected tap is then added to the point sum. Returns (pts [C,
    H*W, 3] = (point + sum) / (n + 1), keep [C, H*W] = n >= n_consistent
    and ref depth > 0), and with `return_counts` also n [C, H*W]."""
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    dev = ref_depth.device
    gx, gy = pixel_grid(H, W, dev)
    P = H * W
    px = gx.repeat(H)
    py = gy.repeat_interleave(W)
    d_ref = ref_depth.reshape(C, P)
    pw = _backproject(cams[self_idx][:, None, :], px[None], py[None], d_ref)
    n = torch.zeros((C, P), dtype=torch.int32, device=dev)
    sums = [torch.zeros((C, P), dtype=torch.float32, device=dev)
            for _ in range(3)]
    zt = torch.tensor(z_thresh, dtype=torch.float32, device=dev)
    for s in range(N):
        cs = cams[s]
        X, Y, z = (_row3(cs[4 * i], cs[4 * i + 1], cs[4 * i + 2], *pw)
                   + cs[4 * i + 3] for i in range(3))
        x, y = X / z, Y / z
        xi, yi = torch.round(x), torch.round(y)
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        tap = torch.where(inb, yi * W + xi, torch.zeros_like(xi)).long()
        zs = torch.where(inb, all_depth[s].reshape(-1)[tap],
                         torch.zeros_like(z))
        valid = (((z - zs).abs() < zt) & (x >= 0) & (x <= W - 1) & (y >= 0)
                 & (y <= H - 1) & (z > 1e-4) & (zs > 0)
                 & (self_idx != s)[:, None])
        o = _backproject(cs, x, y, zs)
        sums = [torch.where(valid, a + b, a) for a, b in zip(sums, o)]
        n = n + valid.to(torch.int32)
    den = (n + 1).to(torch.float32)
    pts = torch.stack([(a + b) / den for a, b in zip(pw, sums)], dim=-1)
    keep = (n >= n_consistent) & (d_ref > 0)
    return (pts, keep, n) if return_counts else (pts, keep)


def consistency_fuse(ref_depth: torch.Tensor, all_depth: torch.Tensor,
                     cams: torch.Tensor, self_idx: torch.Tensor,
                     z_thresh: float, n_consistent: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as `consistency_fuse_ref`; launches the CUDA kernel
    for CUDA tensors."""
    if on_cpu(ref_depth, all_depth, cams, self_idx):
        return consistency_fuse_ref(ref_depth, all_depth, cams, self_idx,
                                    z_thresh, n_consistent)
    C, H, W = ref_depth.shape
    N = all_depth.shape[0]
    check(ref_depth, "ref_depth", torch.float32, (C, H, W))
    check(all_depth, "all_depth", torch.float32, (N, H, W))
    check(cams, "cams", torch.float32, (N, CAM))
    check(self_idx, "self_idx", torch.int64, (C,))
    dev = ref_depth.device
    gx, gy = pixel_grid(H, W, dev)
    pts = torch.empty((C, H * W, 3), dtype=torch.float32, device=dev)
    keep = torch.empty((C, H * W), dtype=torch.bool, device=dev)
    launch("tdv_consistency_fuse", dev, ref_depth.data_ptr(),
           all_depth.data_ptr(), cams.data_ptr(), self_idx.data_ptr(),
           gx.data_ptr(), gy.data_ptr(), pts.data_ptr(), keep.data_ptr(),
           C, N, H, W, float(z_thresh), int(n_consistent))
    consistency_fuse.launches += 1
    return pts, keep


consistency_fuse.launches = 0
