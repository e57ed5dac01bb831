"""Masked image-feature variance of every depth hypothesis of a pixel, each
sampled from one 4x4 patch per (pixel, source) (K7, the fast path's
PointFlow variance).

Kernel: `csrc/patch_fan_variance.cu` (see its header for the TPU op it
replaces, its bound and its design). `patch_fan_variance_ref` is the plain
PyTorch twin; the wrapper runs it only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tdvnet_torch.kernels._launch import check, launch, on_cpu
from tdvnet_torch.kernels.variance import _feature_scale
from tdvnet_torch.ops.sampling import patch_sample_hypotheses_batched


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to fp32, as a fused multiply-add gives it:
    the product of two fp32 values is exact in fp64, and the fp64 sum then
    rounds to fp32 (a double rounding that can differ from the fused one
    only on a tie, about once in 2^29)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _project(pts: torch.Tensor, M: torch.Tensor, sx: float, sy: float):
    """pts [R, Q, 3] world points, M [R, 3, 4] -> [R, Q, 2] feature-grid
    coords. Each row is fma(m2, z, fma(m1, y, m0 * x)) + m3, the order in
    which XLA's CPU dot and the kernel compute it, so that all three give
    the same coordinates (a floor that differs moves a whole fan)."""
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]

    def row(i):
        m = M[:, i, :, None]
        return _fma(m[:, 2], pz, _fma(m[:, 1], py, m[:, 0] * px)) + m[:, 3]

    X, Y, Z = row(0), row(1), row(2)
    den = Z.abs() + 1e-8
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=pts.device)
    return torch.stack([X / den * f32(sx), Y / den * f32(sy)], dim=-1)


def patch_fan_variance_ref(pts_hyp: torch.Tensor, feats: torch.Tensor,
                           src_idx: torch.Tensor, src_mask: torch.Tensor,
                           P_all: torch.Tensor,
                           img_size: Tuple[int, int]) -> torch.Tensor:
    """pts_hyp [R, Hh, P, 3] the Hh hypotheses of P pixels of ref r (the
    centre one at Hh // 2); feats [N, Hf, Wf, C]; src_idx/src_mask [R, S];
    P_all [N, 3, 4] (full-image pixel units). Returns var [R, Hh, P, C]
    fp32: E[f^2] - E[f]^2 over the real sources (cnt = max(sum(mask), 1)),
    each hypothesis sampled by `patch_sample_hypotheses_batched`."""
    R, Hh, P, _ = pts_hyp.shape
    S = src_idx.shape[1]
    C = feats.shape[-1]
    sx, sy = _feature_scale(feats, img_size)
    mask = src_mask.to(torch.float32)
    cnt = mask.sum(dim=1).clamp(min=1.0)[:, None, None, None]
    flat = pts_hyp.reshape(R, Hh * P, 3)
    acc = torch.zeros((R, Hh, P, C), dtype=torch.float32, device=feats.device)
    acc_sq = torch.zeros_like(acc)
    for s in range(S):
        idx = src_idx[:, s]
        xy = _project(flat, P_all[idx], sx, sy).reshape(R, Hh, P, 2)
        f = patch_sample_hypotheses_batched(feats[idx], xy[:, Hh // 2], xy)
        m = mask[:, s, None, None, None]
        acc = acc + f * m
        acc_sq = acc_sq + f * f * m
    mean = acc / cnt
    return acc_sq / cnt - mean * mean


def patch_fan_variance(pts_hyp: torch.Tensor, feats: torch.Tensor,
                       src_idx: torch.Tensor, src_mask: torch.Tensor,
                       P_all: torch.Tensor,
                       img_size: Tuple[int, int]) -> torch.Tensor:
    """Same contract as `patch_fan_variance_ref`; launches the CUDA kernel
    for CUDA tensors."""
    if on_cpu(pts_hyp, feats, src_idx, src_mask, P_all):
        return patch_fan_variance_ref(pts_hyp, feats, src_idx, src_mask,
                                      P_all, img_size)
    R, Hh, P, _ = pts_hyp.shape
    N, Hf, Wf, C = feats.shape
    S = src_idx.shape[1]
    if not 1 <= Hh <= 8:
        raise ValueError(f"patch_fan_variance: Hh={Hh} hypotheses, the "
                         f"kernel takes 1 to 8")
    check(pts_hyp, "pts_hyp", torch.float32, (R, Hh, P, 3))
    check(feats, "feats", torch.float32, (N, Hf, Wf, C))
    check(src_idx, "src_idx", torch.int64, (R, S))
    check(P_all, "P_all", torch.float32, (N, 3, 4))
    check(src_mask, "src_mask", src_mask.dtype, (R, S), contiguous=False)
    src_w = src_mask.to(torch.float32).contiguous()
    sx, sy = _feature_scale(feats, img_size)
    out = torch.empty((R, Hh, P, C), dtype=torch.float32, device=feats.device)
    launch("tdv_patch_fan_variance", feats.device, feats.data_ptr(),
           pts_hyp.data_ptr(), src_idx.data_ptr(), src_w.data_ptr(),
           P_all.data_ptr(), out.data_ptr(), R, Hh, P, S, Hf, Wf, C, sx, sy)
    patch_fan_variance.launches += 1
    return out


patch_fan_variance.launches = 0
