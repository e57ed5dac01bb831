"""Masked per-point feature variance over each ref view's sources (K1+K2),
and its gradient with respect to the feature maps.

Kernels: `csrc/source_variance.cu` and `csrc/source_variance_backward.cu`
(see their headers for the TPU op each replaces, its bound and its design).
`source_variance_ref` and `source_variance_backward_ref` are the plain
PyTorch twins; the wrappers run them only for CPU tensors. When autograd
records a call (grad mode on and `feats` requiring grad), `source_variance`
goes through `SourceVarianceFn`, whose backward is
`source_variance_backward`, whose kernel sums in fixed point so that the
gradient is the same bits on every launch (`csrc/fixed_sum.cuh`). Both
kernels take 4 channels a thread; for a channel count that is not a
multiple of 4 the wrappers add zero channels (`_launch.pad_channels`) and
slice the real ones out. That is exact: the variance, its mean and the
gradient are per channel, and the backward's fixed-point scale comes from
the inputs' largest magnitudes and the count of terms, which zeros do not
change. (A form with one channel a thread ran 2.8x slower than padding at
the cost volume with 30 channels: its lanes no longer share a point's
projections; PERF.md, section 6.)

bf16 features: the kernel's bf16 form reads the bf16 taps, interpolates
and sums in fp32, and rounds each source's sample to bf16 once, where the
JAX package stores a bf16 sample (its bilinear interpolation runs in the
table's dtype); the variance is fp32, or rounded once to bf16 as it is
written (`out_dtype`), which is the JAX package's cast of the fp32
variance before CostRegNet, bit for bit. Its launches count in
`source_variance.bf16_launches`, the fp32 form's in `launches`. The
backward's bf16 form (a bf16 model in training) takes the incoming
gradient in bf16 (a bf16 variance) or fp32, the forward's fp32 mean and
the bf16 features, resamples each source as the forward rounded it, sums
its terms in the fp32 form's fixed point and rounds the feature gradient
once to bf16 (`source_variance_backward.bf16_launches`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from tdvnet_torch.kernels._launch import (check, launch, on_cpu,
                                          pad_channels, quad, wants_grad)
from tdvnet_torch.ops import camera
from tdvnet_torch.ops.sampling import _floor_in, bilinear_sample_batched


def _feature_scale(feats: torch.Tensor, img_size: Tuple[int, int]):
    """Pixel -> feature-grid factors (align corners: x_f = x*(Wf-1)/(W-1))."""
    Hf, Wf = feats.shape[1:3]
    H, W = img_size
    return (Wf - 1.0) / (W - 1.0), (Hf - 1.0) / (H - 1.0)


def _source_xy(pts_world, P_all, idx, scale):
    xy, _ = camera.project_points(pts_world, P_all[idx])
    return xy * scale


def source_variance_ref(pts_world: torch.Tensor, feats: torch.Tensor,
                        src_idx: torch.Tensor, src_mask: torch.Tensor,
                        P_all: torch.Tensor, img_size: Tuple[int, int],
                        with_mean: bool = False, out_dtype=None):
    """pts_world [R, P, 3]; feats [N, Hf, Wf, C]; src_idx/src_mask [R, S];
    P_all [N, 3, 4] (full-image pixel units). Returns var [R, P, C] fp32:
    E[f^2] - E[f]^2 over the real sources, with cnt = max(sum(mask), 1);
    with `with_mean`, (var, mean) as the JAX package's `_source_variance`
    returns them. bf16 features are sampled in fp32 and each sample is
    rounded to bf16 once; `out_dtype` (None: the working type, fp32 or
    float64) is the variance's."""
    R, P, _ = pts_world.shape
    S = src_idx.shape[1]
    C = feats.shape[-1]
    sx, sy = _feature_scale(feats, img_size)
    scale = torch.tensor([sx, sy], dtype=torch.float32, device=feats.device)
    mask = src_mask.to(torch.float32)
    cnt = mask.sum(dim=1).clamp(min=1.0)[:, None, None]
    acc = torch.zeros((R, P, C), dtype=torch.float32, device=feats.device)
    acc_sq = torch.zeros_like(acc)
    for s in range(S):
        idx = src_idx[:, s]
        f = bilinear_sample_batched(feats[idx],
                                    _source_xy(pts_world, P_all, idx, scale))
        if feats.dtype == torch.bfloat16:
            f = f.to(torch.bfloat16).float()
        m = mask[:, s, None, None]
        acc = acc + f * m
        acc_sq = acc_sq + f * f * m
    mean = acc / cnt
    var = acc_sq / cnt - mean * mean
    if out_dtype is not None:
        var = var.to(out_dtype)
    return (var, mean) if with_mean else var


def source_variance_backward_ref(grad: torch.Tensor, mean: torch.Tensor,
                                 pts_world: torch.Tensor, feats: torch.Tensor,
                                 src_idx: torch.Tensor, src_mask: torch.Tensor,
                                 P_all: torch.Tensor,
                                 img_size: Tuple[int, int],
                                 sample_dtype=None) -> torch.Tensor:
    """d loss / d feats [N, Hf, Wf, C] from grad = d loss / d var and the
    forward's mean (both [R, P, C]): each source sample f_s takes
    g * 2 m_s (f_s - mean) / cnt, spread over its four bilinear taps with
    the forward's weights (taps off the map take nothing). A point whose
    projection is not finite (NaN variance in the forward) gives nothing.
    bf16 features: each sample rounded to bf16 as the forward's, the sums
    in fp32 (or float64 for a float64 grad), the result rounded once to
    bf16. `sample_dtype` bf16 rounds the samples of wider features so
    (the float64 referee of the bf16 form: bf16 values in float64, the
    result unrounded)."""
    R, P, _ = pts_world.shape
    N, Hf, Wf, C = feats.shape
    S = src_idx.shape[1]
    sx, sy = _feature_scale(feats, img_size)
    scale = torch.tensor([sx, sy], dtype=torch.float32, device=feats.device)
    mask = src_mask.to(torch.float32)
    cnt = mask.sum(dim=1).clamp(min=1.0)
    # fp32, or float64 for a float64 reference run
    dtype = torch.promote_types(torch.promote_types(grad.dtype, feats.dtype),
                                torch.float32)
    half = feats.dtype == torch.bfloat16
    sample_dtype = torch.bfloat16 if half else sample_dtype
    grad = grad.to(dtype)
    out = torch.zeros((N * Hf * Wf, C), dtype=dtype, device=feats.device)
    for s in range(S):
        idx = src_idx[:, s]
        xy = _source_xy(pts_world, P_all, idx, scale)
        f = bilinear_sample_batched(feats[idx], xy)
        if sample_dtype is not None:
            f = f.to(sample_dtype).to(dtype)
        d = grad * (2.0 * mask[:, s] / cnt)[:, None, None] * (f - mean)
        x, y = xy[..., 0], xy[..., 1]
        x0f, okx, x0 = _floor_in(x, Wf - 1)
        y0f, oky, y0 = _floor_in(y, Hf - 1)
        wx, wy = x - x0f, y - y0f
        ok = okx & oky & torch.isfinite(x) & torch.isfinite(y) \
            & (mask[:, s] != 0)[:, None]
        base = idx[:, None] * (Hf * Wf)
        for xi, yi, wgt in ((x0, y0, (1 - wx) * (1 - wy)),
                            (x0 + 1, y0, wx * (1 - wy)),
                            (x0, y0 + 1, (1 - wx) * wy),
                            (x0 + 1, y0 + 1, wx * wy)):
            inb = ok & (xi >= 0) & (xi <= Wf - 1) & (yi >= 0) & (yi <= Hf - 1)
            rows = base + yi.clamp(0, Hf - 1) * Wf + xi.clamp(0, Wf - 1)
            val = torch.where(inb[..., None], d * wgt[..., None],
                              torch.zeros_like(d))
            out.index_add_(0, rows.reshape(-1), val.reshape(-1, C))
    out = out.reshape(N, Hf, Wf, C)
    return out.to(torch.bfloat16) if half else out


def _check_args(pts_world, feats, src_idx, src_mask, P_all, name,
                feats_dtype=torch.float32):
    R, P, _ = pts_world.shape
    N, Hf, Wf, C = feats.shape
    S = src_idx.shape[1]
    check(pts_world, "pts_world", torch.float32, (R, P, 3))
    check(feats, "feats", feats_dtype, (N, Hf, Wf, C))
    check(src_idx, "src_idx", torch.int64, (R, S))
    check(P_all, "P_all", torch.float32, (N, 3, 4))
    check(src_mask, "src_mask", src_mask.dtype, (R, S), contiguous=False)
    return R, P, S, N, Hf, Wf, C


def _source_variance(pts_world, feats, src_idx, src_mask, P_all, img_size,
                     with_mean, out_dtype=None):
    if on_cpu(pts_world, feats, src_idx, src_mask, P_all):
        return source_variance_ref(pts_world, feats, src_idx, src_mask,
                                   P_all, img_size, with_mean, out_dtype)
    C = feats.shape[-1]
    if C % 4:
        got = _source_variance(pts_world, pad_channels(feats, quad(C)),
                               src_idx, src_mask, P_all, img_size, with_mean,
                               out_dtype)
        if with_mean:
            return tuple(x[..., :C].contiguous() for x in got)
        return got[..., :C].contiguous()
    half = feats.dtype == torch.bfloat16
    out_dtype = out_dtype or torch.float32
    if out_dtype not in ((torch.float32, torch.bfloat16) if half
                         else (torch.float32,)):
        raise TypeError(f"source_variance: no {out_dtype} variance from "
                        f"{feats.dtype} features")
    R, P, S, N, Hf, Wf, C = _check_args(
        pts_world, feats, src_idx, src_mask, P_all, "source_variance",
        torch.bfloat16 if half else torch.float32)
    src_w = src_mask.to(torch.float32).contiguous()
    sx, sy = _feature_scale(feats, img_size)
    out = torch.empty((R, P, C), dtype=out_dtype, device=feats.device)
    mean = torch.empty((R, P, C), dtype=torch.float32,
                       device=feats.device) if with_mean else None
    if half:
        launch("tdv_source_variance_bf16", feats.device, feats.data_ptr(),
               pts_world.data_ptr(), src_idx.data_ptr(), src_w.data_ptr(),
               P_all.data_ptr(), out.data_ptr(),
               mean.data_ptr() if with_mean else None,
               int(out_dtype == torch.bfloat16), R, P, S, Hf, Wf, C, sx, sy)
        source_variance.bf16_launches += 1
        return (out, mean) if with_mean else out
    launch("tdv_source_variance", feats.device, feats.data_ptr(),
           pts_world.data_ptr(), src_idx.data_ptr(), src_w.data_ptr(),
           P_all.data_ptr(), out.data_ptr(),
           mean.data_ptr() if with_mean else None, R, P, S, Hf, Wf, C, sx, sy)
    source_variance.launches += 1
    return (out, mean) if with_mean else out


class SourceVarianceFn(torch.autograd.Function):
    """`source_variance` with its hand backward: the forward keeps the
    per-point mean for `source_variance_backward`."""

    @staticmethod
    def forward(ctx, pts_world, feats, src_idx, src_mask, P_all, img_size,
                plane, out_dtype):
        var, mean = _source_variance(pts_world, feats, src_idx, src_mask,
                                     P_all, img_size, True, out_dtype)
        ctx.save_for_backward(pts_world, feats, src_idx, src_mask, P_all,
                              mean)
        ctx.img_size, ctx.plane = img_size, plane
        return var

    @staticmethod
    def backward(ctx, grad):
        pts_world, feats, src_idx, src_mask, P_all, mean = ctx.saved_tensors
        g = source_variance_backward(grad.contiguous(), mean, pts_world,
                                     feats, src_idx, src_mask, P_all,
                                     ctx.img_size, ctx.plane)
        return None, g, None, None, None, None, None, None


def source_variance(pts_world: torch.Tensor, feats: torch.Tensor,
                    src_idx: torch.Tensor, src_mask: torch.Tensor,
                    P_all: torch.Tensor, img_size: Tuple[int, int],
                    plane: Tuple[int, int], out_dtype=None) -> torch.Tensor:
    """Same contract as `source_variance_ref`; launches the CUDA kernel for
    CUDA tensors. Differentiable in `feats` only: the JAX package stops the
    gradient of every point set it samples at, so a call where the points
    or projections require grad raises rather than drop their gradient.
    `plane` (h, w) says that the points are planes of h x w pixels (the
    plane-sweep volume's depths, or the hypotheses over a depth map; (1, P)
    for points in no such order): the backward
    kernel tiles them by pixels and neighbouring planes, whose taps crowd
    together. `out_dtype`: the variance's dtype (None: fp32, or the twin's
    float64; bf16 features may ask for bf16)."""
    if wants_grad(pts_world, P_all):
        raise NotImplementedError(
            "source_variance: no gradient with respect to the points or the "
            "projections (the JAX package stops it); detach them")
    if wants_grad(feats):
        return SourceVarianceFn.apply(pts_world, feats, src_idx, src_mask,
                                      P_all, img_size, plane, out_dtype)
    return _source_variance(pts_world, feats, src_idx, src_mask, P_all,
                            img_size, False, out_dtype)


source_variance.launches = 0
source_variance.bf16_launches = 0


def source_variance_backward(grad: torch.Tensor, mean: torch.Tensor,
                             pts_world: torch.Tensor, feats: torch.Tensor,
                             src_idx: torch.Tensor, src_mask: torch.Tensor,
                             P_all: torch.Tensor, img_size: Tuple[int, int],
                             plane: Tuple[int, int]) -> torch.Tensor:
    """Same contract as `source_variance_backward_ref`; launches the CUDA
    kernel for CUDA tensors (its bf16 form for bf16 features, with an fp32
    or bf16 grad). Its sums are fixed-point integer sums, so the result is
    the same bits on every launch, whatever order the points come in;
    `plane` as for `source_variance` (it changes how the kernel tiles the
    points, not the result)."""
    if on_cpu(grad, mean, pts_world, feats, src_idx, src_mask, P_all):
        return source_variance_backward_ref(grad, mean, pts_world, feats,
                                            src_idx, src_mask, P_all,
                                            img_size)
    C = feats.shape[-1]
    if C % 4:
        c4 = quad(C)
        return source_variance_backward(
            pad_channels(grad, c4), pad_channels(mean, c4), pts_world,
            pad_channels(feats, c4), src_idx, src_mask, P_all, img_size,
            plane)[..., :C].contiguous()
    half = feats.dtype == torch.bfloat16
    R, P, S, N, Hf, Wf, C = _check_args(
        pts_world, feats, src_idx, src_mask, P_all,
        "source_variance_backward", torch.bfloat16 if half else torch.float32)
    check(grad, "grad", grad.dtype if half and grad.dtype == torch.bfloat16
          else torch.float32, (R, P, C))
    check(mean, "mean", torch.float32, (R, P, C))
    h, w = plane
    if h < 1 or w < 1:
        raise ValueError(f"source_variance_backward: plane {plane} is empty")
    src_w = src_mask.to(torch.float32).contiguous()
    sx, sy = _feature_scale(feats, img_size)
    out = torch.empty_like(feats)
    acc = torch.empty(feats.shape, dtype=torch.int64, device=feats.device)
    scratch = torch.empty((4,), dtype=torch.int32, device=feats.device)
    args = (grad.data_ptr(), mean.data_ptr(), feats.data_ptr(),
            pts_world.data_ptr(), src_idx.data_ptr(), src_w.data_ptr(),
            P_all.data_ptr(), out.data_ptr(), acc.data_ptr(),
            scratch.data_ptr(), R, P, S, N, Hf, Wf, C, h * w, w, sx, sy)
    if half:
        launch("tdv_source_variance_backward_bf16", feats.device,
               int(grad.dtype == torch.bfloat16), *args)
        source_variance_backward.bf16_launches += 1
    else:
        launch("tdv_source_variance_backward", feats.device, *args)
        source_variance_backward.launches += 1
    return out


source_variance_backward.launches = 0
source_variance_backward.bf16_launches = 0
