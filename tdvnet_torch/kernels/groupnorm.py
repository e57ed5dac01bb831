"""Masked GroupNorm with the scene U-Net's ReLU / residual tails (K5), and
its gradient.

Kernels: `csrc/masked_group_norm.cu` and `csrc/masked_group_norm_backward.cu`
(see their headers for the TPU op they replace, their bounds and their
designs). The forward is two launches: a statistics pass whose blocks
(sized by `stats_blocks` from the shape and the SM count, so that every
U-Net level fills the card) sum float64 partials, the last block of each
(batch, group) adding them in a fixed order into the statistics; then the
apply pass with the tail. The backward is one cooperative launch: its
reductions, in a fixed order with a ticket per (batch, group), then the
apply, each work item waiting for its (batch, group)'s coefficients.
`masked_group_norm_ref` and `masked_group_norm_backward_ref` are the plain
PyTorch twins; the wrappers run them only for CPU tensors. When autograd
records a call (grad mode on and an input requiring grad), it goes through
`MaskedGroupNormFn`, which keeps the forward's statistics, bias and output
for `masked_group_norm_backward`.

A bf16 x (with its bf16 mask and skip) goes to the forward's bf16 form:
the same float64 statistics of the bf16 values, then the tail in fp32
arithmetic rounded to bf16 where the JAX package's separate bf16 ops
store: the normalised x, its product with the bf16 weight, the sum with
the bf16 bias, and the residual add (the twin does the same in torch's
bf16 ops, which round each result). Its launches count
in `masked_group_norm.bf16_launches`. The backward's bf16 form (a bf16
model in training) takes the bf16 grad, x, mask and output, the forward's
statistics and the bf16-cast weight, computes in fp32 as the fp32 form
(the ReLU seen in the output) and rounds d x and d skip once to bf16, and
d weight and d bias, the gradients of the bf16-cast affine, once to bf16
values held in fp32 (autograd's cast widens them to the fp32 parameters;
`masked_group_norm_backward.bf16_launches`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import (at_least_fp32, check, launch,
                                          on_cpu, wants_grad)

# the forward's statistics blocks: each sums STATS_VOXELS voxels of a
# (batch, group) slice over a chunk of the group's channels, the chunks cut
# until there are at least STATS_BLOCKS_PER_SM blocks an SM
STATS_VOXELS = 1024
STATS_BLOCKS_PER_SM = 4

_SM_COUNT = {}            # multiprocessors per device index
# (device index, stream): the statistics pass's scratch, float64 partials
# and uint32 tickets, reused by every call on that stream
_SCRATCH = {}
# (device index, stream): the backward's scratch, [float32 partials, sums
# and coefficients; uint32 counters (zero between calls); uint32 ready
# epochs; the last epoch], reused by every call on that stream
_BACKWARD_SCRATCH = {}
# (device index, B, C, G, V, bf16): the backward's block shape (CC, VB,
# n_vb)
_BACKWARD_SHAPE = {}


def _group_stats(x, mask, num_groups):
    """x as [B, G, C/G, V] in its working type (fp32, or float64), and per
    (batch, group) the mean, the variance (before its clamp) and the count
    over the active voxels, all three in float64. The sums run in float64:
    E[x^2] - E[x]^2 in fp32 (the JAX package's form) loses up to ~1e-3 of
    the variance where a group's mean is large against its spread, which
    costs the scene stages' gradients that much; in float64 the formula is
    exact to fp32."""
    B, C = x.shape[:2]
    G = num_groups
    xg = x.reshape(B, G, C // G, -1).to(torch.promote_types(x.dtype,
                                                            torch.float32))
    x64 = xg.to(torch.float64)
    m = mask.reshape(B, 1, 1, -1).to(torch.float64)
    cnt = (m.sum(dim=(2, 3)) * (C // G)).clamp(min=1.0)        # [B, 1]
    s1 = (x64 * m).sum(dim=(2, 3))                             # [B, G]
    s2 = (x64 * x64 * m).sum(dim=(2, 3))
    mean = s1 / cnt
    var = s2 / cnt - mean * mean
    return xg, mean, var, cnt


def masked_group_norm_ref(x: torch.Tensor, mask: torch.Tensor,
                          num_groups: int, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5,
                          relu: bool = False,
                          skip: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """GroupNorm over active voxels only.

    x [B, C, gx, gy, gz]; mask [B, 1, gx, gy, gz] in {0, 1}. Statistics are
    per (batch, group) over the active sites and the group's channels: the
    count is that of the batch element's own mask times C/G. The result is
    y = (normalized * weight + bias) * mask, then `relu(y) * mask` with
    `relu`, or `relu(y + skip) * mask` with a `skip` of x's shape. The
    normalized x, the weight, the bias and the mask take x's dtype, so a
    bf16 x rounds each of those ops to bf16, as the JAX package's do.
    """
    B, C = x.shape[:2]
    xg, mean, var, _ = _group_stats(x, mask, num_groups)
    rstd = torch.rsqrt(var.clamp(min=0.0) + eps)
    xn = (xg - mean.to(xg.dtype)[..., None, None]) \
        * rstd.to(xg.dtype)[..., None, None]
    xn = xn.reshape(x.shape).to(x.dtype)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = (xn * weight.reshape(shape).to(x.dtype)
         + bias.reshape(shape).to(x.dtype)) * mask.to(x.dtype)
    if skip is not None:
        return F.relu(y + skip) * mask
    return F.relu(y) * mask if relu else y


def masked_group_norm_backward_ref(grad: torch.Tensor, x: torch.Tensor,
                                   mask: torch.Tensor, num_groups: int,
                                   weight: torch.Tensor, out: torch.Tensor,
                                   eps: float = 1e-5, relu: bool = False,
                                   skip: bool = False):
    """(d x, d weight, d bias, d skip or None) of `masked_group_norm_ref`
    from grad = d loss / d out and the forward's output `out` (which shows
    where the ReLU passed), the statistics recomputed from x and the mask
    in {0, 1}; `skip` says the call had a skip. With g' = grad * mask (and
    where out > 0 under a ReLU tail), per (batch, group) with xn the
    normalised input and n the count:
    d x = rstd (w g' - m (sum w g' + xn sum w g' xn [var >= 0]) / n),
    d weight = sum g' xn, d bias = sum g', d skip = g'. A bf16 x (the bf16
    form): the same in fp32 on the widened inputs with the bf16-cast
    weight, the ReLU seen in the output, d x and d skip rounded once to
    bf16, d weight and d bias once to bf16 values in the weight's dtype."""
    if x.dtype == torch.bfloat16:
        bf = torch.bfloat16
        dx, dw, db, ds = masked_group_norm_backward_ref(
            at_least_fp32(grad), at_least_fp32(x), at_least_fp32(mask),
            num_groups, weight.to(bf).to(at_least_fp32(weight).dtype),
            at_least_fp32(out), eps, relu or skip, skip)
        return (dx.to(bf), dw.to(bf).to(weight.dtype),
                db.to(bf).to(weight.dtype), None if ds is None else ds.to(bf))
    B, C = x.shape[:2]
    G = num_groups
    xg, mean, var, cnt = _group_stats(x, mask, G)
    wt = xg.dtype
    rstd = torch.rsqrt(var.clamp(min=0.0) + eps).to(wt)[..., None, None]
    xn = (xg - mean.to(wt)[..., None, None]) * rstd            # [B, G, c, V]
    cnt = cnt.to(wt)
    m = mask.reshape(B, 1, 1, -1).to(xg.dtype)
    g = grad.reshape(xg.shape).to(xg.dtype) * m
    if relu or skip:
        g = torch.where(out.reshape(xg.shape) > 0, g, torch.zeros_like(g))
    w = weight.reshape(1, G, C // G, 1).to(xg.dtype)
    d_weight = (g * xn).sum(dim=(0, 3)).reshape(C)
    d_bias = g.sum(dim=(0, 3)).reshape(C)
    a = (w * g).sum(dim=(2, 3)) / cnt                           # [B, G]
    bx = (w * g * xn).sum(dim=(2, 3))
    bx = torch.where(var >= 0, bx, torch.zeros_like(bx)) / cnt
    dx = rstd * (w * g - m * (a[..., None, None] + xn * bx[..., None, None]))
    return (dx.reshape(x.shape), d_weight, d_bias,
            g.reshape(x.shape) if skip else None)


def stats_blocks(B, C, G, V, n_sm):
    """(voxels, channels) that one block of the forward's statistics pass
    sums: STATS_VOXELS voxels of a (batch, group) slice and a chunk of the
    group's C/G channels, halved while the grid has fewer than
    STATS_BLOCKS_PER_SM blocks an SM (so that the U-Net's coarse levels
    fill the card) and the chunk is even."""
    cg = C // G
    n_vb = -(-V // STATS_VOXELS)
    cc = cg
    want = STATS_BLOCKS_PER_SM * n_sm
    while cc % 2 == 0 and B * G * n_vb * (cg // cc) < want:
        cc //= 2
    return STATS_VOXELS, cc


def _scratch(dev, n_partial, n_tickets):
    """Pointers to the statistics pass's float64 partials (n_partial) and
    uint32 tickets (n_tickets) on `dev`'s current stream. The tickets are
    zeroed once, when the scratch is made, and every launch leaves them zero
    (the last block of a slice puts its ticket back), so no call fills them;
    calls on one stream run in order, so they share the scratch."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < n_partial \
            or have[1].numel() < n_tickets:
        n_partial = max(n_partial, 1 << 14)
        n_tickets = max(n_tickets, 256)
        have = _SCRATCH[key] = (
            torch.empty((n_partial,), dtype=torch.float64, device=dev),
            torch.zeros((n_tickets,), dtype=torch.int32, device=dev))
    return have[0].data_ptr(), have[1].data_ptr()


def _sm_count(dev):
    index = torch.cuda.current_device() if dev.index is None else dev.index
    n = _SM_COUNT.get(index)
    if n is None:
        n = _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _masked_group_norm(x, mask, num_groups, weight, bias, eps, relu, skip):
    """The forward launch; returns (out, stats [B*G, 4]: mean, rstd, count,
    var >= 0)."""
    B, C = x.shape[:2]
    G = num_groups
    if C % G:
        raise ValueError(f"masked_group_norm: C={C} not divisible by G={G}")
    dims = tuple(x.shape[2:])
    V = 1
    for d in dims:
        V *= d
    half = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if half else torch.float32
    check(x, "x", dtype)
    check(mask, "mask", dtype, (B, 1, *dims))
    check(weight, "weight", torch.float32, (C,))
    check(bias, "bias", torch.float32, (C,))
    if skip is not None:
        check(skip, "skip", dtype, tuple(x.shape))
    dev = x.device
    out = torch.empty_like(x)
    vb, cc = stats_blocks(B, C, G, V, _sm_count(dev))
    n_blk = -(-V // vb) * (C // G // cc)
    partial, tickets = _scratch(dev, B * G * n_blk * 3, B * G)
    stats = torch.empty((B * G, 4), dtype=torch.float32, device=dev)
    mode = 2 if skip is not None else int(relu)
    launch("tdv_masked_group_norm_bf16" if half else "tdv_masked_group_norm",
           dev, x.data_ptr(), mask.data_ptr(), weight.data_ptr(),
           bias.data_ptr(), skip.data_ptr() if skip is not None else None,
           out.data_ptr(), partial, tickets, stats.data_ptr(), B, C, G, V,
           float(eps), mode, vb, cc)
    if half:
        masked_group_norm.bf16_launches += 1
    else:
        masked_group_norm.launches += 1
    return out, stats


class MaskedGroupNormFn(torch.autograd.Function):
    """`masked_group_norm` with its hand backward; the forward's statistics,
    bias and output are kept for it (the backward recomputes the ReLU's
    input from x and the bias, or after a skip reads the output)."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, skip, num_groups, eps, relu):
        out, stats = _masked_group_norm(x, mask, num_groups, weight, bias,
                                        eps, relu, skip)
        ctx.save_for_backward(x, mask, weight, bias, out, stats)
        ctx.num_groups, ctx.eps, ctx.relu = num_groups, eps, relu
        ctx.has_skip = skip is not None
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mask, weight, bias, out, stats = ctx.saved_tensors
        dx, dw, db, ds = masked_group_norm_backward(
            grad.contiguous(), x, mask, ctx.num_groups, weight, out, stats,
            ctx.eps, ctx.relu, ctx.has_skip, bias=bias)
        return dx, None, dw, db, ds, None, None, None


def masked_group_norm(x: torch.Tensor, mask: torch.Tensor, num_groups: int,
                      weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5, relu: bool = False,
                      skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    tensors = (x, mask, weight, bias) + (() if skip is None else (skip,))
    if on_cpu(*tensors):
        return masked_group_norm_ref(x, mask, num_groups, weight, bias, eps,
                                     relu, skip)
    if wants_grad(mask):
        raise NotImplementedError(
            "masked_group_norm: no gradient with respect to the mask (the "
            "occupancy takes none); detach it")
    if wants_grad(*tensors):
        return MaskedGroupNormFn.apply(x, mask, weight, bias, skip,
                                       num_groups, eps, relu)
    return _masked_group_norm(x, mask, num_groups, weight, bias, eps, relu,
                              skip)[0]


masked_group_norm.launches = 0
masked_group_norm.bf16_launches = 0


def masked_group_norm_backward(grad: torch.Tensor, x: torch.Tensor,
                               mask: torch.Tensor, num_groups: int,
                               weight: torch.Tensor, out: torch.Tensor,
                               stats: Optional[torch.Tensor],
                               eps: float = 1e-5, relu: bool = False,
                               skip: bool = False, *, bias: torch.Tensor):
    """Same contract as `masked_group_norm_backward_ref`, with the forward's
    `bias` besides; launches the CUDA kernel for CUDA tensors (its bf16
    form for a bf16 x), which reads the forward kernel's `stats` [B*G, 4]
    (the twin recomputes them and ignores the argument). In fp32 a ReLU
    tail without skip is seen by recomputing the forward's output from x
    and the bias (the same bits); one after a skip, and every bf16 tail, by
    reading `out`."""
    if on_cpu(grad, x, mask, weight, out):
        return masked_group_norm_backward_ref(grad, x, mask, num_groups,
                                              weight, out, eps, relu, skip)
    B, C = x.shape[:2]
    G = num_groups
    shp = x.shape
    V = x.numel() // (B * C) if B * C else 0
    half = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if half else torch.float32
    for name, tsr in (("grad", grad), ("x", x), ("out", out)):
        check(tsr, name, dtype, shp)
    check(mask, "mask", dtype, (B, 1, *shp[2:]))
    check(weight, "weight", torch.float32, (C,))
    check(stats, "stats", torch.float32, (B * G, 4))
    check(bias, "bias", torch.float32, (C,))
    dev = x.device
    dx = torch.empty_like(x)
    ds = torch.empty_like(x) if skip else None
    dw = torch.empty((C,), dtype=torch.float32, device=dev)
    db = torch.empty_like(dw)
    mode = 2 if skip else int(relu)
    cc, vb, n_vb = _backward_shape(dev, B, C, G, V, half)
    part, sync, ready, epoch = _backward_scratch(
        dev, B * G * n_vb * (C // G) * 2 + B * C * 2 + B * G * 2,
        B * G + G, B * G)
    n_part = B * G * n_vb * (C // G) * 2
    launch("tdv_masked_group_norm_backward_bf16" if half
           else "tdv_masked_group_norm_backward", dev, grad.data_ptr(),
           x.data_ptr(), mask.data_ptr(), out.data_ptr(), weight.data_ptr(),
           bias.data_ptr(),
           stats.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
           ds.data_ptr() if skip else None, part,
           part + 4 * n_part, part + 4 * (n_part + B * C * 2), sync, ready,
           B, C, G, V, mode, cc, vb, epoch)
    if half:
        masked_group_norm_backward.bf16_launches += 1
    else:
        masked_group_norm_backward.launches += 1
    return dx, dw, db, ds


def _backward_shape(dev, B, C, G, V, half=False):
    """(CC, VB, n_vb) of the backward kernel (its bf16 form with `half`)
    for this shape on this card (`tdv_masked_group_norm_backward_shape`),
    cached."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, B, C, G, V, half)
    have = _BACKWARD_SHAPE.get(key)
    if have is None:
        if C % G or C // G > 32 and (C // G) % 2:
            raise ValueError(f"masked_group_norm_backward: C={C}, G={G} "
                             f"not supported")
        import ctypes

        from tdvnet_torch.kernels.build import library

        out = (ctypes.c_longlong * 3)()
        fn = (library().tdv_masked_group_norm_backward_shape_bf16 if half
              else library().tdv_masked_group_norm_backward_shape)
        with torch.cuda.device(index):
            err = fn(B, C, G, V, out)
        if err:
            raise RuntimeError(f"masked_group_norm_backward: no block shape "
                               f"for {(B, C, G, V)} (CUDA error {err})")
        have = _BACKWARD_SHAPE[key] = (int(out[0]), int(out[1]), int(out[2]))
    return have


def _backward_scratch(dev, n_float, n_sync, n_ready):
    """Pointers to the backward's scratch on `dev`'s current stream (float
    partials, zeroed counters, ready epochs) and this call's epoch. The
    counters are zeroed once, when made, and every launch leaves them zero;
    the ready epochs keep the last call's, which the next epoch never
    equals."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    have = _BACKWARD_SCRATCH.get(key)
    if have is None or have[0].numel() < n_float \
            or have[1].numel() < n_sync or have[2].numel() < n_ready:
        epoch = have[3] if have is not None else 0
        have = _BACKWARD_SCRATCH[key] = [
            torch.empty((max(n_float, 1 << 14),), dtype=torch.float32,
                        device=dev),
            torch.zeros((max(n_sync, 256),), dtype=torch.int32, device=dev),
            torch.zeros((max(n_ready, 256),), dtype=torch.int32, device=dev),
            epoch]
    have[3] = have[3] % 0x7fffffff + 1
    return (have[0].data_ptr(), have[1].data_ptr(), have[2].data_ptr(),
            have[3])


masked_group_norm_backward.launches = 0
masked_group_norm_backward.bf16_launches = 0
