"""Bilinear / trilinear sampling with zero padding, the fast path's
patch-fan sampling, int8 quantization and exact lattice upsampling, and
nearest resize (plain PyTorch; port of `tdvnet/ops/sampling.py`).

Semantics are `grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True)` with queries in pixel/cell coordinates: taps outside
the map contribute zero. Bounds are tested on the float coordinates before
any float-to-int conversion, so far-off or non-finite queries give zero
instead of an undefined index. The batched forms gather from one flattened
table, so a batch is one set of indexing ops.

The JAX package packs 2x2, 4x4 and 2x2x2 tap neighbourhoods into wide
gather rows (`pack_bilinear_quads`, `pack_bilinear_patches`,
`pack_trilinear_octs`) because the TPU's gather costs per row; the port
reads the unpacked maps, which gives the same taps.
"""
from __future__ import annotations

import torch


def _floor_in(c: torch.Tensor, hi: int):
    """floor(c); whether -1 <= floor(c) <= hi (the 2-tap footprint touches
    [0, hi]); and floor(c) as int64, set to -1 where it is out of range so
    the conversion is always defined."""
    f = torch.floor(c)
    ok = (f >= -1) & (f <= hi)
    return f, ok, torch.where(ok, f, torch.full_like(f, -1.0)).long()


def bilinear_sample_batched(feat: torch.Tensor, xy: torch.Tensor):
    """feat [B, H, W, C]; xy [B, P, 2] (x, y) pixel coords -> [B, P, C]."""
    B, H, W, C = feat.shape
    table = feat.reshape(B * H * W, C)
    x, y = xy[..., 0], xy[..., 1]
    x0f, okx, x0 = _floor_in(x, W - 1)
    y0f, oky, y0 = _floor_in(y, H - 1)
    wx = x - x0f
    wy = y - y0f
    ok = okx & oky
    base = torch.arange(B, device=feat.device)[:, None] * (H * W)

    def tap(xi, yi, wgt):
        inb = ok & (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        rows = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return table[rows] * (wgt * inb.to(feat.dtype))[..., None]

    return (tap(x0, y0, (1 - wx) * (1 - wy))
            + tap(x0 + 1, y0, wx * (1 - wy))
            + tap(x0, y0 + 1, (1 - wx) * wy)
            + tap(x0 + 1, y0 + 1, wx * wy))


def bilinear_sample(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """feat [H, W, C]; xy [P, 2] -> [P, C]."""
    return bilinear_sample_batched(feat[None], xy[None])[0]


def trilinear_sample_batched(vol: torch.Tensor, q: torch.Tensor):
    """vol [B, X, Y, Z, C]; q [B, P, 3] (x, y, z) in cell units -> [B, P, C].

    Taps outside the volume contribute zero (inactive cells of a masked
    dense grid hold zero too).
    """
    B, X, Y, Z, C = vol.shape
    dims = (X, Y, Z)
    table = vol.reshape(B * X * Y * Z, C)
    f, ok, i0 = zip(*[_floor_in(q[..., a], dims[a] - 1) for a in range(3)])
    w = [q[..., a] - f[a] for a in range(3)]
    anchor_ok = ok[0] & ok[1] & ok[2]
    base = torch.arange(B, device=vol.device)[:, None]
    out = torch.zeros((*q.shape[:-1], C), dtype=vol.dtype, device=vol.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = [i0[0] + dx, i0[1] + dy, i0[2] + dz]
                wgt = ((w[0] if dx else 1 - w[0])
                       * (w[1] if dy else 1 - w[1])
                       * (w[2] if dz else 1 - w[2]))
                inb = anchor_ok
                for a in range(3):
                    inb = inb & (idx[a] >= 0) & (idx[a] <= dims[a] - 1)
                xi, yi, zi = [idx[a].clamp(0, dims[a] - 1) for a in range(3)]
                rows = ((base * X + xi) * Y + yi) * Z + zi
                out = out + table[rows] * (wgt * inb.to(vol.dtype))[..., None]
    return out


def trilinear_sample(vol: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """vol [X, Y, Z, C]; q [P, 3] -> [P, C]."""
    return trilinear_sample_batched(vol[None], q[None])[0]


PATCH_K = 4  # 4x4 tap patch: covers hypothesis anchors within +-1 texel
             # of the centre hypothesis's anchor


def patch_sample_hypotheses_batched(feat: torch.Tensor, xy_c: torch.Tensor,
                                    xy_h: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample every hypothesis of a pixel from one 4x4 patch.

    feat [B, H, W, C]; xy_c [B, P, 2] the centre hypothesis's coords
    (feature-grid pixels); xy_h [B, Hh, P, 2] every hypothesis's coords.
    Returns [B, Hh, P, C].

    The patch holds rows yc0-1 .. yc0+2 and columns xc0-1 .. xc0+2 of the
    map (zero outside it), where (xc0, yc0) is the floor of the centre. As
    in the JAX package: each hypothesis's local coordinates clamp to
    [0, PATCH_K - 1 - 1e-4] and its cell to [0, PATCH_K - 2], so one beyond
    +-1 texel of the centre reads the patch's edge; a hypothesis whose own
    2x2 footprint misses the map gives 0, and the whole fan gives 0 when
    the centre's does. A non-finite coordinate gives NaN (the port's rule,
    as in `source_variance`).
    """
    B, H, W, C = feat.shape
    Hh, P = xy_h.shape[1:3]
    K = PATCH_K
    xc0f, yc0f = torch.floor(xy_c[..., 0]), torch.floor(xy_c[..., 1])
    inb_c = (xc0f >= -1) & (xc0f <= W - 1) & (yc0f >= -1) & (yc0f <= H - 1)
    zero = torch.zeros_like(xc0f)
    taps = torch.arange(K, device=feat.device) - 1
    xs = torch.where(inb_c, xc0f, zero).long()[..., None] + taps  # [B, P, K]
    ys = torch.where(inb_c, yc0f, zero).long()[..., None] + taps
    okx = (xs >= 0) & (xs <= W - 1)
    oky = (ys >= 0) & (ys <= H - 1)
    base = torch.arange(B, device=feat.device)[:, None, None, None] * (H * W)
    rows = base + ys.clamp(0, H - 1)[..., :, None] * W \
        + xs.clamp(0, W - 1)[..., None, :]                      # [B, P, K, K]
    ok = (oky[..., :, None] & okx[..., None, :])[..., None]
    patch = torch.where(ok, feat.reshape(B * H * W, C)[rows],
                        torch.zeros((), dtype=feat.dtype, device=feat.device))
    patch = patch.reshape(B, P, K * K, C)

    def local(c, c0f):
        # patch origin = anchor - 1; a non-finite coordinate makes it NaN
        lc = (c - (c0f[:, None] - 1.0)).clamp(0.0, K - 1 - 1e-4)
        i = torch.floor(lc).clamp(0, K - 2)
        return torch.nan_to_num(i).long(), lc - i                # [B, Hh, P]

    ix, fx = local(xy_h[..., 0], xc0f)
    iy, fy = local(xy_h[..., 1], yc0f)
    bi = torch.arange(B, device=feat.device)[:, None, None]
    pi = torch.arange(P, device=feat.device)[None, None, :]
    tap = lambda i, j: patch[bi, pi, i * K + j]                # [B, Hh, P, C]
    fx, fy = fx[..., None], fy[..., None]
    top = (1 - fx) * tap(iy, ix) + fx * tap(iy, ix + 1)
    bot = (1 - fx) * tap(iy + 1, ix) + fx * tap(iy + 1, ix + 1)
    f = (1 - fy) * top + fy * bot
    xh0f, yh0f = torch.floor(xy_h[..., 0]), torch.floor(xy_h[..., 1])
    inb = ((xh0f >= -1) & (xh0f <= W - 1) & (yh0f >= -1) & (yh0f <= H - 1)
           & inb_c[:, None, :])
    f = f * inb[..., None].to(f.dtype)
    bad = ~(torch.isfinite(xy_h).all(-1)
            & torch.isfinite(xy_c).all(-1)[:, None, :])
    return torch.where(bad[..., None], torch.full_like(f, float("nan")), f)


def quantize_per_channel_int8(vol: torch.Tensor):
    """Symmetric per-channel int8 quantization: vol [..., C] float ->
    (q [..., C] int8, scale [C] fp32) with scale = max(absmax_c, 1e-12) / 127
    and q = round(vol / scale), half to even. Zeros stay zero."""
    v = vol.to(torch.float32)
    absmax = v.abs().amax(dim=tuple(range(v.dim() - 1)))
    # a true division by a tensor (CUDA divides by a Python scalar through
    # its reciprocal), filled on the device: a tensor made from a host value
    # would copy from pageable memory and wait for the stream
    scale = absmax.clamp(min=1e-12) / torch.full_like(absmax, 127.0)
    return torch.round(v / scale).to(torch.int8), scale


def _up2_axis_zeropad(vol: torch.Tensor, axis: int,
                      out_len: int) -> torch.Tensor:
    """Exact 2x linear upsampling along one axis with zero padding: input
    node i lands on output node 2i, odd nodes are midpoints with a zero
    one past the end; cropped or zero-padded to `out_len`."""
    n = vol.shape[axis]
    nxt = torch.cat([vol.narrow(axis, 1, n - 1),
                     torch.zeros_like(vol.narrow(axis, 0, 1))], dim=axis)
    mid = (vol + nxt) * 0.5
    shape = list(vol.shape)
    shape[axis] = 2 * n
    y = torch.stack([vol, mid], dim=axis + 1).reshape(shape)
    if out_len <= 2 * n:
        return y.narrow(axis, 0, out_len)
    shape[axis] = out_len - 2 * n
    return torch.cat([y, y.new_zeros(shape)], dim=axis)


def upsample_linear_zeropad(vol: torch.Tensor, factor: int,
                            out_xyz) -> torch.Tensor:
    """Exact trilinear upsampling of [B, X, Y, Z, C] by a power-of-two
    factor onto the nested finer lattice (coarse node i -> fine node
    factor * i), zero outside the coarse volume, cropped or zero-padded to
    `out_xyz`: sampling the result at p equals sampling `vol` at p/factor."""
    if factor < 1 or factor & (factor - 1):
        raise ValueError(f"factor {factor} is not a power of two")
    f = factor
    while f > 1:
        tgt = [min(2 * s, o if f == 2 else 2 * s)
               for s, o in zip(vol.shape[1:4], out_xyz)]
        for ax, t in zip((1, 2, 3), tgt):
            vol = _up2_axis_zeropad(vol, ax, t)
        f //= 2
    for ax, o in zip((1, 2, 3), out_xyz):
        n = vol.shape[ax]
        if n > o:
            vol = vol.narrow(ax, 0, o)
        elif n < o:
            shape = list(vol.shape)
            shape[ax] = o - n
            vol = torch.cat([vol, vol.new_zeros(shape)], dim=ax)
    return vol


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    # floor(dst * n_in / n_out) in float32, as the JAX package computes it
    scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    return torch.floor(torch.arange(n_out, dtype=torch.float32) * scale) \
        .long().to(device)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize over the trailing two dims of [..., H, W] (torch
    `F.interpolate(mode='nearest')` index rule)."""
    H, W = x.shape[-2], x.shape[-1]
    h, w = out_hw
    ys = _nearest_index(H, h, x.device)
    xs = _nearest_index(W, w, x.device)
    return x[..., ys[:, None], xs[None, :]]


def resize_nearest_nhwc(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize for channel-last [..., H, W, C] tensors."""
    H, W = x.shape[-3], x.shape[-2]
    h, w = out_hw
    ys = _nearest_index(H, h, x.device)
    xs = _nearest_index(W, w, x.device)
    return x[..., ys[:, None], xs[None, :], :]
