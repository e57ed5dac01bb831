"""Bilinear / trilinear sampling with zero padding, and nearest resize
(plain PyTorch; port of `tdvnet/ops/sampling.py`).

Semantics are `grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True)` with queries in pixel/cell coordinates: taps outside
the map contribute zero. Bounds are tested on the float coordinates before
any float-to-int conversion, so far-off or non-finite queries give zero
instead of an undefined index. The batched forms gather from one flattened
table, so a batch is one set of indexing ops.
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
