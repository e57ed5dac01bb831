"""PointFlow hypothesis decoder and scene-feature sampling (port of
`tdvnet/models/hypothesis.py`).

For every depth pixel the 2n+1 hypothesis points are scored by sampling
each scene U-Net scale at the points (the `trilinear_sample` kernel, or
`trilinear_sample_i8` over the fast path's int8 tables), concatenating the
per-hypothesis image variance, and running a small conv stack along the
hypothesis axis that ends in a softmax.

The fast path's helpers are here too: `combine_scales` merges the nested
scale lattices into one fine grid, and `decoder_scene_projection` /
`projected_decoder` build the rank-r basis the merged table is projected
onto and the decoder whose first conv reads it. The JAX package also packs
oct gather tables (`pack_scales`) for the TPU's per-row gather cost; the
kernels here read the grids directly.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.kernels import trilinear_sample, trilinear_sample_i8
from tdvnet_torch.models.layers import batch_norm
from tdvnet_torch.ops.sampling import upsample_linear_zeropad

# The JAX package's byte budget for the fast path's packed tables: a merged
# grid whose 8x oct table (in the grid's own element size) exceeds it is
# not merged, and a grid whose int8 oct table exceeds it is sampled in fp32
# (never a merged one: its int8 table is at most a quarter of the bytes it
# passed). It is a TPU memory measure, kept so that the port takes the same
# branch (whether the rank projection applies at all depends on it).
_COMBINE_BUDGET_BYTES = 3584 * 1024 * 1024


def int8_table_bytes(grid: torch.Tensor) -> int:
    """Bytes of the JAX package's int8 oct table of a [B, X, Y, Z, C] grid."""
    B, X, Y, Z, C = grid.shape
    return B * (X + 1) * (Y + 1) * (Z + 1) * 8 * C


def combine_scales(scales):
    """Merge the U-Net scales into the fewest fine-lattice grids the budget
    allows (the JAX package's `combine_scales`, fast path).

    The lattices are nested (stride-s node i is fine node s*i), and
    trilinear sampling of a coarse scale equals sampling its exact linear
    upsampling on the finer lattice, zero padding included. Coarser scales
    are upsampled onto the finest target whose merged oct table fits
    `_COMBINE_BUDGET_BYTES` and whose dims the coarse dims tile exactly;
    the merged grid is extended by `cell_offset` low-side nodes that carry
    the coarse scales' zero-pad ramps. scales: coarsest-first
    [{"grid": [B, x, y, z, C], "stride": s}, ...]; returns a coarsest-first
    list whose merged grid holds its channels finest first, so the sampled
    channel order is unchanged.
    """
    if len(scales) <= 1:
        return scales
    by_fine = sorted(scales, key=lambda sc: sc["stride"])
    itemsize = by_fine[0]["grid"].element_size()
    for ti, tgt in enumerate(by_fine):
        ts = tgt["stride"]
        B, X, Y, Z, _ = tgt["grid"].shape
        n_ch = sum(sc["grid"].shape[-1] for sc in by_fine[ti:])
        pad_n = by_fine[-1]["stride"] // ts - 1
        packed = (B * (X + pad_n + 1) * (Y + pad_n + 1) * (Z + pad_n + 1)
                  * 8 * n_ch * itemsize)
        if packed > _COMBINE_BUDGET_BYTES:
            continue
        # exact only where each coarse grid ends where the fine one does
        if any(d * (sc["stride"] // ts) != D
               for sc in by_fine[ti + 1:]
               for d, D in zip(sc["grid"].shape[1:4], (X, Y, Z))):
            continue

        def low_pad(g, n):
            return F.pad(g, (0, 0, n, 0, n, 0, n, 0)) if n else g

        parts = [low_pad(tgt["grid"], pad_n)]
        for sc in by_fine[ti + 1:]:
            r = sc["stride"] // ts
            up = upsample_linear_zeropad(low_pad(sc["grid"], 1), r,
                                         (X + r, Y + r, Z + r))
            # nodes cover fine [-r, D-1]; align to [-pad_n, D-1]
            sl = max(r - pad_n, 0)
            up = up[:, sl:, sl:, sl:]
            parts.append(low_pad(up, max(pad_n - r, 0)))
        combined = {"grid": torch.cat(parts, dim=-1).contiguous(),
                    "stride": ts, "cell_offset": float(pad_n)}
        return [combined] + by_fine[:ti][::-1]
    return scales


def sample_scales(scales, pts: torch.Tensor, origins: torch.Tensor,
                  edge_len: float) -> torch.Tensor:
    """Trilinear-sample every U-Net scale at world points, concat channels.

    scales: coarsest-first list of {"grid": [B, x, y, z, C], "stride": s};
    a grid of int8 carries its per-channel dequantization "scale" [B, C]
    and may carry a merged grid's "cell_offset" o. pts [B, Q, 3] world
    points grouped per scene; origins [B, 3]. Node i of a stride-s scale
    sits at origin + edge/2 + s*(i - o)*edge. Returns [B, Q, sum C] with
    the finest scale first, in bf16 when every grid is int8 (as the JAX
    package samples its int8 tables), else fp32; each scale's kernel launch
    writes its own channel slice.
    """
    center0 = (origins + 0.5 * edge_len).contiguous()
    B, Q, _ = pts.shape
    fine_first = scales[::-1]
    n_ch = sum(sc["grid"].shape[-1] for sc in scales)
    int8 = [sc["grid"].dtype == torch.int8 for sc in fine_first]
    dtype = torch.bfloat16 if all(int8) else torch.float32
    out = torch.empty((B, Q, n_ch), dtype=dtype, device=pts.device)
    pts = pts.contiguous()
    off = 0
    for sc, i8 in zip(fine_first, int8):
        g = sc["grid"]
        C = g.shape[-1]
        at = (pts, center0, sc["stride"] * edge_len)
        if not i8:
            if sc.get("cell_offset"):
                raise ValueError("a merged float grid: its cell_offset is "
                                 "sampled by the int8 kernel only")
            trilinear_sample(g, *at, out, off)
        elif dtype == torch.bfloat16:
            trilinear_sample_i8(g, sc["scale"], *at, out, off,
                                cell_offset=sc.get("cell_offset", 0.0))
        else:
            # a float grid beside it: the JAX package's concat widens bf16
            part = torch.empty((B, Q, C), dtype=torch.bfloat16,
                               device=pts.device)
            out[..., off:off + C] = trilinear_sample_i8(
                g, sc["scale"], *at, part, 0,
                cell_offset=sc.get("cell_offset", 0.0))
        off += C
    return out


def decoder_scene_projection(decoder: "HypothesisDecoder", n_var: int,
                             rank: int):
    """Rank-r compression of the decoder's scene input (the JAX package's
    `decoder_scene_projection`, in numpy on the host).

    The first conv is linear in the sampled scene features, and sampling is
    linear in the table, so a basis V applied to the table once per scene
    iteration folds into the conv's weights. V holds the top-r left
    singular vectors of the stacked scene weights [K_-1 K_0 K_+1]
    ([n_scene, taps * hidden], built from the flax-layout [taps, n_in,
    hidden] kernel, so that V equals the JAX package's up to column sign).
    Returns (V [n_scene, rank] fp32 numpy, the projected Conv_0 weight
    [hidden, rank + n_var, taps] as a CPU tensor, tail) where tail is the
    square root of the discarded spectral energy fraction.
    """
    w = decoder.Conv_0.weight.detach().to("cpu", torch.float32).numpy()
    k = np.ascontiguousarray(np.transpose(w, (2, 1, 0)))  # [T, n_in, H]
    T, n_in, H = k.shape
    n_scene = n_in - n_var
    if not 0 < rank < n_scene:
        raise ValueError(f"rank {rank} must lie in (0, {n_scene})")
    scene = k[:, :n_scene, :]
    M = np.transpose(scene, (1, 0, 2)).reshape(n_scene, T * H)
    U, S, _ = np.linalg.svd(M, full_matrices=False)
    V = np.ascontiguousarray(U[:, :rank])
    proj = np.einsum("cr,tch->trh", V, scene)
    new_k = np.concatenate([proj, k[:, n_scene:, :]], axis=1)
    tail = float(np.sqrt(np.sum(S[rank:] ** 2)
                         / max(np.sum(S ** 2), 1e-30)))
    weight = torch.from_numpy(np.ascontiguousarray(
        np.transpose(new_k, (2, 1, 0)), np.float32))
    return V, weight, tail


def projected_decoder(decoder: "HypothesisDecoder", n_var: int, rank: int):
    """(V, a copy of `decoder` whose Conv_0 reads rank + n_var channels,
    tail) on the decoder's device; see `decoder_scene_projection`."""
    V, weight, tail = decoder_scene_projection(decoder, n_var, rank)
    conv = decoder.Conv_0
    new = copy.deepcopy(decoder)
    new.Conv_0 = nn.Conv1d(weight.shape[1], weight.shape[0],
                           conv.kernel_size, padding=conv.padding, bias=False)
    with torch.no_grad():
        new.Conv_0.weight.copy_(weight)
    return V, new.to(conv.weight.device).eval(), tail


class HypothesisDecoder(nn.Module):
    def __init__(self, in_ch: int, hidden: int = 128, ksize: int = 3):
        super().__init__()
        p = ksize // 2    # SAME for an odd kernel at stride 1
        self.Conv_0 = nn.Conv1d(in_ch, hidden, ksize, padding=p, bias=False)
        self.BatchNorm_0 = batch_norm(1, hidden)
        self.Conv_1 = nn.Conv1d(hidden, hidden, ksize, padding=p, bias=False)
        self.BatchNorm_1 = batch_norm(1, hidden)
        self.Conv_2 = nn.Conv1d(hidden, hidden, ksize, padding=p, bias=False)
        self.BatchNorm_2 = batch_norm(1, hidden)
        self.Conv_3 = nn.Conv1d(hidden, 1, ksize, padding=p)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [M, n_hyp, C] -> softmax scores [M, n_hyp]."""
        y = feats.transpose(1, 2)
        for conv, bn in ((self.Conv_0, self.BatchNorm_0),
                         (self.Conv_1, self.BatchNorm_1),
                         (self.Conv_2, self.BatchNorm_2)):
            y = F.relu(bn(conv(y)))
        return torch.softmax(self.Conv_3(y)[:, 0].to(torch.float32), dim=-1)
