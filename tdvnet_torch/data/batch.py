"""Fixed-shape padded batch of posed frames (port of `tdvnet/data/batch.py`).

Every scene contributes exactly `n_views` images and `n_ref` ref slots; the
ref/source graph is a dense `[R, S]` source-index table per ref slot (the
window includes the ref itself), and `img_scene`/`ref_scene` are explicit
scene ids.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class FrameBatch:
    """A collated multi-scene batch.

    Shapes (N = images, R = ref slots, S = sources per ref):
      images [N, H, W, 3] normalized RGB (channel-last); rotmats [N, 3, 3]
      world->cam; tvecs [N, 3]; K [N, 3, 3]; depth_gt [R, hg, wg] or None;
      ref_idx [R]; src_idx [R, S]; src_mask [R, S]; ref_mask [R];
      img_mask [N]; img_scene [N]; ref_scene [R].
    """

    images: torch.Tensor
    rotmats: torch.Tensor
    tvecs: torch.Tensor
    K: torch.Tensor
    depth_gt: Optional[torch.Tensor]
    ref_idx: torch.Tensor
    src_idx: torch.Tensor
    src_mask: torch.Tensor
    ref_mask: torch.Tensor
    img_mask: torch.Tensor
    img_scene: torch.Tensor
    ref_scene: torch.Tensor
    n_scenes: int = 1

    @property
    def n_imgs(self) -> int:
        return self.images.shape[0]

    @property
    def n_refs(self) -> int:
        return self.ref_idx.shape[0]

    @property
    def img_size(self):
        return tuple(self.images.shape[1:3])

    def to(self, device) -> "FrameBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _batch_from_numpy(n_scenes: int, **arrays) -> FrameBatch:
    index_keys = ("ref_idx", "src_idx", "img_scene", "ref_scene")
    out = {}
    for k, v in arrays.items():
        if v is None:
            out[k] = None
        elif k in index_keys:
            out[k] = torch.from_numpy(np.asarray(v, np.int64))
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return FrameBatch(n_scenes=n_scenes, **out)


def single_scene_views(images: np.ndarray, rotmats: np.ndarray,
                       tvecs: np.ndarray, K: np.ndarray,
                       depth_gt: Optional[np.ndarray],
                       n_src_on_either_side: int) -> FrameBatch:
    """Build a FrameBatch from one scene's ordered view list (no padding).

    The source window of ref i spans images [i-k, i+k]; the first k and the
    last k images are source-only.
    """
    n = images.shape[0]
    k = n_src_on_either_side
    n_ref = n - 2 * k
    if n_ref < 1:
        raise ValueError("need at least one ref view")
    ref_idx = np.arange(k, n - k)
    src_idx = ref_idx[:, None] + np.arange(-k, k + 1)[None, :]
    S = 2 * k + 1
    return _batch_from_numpy(
        1, images=images.astype(np.float32), rotmats=rotmats.astype(np.float32),
        tvecs=tvecs.astype(np.float32), K=K.astype(np.float32),
        depth_gt=None if depth_gt is None else depth_gt.astype(np.float32),
        ref_idx=ref_idx, src_idx=src_idx, src_mask=np.ones((n_ref, S), bool),
        ref_mask=np.ones((n_ref,), bool), img_mask=np.ones((n,), bool),
        img_scene=np.zeros((n,)), ref_scene=np.zeros((n_ref,)))


def collate_scenes(scenes, n_views: int, n_ref: int,
                   n_src_on_either_side: int) -> FrameBatch:
    """Collate per-scene view dicts into one padded FrameBatch (on the CPU).

    scenes: list of dicts with keys images [V,H,W,3], rotmats, tvecs, K,
    depth_gt [V_ref, hg, wg] (numpy). Each scene is padded or truncated to
    exactly `n_views` images and `n_ref` ref slots.
    """
    B = len(scenes)
    k = n_src_on_either_side
    S = 2 * k + 1
    H, W = scenes[0]["images"].shape[1:3]

    images = np.zeros((B * n_views, H, W, 3), np.float32)
    rotmats = np.tile(np.eye(3, dtype=np.float32), (B * n_views, 1, 1))
    tvecs = np.zeros((B * n_views, 3), np.float32)
    Ks = np.tile(np.eye(3, dtype=np.float32), (B * n_views, 1, 1))
    img_mask = np.zeros((B * n_views,), bool)
    img_scene = np.repeat(np.arange(B), n_views)

    has_depth = scenes[0].get("depth_gt") is not None
    hg, wg = scenes[0]["depth_gt"].shape[1:3] if has_depth else (1, 1)
    depth_gt = np.zeros((B * n_ref, hg, wg), np.float32) if has_depth else None
    ref_idx = np.zeros((B * n_ref,), np.int64)
    src_idx = np.zeros((B * n_ref, S), np.int64)
    src_mask = np.zeros((B * n_ref, S), bool)
    ref_mask = np.zeros((B * n_ref,), bool)
    ref_scene = np.repeat(np.arange(B), n_ref)

    for b, sc in enumerate(scenes):
        v = min(sc["images"].shape[0], n_views)
        base = b * n_views
        images[base:base + v] = sc["images"][:v]
        rotmats[base:base + v] = sc["rotmats"][:v]
        tvecs[base:base + v] = sc["tvecs"][:v]
        Ks[base:base + v] = sc["K"][:v]
        img_mask[base:base + v] = True

        r = min(max(v - 2 * k, 0), n_ref)
        rbase = b * n_ref
        for i in range(r):
            ref_idx[rbase + i] = base + k + i
            window = base + k + i + np.arange(-k, k + 1)
            src_idx[rbase + i] = np.clip(window, base, base + v - 1)
            src_mask[rbase + i] = (window >= base) & (window < base + v)
            ref_mask[rbase + i] = True
        # padded ref slots point at the scene's first image (safe gather)
        ref_idx[rbase + r:rbase + n_ref] = base
        src_idx[rbase + r:rbase + n_ref] = base
        if has_depth:
            depth_gt[rbase:rbase + r] = sc["depth_gt"][:r]

    return _batch_from_numpy(
        B, images=images, rotmats=rotmats, tvecs=tvecs, K=Ks,
        depth_gt=depth_gt, ref_idx=ref_idx, src_idx=src_idx,
        src_mask=src_mask, ref_mask=ref_mask, img_mask=img_mask,
        img_scene=img_scene, ref_scene=ref_scene)
