"""Whole-scene depth inference (port of `tdvnet/eval/fused_scene.py`).

One scene of N ordered views has R = N - 2k ref views (k sources on either
side). Refs are processed in chunks of `EvalConfig.fused_chunk`; the ref
count buckets up to a multiple of the chunk, images and cameras are padded
by repeating the last one, and masks keep the padded slots out of every
result:

  prep     u8 -> normalized images, features, initial depth per ref chunk,
           scene bbox from the valid refs' back-projected depths
  host     fetch the bbox (6 floats: the one host sync per scene the
           algorithm needs) and choose the scene grid
  refine   per refinement iteration one scene volume over all refs, then
           PointFlow per ref chunk with the depth carried across the offset
           passes; propagation upsampling per chunk; optional uint16-millimetre
           result (bounded +-0.5 mm quantization)

The chunk semantics are those of the JAX class; a Python loop over chunks
stands where it scans on the device. `count_flops`, which reads XLA's cost
analysis, has no counterpart here.

Parity path (`fast_path=False`): each U-Net scale's grid is sampled directly
with the `trilinear_sample` kernel. The JAX class packs oct gather tables
(`pack_scales`) because the TPU's gather costs per row; that is exact in
real arithmetic and has no counterpart here.

A bf16 model (`ModelConfig.dtype`) runs the parity path in bf16: the
images, cameras, depths and the fetched result stay fp32, the features and
scene tables bf16 (see `models/threedvnet.py`); the fast path in bf16
raises (ROADMAP.md queue 1 item 2c).

Fast path (`fast_path=True`, the JAX class's op mix): iteration 2 runs one
fine offset pass (`FAST_OFFSETS`); per iteration the U-Net scales merge
into one fine lattice (`combine_scales`), which is projected onto the top
`fast_rank` singular directions of the decoder's first-conv scene weights
(the decoder's copy with the projected Conv_0 reads it) and quantized per
channel to int8, sampled by `trilinear_sample_i8` into bf16; with
`fast_patch` the image variance of a pixel's hypothesis fan comes from one
4x4 patch per source (`patch_fan_variance`).
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tdvnet_torch.config import (Config, GridConfig, check_bf16_fast_path,
                                 set_fp32_numerics)
from tdvnet_torch.data.batch import FrameBatch
from tdvnet_torch.models import hypothesis
from tdvnet_torch.models.threedvnet import ThreeDVNet
from tdvnet_torch.ops import camera
from tdvnet_torch.ops.sampling import quantize_per_channel_int8

PARITY_OFFSETS = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
# the fast path's offsets: iteration 2 runs one fine pass, by then the
# depth is within the fine capture range
FAST_OFFSETS = ((0.05, 0.05, 0.025), (0.025,))
FEATURE_CHUNK = 32        # images per backbone call (memory, not numerics)
STAT_KEYS = ("n_out_of_grid", "n_overflow", "n_points")


class FusedSceneInference:
    """Whole-scene depth prediction on the model's device."""

    def __init__(self, model: ThreeDVNet, cfg: Config,
                 offsets_list: Sequence[Sequence[float]] = PARITY_OFFSETS,
                 fetch_mm: bool = True, fast_path: Optional[bool] = None):
        self.model = model
        self.cfg = cfg
        e = cfg.eval
        self.fast_path = e.fast_path if fast_path is None else fast_path
        check_bf16_fast_path(model.cfg, self.fast_path)
        offsets = tuple(tuple(float(o) for o in off) for off in offsets_list)
        if self.fast_path and offsets == PARITY_OFFSETS:
            offsets = FAST_OFFSETS
        self.offsets_list = offsets
        self.fetch_mm = fetch_mm
        self.chunk = e.fused_chunk
        self.grid_cfg = GridConfig(
            edge_len=cfg.model.grid.edge_len, grid_size=e.eval_grid_size,
            max_anchors=e.eval_max_anchors)
        self.device = next(model.parameters()).device
        self.fast_patch = self.fast_path and e.fast_patch
        # the rank projection: V on the card and the decoder that reads
        # the projected table; off when the rank keeps every scene channel
        self.fast_rank = e.fast_rank if self.fast_path else 0
        self._proj_V = self._decoder_fast = None
        if self.fast_rank:
            feat_dim = cfg.model.feat_dim
            n_scene = model.decoder.Conv_0.in_channels - feat_dim
            if 0 < self.fast_rank < n_scene:
                V, self._decoder_fast, tail = hypothesis.projected_decoder(
                    model.decoder, feat_dim, self.fast_rank)
                self._proj_V = torch.from_numpy(V).to(self.device)
                print(f"fast-rank {self.fast_rank}/{n_scene}: discarded "
                      f"interface spectral energy {tail:.4f}")
            else:
                self.fast_rank = 0
        # fast path: tables sampled per iteration of the last scene, and
        # whether the projection applied to them
        self.last_n_tables = None
        self.last_projected = None
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.last_scene_stats: Dict = {}
        self.last_grid_size = None

    # ------------------------------------------------------------- helpers
    def _arange(self, n):
        return torch.arange(n, dtype=torch.int64, device=self.device)

    def _chunk_tables(self):
        """Per-chunk index tables, local to a chunk's image window."""
        CH, k = self.chunk, self.cfg.eval.n_src_on_either_side
        ref_idx = self._arange(CH) + k
        off = self._arange(2 * k + 1) - k
        src_idx = (ref_idx[:, None] + off[None]).clamp(0, CH + 2 * k - 1)
        return ref_idx, src_idx

    def _window_masks(self, rg, n_refs, n_imgs_valid):
        """Ref/source validity of the global ref slots `rg`."""
        k = self.cfg.eval.n_src_on_either_side
        ref_mask = rg < n_refs
        off = self._arange(2 * k + 1) - k
        src_global = rg[:, None] + k + off[None]          # global image index
        src_mask = (ref_mask[:, None] & (src_global >= 0)
                    & (src_global < n_imgs_valid))
        return ref_mask, src_mask

    def _chunk_masks(self, r0, n_refs, n_imgs_valid):
        """Ref/source validity of the chunk starting at global ref r0."""
        return self._window_masks(r0 + self._arange(self.chunk), n_refs,
                                  n_imgs_valid)

    def _frame_batch(self, rot, tv, Ks, ref_idx, src_idx, ref_mask, src_mask):
        n, r = rot.shape[0], ref_idx.shape[0]
        dev = self.device
        return FrameBatch(
            images=torch.zeros((n, 1, 1, 3), device=dev), rotmats=rot,
            tvecs=tv, K=Ks, depth_gt=None, ref_idx=ref_idx, src_idx=src_idx,
            src_mask=src_mask, ref_mask=ref_mask,
            img_mask=torch.ones((n,), dtype=torch.bool, device=dev),
            img_scene=torch.zeros((n,), dtype=torch.int64, device=dev),
            ref_scene=torch.zeros((r,), dtype=torch.int64, device=dev),
            n_scenes=1)

    def _chunk_frame_batch(self, cams, r0, n_refs, n_imgs_valid):
        """FrameBatch of ref slots [r0, r0 + chunk) over their image
        window [r0, r0 + chunk + 2k)."""
        W = self.chunk + 2 * self.cfg.eval.n_src_on_either_side
        ref_idx, src_idx = self._chunk_tables()
        ref_mask, src_mask = self._chunk_masks(r0, n_refs, n_imgs_valid)
        rot, tv, Ks = (a[r0:r0 + W] for a in cams)
        return self._frame_batch(rot, tv, Ks, ref_idx, src_idx, ref_mask,
                                 src_mask)

    def _scene_frame_batch(self, cams, Rb, n_refs, n_imgs_valid):
        """Whole-scene FrameBatch (Rb ref slots)."""
        k = self.cfg.eval.n_src_on_either_side
        rg = self._arange(Rb)
        ref_idx = rg + k
        off = self._arange(2 * k + 1) - k
        src_idx = (ref_idx[:, None] + off[None]).clamp(0, Rb + 2 * k - 1)
        ref_mask, src_mask = self._window_masks(rg, n_refs, n_imgs_valid)
        return self._frame_batch(*cams, ref_idx, src_idx, ref_mask, src_mask)

    def _grid_from_extent(self, extent: np.ndarray) -> GridConfig:
        """Grid dims for a scene of this bbox extent: rounded up to
        `grid_bucket` multiples and capped at `eval_grid_size`."""
        e = self.cfg.eval
        gc = self.grid_cfg
        if not e.auto_grid or not np.isfinite(extent).all() \
                or (extent <= 0).any():
            return gc
        b = e.grid_bucket
        need = np.ceil(extent / gc.edge_len).astype(int) + 2
        buckets = np.array([b, b, b])
        dims = -(-need // buckets) * buckets
        cap = np.array(gc.grid_size) // buckets * buckets
        capped = np.minimum(dims, np.maximum(cap, buckets))
        if (dims > np.array(gc.grid_size)).any():
            warnings.warn(
                f"scene bbox needs grid {tuple(dims)} voxels but "
                f"eval_grid_size caps it at {gc.grid_size}; geometry "
                f"outside will be dropped (see scene_stats counters)")
        return GridConfig(edge_len=gc.edge_len,
                          grid_size=tuple(int(x) for x in capped),
                          max_anchors=gc.max_anchors)

    def _fast_tables(self, scales):
        """The fast path's tables of one iteration: merge the scales, project
        a single merged grid onto V (the projected decoder then reads it),
        quantize each grid per channel to int8 unless its oct table would
        exceed the budget (then it is sampled in fp32, as in the JAX
        package). Returns (scales, decoder or None for the model's own)."""
        scales = hypothesis.combine_scales(scales)
        decoder, V = None, self._proj_V
        if V is not None and len(scales) == 1 \
                and scales[0]["grid"].shape[-1] == V.shape[0]:
            g = scales[0]["grid"]
            gp = (g.reshape(-1, g.shape[-1]) @ V).reshape(*g.shape[:-1],
                                                         V.shape[1])
            scales = [dict(scales[0], grid=gp)]
            decoder = self._decoder_fast
        out = []
        for sc in scales:
            g = sc["grid"]
            if hypothesis.int8_table_bytes(g) <= \
                    hypothesis._COMBINE_BUDGET_BYTES:
                qs = [quantize_per_channel_int8(gb) for gb in g]
                sc = dict(sc, grid=torch.stack([q for q, _ in qs]),
                          scale=torch.stack([s for _, s in qs]))
            out.append(sc)
        return out, decoder

    # ------------------------------------------------------------ transfers
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor. On a card the copy goes from a
        pinned buffer on a side stream, so it does not wait on the work the
        main stream still holds; the main stream waits on the copy."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._copy_stream is None:
            return t.to(self.device)
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            d = t.pin_memory().to(self.device, non_blocking=True)
        main.wait_stream(self._copy_stream)
        d.record_stream(main)
        return d

    def _to_host(self, d: torch.Tensor):
        """Device tensor -> (host tensor, event). On a card the copy into a
        pinned buffer is asynchronous; wait on the event before reading."""
        if self.device.type != "cuda":
            return d, None
        h = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
        h.copy_(d, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return h, ev

    # ----------------------------------------------------------------- prep
    @torch.inference_mode()
    def _dispatch_prep(self, views: Dict) -> Dict:
        """Upload one scene and enqueue features, initial depth and bbox."""
        set_fp32_numerics()
        span = torch.profiler.record_function
        cfg, e = self.cfg, self.cfg.eval
        k, CH = e.n_src_on_either_side, self.chunk
        u8 = "images_u8" in views
        images = views["images_u8"] if u8 else views["images"]
        n_imgs = images.shape[0]
        R = n_imgs - 2 * k
        if R < 1:
            raise ValueError("scene too short")
        n_chunks = -(-R // CH)
        Rb = n_chunks * CH
        pad = Rb + 2 * k - n_imgs

        def padded(a, dtype=None):
            a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
            if pad:
                a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], 0)
            return a

        with span("stage_input"):
            imgs = self._to_device(padded(images))
            cams = tuple(self._to_device(padded(views[n], np.float32))
                         for n in ("rotmats", "tvecs", "K"))
            if u8:
                # true divisions by tensors, as the JAX package divides
                # (PyTorch's CUDA division by a Python scalar multiplies by
                # the reciprocal)
                f32 = lambda v: torch.as_tensor(
                    np.asarray(v, np.float32), device=self.device)
                imgs = ((imgs.to(torch.float32)
                         / f32(views.get("rgb_scale", 255.0))
                         - f32(views["rgb_mean"])) / f32(views["rgb_std"]))
            else:
                imgs = imgs.to(torch.float32)

        model = self.model
        with span("stage_A_features"):
            halves, quarters = [], []
            for i in range(0, imgs.shape[0], FEATURE_CHUNK):
                fh, fq, _ = model.extract_features(imgs[i:i + FEATURE_CHUNK])
                halves.append(fh)
                quarters.append(fq)
            feats_half, feats_quarter = torch.cat(halves), torch.cat(quarters)

        n_imgs_valid = R + 2 * k
        dc = cfg.model.depth_test
        with span("stage_B_initial_depth"):
            depth_all = torch.cat([
                model.initial_depth(
                    self._chunk_frame_batch(cams, r0, R, n_imgs_valid), dc,
                    feats_quarter[r0:r0 + CH + 2 * k])
                for r0 in range(0, Rb, CH)])

        with span("stage_bbox"):
            # scene bbox from the valid refs' positive depths
            rot, tv, Ks = cams
            ridx = self._arange(Rb) + k
            pts = camera.backproject_grid(depth_all, Ks[ridx], rot[ridx],
                                          tv[ridx], cfg.model.img_size)
            valid = ((self._arange(Rb) < R)[:, None]
                     & (depth_all.reshape(Rb, -1) > 0))[..., None]
            big = torch.tensor(1e9, dtype=torch.float32, device=self.device)
            lo = torch.where(valid, pts, big).amin(dim=(0, 1))
            hi = torch.where(valid, pts, -big).amax(dim=(0, 1))
            bbox, bbox_ev = self._to_host(torch.stack([lo, hi]))
        return {"imgs": imgs, "feats_half": feats_half,
                "feats_quarter": feats_quarter, "cams": cams,
                "depth_all": depth_all, "bbox": bbox, "bbox_ev": bbox_ev,
                "R": R, "n_chunks": n_chunks}

    # --------------------------------------------------------------- refine
    @torch.inference_mode()
    def _dispatch_refine(self, st: Dict) -> None:
        """Fetch the scene's bbox (sync), then enqueue refinement,
        upsampling and the result's copy to the host."""
        span = torch.profiler.record_function
        if st["bbox_ev"] is not None:
            st["bbox_ev"].synchronize()
        bbox = st["bbox"].cpu().numpy()
        gc = self._grid_from_extent(bbox[1] - bbox[0])
        st["grid_size"] = gc.grid_size

        model = self.model
        k, CH = self.cfg.eval.n_src_on_either_side, self.chunk
        R, cams = st["R"], st["cams"]
        fq, fh, imgs = st["feats_quarter"], st["feats_half"], st["imgs"]
        depth_all = st["depth_all"]
        Rb = depth_all.shape[0]
        n_imgs_valid = R + 2 * k
        sb = self._scene_frame_batch(cams, Rb, R, n_imgs_valid)
        chunks = [(r0, self._chunk_frame_batch(cams, r0, R, n_imgs_valid))
                  for r0 in range(0, Rb, CH)]
        stats_acc = torch.zeros((len(STAT_KEYS),), dtype=torch.int64,
                                device=self.device)

        for offsets in self.offsets_list:
            with span("stage_C_scene_model"):
                d_pad = torch.where(sb.ref_mask[:, None, None], depth_all,
                                    torch.zeros_like(depth_all))
                scales, origins, sstats = model.model_scene(d_pad, fq, sb, gc)
                stats_acc = stats_acc + torch.stack(
                    [sstats[name] for name in STAT_KEYS])
            decoder = None
            if self.fast_path:
                with span("stage_C_fast_tables"):
                    scales, decoder = self._fast_tables(scales)
                st["n_tables"] = len(scales)
                st["projected"] = decoder is not None
            with span("stage_D_pointflow"):
                # refs are independent inside an iteration: every chunk
                # starts from the depth the iteration began with
                depth_all = torch.cat([
                    model.run_pointflow_multi(
                        scales, origins, depth_all[r0:r0 + CH],
                        fq[r0:r0 + CH + 2 * k], cb, offsets, 3, gc,
                        self.fast_patch, decoder)
                    for r0, cb in chunks])

        with span("stage_E_upsample"):
            # ref r uses image r + k; the windows are contiguous
            ridx = self._arange(CH)
            out = torch.cat([
                model.upsample(depth_all[r0:r0 + CH],
                               fh[r0 + k:r0 + k + CH], fq[r0 + k:r0 + k + CH],
                               imgs[r0 + k:r0 + k + CH], ridx)
                for r0, _ in chunks])
        with span("stage_output"):
            out = out[:R]
            if self.fetch_mm:
                # uint16 has no CUDA arithmetic: round into int32, keep the
                # low 16 bits (the clip bounds the value to 65535)
                out = torch.round(out.clamp(0.0, 65.535) * 1000.0) \
                    .to(torch.int32).to(torch.uint16)
            st["result"], st["result_ev"] = self._to_host(out)
            st["stats"], st["stats_ev"] = self._to_host(stats_acc)

    def _fetch(self, st: Dict) -> np.ndarray:
        for ev in (st["result_ev"], st["stats_ev"]):
            if ev is not None:
                ev.synchronize()
        self.last_grid_size = st["grid_size"]
        self.last_n_tables = st.get("n_tables")
        self.last_projected = st.get("projected")
        self.last_scene_stats = {name: int(v) for name, v in
                                 zip(STAT_KEYS, st["stats"].cpu().tolist())}
        out = st["result"].cpu().numpy()
        if self.fetch_mm:
            return out.astype(np.float32) * 1e-3
        return out

    # ---------------------------------------------------------- entry points
    def _warn_dropped(self) -> None:
        s = self.last_scene_stats
        dropped = s.get("n_out_of_grid", 0) + s.get("n_overflow", 0)
        if dropped:
            warnings.warn(
                f"scene volume dropped {dropped} points "
                f"(out_of_grid={s.get('n_out_of_grid', 0)}, "
                f"anchor_overflow={s.get('n_overflow', 0)} of "
                f"{s.get('n_points', 0)} valid): enlarge "
                f"eval_grid_size / eval_max_anchors")

    def predict_scene(self, views: Dict,
                      timings: Optional[Dict] = None) -> np.ndarray:
        """views: whole-scene dict of numpy arrays (`images_u8` with
        `rgb_scale`/`rgb_mean`/`rgb_std`, or normalized `images`; `rotmats`,
        `tvecs`, `K`). Returns [R, H, W] float32 depth at image resolution.
        `timings` accumulates the host seconds of "prep" (to the bbox fetch)
        and "refine" (to the fetched result)."""
        def mark(name, t0):
            now = time.perf_counter()
            if timings is not None:
                timings[name] = timings.get(name, 0.0) + now - t0
            return now

        t0 = time.perf_counter()
        st = self._dispatch_prep(views)
        if st["bbox_ev"] is not None:
            st["bbox_ev"].synchronize()
        t0 = mark("prep", t0)
        self._dispatch_refine(st)
        out = self._fetch(st)
        mark("refine", t0)
        self._warn_dropped()
        return out

    def predict_scenes(self, scene_iter):
        """Whole-scene inference over an iterable of view dicts; yields
        [R, H, W] float32 per scene, the arrays `predict_scene` returns.

        Scene i+1's upload runs on a side stream from pinned memory and its
        prep is enqueued while scene i's refinement still runs on the card.
        Scene i's result, copied to pinned host memory asynchronously, is
        handed out before scene i+1's refinement is enqueued: in eager
        PyTorch that enqueue takes the host about as long as the card
        takes to run it, and a result should not wait for it.
        """
        prev = None
        for views in scene_iter:
            st = self._dispatch_prep(views)
            if prev is not None:
                yield self._fetch(prev)
                self._warn_dropped()
            self._dispatch_refine(st)
            prev = st
        if prev is not None:
            yield self._fetch(prev)
            self._warn_dropped()
