"""ThreeDVNet: initial MVS depth, scene-level volumetric modelling, iterative
PointFlow refinement and multi-scale guided upsampling (port of
`tdvnet/models/threedvnet.py`, inference only).

  initial depth   `initial_depth`           cost volume, CostRegNet, soft-argmax
  point cloud     `build_scene_pointcloud`  back-projection + source variance
  scene volume    `model_scene`             voxelize, PointNet, scene U-Net
  refinement      `run_pointflow`           hypotheses, scene sampling, decoder
  upsampling      `upsample`                3 PropagationNets
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tdvnet_torch.config import (DepthConfig, GridConfig, ModelConfig,
                                 set_fp32_numerics)
from tdvnet_torch.data.batch import FrameBatch
from tdvnet_torch.models.hypothesis import HypothesisDecoder, sample_scales
from tdvnet_torch.models.mvsnet import MVSNet
from tdvnet_torch.models.pointnet import PointNet
from tdvnet_torch.models.scene_unet import SceneUNet
from tdvnet_torch.models.upsampling import PropagationNet
from tdvnet_torch.ops import camera, costvolume, voxelize as vox
from tdvnet_torch.ops.sampling import resize_nearest


class ThreeDVNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = self.cfg = cfg
        f = c.feat_dim
        self.mvsnet = MVSNet(f, c.img_size, c.cost_base_channels)
        # PointNet(in = 3 + f, hidden = 4f, out = 2f)
        self.pointnet = PointNet(3 + f, 4 * f, 2 * f)
        self.scene_unet = SceneUNet(c.unet_dims, c.unet_groups, c.unet_res)
        self.decoder = HypothesisDecoder(sum(c.unet_dims) + f,
                                         c.decoder_hidden, c.hyp_ksize)
        self.refine_quarter = PropagationNet(f, c.propagation_hidden)
        self.refine_half = PropagationNet(f, c.propagation_hidden)
        self.refine_full = PropagationNet(3, c.propagation_hidden)

    # ---------------------------------------------------------------- 2D stage
    def extract_features(self, images):
        return self.mvsnet.extract_features(images)

    def initial_depth(self, batch: FrameBatch, depth_cfg: DepthConfig,
                      feats_quarter):
        return self.mvsnet.predict_depth(
            feats_quarter, batch.rotmats, batch.tvecs, batch.K, batch.ref_idx,
            batch.src_idx, batch.src_mask, depth_cfg.depth_start,
            depth_cfg.depth_interval, depth_cfg.n_intervals, depth_cfg.size)

    # ---------------------------------------------------------------- 3D stage
    def build_scene_pointcloud(self, depth_pred, feats_quarter,
                               batch: FrameBatch):
        """Back-project all ref depths; variance feature per point.
        Returns (pts [R, P, 3], feats [R, P, C])."""
        ri = batch.ref_idx
        pts = camera.backproject_grid(depth_pred, batch.K[ri],
                                      batch.rotmats[ri], batch.tvecs[ri],
                                      self.cfg.img_size)
        feats = costvolume.hypothesis_point_variance(
            pts, feats_quarter, batch.src_idx, batch.src_mask, batch.rotmats,
            batch.tvecs, batch.K, self.cfg.img_size)
        return pts, feats

    def scene_dense(self, depth_pred, feats_quarter, batch: FrameBatch,
                    grid_cfg: Optional[GridConfig] = None):
        """Voxelize the scene point cloud and PointNet-encode it into the
        dense grid the U-Net consumes. Returns (dense [B, gx, gy, gz, 2f],
        occ [B, gx, gy, gz, 1], origins [B, 3], stats)."""
        g = grid_cfg or self.cfg.grid
        B = batch.n_scenes
        pts, feats = self.build_scene_pointcloud(depth_pred, feats_quarter,
                                                 batch)
        R, P, _ = pts.shape
        pts_flat = pts.reshape(-1, 3)
        pt_scene = batch.ref_scene.repeat_interleave(P)
        pt_valid = batch.ref_mask.repeat_interleave(P)
        vg = vox.voxelize(pts_flat, pt_scene, pt_valid, g.edge_len,
                          g.grid_size, g.max_anchors, B)
        centers = torch.cat([vg.anchor_center,
                             vg.anchor_center.new_zeros((1, 3))])
        # points stay in their input order: the PointNet's max pools and
        # per-row linears do not depend on it (the JAX package sorts them by
        # anchor only so that XLA can declare sorted segments)
        x = torch.cat([pts_flat - centers[vg.point2anchor],
                       feats.reshape(R * P, -1)], dim=-1)
        anchor_feats = self.pointnet(x, vg.point2anchor, vg.point_valid,
                                     g.max_anchors)
        dense, occ = vox.scatter_anchors_to_dense(anchor_feats, vg,
                                                  g.grid_size, B)
        stats = {"n_out_of_grid": vg.n_out_of_grid,
                 "n_overflow": vg.n_overflow,
                 "n_points": vg.point_valid.sum()}
        return dense, occ, vg.origins, stats

    def model_scene(self, depth_pred, feats_quarter, batch: FrameBatch,
                    grid_cfg: Optional[GridConfig] = None):
        """Returns (scales coarsest-first, origins [B, 3], stats)."""
        dense, occ, origins, stats = self.scene_dense(
            depth_pred, feats_quarter, batch, grid_cfg)
        return self.scene_unet(dense, occ), origins, stats

    def run_pointflow(self, scales, origins, depth_pred, feats_quarter,
                      batch: FrameBatch, offset: float, n: int = 3,
                      grid_cfg: Optional[GridConfig] = None):
        """Score 2n+1 depth-offset hypotheses per pixel; return the expected
        depth correction [R, h, w]."""
        g = grid_cfg or self.cfg.grid
        R, h, w = depth_pred.shape
        P = h * w
        H = 2 * n + 1
        B = batch.n_scenes
        n_ref = R // B
        dev = depth_pred.device

        ri = batch.ref_idx
        grid = camera.build_img_grid(self.cfg.img_size, (h, w), dev)
        ray_cam = grid @ torch.linalg.inv(batch.K[ri]).transpose(-1, -2)
        Rr = batch.rotmats[ri]
        ray_world = ray_cam @ Rr                                  # R^T ray
        center = camera.camera_center(Rr, batch.tvecs[ri])
        ivals = torch.arange(-n, n + 1, dtype=torch.float32, device=dev)
        dh = depth_pred.reshape(R, 1, P) + ivals[None, :, None] * offset
        pts_hyp = center[:, None, None, :] \
            + ray_world[:, None, :, :] * dh[..., None]            # [R, H, P, 3]

        var = costvolume.hypothesis_point_variance(
            pts_hyp.reshape(R, H * P, 3), feats_quarter, batch.src_idx,
            batch.src_mask, batch.rotmats, batch.tvecs, batch.K,
            self.cfg.img_size)                                    # [R, HP, C]
        scene_feats = sample_scales(scales, pts_hyp.reshape(B, n_ref * H * P, 3),
                                    origins, g.edge_len)
        feats = torch.cat([scene_feats.reshape(R, H, P, -1),
                           var.reshape(R, H, P, -1)], dim=-1)
        feats = feats.transpose(1, 2).reshape(R * P, H, -1)
        probs = self.decoder(feats)                               # [RP, H]
        pred = (probs * (ivals * offset)[None, :]).sum(dim=-1)
        return pred.reshape(R, h, w)

    def run_pointflow_multi(self, scales, origins, depth_pred, feats_quarter,
                            batch: FrameBatch, offsets, n: int = 3,
                            grid_cfg: Optional[GridConfig] = None):
        """All of one refinement iteration's offset passes; the depth
        carries from pass to pass."""
        for off in offsets:
            depth_pred = depth_pred + self.run_pointflow(
                scales, origins, depth_pred, feats_quarter, batch, float(off),
                n, grid_cfg)
        return depth_pred

    def upsample(self, depth_pred, feats_half, feats_quarter, images,
                 ref_idx):
        """3-stage guided upsampling: coarse -> 1/4 -> 1/2 -> full."""
        depth_pred = resize_nearest(depth_pred, feats_quarter.shape[1:3])
        depth_pred = self.refine_quarter(feats_quarter[ref_idx], depth_pred)
        depth_pred = resize_nearest(depth_pred, feats_half.shape[1:3])
        depth_pred = self.refine_half(feats_half[ref_idx], depth_pred)
        depth_pred = resize_nearest(depth_pred, images.shape[1:3])
        return self.refine_full(images[ref_idx], depth_pred)

    @torch.inference_mode()
    def infer_stages(self, batch: FrameBatch,
                     offsets_list: Sequence[Sequence[float]],
                     depth_cfg: Optional[DepthConfig] = None,
                     grid_cfg: Optional[GridConfig] = None) -> dict:
        """Whole-batch inference, keeping each stage's depth: {"initial"
        [R, h, w], "refined" [R, h, w], "final" [R, H, W], "stats"} (stats
        of the last scene modelling). The batch moves to the model's
        device."""
        set_fp32_numerics()
        dev = next(self.parameters()).device
        # stage spans for torch.profiler (free when no profiler runs)
        span = torch.profiler.record_function
        with span("stage_input"):
            batch = batch.to(dev)
        dc = depth_cfg or self.cfg.depth_test
        with span("stage_A_features"):
            feats_half, feats_quarter, _ = self.extract_features(batch.images)
        with span("stage_B_initial_depth"):
            depth_pred = self.initial_depth(batch, dc, feats_quarter)
        out = {"initial": depth_pred, "stats": {}}
        for offsets in offsets_list:
            with span("stage_C_scene_model"):
                scales, origins, out["stats"] = self.model_scene(
                    depth_pred, feats_quarter, batch, grid_cfg)
            with span("stage_D_pointflow"):
                depth_pred = self.run_pointflow_multi(
                    scales, origins, depth_pred, feats_quarter, batch,
                    offsets, 3, grid_cfg)
        out["refined"] = depth_pred
        with span("stage_E_upsample"):
            out["final"] = self.upsample(depth_pred, feats_half,
                                         feats_quarter, batch.images,
                                         batch.ref_idx)
        return out

    def infer_depth(self, batch: FrameBatch,
                    offsets_list: Sequence[Sequence[float]],
                    depth_cfg: Optional[DepthConfig] = None,
                    grid_cfg: Optional[GridConfig] = None) -> torch.Tensor:
        """Whole-batch depth inference (no losses): final depth [R, H, W]."""
        return self.infer_stages(batch, offsets_list, depth_cfg,
                                 grid_cfg)["final"]
