"""ThreeDVNet: initial MVS depth, scene-level volumetric modelling, iterative
PointFlow refinement and multi-scale guided upsampling (port of
`tdvnet/models/threedvnet.py`).

  initial depth   `initial_depth`           cost volume, CostRegNet, soft-argmax
  point cloud     `build_scene_pointcloud`  back-projection + source variance
  scene volume    `model_scene`             voxelize, PointNet, scene U-Net
  refinement      `run_pointflow`           hypotheses, scene sampling, decoder
  upsampling      `upsample`                3 PropagationNets

`forward` is the training loss (the JAX package's `__call__`): deep
supervision with the masked MAE at every stage and a lambda weight on the
refinement passes. Inference is `infer_stages` / `infer_depth`. Where the
JAX package stops the gradient of a point set (the scene cloud's variance
and voxelization, the hypothesis points), the port detaches it.

`ModelConfig.dtype=torch.bfloat16` (inference and training) computes as
the JAX package's bf16 model: the parameters stay fp32 and
every convolution and linear layer casts its input and parameters to bf16
at use (`layers.set_compute_dtype`); the features, the cost volume, the
PointNet rows, the dense grid, the scene U-Net and the decoder are bf16;
the point variance, the cameras, the points, the soft-argmax (K8b) and the
propagation blend (K8a) take fp32, as there; the two convs whose output
is a softmax's logits (the cost volume's last, the decoder's) keep it in
fp32 (`layers._Cast.logits_fp32`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from tdvnet_torch.config import (DepthConfig, GridConfig, ModelConfig,
                                 set_fp32_numerics)
from tdvnet_torch.data.batch import FrameBatch
from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics, mae_loss
from tdvnet_torch.models.hypothesis import HypothesisDecoder, sample_scales
from tdvnet_torch.models.layers import set_compute_dtype
from tdvnet_torch.models.mvsnet import MVSNet
from tdvnet_torch.models.pointnet import PointNet
from tdvnet_torch.models.scene_unet import SceneUNet
from tdvnet_torch.models.upsampling import PropagationNet
from tdvnet_torch.ops import camera, costvolume, voxelize as vox
from tdvnet_torch.ops.sampling import resize_nearest


def hypothesis_points(depth_pred: torch.Tensor, K: torch.Tensor,
                      rotmats: torch.Tensor, tvecs: torch.Tensor,
                      img_size, offset: float, n: int = 3) -> torch.Tensor:
    """World points of the 2n+1 depth hypotheses d + i * offset (i = -n..n)
    along each pixel's ray of the ref views: depth_pred [R, h, w], the refs'
    K/rotmats/tvecs -> [R, 2n+1, h*w, 3]."""
    R, h, w = depth_pred.shape
    P = h * w
    dev = depth_pred.device
    grid = camera.build_img_grid(img_size, (h, w), dev)
    ray_cam = grid @ torch.linalg.inv(K).transpose(-1, -2)
    ray_world = ray_cam @ rotmats                                # R^T ray
    center = camera.camera_center(rotmats, tvecs)
    ivals = torch.arange(-n, n + 1, dtype=torch.float32, device=dev)
    dh = depth_pred.reshape(R, 1, P) + ivals[None, :, None] * offset
    return center[:, None, None, :] + ray_world[:, None, :, :] * dh[..., None]


@contextlib.contextmanager
def _module_mode(module: nn.Module, training: bool):
    """Train or eval mode for `module` inside the block, restored after."""
    before = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        yield
    finally:
        for m, mode in before:
            m.training = mode


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
        set_compute_dtype(self, c.dtype)

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
            pts.detach(), feats_quarter, batch.src_idx, batch.src_mask,
            batch.rotmats, batch.tvecs, batch.K, self.cfg.img_size,
            plane=tuple(depth_pred.shape[-2:]))
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
        vg = vox.voxelize(pts_flat.detach(), pt_scene, pt_valid, g.edge_len,
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
                      grid_cfg: Optional[GridConfig] = None,
                      patch_variance: bool = False,
                      decoder: Optional[nn.Module] = None):
        """Score 2n+1 depth-offset hypotheses per pixel; return the expected
        depth correction [R, h, w]. `patch_variance` samples the image
        variance of a pixel's whole hypothesis fan from one 4x4 patch per
        source (fast path); `decoder` replaces `self.decoder` (the fast
        path's projected decoder)."""
        g = grid_cfg or self.cfg.grid
        R, h, w = depth_pred.shape
        P = h * w
        H = 2 * n + 1
        B = batch.n_scenes
        n_ref = R // B
        ri = batch.ref_idx
        pts_hyp = hypothesis_points(depth_pred, batch.K[ri], batch.rotmats[ri],
                                    batch.tvecs[ri], self.cfg.img_size,
                                    offset, n).detach()          # [R, H, P, 3]
        ivals = torch.arange(-n, n + 1, dtype=torch.float32,
                             device=depth_pred.device)

        if patch_variance:
            var = costvolume.hypothesis_patch_variance(
                pts_hyp, feats_quarter, batch.src_idx, batch.src_mask,
                batch.rotmats, batch.tvecs, batch.K, self.cfg.img_size)
        else:
            var = costvolume.hypothesis_point_variance(
                pts_hyp.reshape(R, H * P, 3), feats_quarter, batch.src_idx,
                batch.src_mask, batch.rotmats, batch.tvecs, batch.K,
                self.cfg.img_size,
                plane=tuple(depth_pred.shape[-2:]))               # [R, HP, C]
        scene_feats = sample_scales(scales, pts_hyp.reshape(B, n_ref * H * P, 3),
                                    origins, g.edge_len)
        # as in the JAX package, the variance takes the scene features'
        # dtype before the concat (bf16 from the fast path's int8 tables
        # and from a bf16 model's grids) and the decoder casts its input to
        # its compute dtype: an fp32 model's widens to fp32 (float64, the
        # reference run on the card, stays float64), a bf16 model's convs
        # take bf16
        feats = torch.cat([scene_feats.reshape(R, H, P, -1),
                           var.reshape(R, H, P, -1).to(scene_feats.dtype)],
                          dim=-1)
        feats = feats.transpose(1, 2).reshape(R * P, H, -1)
        if self.cfg.dtype != torch.bfloat16:
            feats = feats.to(torch.promote_types(feats.dtype, torch.float32))
        probs = (decoder or self.decoder)(feats)                 # [RP, H]
        pred = (probs * (ivals * offset)[None, :]).sum(dim=-1)
        return pred.reshape(R, h, w)

    def run_pointflow_multi(self, scales, origins, depth_pred, feats_quarter,
                            batch: FrameBatch, offsets, n: int = 3,
                            grid_cfg: Optional[GridConfig] = None,
                            patch_variance: bool = False,
                            decoder: Optional[nn.Module] = None):
        """All of one refinement iteration's offset passes; the depth
        carries from pass to pass."""
        for off in offsets:
            depth_pred = depth_pred + self.run_pointflow(
                scales, origins, depth_pred, feats_quarter, batch, float(off),
                n, grid_cfg, patch_variance, decoder)
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

    # ------------------------------------------------------------- full model
    def forward(self, batch: FrameBatch, offsets: Sequence[float],
                n_iters: int, lam=1.0,
                depth_cfg: Optional[DepthConfig] = None,
                grid_cfg: Optional[GridConfig] = None,
                with_metrics: bool = True,
                backbone_train: Optional[bool] = None) -> Dict:
        """The training loss and its per-stage metrics (the JAX package's
        `__call__`): {"loss", "loss_2d" (the initial depth's), "initial",
        "ref" (one entry per refinement pass), "quarter", "half", "final",
        "depth_pred" [R, H, W], and "scene_stats" when n_iters >= 1}. Train
        or eval mode is the module's (`model.train()`), and picks the
        depth hypotheses of `depth_train` or `depth_test`.
        `backbone_train=False` keeps the backbone's BatchNorm in eval mode
        for the call, the reference's non-finetune regime; None follows the
        module's mode. The batch moves to the model's device."""
        set_fp32_numerics()
        c = self.cfg
        train = self.training
        dc = depth_cfg or (c.depth_train if train else c.depth_test)
        batch = batch.to(next(self.parameters()).device)
        w_ref = batch.ref_mask.to(torch.float32)
        gt = batch.depth_gt
        bb_train = train if backbone_train is None else backbone_train

        def supervise(pred):
            gt_s = resize_nearest(gt, pred.shape[-2:])
            loss = mae_loss(pred, gt_s, dc.depth_interval, w_ref)
            mets = {}
            if with_metrics:
                with torch.no_grad():
                    mets = calc_2d_depth_metrics(pred.detach(), gt_s, w_ref)
            mets["loss_2d"] = loss
            return loss, mets

        with _module_mode(self.mvsnet.backbone, train and bb_train):
            feats_half, feats_quarter, _ = self.extract_features(batch.images)
        depth_pred = self.initial_depth(batch, dc, feats_quarter)
        out: Dict = {"ref": []}
        loss, out["initial"] = supervise(depth_pred)
        out["loss_2d"] = loss
        total = loss
        for _ in range(n_iters):
            scales, origins, out["scene_stats"] = self.model_scene(
                depth_pred, feats_quarter, batch, grid_cfg)
            for off in offsets:
                depth_pred = depth_pred + self.run_pointflow(
                    scales, origins, depth_pred, feats_quarter, batch,
                    float(off), 3, grid_cfg)
                l_off, mets = supervise(depth_pred)
                total = total + lam * l_off
                out["ref"].append(mets)

        ri = batch.ref_idx
        stages = (("quarter", self.refine_quarter, feats_quarter),
                  ("half", self.refine_half, feats_half),
                  ("final", self.refine_full, batch.images))
        for key, net, guide in stages:
            depth_pred = net(guide[ri],
                             resize_nearest(depth_pred, guide.shape[1:3]))
            l_s, out[key] = supervise(depth_pred)
            total = total + l_s
        out["loss"] = total
        out["depth_pred"] = depth_pred
        return out

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
