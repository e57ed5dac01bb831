"""Typed configuration of the port (a jax-free copy of `tdvnet/config.py`).

Two deviations from the JAX package's `ModelConfig`:
- `warp_mode` is only ``"gather"`` (the default here). The two-pass
  homography matmul warp is a TPU matrix-unit artifact and is not ported.
- `conv3d_impl` is gone: cuDNN runs the 3D convolutions.

`EvalConfig` holds the fields whole-scene inference and 3D evaluation
read, the fast-path switches and the fusion constants as plain data;
`DataConfig` the dataset roots.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class DepthConfig:
    """Plane-sweep depth hypothesis space."""

    depth_start: float = 0.5
    depth_interval: float = 0.05
    n_intervals: int = 96
    size: Tuple[int, int] = (56, 56)  # (h, w) of the coarse depth map

    @property
    def depth_end(self) -> float:
        return self.depth_start + self.depth_interval * (self.n_intervals - 1)


@dataclass(frozen=True)
class GridConfig:
    """Static-shape budget for the scene feature volume."""

    edge_len: float = 0.08           # voxel edge in meters
    grid_size: Tuple[int, int, int] = (64, 64, 64)   # cells per scene
    max_anchors: int = 16384         # compact active-voxel capacity
    levels: int = 3                  # U-Net scales (strides 1, 2, 4)

    @property
    def n_cells(self) -> int:
        gx, gy, gz = self.grid_size
        return gx * gy * gz


@dataclass(frozen=True)
class ModelConfig:
    feat_dim: int = 32
    img_size: Tuple[int, int] = (256, 320)
    hyp_ksize: int = 3
    unet_dims: Tuple[int, int, int] = (64, 128, 128)
    unet_groups: Tuple[int, int, int] = (4, 8, 8)
    unet_res: Tuple[int, int, int] = (1, 2, 3)
    cost_base_channels: int = 8
    decoder_hidden: int = 128
    propagation_hidden: int = 32
    depth_train: DepthConfig = field(default_factory=DepthConfig)
    depth_test: DepthConfig = field(default_factory=DepthConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    dtype: Any = torch.float32
    warp_mode: str = "gather"

    def __post_init__(self):
        if self.warp_mode != "gather":
            raise ValueError(
                f"warp_mode={self.warp_mode!r}: the port has only the exact "
                f"gather warp")

    @property
    def n_hyp(self) -> int:
        return 7  # 2*3+1 hypotheses per pixel


@dataclass(frozen=True)
class BatchConfig:
    """Static-shape budget for a collated batch."""

    n_scenes: int = 2
    n_ref: int = 7
    n_src_on_either_side: int = 1
    img_size: Tuple[int, int] = (256, 320)
    depth_img_size: Tuple[int, int] = (256, 320)

    @property
    def n_views(self) -> int:
        return self.n_ref + 2 * self.n_src_on_either_side

    @property
    def n_imgs(self) -> int:
        return self.n_scenes * self.n_views

    @property
    def n_refs_total(self) -> int:
        return self.n_scenes * self.n_ref

    @property
    def n_src(self) -> int:
        return 2 * self.n_src_on_either_side + 1


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation constants (the JAX package's `EvalConfig`)."""

    dataset_type: str = "scannet"
    save_dir: str = "eval_results"
    pdist: float = 0.1               # keyframe pose-distance threshold
    n_src_on_either_side: int = 2
    z_thresh: float = 0.01           # point-cloud fusion consistency threshold
    n_consistent_thresh: int = 3     # views that must agree
    voxel_downsample: float = 0.02
    fscore_thresh: float = 0.05
    run_tsdf_fusion: bool = False
    run_pc_fusion: bool = True
    tsdf_img_batch: int = 100
    tsdf_voxel_size: float = 0.04
    tsdf_margin: float = 1.5
    tsdf_bounds_quantile: float = 0.995
    tsdf_trunc_ratio: float = 3.0
    depth_img_size: Tuple[int, int] = (480, 640)
    # whole-scene inference: one ref-chunk size for every stage; ref totals
    # bucket to multiples of it
    fused_chunk: int = 16
    eval_grid_size: Tuple[int, int, int] = (160, 160, 64)
    eval_max_anchors: int = 262144
    # size the scene grid to the scene bbox (rounded up to grid_bucket
    # multiples, capped at eval_grid_size with a warning when the cap clips)
    auto_grid: bool = True
    grid_bucket: int = 16
    # the fast path (off = the parity op mix): merged U-Net scales projected
    # onto the decoder's top `fast_rank` scene directions and sampled from
    # per-channel int8 tables, one fine offset pass in refinement iteration
    # 2, and with `fast_patch` the image variance of a pixel's whole
    # hypothesis fan from one 4x4 patch per source. The projection is off
    # when `fast_rank` reaches the decoder's scene-channel count.
    fast_path: bool = False
    fast_rank: int = 96
    fast_patch: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Dataset roots (the JAX package's `DataConfig`; its loader settings
    arrive with training)."""

    scannet_dir: str = "/data/scannet"
    icl_nuim_dir: str = "/data/icl-nuim"
    tum_rgbd_dir: str = "/data/tum-rgbd"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: DataConfig = field(default_factory=DataConfig)


def _overlay(dc, updates: Dict[str, Any]):
    """Recursively apply a nested dict of overrides to a dataclass tree."""
    changes = {}
    for k, v in updates.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key: {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            changes[k] = _overlay(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            changes[k] = tuple(v)
        else:
            changes[k] = v
    return dataclasses.replace(dc, **changes)


def load_config(overrides: Optional[Dict[str, Any]] = None) -> Config:
    cfg = Config()
    if overrides:
        cfg = _overlay(cfg, overrides)
    return cfg


def tiny_test_config() -> Config:
    """Small shapes for CPU tests (the JAX package's `tiny_test_config`)."""
    return load_config({
        "model": {
            "feat_dim": 8,
            "img_size": (64, 80),
            "unet_dims": (16, 24, 24),
            "unet_groups": (4, 4, 4),
            "unet_res": (1, 1, 1),
            "cost_base_channels": 4,
            "decoder_hidden": 16,
            "propagation_hidden": 8,
            "depth_train": {"n_intervals": 16, "size": (16, 16)},
            "depth_test": {"n_intervals": 16, "size": (16, 16)},
            "grid": {"grid_size": (16, 16, 16), "max_anchors": 2048},
        },
        "batch": {
            "n_scenes": 1,
            "n_ref": 3,
            "img_size": (64, 80),
            "depth_img_size": (64, 80),
        },
    })


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when no card is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_fp32_numerics() -> None:
    """The JAX parity path is fp32 throughout. cuDNN's default TF32 for
    float32 convolutions keeps about three decimal digits, so turn TF32 off
    for convolutions and matrix products alike."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
