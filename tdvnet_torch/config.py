"""Typed configuration of the port (a jax-free copy of `tdvnet/config.py`).

Four deviations from the JAX package's `ModelConfig`:
- `warp_mode` is only ``"gather"`` (the default here). The two-pass
  homography matmul warp is a TPU matrix-unit artifact and is not ported.
- `conv3d_impl` is gone: cuDNN runs the 3D convolutions.
- `feat_dim` is at most `MAX_FEAT_DIM` (3072): the PointNet pools 4 *
  feat_dim channels, and the pool kernel's long path holds a segment's
  running maxima in 48 KB of shared memory (`kernels/segmax.py`).

`TrainConfig` holds the training schedule; `EvalConfig` the fields
whole-scene inference and 3D evaluation read, the fast-path switches and
the fusion constants as plain data; `DataConfig` the dataset roots.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

# the largest feat_dim: the PointNet's pools take 4 * feat_dim channels, at
# most the 12288 floats of the pool kernel's 48 KB shared long path
MAX_FEAT_DIM = 3072
# the compute dtypes the port has (parameters stay fp32 in both)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        if self.feat_dim > MAX_FEAT_DIM:
            raise ValueError(
                f"ModelConfig.feat_dim={self.feat_dim}: the port takes at "
                f"most {MAX_FEAT_DIM}; the PointNet pools 4 * feat_dim "
                f"channels, and the pool kernel's long path holds a "
                f"segment's maxima in 48 KB of shared memory (12288 "
                f"floats)")
        if self.warp_mode != "gather":
            raise ValueError(
                f"warp_mode={self.warp_mode!r}: the port has only the exact "
                f"gather warp")
        if isinstance(self.dtype, str) and self.dtype in _DTYPE_NAMES:
            # a YAML file names the dtype
            object.__setattr__(self, "dtype", _DTYPE_NAMES[self.dtype])
        if self.dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"ModelConfig.dtype={self.dtype!r}: the port computes in "
                f"fp32 or bf16 only")

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


def check_bf16_fast_path(model_cfg: "ModelConfig", fast_path: bool) -> None:
    """The fast path has fp32 kernels only so far: K7 on bf16 features and
    K6-int8 packed from a bf16 grid come in a later slice (ROADMAP.md queue
    1 item 2c)."""
    if fast_path and model_cfg.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bf16 with the fast path: the port has it in fp32 only so far "
            "(ROADMAP.md queue 1 item 2c, the bf16 fast path)")


@dataclass(frozen=True)
class TrainConfig:
    """The training schedule (the JAX package's `TrainConfig`): Adam with a
    StepLR schedule, the lambda ramp on the refinement losses and the
    n_iters switch, or the finetune regime. `bf16_compute` trains a bf16
    model (`ModelConfig.dtype`; the parameters, gradients and Adam's state
    stay fp32), `remat` recomputes the forward in the backward (one
    checkpoint around the whole forward, as `jax.checkpoint` wraps it), and
    `grad_accum_steps` = k updates once every k microbatches with the mean
    of their gradients (`optax.MultiSteps`)."""

    lr: float = 1e-3
    lr_step: int = 100               # epochs between decays (StepLR)
    lr_gamma: float = 0.1
    finetune: bool = False
    finetune_lr: float = 1e-4
    finetune_lr_step: int = 50
    finetune_lr_gamma: float = 0.5
    offsets: Tuple[float, float, float] = (0.05, 0.05, 0.025)
    n_iters_early: int = 1           # refinement iters before the switch
    n_iters_late: int = 2
    iters_switch_epoch: int = 20
    lambda_ramp_epochs: int = 10     # lam = min(epoch, 10) * 0.1 unless finetune
    seed: int = 0
    log_every: int = 50
    ckpt_every_epochs: int = 1
    use_tensorboard: bool = True
    bf16_compute: bool = False
    remat: bool = False
    grad_accum_steps: int = 1
    loader_workers: int = 8          # the StreamingLoader's threads
    loader_prefetch: int = 3         # batches built ahead

    def __post_init__(self):
        if int(self.grad_accum_steps) != self.grad_accum_steps \
                or self.grad_accum_steps < 1:
            raise ValueError(f"TrainConfig.grad_accum_steps="
                             f"{self.grad_accum_steps!r}: a count of "
                             f"microbatches, at least 1")


@dataclass(frozen=True)
class DataConfig:
    """Dataset roots (the JAX package's `DataConfig`)."""

    scannet_dir: str = "/data/scannet"
    icl_nuim_dir: str = "/data/icl-nuim"
    tum_rgbd_dir: str = "/data/tum-rgbd"
    img_interval: int = 20           # frame selector search interval
    num_workers: int = 8


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: DataConfig = field(default_factory=DataConfig)
    ckpt_path: Optional[str] = None


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


def load_config(overrides: Optional[Dict[str, Any]] = None,
                yaml_path: Optional[str] = None) -> Config:
    """A Config with a YAML file's nested fields overlaid, then the
    `overrides` dict's. Reading YAML needs PyYAML, imported here only."""
    cfg = Config()
    if yaml_path is not None:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"load_config: reading {yaml_path} needs "
                              f"PyYAML, which is not installed") from e
        with open(yaml_path) as f:
            cfg = _overlay(cfg, yaml.safe_load(f) or {})
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
