"""Drive the PyTorch/CUDA port of tdvnet on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels with nvcc
     (seconds and the ptxas register/shared-memory summary);
  2. hold each kernel against its plain PyTorch twin at the shapes the main
     path gives it, and time kernel, twin and (where one exists) a single
     PyTorch library call with CUDA events; (b) the segment plan and
     K8b's backward at the edge inputs of `tests/_kernel_edge_cases.py`
     (the plan's and the pools'; the soft-argmax's, NaN and inf in the
     twin's places), K8b forward and backward past 384 planes (D = 392
     and 768 at [14, D, 56, 56]), its any-D form against the register
     form at D = 96 (the same bits), and K1 and K6 with their backward at
     channel counts that are not a multiple of 4, all counted 0 times;
     (c) the six bf16 forms (K1/K2, K6, K5, K4's pool and concat-back,
     K3's scatter) on the inputs one bf16 `infer_depth` of the golden
     batch gives them, each against its twin and its float64 referee;
  3. load the synth48 weights and run full-width `ThreeDVNet.infer_depth`
     on the golden batch (2 synthetic scenes x 9 views, 7 refs each), hold
     it against the JAX golden `tests/data/torch_golden_synth48.npz`, and
     check from the launch counters that every kernel ran on that path;
     (3') the same in bf16 (`ModelConfig(dtype=bfloat16)`, parameters
     fp32): its |bf16 - fp32| per stage against this run's fp32 one within
     1.5x JAX's own bf16 error (`tests/data/torch_golden_bf16_synth48.npz`),
     abs_rel and drop counters against JAX's bf16 run, and every bf16
     form launched;
  4. serve three more batches and time each; (4') the same in bf16;
  5. trace one more batch with torch.profiler: the device's busy share of
     the window, host and device time per stage span, the top kernels,
     and the device time of the port's own kernels;
  6. whole-scene inference, `FusedSceneInference` at the parity settings:
     (a) `predict_scene` on the golden scene against the JAX golden
     `tests/data/torch_golden_scene_synth48.npz` (depth, chosen grid, drop
     counters, launch counts); (b) `predict_scenes` over three scenes of 52
     views (48 refs, three chunks of 16), timed per scene; (a') the golden
     scene in bf16 against this run's fp32 one within 1.5x JAX's own bf16
     error, grid, counters and abs_rel against JAX's bf16 run, the bf16
     forms' launches; (b') the stream in bf16, timed beside (b); (c) one
     more scene traced as in phase 5;
  7. the same on the fast path (`EvalConfig(fast_path=True)`: merged,
     rank-96-projected int8 scene tables, patch-fan variance, the fast
     offsets): (a) against the JAX golden
     `tests/data/torch_golden_fastscene_synth48.npz` (depth, grid, drop
     counters, the projection's basis, launch counts); (b) the stream;
     (c) a trace;
  8. 3D evaluation on datasets written here (`data/synthetic_dataset.py`,
     52 views at 480x640, GT meshes fused on the card): (a) the 2D,
     fused-cloud and TSDF metrics of the golden scene's recipe predictions
     against the JAX golden `tests/data/torch_golden_eval3d_synth48.npz`
     (metrics, fused point count, GT mesh size, launch counts); (b)
     `harness.main` with the model's fast-path `pred_fn` over three scenes,
     per-stage shares, and a second call that reuses every cached file; (c)
     one scene's evaluation traced by stage span;
  9. training (`train.loop.make_train_step`, the non-finetune regime,
     from the synth48 weights on the golden batch): (a) the backward
     kernels against their twins at the train steps' shapes (n_iters=0:
     the cost volume's variance, the soft-argmax, the propagation blends;
     n_iters=1: the variance at the scene cloud and the hypotheses, the
     dense scatter, the pools and concat-backs, the masked GroupNorm, the
     scene sampling, on uniform points and on one offset pass of the golden
     batch's n_iters=1 step as it reaches the backward; the order-free
     ones also for the same bits on a second launch and with their points
     shuffled), and the source variance's kernel and fp32 twin against its
     twin in float64; (b'') two fresh runs of three n_iters=0 and three
     n_iters=1 steps whose every parameter, gradient, Adam moment,
     BatchNorm statistic and loss must repeat bit for bit (else the first
     leaf that moved, in backward order, is named); (b) three n_iters=0
     steps and three
     n_iters=1 steps (at the epoch-5 lambda) each against a float64 referee
     on the card and against its JAX golden
     (`tests/data/torch_golden_train_synth48.npz`,
     `tests/data/torch_golden_train_refine_synth48.npz`: losses, step 1's
     gradient norms per module and gradient leaves, BatchNorm running
     statistics, launch counts), with three faulty controls that the limits
     must see; (b') one n_iters=2 step against the referee, and two fresh
     n_iters=2 forwards whose every module output must repeat bit for
     bit (the referee's limits rest on it); (c) warm steps
     at n_iters 0, 1 and 2 timed, ref-frames/s trained, peak memory; (d)
     one n_iters=0 and one n_iters=1 step traced by span (train_forward,
     train_backward, train_optimizer); (e) `fit` with the default
     TrainConfig (n_iters=1 at epoch 0) for one epoch of two batches;
 10. the probe tools (`tdvnet_torch.tools.probe_batched_dot`,
     `probe_gather`): every case against its twin, timed beside the
     library call; then `batched_dot` at ragged shapes, `take_along_axis`
     on out-of-range indices (jnp.take_along_axis's rule: NaN, negative
     wrap) and under the sync debug mode "error";
 11. the command-line entry points, in this process: (a) `eval_3dvnet`
     from the synth48 `.npz` on the fast path over phase 8b's scenes,
     whose averaged 2D and fused-cloud metrics must equal phase 8b's (or
     hold within its limits); (b) `train_3dvnet --synthetic 2 --epochs 1`
     at the full-width config (finite losses, the epoch's checkpoint and
     `.npz` export, every training kernel launched, the backward's exactly
     once a step); (c) `export_weights` of (b)'s checkpoint, equal bit for
     bit to (b)'s export, then `eval_3dvnet` from it over phase 8a's
     scene (finite metrics); (a') `eval_3dvnet` and `eval_3dvnet --bf16`
     from the synth48 `.npz` over phase 8a's scene, the bf16 metrics
     within section 2's bf16 limits of the fp32 ones. Phase 8's folder
     lives until phase 11 ends.

Every trace (phases 5, 6c, 7c, 8c, 9d) also counts each port kernel's
wrapper calls beside its device kernels; the segment plan and K8b's
backward must show no more device kernels than calls (one a call), and
some where they were called. The line before the last is
the `kernels` JSON; the last line is the device JSON. Imports nothing of JAX; the port runs on the card only.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time

GOLDEN_SEEDS = (0, 1)
OFFSETS = ((0.05, 0.05, 0.025), (0.05, 0.05, 0.025))
# each served batch holds two synthetic scenes, seeds 2s and 2s + 1
SERVE_SEEDS = (2, 3, 4)

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "weights", "3dvnet_synth48.npz")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth48.npz")
SCENE_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_golden_scene_synth48.npz")
FAST_SCENE_GOLDEN = os.path.join(ROOT, "tests", "data",
                                 "torch_golden_fastscene_synth48.npz")
# the streamed scenes: 48 refs + 2 x 2 source-only views, three of them
STREAM_VIEWS = 52
STREAM_SEEDS = (7, 8, 9)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12          # H100 SXM, bf16 tensor cores, dense

# golden tolerances on the full path (see PERF.md): the card sums in
# another order than the JAX CPU run, and the golden's final depth is f16
INIT_MAX_REL = 1e-3
FINAL_MEDIAN_ABS = 1e-3
FINAL_P99_ABS = 1e-2
ABS_REL_DELTA = 2e-3
STREAM_ABS_REL_SLACK = 5e-3
# the fast path's basis V against the golden's, column by column up to sign
# (the same numpy SVD of the same weights)
FAST_V_ABS = 1e-4
# a kernel case's tolerance that asks for every element within one bf16 ulp
# of the larger of the two magnitudes
BF16_ULP = "bf16_ulp"

# 3D evaluation (phase 8): the golden scene, the recipe of its predictions
# (GT depth of refs k..n-k-1, nearest-resized to the model's resolution,
# with seeded multiplicative noise and dropped pixels so that the
# consistency test rejects some) and the EvalConfig overrides; the streamed
# harness scenes
EVAL3D_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_golden_eval3d_synth48.npz")
EVAL3D = {"scene": "synth_eval3d", "seed": 21, "n_views": 52,
          "hw": [480, 640], "pred_hw": [256, 320], "k": 2,
          "noise_sigma": 0.002, "drop": 0.05, "noise_seed": 0}
EVAL3D_EVAL = {"run_tsdf_fusion": True}
EVAL3D_STREAM_SEEDS = (22, 23, 24)
STREAM_DIR = "stream"    # phase 8b's scenes, under phase 8's folder
# refs per consistency-fusion chunk (`fuse_point_cloud`'s, and JAX's)
FUSION_REF_CHUNK = 16
# the golden's limits: metrics in metres and fractions, counts relative
EVAL3D_ABS = {"acc": 1e-4, "comp": 1e-4, "prec": 2e-3, "recal": 2e-3,
              "fscore": 2e-3}
EVAL3D_REL_2D = 1e-5
EVAL3D_COUNT_REL = 1e-3
EVAL3D_MESH_REL = 5e-3
# kernel against twin: TSDF weights equal on this share of voxels (tsdf and
# colour within 1e-5 where they agree), fusion keep flags on this share of
# pixels (points within 1e-5 m where both keep)
TSDF_WEIGHT_SHARE = 0.9999
FUSE_KEEP_SHARE = 0.999
K9_ABS = 1e-5

# training (phase 9): three n_iters=0 steps of `make_train_step` on the
# golden batch from the synth48 weights, held to the JAX golden (losses per
# step; step 1's gradient norm per module and the full gradient of three
# leaves; one CostRegNet BatchNorm's running statistics after the steps),
# then timed warm over TRAIN_TIMED steps and traced for one
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_golden_train_synth48.npz")
TRAIN_STEPS = 3
TRAIN_TIMED = 10
TRAIN_MODULES = ("mvsnet.backbone", "mvsnet.fpn", "mvsnet.cost_reg",
                 "pointnet", "scene_unet", "decoder", "refine_quarter",
                 "refine_half", "refine_full")
TRAIN_LEAVES = ("mvsnet.fpn.smooth1.weight",
                "mvsnet.cost_reg.ConvBnRelu_0.Conv_0.weight",
                "refine_full.ConvBnRelu_3.Conv_0.weight")
TRAIN_BN = "mvsnet.cost_reg.ConvBnRelu_0.BatchNorm_0"
# the n_iters=1 steps (phase 9b): the same batch, weights and step count,
# at the epoch-5 lambda (epoch 0's is 0, which would zero every refinement
# loss term), held to their own JAX golden; it adds one gradient leaf of
# each scene stage and the decoder's first BatchNorm
TRAIN_REFINE_GOLDEN = os.path.join(ROOT, "tests", "data",
                                   "torch_golden_train_refine_synth48.npz")
TRAIN_REFINE_EPOCH = 5
TRAIN_REFINE_LEAVES = TRAIN_LEAVES + (
    "pointnet.fc_pos.weight",
    "scene_unet.SparseResidual3d_0.MaskedConv3d_0.Conv_0.weight",
    "decoder.Conv_0.weight")
TRAIN_REFINE_BNS = (TRAIN_BN, "decoder.BatchNorm_0")
# limits against the float64 referee (each step's loss at the port's own
# parameters): losses relative per step; gradient norms and leaves
# relative (L2 for a leaf); running statistics relative to their largest;
# step 1's parameter update, per element, within TRAIN_UPDATE_REL of the lr
# plus one fp32 ulp of the parameter
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
TRAIN_STATS_REL = 1e-3
TRAIN_UPDATE_REL = 1e-3
ADAM_EPS = 1e-8
# the share of trained elements whose float64 gradient is noise-level (at
# most TRAIN_GRAD_REL of its leaf's largest) read 4.64% at full width
# (PERF.md, section 6); the optimizer check from the port's own gradients
# holds every element
TRAIN_NOISE_SHARE = 0.1
# the last cost conv's bias shifts every plane's cost alike, which the
# soft-argmax does not see, and the decoder's last conv bias (trained at
# n_iters >= 1) shifts every hypothesis's score alike, which its softmax
# does not see: their gradients are zero in exact arithmetic, and both
# sides' are rounding noise
ZERO_GRADS = ("mvsnet.cost_reg.Conv_0.bias", "decoder.Conv_3.bias")
# limits against the JAX golden, per step for the losses and per quantity
# for step 1's gradients ("" for the rest), each 1.3x to 2.5x the golden's
# own error: its fp32 step 1 is 9.9e-4 off a float64 rerun at the same
# parameters in the loss and 4e-5 to 1.03e-2 in the gradients (the largest
# behind the cost volume, whose first batch variance XLA's CPU sums put
# 2-4e-4 off), and its steps 2 and 3 drift 3.9e-3 and 2.9e-3 from the
# port's (PERF.md, section 6); the port's fp32 step is 5e-7 and 1e-5 to
# 8.4e-5 off the float64 referee, which holds it to its own precision
GOLDEN_LOSS_REL = (2.5e-3, 5e-3, 4e-3)
GOLDEN_GRAD_REL = {"": 4e-3, "mvsnet.cost_reg": 1.5e-2,
                   "mvsnet.fpn.smooth1.weight": 1e-2,
                   "mvsnet.cost_reg.ConvBnRelu_0.Conv_0.weight": 1e-2}
# the n_iters=1 steps against their JAX golden: each limit 1.8x to 2.3x
# the golden's own distance from the float64 referee at step 1 (read on
# the H100 80GB HBM3 at 700 W, beside each), and for steps 2 and 3 and the
# running statistics after them the port's distance from the golden (the
# two trajectories part after one Adam step). JAX's masked GroupNorm takes its
# variance in one pass in fp32, which puts its scene stages and everything
# upstream of them 5e-3 to 5e-2 off (PERF.md, section 6)
GOLDEN_REFINE_LOSS_REL = (6e-3,      # 3.27e-3
                          8e-3,      # 3.91e-3
                          1.3e-2)    # 6.55e-3
GOLDEN_REFINE_GRAD_REL = {
    "": 4e-3,
    "mvsnet.backbone": 1e-2,         # 4.87e-3
    "mvsnet.fpn": 4e-3,              # 1.76e-3
    "mvsnet.cost_reg": 2.5e-2,       # 1.24e-2
    "pointnet": 1.3e-2,              # 6.52e-3
    "scene_unet": 5e-2,              # 2.55e-2
    "decoder": 3e-2,                 # 1.46e-2
    "refine_quarter": 4e-3,          # 1.73e-3
    "refine_half": 1.6e-2,           # 8.07e-3
    "refine_full": 1.6e-2,           # 8.27e-3
    "decoder.Conv_0.weight": 5e-2,   # 2.71e-2
    "mvsnet.cost_reg.ConvBnRelu_0.Conv_0.weight": 2e-2,   # 1.09e-2
    "mvsnet.fpn.smooth1.weight": 3e-2,                    # 1.63e-2
    "pointnet.fc_pos.weight": 0.1,                        # 5.10e-2
    "refine_full.ConvBnRelu_3.Conv_0.weight": 7e-2,       # 3.56e-2
    "scene_unet.SparseResidual3d_0.MaskedConv3d_0.Conv_0.weight": 7e-2}
# the decoder's first BatchNorm after the three steps, 2.99e-3 off
GOLDEN_REFINE_STATS_REL = 6e-3
# the n_iters >= 1 steps against the float64 referee: TRAIN_GRAD_REL, but
# for the quantities behind the PointNet's max pools. The fp32 step's
# initial depth differs from float64's (1e-6 in the loss; it repeats bit
# for bit from run to run since the backward sums in fixed point, phase
# 9b''); the PointNet amplifies its points' rounding (1.8e-6 m) to 3.4e-3
# in its activations, and 167 to 301 of a pool's 5.6M (row, channel)
# maxima then sit on another row than in float64, which routes their
# gradient elsewhere. Readings of two runs on the H100 80GB HBM3 at 700 W
# (n_iters=1; n_iters=2 lower; PERF.md, section 6):
REFEREE_REFINE_GRAD_REL = {
    "": TRAIN_GRAD_REL,
    "pointnet": 4e-3,                                   # 1.2e-4, 1.3e-3
    "pointnet.fc_pos.weight": 8e-3,                     # 3.8e-3, 2.8e-3
    "scene_unet.SparseResidual3d_0.MaskedConv3d_0.Conv_0.weight": 3e-3,
    #                                                     1.4e-3, 9.2e-4
    "mvsnet.fpn.smooth1.weight": 2e-3}                  # 7.5e-4, 8.1e-4
# the epoch whose lambda the n_iters=2 step trains at: the switch epoch
TRAIN_LATE_EPOCH = 20
# controls: faults that the limits above must see. A loss-composition
# fault (the full-resolution stage's term counted 1% more), an optimizer
# fault (step 1's lr 1% off) and a BatchNorm fault (flax's momentum 0.9
# taken as torch's, the update weights swapped)
CONTROL_STAGE_WEIGHT = 1.01
CONTROL_LR = 1.01
# backward kernels against their twins, relative to the twin's largest
# magnitude; the variance backward's wider: the kernel's projection rounds
# apart from the twin's matmul (a tap's weight moves by an ulp of the
# coordinate), and it sums in another order (fixed point) than the twin's
# index_add_. Against the
# twin in float64 with float64 geometry the kernel is as close as the fp32
# twin (1.4e-5 to 3.4e-5 of the largest, both); kernel and twin read
# 2.4e-5 (cost volume), 4.1e-5 (scene cloud) and 2.3e-5 (hypotheses) apart
# on the H100 80GB HBM3 at 700 W (PERF.md, section 6)
BACKWARD_TOL = 1e-5
VARIANCE_BACKWARD_TOL = 6e-5
# a backward kernel that sums in fixed point (the same bits every run)
# against a twin whose sums run on float atomics in a run-dependent order
# (index_add_ on the card), where many terms meet in one element
ATOMIC_BACKWARD_TOL = 1e-4

# kernel -> (source, the TPU op it replaces, its wrappers in
# tdvnet_torch.kernels.WRAPPERS)
KERNEL_META = {
    "source_variance": ("tdvnet_torch/csrc/source_variance.cu",
                        "tdvnet/ops/costvolume.py:36", ("source_variance",)),
    "trilinear_sample": ("tdvnet_torch/csrc/trilinear_sample.cu",
                         "tdvnet/ops/sampling.py:199", ("trilinear_sample",)),
    "trilinear_sample_i8": ("tdvnet_torch/csrc/trilinear_sample_i8.cu",
                            "tdvnet/ops/sampling.py:306",
                            ("trilinear_sample_i8",)),
    "patch_fan_variance": ("tdvnet_torch/csrc/patch_fan_variance.cu",
                           "tdvnet/ops/costvolume.py:180",
                           ("patch_fan_variance",)),
    "propagation_blend": ("tdvnet_torch/csrc/propagation_blend.cu",
                          "tdvnet/kernels/depthops_pallas.py:83 (2df7997^)",
                          ("propagation_blend",)),
    "softargmax_depth": ("tdvnet_torch/csrc/softargmax_depth.cu",
                         "tdvnet/kernels/depthops_pallas.py:44 (2df7997^)",
                         ("softargmax_depth",)),
    "voxelize": ("tdvnet_torch/csrc/voxelize.cu", "tdvnet/ops/voxelize.py:60",
                 ("voxelize", "scatter_anchors_to_dense")),
    "segment_plan": ("tdvnet_torch/csrc/segment_plan.cu",
                     "tdvnet/models/pointnet.py:19 (the segments of "
                     "`_segmax`)", ("segment_plan",)),
    "segment_max": ("tdvnet_torch/csrc/segment_max.cu",
                    "tdvnet/models/pointnet.py:19",
                    ("segment_max", "gather_concat")),
    "masked_group_norm": ("tdvnet_torch/csrc/masked_group_norm.cu",
                          "tdvnet/models/layers.py:106",
                          ("masked_group_norm",)),
    "tsdf_integrate": ("tdvnet_torch/csrc/tsdf_integrate.cu",
                       "tdvnet/ops/tsdf.py:42", ("tsdf_integrate",)),
    "consistency_fuse": ("tdvnet_torch/csrc/consistency_fuse.cu",
                         "tdvnet/ops/fusion.py:47", ("consistency_fuse",)),
    "source_variance_backward": (
        "tdvnet_torch/csrc/source_variance_backward.cu",
        "tdvnet/ops/costvolume.py:36 (VJP)", ("source_variance_backward",)),
    "softargmax_depth_backward": (
        "tdvnet_torch/csrc/softargmax_depth_backward.cu",
        "tdvnet/kernels/depthops_pallas.py:44 (2df7997^, VJP)",
        ("softargmax_depth_backward",)),
    "propagation_blend_backward": (
        "tdvnet_torch/csrc/propagation_blend_backward.cu",
        "tdvnet/kernels/depthops_pallas.py:83 (2df7997^, VJP)",
        ("propagation_blend_backward",)),
    "scatter_dense_backward": (
        "tdvnet_torch/csrc/scatter_dense_backward.cu",
        "tdvnet/ops/voxelize.py:124 (VJP)",
        ("scatter_anchors_to_dense_backward",)),
    "segment_max_backward": (
        "tdvnet_torch/csrc/segment_max_backward.cu",
        "tdvnet/models/pointnet.py:19 (VJP)",
        ("segment_max_backward", "gather_concat_backward")),
    "masked_group_norm_backward": (
        "tdvnet_torch/csrc/masked_group_norm_backward.cu",
        "tdvnet/models/layers.py:106 (VJP)", ("masked_group_norm_backward",)),
    "trilinear_sample_backward": (
        "tdvnet_torch/csrc/trilinear_sample_backward.cu",
        "tdvnet/ops/sampling.py:199 (VJP)", ("trilinear_sample_backward",)),
    "batched_dot": ("tdvnet_torch/csrc/batched_dot.cu",
                    "tools/probe_mosaic_batched_dot.py:119",
                    ("batched_dot",)),
    "take_along_axis": ("tdvnet_torch/csrc/take_along_axis.cu",
                        "tools/probe_mosaic_gather.py:49",
                        ("take_along_axis",)),
    # the bf16 forms (bf16 inference): each its fp32 kernel's source,
    # templated on the storage
    "source_variance_bf16": ("tdvnet_torch/csrc/source_variance.cu",
                             "tdvnet/ops/costvolume.py:36 (bf16 features)",
                             ("source_variance_bf16",)),
    "trilinear_sample_bf16": ("tdvnet_torch/csrc/trilinear_sample.cu",
                              "tdvnet/ops/sampling.py:199 (bf16 grid)",
                              ("trilinear_sample_bf16",)),
    "voxelize_bf16": ("tdvnet_torch/csrc/voxelize.cu",
                      "tdvnet/ops/voxelize.py:124 (bf16 rows)",
                      ("scatter_anchors_to_dense_bf16",)),
    "segment_max_bf16": ("tdvnet_torch/csrc/segment_max.cu",
                         "tdvnet/models/pointnet.py:19 (bf16 rows)",
                         ("segment_max_bf16", "gather_concat_bf16")),
    "masked_group_norm_bf16": ("tdvnet_torch/csrc/masked_group_norm.cu",
                               "tdvnet/models/layers.py:106 (bf16)",
                               ("masked_group_norm_bf16",)),
    # the bf16 backward forms (bf16 training): each its fp32 backward
    # kernel's source, templated on the storage
    "source_variance_backward_bf16": (
        "tdvnet_torch/csrc/source_variance_backward.cu",
        "tdvnet/ops/costvolume.py:36 (VJP, bf16 features)",
        ("source_variance_backward_bf16",)),
    "trilinear_sample_backward_bf16": (
        "tdvnet_torch/csrc/trilinear_sample_backward.cu",
        "tdvnet/ops/sampling.py:199 (VJP, bf16 grid)",
        ("trilinear_sample_backward_bf16",)),
    "scatter_dense_backward_bf16": (
        "tdvnet_torch/csrc/scatter_dense_backward.cu",
        "tdvnet/ops/voxelize.py:124 (VJP, bf16 rows)",
        ("scatter_anchors_to_dense_backward_bf16",)),
    "segment_max_backward_bf16": (
        "tdvnet_torch/csrc/segment_max_backward.cu",
        "tdvnet/models/pointnet.py:19 (VJP, bf16 rows)",
        ("segment_max_backward_bf16", "gather_concat_backward_bf16")),
    "masked_group_norm_backward_bf16": (
        "tdvnet_torch/csrc/masked_group_norm_backward.cu",
        "tdvnet/models/layers.py:106 (VJP, bf16)",
        ("masked_group_norm_backward_bf16",)),
}


# kernels whose wrapper makes one device kernel a call: the traces hold
# them to it
ONE_KERNEL_A_CALL = ("segment_plan", "softargmax_depth_backward")


def group_norm_calls(unet_res):
    """(relu tails, skip tails) of the masked GroupNorm per U-Net level in
    one forward: a residual block has one of each; a level below the finest
    adds the down conv's; a level above the coarsest adds the up conv's and
    the merge conv's and runs its blocks a second time in the decoder."""
    L = len(unet_res)
    out = []
    for lvl, res in enumerate(unet_res):
        blocks = res * (2 if lvl < L - 1 else 1)
        out.append((blocks + (lvl > 0) + 2 * (lvl < L - 1), blocks))
    return out


def expected_launches(offsets_list, n_chunks, unet_res, fast_patch=False,
                      n_tables=None):
    """Launches per wrapper in one inference over `n_chunks` ref chunks
    (`infer_depth` is the one-chunk case), counted from the code: the cost
    volume per chunk; per refinement iteration one scene model (point
    cloud variance, voxelize, PointNet with one segment plan, 4 pools and
    3 concat-backs, scatter, U-Net) and per chunk and offset pass one variance and three
    scale samplings; three propagation blends per chunk. On the fast path
    (`n_tables`, the int8 tables left per iteration: 1 when the scales
    merge into one grid) each pass samples every table with
    `trilinear_sample_i8` in place of the three fp32 samplings, and with
    `fast_patch` takes its variance from `patch_fan_variance`. The 3D
    evaluation's kernels do not run in inference."""
    n_iters = len(offsets_list)
    pf = n_chunks * sum(len(o) for o in offsets_list)   # chunk passes
    gn = sum(a + b for a, b in group_norm_calls(unet_res))
    return {"tsdf_integrate": 0, "consistency_fuse": 0,
            "source_variance": n_chunks + n_iters + (0 if fast_patch else pf),
            "trilinear_sample": 3 * pf if n_tables is None else 0,
            "trilinear_sample_i8": 0 if n_tables is None else n_tables * pf,
            "patch_fan_variance": pf if fast_patch else 0,
            "propagation_blend": 3 * n_chunks,
            "softargmax_depth": n_chunks,
            "voxelize": n_iters, "scatter_anchors_to_dense": n_iters,
            "segment_plan": n_iters,
            "segment_max": 4 * n_iters, "gather_concat": 3 * n_iters,
            "masked_group_norm": gn * n_iters,
            "source_variance_backward": 0, "softargmax_depth_backward": 0,
            "propagation_blend_backward": 0, "batched_dot": 0,
            "take_along_axis": 0, "scatter_anchors_to_dense_backward": 0,
            "segment_max_backward": 0, "gather_concat_backward": 0,
            "masked_group_norm_backward": 0, "trilinear_sample_backward": 0}


def train_expected_launches(n_steps, n_iters=0, n_offsets=0, unet_res=(),
                            remat=False):
    """Launches per wrapper in `n_steps` train steps at `n_iters`, counted
    from the code: per step the forward's cost volume, soft-argmax and three
    propagation blends; per refinement iteration one scene cloud variance,
    one voxelize, one scatter, one segment plan, four pools, three
    concat-backs and the U-Net's GroupNorms; per offset pass one hypothesis
    variance and three scale samplings. Every one of them but the voxelize
    and the plan has its backward's launch too (neither takes a
    gradient). With `remat` the backward reruns the whole forward, whose
    launches count twice."""
    out = {w: 0 for w in expected_launches((), 1, ())}
    gn = sum(a + b for a, b in group_norm_calls(unet_res))
    forward = {"source_variance": 1 + n_iters * (1 + n_offsets),
               "softargmax_depth": 1, "propagation_blend": 3,
               "scatter_anchors_to_dense": n_iters,
               "segment_max": 4 * n_iters, "gather_concat": 3 * n_iters,
               "masked_group_norm": gn * n_iters,
               "trilinear_sample": 3 * n_iters * n_offsets}
    runs = 2 if remat else 1
    for k, n in forward.items():
        out[k] = runs * n * n_steps
        out[k + "_backward"] = n * n_steps
    out["voxelize"] = out["segment_plan"] = runs * n_iters * n_steps
    return out


# the backward wrappers whose bf16 form a bf16 train step launches instead
BF16_BACKWARD_OF = {
    "source_variance_backward": "source_variance_backward_bf16",
    "trilinear_sample_backward": "trilinear_sample_backward_bf16",
    "scatter_anchors_to_dense_backward":
        "scatter_anchors_to_dense_backward_bf16",
    "segment_max_backward": "segment_max_backward_bf16",
    "gather_concat_backward": "gather_concat_backward_bf16",
    "masked_group_norm_backward": "masked_group_norm_backward_bf16"}


def train_bf16_expected_launches(n_steps, n_iters=0, n_offsets=0,
                                 unet_res=(), remat=False):
    """(fp32 wrapper launches, bf16 form launches) in `n_steps` bf16 train
    steps: `train_expected_launches` with the six forwards and the six
    backwards that have a bf16 form moved to it; K8a, K8b (fp32 logits and
    costs), the voxelize and the plan stay."""
    fp = train_expected_launches(n_steps, n_iters, n_offsets, unet_res,
                                 remat)
    moved = {**BF16_OF, **BF16_BACKWARD_OF}
    bf = {moved[w]: fp[w] for w in moved}
    fp.update({w: 0 for w in moved})
    return fp, bf


def log(*args):
    print(*args, flush=True)


def fail(msg):
    """A verdict that ends the run: on standard output with the rest, and on
    standard error, where a caller that keeps only the errors sees it."""
    log(f"FAILED: {msg}")
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def golden_batch(seeds):
    from tdvnet_torch.config import BatchConfig
    from tdvnet_torch.data import batch as B, synthetic

    bc = BatchConfig()
    scenes = [synthetic.make_batch_scene(
        bc.n_views, bc.img_size, bc.depth_img_size, seed=s,
        n_src_on_either_side=bc.n_src_on_either_side) for s in seeds]
    return B.collate_scenes(scenes, bc.n_views, bc.n_ref,
                            bc.n_src_on_either_side)


# --------------------------------------------------------------- kernel cases
def bound_by(nbytes, flops):
    """Which of the card's two rates bounds work of this size."""
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations")


class Case:
    """One main-path call of a kernel: its wrapper and twin as closures over
    inputs on the card, which path makes the call ("infer_depth", "scene"
    for whole-scene inference of a 48-ref scene, or "fast" for the same on
    the fast path) and how often per inference, the bytes it must move and
    the flops it does, its tolerance (0: every output tensor equal;
    BF16_ULP: every element within one bf16 ulp), and where one exists a
    single PyTorch call computing the same function. `run` and `ref`
    return a tensor or a tuple of tensors. With `repeat`, a second launch
    must give the same bits; `shuffled`, where given, runs the kernel on
    the inputs with their points in another order and returns the result
    in the first order, which must be the same bits too. A kernel that
    culls work may give the bound over the work it leaves
    (`touched_bound_ms`) and a `note` on what it culled."""

    def __init__(self, kernel, label, per_infer, run, ref, tol, nbytes,
                 flops, library=None, path="infer_depth", repeat=False,
                 shuffled=None, touched_bound_ms=None, note=""):
        self.kernel, self.label, self.per_infer = kernel, label, per_infer
        self.run, self.ref, self.tol = run, ref, tol
        self.nbytes, self.flops, self.library = nbytes, flops, library
        self.path = path
        self.repeat, self.shuffled = repeat, shuffled
        self.touched_bound_ms, self.note = touched_bound_ms, note

    @property
    def bound_ms(self):
        return 1e3 * max(self.nbytes / HBM_BYTES_PER_S,
                         self.flops / FP32_FLOPS)


def scene_golden_record(path=SCENE_GOLDEN):
    import numpy as np

    with np.load(path) as z:
        return json.loads(str(z["record"]))


# the kernels whose main path is the fast whole-scene path, one scene's 3D
# evaluation, the n_iters=0 train step ("train"), the n_iters=1 train step
# ("train1") or the probe tools; the others' is infer_depth
MAIN_PATHS = {"trilinear_sample_i8": "fast", "patch_fan_variance": "fast",
              "tsdf_integrate": "eval3d", "consistency_fuse": "eval3d",
              "source_variance_backward": "train",
              "softargmax_depth_backward": "train",
              "propagation_blend_backward": "train",
              "scatter_dense_backward": "train1",
              "segment_max_backward": "train1",
              "masked_group_norm_backward": "train1",
              "trilinear_sample_backward": "train1",
              "batched_dot": "probe", "take_along_axis": "probe",
              **{k: "bf16" for k in ("source_variance_bf16",
                                     "trilinear_sample_bf16", "voxelize_bf16",
                                     "segment_max_bf16",
                                     "masked_group_norm_bf16")},
              # one bf16 n_iters=1 train step (phase 9h)
              **{k: "train_bf16" for k in (
                  "source_variance_backward_bf16",
                  "trilinear_sample_backward_bf16",
                  "scatter_dense_backward_bf16",
                  "segment_max_backward_bf16",
                  "masked_group_norm_backward_bf16")}}


def fast_cases(device, gen, inputs):
    """The fast path's kernels at one chunk pass (16 refs), counted per
    inference of the fast golden scene (its chunks x 4 passes, as phase 7a
    launches them): the patch-fan variance of a chunk's hypothesis fans and
    the int8 sampling of a merged, projected table at the chunk's
    hypothesis points (`inputs`: `time_variance.scene_inputs` of the first
    streamed scene's cameras and depths)."""
    import torch

    from tdvnet_torch.config import EvalConfig
    from tdvnet_torch.kernels import patch_fan_variance, trilinear_sample_i8
    from tdvnet_torch.kernels.patchfan import patch_fan_variance_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_i8_ref
    from tdvnet_torch.tools.time_pool_i8 import i8_bytes, i8_cases
    from tdvnet_torch.tools.time_variance import variance_bytes

    ev = EvalConfig()
    fan_args = inputs["patch_fan"]
    rec = scene_golden_record(FAST_SCENE_GOLDEN)
    per_scene = -(-rec["n_refs"] // ev.fused_chunk) * sum(
        len(o) for o in rec["offsets"])
    pts, feats, src_idx = fan_args[:3]
    R, Hh, P = pts.shape[:3]
    S = src_idx.shape[1]
    N, Hf, Wf, f = feats.shape
    cases = [Case(
        "patch_fan_variance", f"[{R},{Hh},{P},{f}] from [{N},{Hf},"
        f"{Wf},{f}] x {S} sources", per_scene,
        lambda a=fan_args: patch_fan_variance(*a),
        lambda a=fan_args: patch_fan_variance_ref(*a), 1e-5,
        variance_bytes(fan_args),
        R * S * Hh * P * (24 + 11 * f) + R * Hh * P * f * 4, path="fast")]

    # the int8 sampling of one fast chunk pass at C = fast_rank in a merged
    # table padded by 3 low-side nodes (`time_pool_i8.i8_cases`): counted on
    # the chunk's hypothesis points of the first streamed scene in the grid
    # sized for its cloud; on uniform queries over the golden scene's grid
    # and a margin around it, checked and timed, counted 0 times. The bound
    # counts the int8 nodes the taps touch
    for name, a in i8_cases(device, gen, inputs).items():
        grid, scale, pts_q, center0, cell, n_ch, off, c_off = a
        B, Q = pts_q.shape[:2]
        C = grid.shape[-1]
        out = torch.empty(B, Q, n_ch, dtype=torch.bfloat16, device=device)
        cases.append(Case(
            "trilinear_sample_i8", f"{name} int8 [1,{grid.shape[1]}x"
            f"{grid.shape[2]}x{grid.shape[3]},{C}] x {Q} queries",
            per_scene if name.startswith("hypothesis") else 0,
            lambda a=a, out=out: trilinear_sample_i8(
                *a[:5], out, a[6], cell_offset=a[7]),
            lambda a=a: trilinear_sample_i8_ref(*a[:5], cell_offset=a[7]),
            0.0, i8_bytes(a), Q * (30 + 17 * C), path="fast"))
    return cases


def scene_model_cases(device, gen, label, path, P, B, grid, A, unet, cloud):
    """The calls one scene modelling makes to the voxelize, segment-plan,
    segment-max and masked-GroupNorm kernels: P points of B scenes into
    `grid` with A anchors, on seeded random points in a box a little larger
    than the grid (some fall outside; a tenth are invalid); K4's counted
    calls on `cloud`, the (y, seg, valid, n_seg) of the main path's own
    cloud (`time_pool_i8.cloud_pool_cases`)."""
    import torch

    from tdvnet_torch.kernels import groupnorm, segmax, voxelize as vox

    n_iters = len(OFFSETS)
    edge = 0.08
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    span = torch.tensor([g * edge * 1.02 for g in grid])
    pts = (torch.rand(P, 3, generator=gen) * span).to(device).contiguous()
    scene = torch.arange(P, device=device) * B // P
    valid = (torch.rand(P, generator=gen) > 0.1).to(device)
    vargs = (pts, scene, valid, edge, grid, A, B)
    # every field but the twin's sorted view, which the kernel leaves out
    fields = lambda vg: tuple(vg[:7]) + tuple(vg[9:])
    n_cells = B * grid[0] * grid[1] * grid[2]
    cases = [Case(
        "voxelize", f"voxelize {label} P={P} grid={grid} A={A}", n_iters,
        lambda a=vargs: fields(vox.voxelize(*a)),
        lambda a=vargs: fields(vox.voxelize_ref(*a)),
        0.0, P * (12 + 8 + 1) + P * (8 + 1) + A * (24 + 8 + 12 + 1),
        P * 12, path=path)]

    vg = vox.voxelize(*vargs)
    C = 64
    feats = rnd(A, C)
    flat = (vg.anchor_idx3[:, 0] * grid[1] + vg.anchor_idx3[:, 1]) \
        * grid[2] + vg.anchor_idx3[:, 2]
    seg_a = (vg.anchor_scene * (n_cells // B) + flat)[vg.anchor_valid]
    feats_a = feats[vg.anchor_valid]
    # the library yardstick fills the dense grid with zeros, then writes
    # the valid anchors' rows. The bound counts what this data needs: every
    # anchor's valid flag, the valid anchors' cells and rows read once,
    # `dense` and `occ` written once
    n_valid = len(seg_a)
    cases.append(Case(
        "voxelize", f"scatter {label} [{A},{C}] -> {B}x{grid}", n_iters,
        lambda a=(feats, vg, grid, B): vox.scatter_anchors_to_dense(*a),
        lambda a=(feats, vg, grid, B): vox.scatter_anchors_to_dense_ref(*a),
        0.0, A + n_valid * (4 * C + 24 + 8) + n_cells * 4 * (C + 1), 0,
        library=lambda c=C: torch.zeros(n_cells, c, device=device)
        .index_put_((seg_a,), feats_a), path=path))

    # K4 on these uniform points (checked and timed, counted 0 times) and
    # on the main path's own cloud (`cloud`: the scene cloud at
    # ground-truth depth voxelized by K3 into this grid, counted)
    y = rnd(P, 128)
    cases += pool_cases(device, f"uniform {label}", path,
                        (y, vg.point2anchor, vg.point_valid, A + 1), 0)
    cases += pool_cases(device, f"cloud {label}", path, cloud, n_iters)

    dims_c, groups, res = unet
    for lvl, ((n_relu, n_skip), C, G) in enumerate(
            zip(group_norm_calls(res), dims_c, groups)):
        dims = tuple(d >> lvl for d in grid)
        V = dims[0] * dims[1] * dims[2]
        mask = (torch.rand(B, 1, *dims, generator=gen) > 0.85).float()
        if B > 1:
            mask[-1, :, dims[0] // 2:] = 0      # scenes differ in their count
        mask = mask.to(device)
        x = (rnd(B, C, *dims) * 2 + 1) * mask
        skip = rnd(B, C, *dims) * mask
        w, b = rnd(C), rnd(C)
        for tail, count, kw in (("relu", n_relu, {"relu": True}),
                                ("skip", n_skip, {"skip": skip})):
            a = (x, mask, G, w, b)
            n_in = 2 if tail == "skip" else 1
            cases.append(Case(
                "masked_group_norm",
                f"{tail} {label} [{B},{C},{dims[0]}x{dims[1]}x{dims[2]}] "
                f"G={G}", count * n_iters,
                lambda a=a, kw=kw: groupnorm.masked_group_norm(*a, **kw),
                lambda a=a, kw=kw: groupnorm.masked_group_norm_ref(*a, **kw),
                1e-4, 4 * (B * C * V * (n_in + 1) + B * V + 2 * C),
                B * C * V * 8, path=path))
    return cases


def plan_check(got, want):
    """The segment plan against its twin: the same offsets, each segment's
    rows the same set (their order within a segment is the kernel's own),
    the same long segments in any order, the same work partition (equal
    `time_pool_i8.plan_digest`s). Returns (0, ok)."""
    from tdvnet_torch.tools.time_pool_i8 import plan_digest

    return 0.0, plan_digest(got) == plan_digest(want)


def pool_cases(device, label, path, args, n_iters):
    """The PointNet's K4 calls on one input (y, seg, valid, n_seg): its
    segment plan, a pool through it (`scatter_reduce` as the library
    yardstick) and a concat-back on the pool's output, counted per
    inference of `path` as `PointNet` makes them (one plan, four pools,
    three concat-backs an iteration). The bounds count what each call
    moves (`time_pool_i8`): the plan the ids, flags, offsets and row list;
    a pool the counted rows of y, its output and the plan; a concat-back
    y, the pooled rows the points name and its output."""
    import torch

    from tdvnet_torch.kernels import segmax
    from tdvnet_torch.tools.time_pool_i8 import (concat_bytes, plan_bytes,
                                                 pool_bytes)

    y, seg, valid, n_seg = args
    P, C = y.shape
    plan = segmax.segment_plan(seg, valid, n_seg)
    pooled = segmax.segment_max(y, seg, valid, n_seg, plan)
    idx = seg.clamp(0, n_seg - 1)[:, None].expand(P, C).contiguous()
    yv = torch.where(valid[:, None], y, torch.full_like(y, -1e30))
    pool0 = torch.full((n_seg, C), -1e30, device=device)
    return [
        Case("segment_plan", f"plan {label} [{P}] -> {n_seg} segments",
             n_iters, lambda: segmax.segment_plan(seg, valid, n_seg),
             lambda: segmax.segment_plan_ref(seg, valid, n_seg), plan_check,
             plan_bytes(seg, valid, n_seg), 0, path=path),
        Case("segment_max", f"pool {label} [{P},{C}] -> [{n_seg},{C}]",
             4 * n_iters,
             lambda: segmax.segment_max(y, seg, valid, n_seg, plan),
             lambda: segmax.segment_max_ref(y, seg, valid, n_seg), 0.0,
             pool_bytes(y, seg, valid, n_seg), P * C,
             library=lambda: pool0.scatter_reduce(0, idx, yv, "amax"),
             path=path, repeat=True),
        Case("segment_max", f"concat-back {label} [{P},{C}] -> "
             f"[{P},{2 * C}]", 3 * n_iters,
             lambda: segmax.gather_concat(y, pooled, seg, relu=True),
             lambda: segmax.gather_concat_ref(y, pooled, seg, relu=True),
             0.0, concat_bytes(y, pooled, seg), P * 2 * C, path=path)]


def nonfinite_tol(tol):
    """A tolerance for outputs with NaN and inf: NaN and each signed inf
    where the twin has them, the rest within `tol` of the twin's largest
    finite magnitude (at least 1). Returns (max |d| over the finite
    places, ok)."""
    import torch

    def check(got, want):
        ok = all(torch.equal(f(got), f(want)) for f in (
            torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(want) & torch.isfinite(got)
        if not fin.any():
            return 0.0, ok
        d = float((got[fin].double() - want[fin].double()).abs().max())
        scale = max(1.0, float(want[fin].abs().max()))
        return d, ok and d <= tol * scale

    check.__name__ = f"nonfinite {tol}"
    return check


def edge_cases(device):
    """The segment plan and K8b's backward on the edge inputs of
    `tests/_kernel_edge_cases.py` (the plan's and the pools'; the
    soft-argmax's, with the twin's depths), against their twins, counted 0
    times on every path; K8b's backward also the same bits on a second
    launch."""
    import torch

    from tdvnet_torch.kernels import segmax, softargmax_depth_backward
    from tdvnet_torch.kernels.softargmax import softargmax_depth_backward_ref
    from tdvnet_torch.tools.time_depthops import (backward_edge_inputs,
                                                  edge_module,
                                                  softargmax_backward_cost)
    from tdvnet_torch.tools.time_pool_i8 import plan_bytes

    E = edge_module()
    up = lambda a: torch.from_numpy(a).to(device)
    plans = {name: E.plan_case(name) for name, *_ in E.PLAN_CASES}
    plans.update({name: E.pool_case(name, 4)[1:] for name, *_ in
                  E.POOL_CASES})
    cases = []
    for name, (seg, valid, n_seg) in plans.items():
        seg, valid = up(seg), up(valid)
        cases.append(Case(
            "segment_plan", f"edge {name} [{len(seg)}] -> {n_seg} segments",
            0, lambda a=(seg, valid, n_seg): segmax.segment_plan(*a),
            lambda a=(seg, valid, n_seg): segmax.segment_plan_ref(*a),
            plan_check, plan_bytes(seg, valid, n_seg), 0))
    for name, args in backward_edge_inputs(device).items():
        cases.append(Case(
            "softargmax_depth_backward", f"{name} {list(args[1].shape)}", 0,
            lambda a=args: softargmax_depth_backward(*a),
            lambda a=args: softargmax_depth_backward_ref(*a),
            nonfinite_tol(BACKWARD_TOL), *softargmax_backward_cost(args[1]),
            path="train", repeat=True))
    return cases + shape_limit_cases(device)


def shape_limit_cases(device, seed=4):
    """The shapes the kernels once refused: K8b past the register form's
    384 planes (D = 392 and 768 at the batch's [14, D, 56, 56], forward and
    backward, against the twins), the any-D form against the register form
    at the main path's D = 96 (the same bits: tolerance 0, the "plain" time
    the register form's), and K1 and K6 at channel counts that are not a
    multiple of 4 (K6's forward takes one channel a lane, the others'
    wrappers pad to whole 4-channel groups and slice): the cost volume's
    variance and its backward at C = 30, the finest
    U-Net scale's sampling into a 126-wide output and its grid backward at
    C = 62, beside the main path's 32 and 64. Counted 0 times on every
    path."""
    import torch

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import (source_variance, softargmax,
                                      trilinear_sample,
                                      trilinear_sample_backward)
    from tdvnet_torch.kernels.trilinear import (
        trilinear_sample_backward_ref, trilinear_sample_ref)
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera
    from tdvnet_torch.tools.time_depthops import (plane_inputs,
                                                  softargmax_backward_cost,
                                                  softargmax_cost)
    from tdvnet_torch.tools.time_k6_backward import backward_bytes
    from tdvnet_torch.tools.time_sampling_gn import (batch_hypothesis_points,
                                                     k6_bytes)

    S = softargmax
    cases = []
    for name, (grad, cost, dv, depth) in plane_inputs(device).items():
        cases.append(Case(
            "softargmax_depth", name, 0,
            lambda a=(cost, dv): S.softargmax_depth(*a),
            lambda a=(cost, dv): S.softargmax_depth_ref(*a),
            1e-5, *softargmax_cost(cost), repeat=True))
        args = (grad, cost, dv, depth)
        cases.append(Case(
            "softargmax_depth_backward", name, 0,
            lambda a=args: S.softargmax_depth_backward(*a),
            lambda a=args: S.softargmax_depth_backward_ref(*a),
            nonfinite_tol(BACKWARD_TOL), *softargmax_backward_cost(cost),
            path="train", repeat=True))
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    cfg = ModelConfig()
    dc = cfg.depth_train
    cost = (rnd(14, dc.n_intervals, *dc.size) * 3).contiguous()
    dv = camera.linspace_f32(dc.depth_start, dc.depth_end, dc.n_intervals,
                             device)
    depth = S.softargmax_depth_ref(cost, dv)
    label = f"any-D form vs registers {list(cost.shape)}"
    cases.append(Case(
        "softargmax_depth", label, 0,
        lambda a=(cost, dv): S._softargmax_depth(*a, long_form=True),
        lambda a=(cost, dv): S._softargmax_depth(*a), 0.0,
        *softargmax_cost(cost)))
    args = (rnd(14, *dc.size), cost, dv, depth)
    cases.append(Case(
        "softargmax_depth_backward", label, 0,
        lambda a=args: S._softargmax_depth_backward(*a, long_form=True),
        lambda a=args: S._softargmax_depth_backward(*a), 0.0,
        *softargmax_backward_cost(cost), path="train"))

    # K1 and its backward at the cost volume with 30 channels
    b = golden_batch(GOLDEN_SEEDS).to(device)
    R, Sn = b.src_idx.shape
    H, W = cfg.img_size
    C = 30
    feats = rnd(b.n_imgs, H // 4, W // 4, C).contiguous()
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs).contiguous()
    ri = b.ref_idx
    pts = camera.plane_sweep_points(
        dc.depth_start, dc.depth_interval, dc.n_intervals, b.rotmats[ri],
        b.tvecs[ri], b.K[ri], cfg.img_size, dc.size).contiguous()
    P = pts.shape[1]
    args = (pts, feats, b.src_idx, b.src_mask, P_all, cfg.img_size)
    active = float(b.src_mask.sum())
    shape = f"[{R},{dc.n_intervals}*{dc.size[0]}*{dc.size[1]},{C}]"
    cases.append(Case(
        "source_variance", f"C={C} cost volume {shape}", 0,
        lambda a=args: source_variance(*a, dc.size),
        lambda a=args: source_variance_ref(*a), 1e-4,
        4 * (pts.numel() + feats.numel() + R * P * C + P_all.numel()
             + R * Sn * 3),
        active * P * (24 + 11 * C) + R * P * C * 4))
    _, mean = source_variance_ref(*args, with_mean=True)
    cases.append(variance_backward_case(
        f"C={C} cost volume {shape}", 0,
        (rnd(R, P, C), mean, pts, feats, b.src_idx, b.src_mask, P_all,
         cfg.img_size), "train", shuffled_points(), plane=dc.size))

    # K6 and its grid backward at the finest scale with 62 channels
    pts_q, center0 = batch_hypothesis_points(device)
    B, Q = pts_q.shape[:2]
    C = 62
    dims = cfg.grid.grid_size
    cell = cfg.grid.edge_len
    grid = rnd(B, *dims, C).contiguous()
    out = torch.empty(B, Q, C + 64, device=device)
    shape = f"[{B},{dims[0]}x{dims[1]}x{dims[2]},{C}] x {Q} queries"
    cases.append(Case(
        "trilinear_sample", f"C={C} hyp s=1 {shape}", 0,
        lambda a=(grid, pts_q, center0, cell, out, 0):
            trilinear_sample(*a)[..., :C],
        lambda a=(grid, pts_q, center0, cell): trilinear_sample_ref(*a),
        1e-5, k6_bytes((grid, pts_q, center0, cell, C + 64, 0)),
        B * Q * (30 + 16 * C)))
    # the hypotheses crowd near the surfaces: the twin sums in float64 on
    # the fp32 coordinates and weights (an fp32 `index_add_` on the card
    # sums in a run-dependent order)
    targs = (rnd(B, Q, C), pts_q, center0, cell, tuple(grid.shape))
    cases.append(Case(
        "trilinear_sample_backward", f"C={C} hyp s=1 {shape}", 0,
        lambda a=targs: trilinear_sample_backward(*a),
        lambda a=targs: trilinear_sample_backward_ref(
            a[0].double(), *a[1:]).float(), BACKWARD_TOL,
        backward_bytes(targs[0], pts_q, targs[4]), B * Q * (30 + 16 * C),
        path="train1", repeat=True))
    return cases


def sampling_cases(device, gen, label, B, dims0, pts_q, center0, per_infer,
                   path):
    """The fp32 scene sampling's three U-Net scales (seeded grids of
    `dims0` / stride nodes) at the points pts_q [B, Q, 3], each written into
    its channel slice of a [B, Q, sum C] output, with `F.grid_sample` at the
    same points as the library yardstick. The byte bound counts the grid
    nodes that the points' taps touch, not the whole grid."""
    import torch
    import torch.nn.functional as F

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import trilinear_sample
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.tools.time_sampling_gn import k6_bytes

    cfg = ModelConfig()
    edge = cfg.grid.edge_len
    Q = pts_q.shape[1]
    n_ch = sum(cfg.unet_dims)
    cases, off = [], 0
    for stride, C in zip((1, 2, 4), cfg.unet_dims):
        dims = tuple(d // stride for d in dims0)
        grid = torch.randn(B, *dims, C, generator=gen).to(device).contiguous()
        cell = stride * edge
        out = torch.empty(B, Q, n_ch, device=device)
        # grid_sample on 5-D input: [B, C, X, Y, Z] with (z, y, x) coords
        # normalised with align_corners=True
        qn = (pts_q - center0[:, None, :]) / cell
        lim = torch.tensor([d - 1 for d in dims], device=device,
                           dtype=torch.float32)
        gs_grid = (qn / lim * 2 - 1).flip(-1).reshape(B, Q, 1, 1, 3)
        gs_in = grid.permute(0, 4, 1, 2, 3)
        cases.append(Case(
            "trilinear_sample", f"{label} s={stride} [{B},{dims[0]}x"
            f"{dims[1]}x{dims[2]},{C}] x {Q} queries", per_infer,
            lambda a=(grid, pts_q, center0, cell, out, off), c=C:
                trilinear_sample(*a)[..., a[5]:a[5] + c],
            lambda a=(grid, pts_q, center0, cell):
                trilinear_sample_ref(*a),
            1e-5, k6_bytes((grid, pts_q, center0, cell, n_ch, off)),
            B * Q * (30 + 16 * C),
            library=lambda a=(gs_in, gs_grid): F.grid_sample(
                a[0], a[1], mode="bilinear", padding_mode="zeros",
                align_corners=True), path=path))
        off += C
    return cases


def kernel_cases(device, seed=0):
    """The calls the full-width main path makes, on the golden batch's
    cameras, with seeded random features, grids, logits and costs; and the
    calls whole-scene inference makes to the scene-modelling kernels at the
    golden scene's size."""
    import torch

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import (propagation_blend, softargmax_depth,
                                      source_variance)
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera
    from tdvnet_torch.tools.time_sampling_gn import batch_hypothesis_points

    cfg = ModelConfig()
    dc, g = cfg.depth_test, cfg.grid
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    b = golden_batch(GOLDEN_SEEDS).to(device)
    R, S = b.src_idx.shape
    N = b.n_imgs
    H, W = cfg.img_size
    f = cfg.feat_dim
    feats = rnd(N, H // 4, W // 4, f).contiguous()
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs).contiguous()
    active = float(b.src_mask.sum())        # real (ref, source) pairs
    ri = b.ref_idx
    cases = []

    # source_variance at its three main-path shapes: the cost volume (D
    # planes), the scene point cloud (1 plane) and pointflow (7 hypotheses)
    hw = f"{dc.size[0]}*{dc.size[1]}"
    for label, planes, per_infer in (
            (f"cost volume [{R},{dc.n_intervals}*{hw},{f}]", dc.n_intervals, 1),
            (f"scene cloud [{R},{hw},{f}]", 1, 2),
            (f"pointflow [{R},7*{hw},{f}]", 7, 6)):
        interval = dc.depth_interval * (dc.n_intervals - 1) / max(planes - 1, 1)
        pts = camera.plane_sweep_points(
            dc.depth_start, interval, planes, b.rotmats[ri], b.tvecs[ri],
            b.K[ri], cfg.img_size, dc.size).contiguous()
        P = pts.shape[1]
        args = (pts, feats, b.src_idx, b.src_mask, P_all, cfg.img_size)
        nbytes = 4 * (pts.numel() + feats.numel() + R * P * f + P_all.numel()
                      + R * S * 3)
        plane = dc.size
        flops = (active / R) * R * P * (24 + 11 * f) + R * P * f * 4
        cases.append(Case("source_variance", label, per_infer,
                          lambda a=args, pl=plane: source_variance(*a, pl),
                          lambda a=args: source_variance_ref(*a),
                          1e-4, nbytes, flops))

    # trilinear_sample: the three U-Net scales at the pointflow queries of
    # the golden batch at its ground-truth depth, the grid at its scene
    # cloud's minimum (the main path's run of queries); and at uniform
    # points over the grid and a margin around it (the out-of-grid taps),
    # checked and timed beside them but not counted per inference
    B = b.n_scenes
    Q = (R // B) * 7 * dc.size[0] * dc.size[1]
    edge = g.edge_len
    extent = g.grid_size[0] * edge
    origins = rnd(B, 3) * 0.1
    center0 = (origins + 0.5 * edge).contiguous()
    # queries over the grid and a margin around it, so some fall outside
    pts_q = (origins[:, None, :] - 0.3
             + torch.rand(B, Q, 3, generator=gen).to(device) * (extent + 0.6)
             ).contiguous()
    cases += sampling_cases(device, gen, "scale", B, g.grid_size, pts_q,
                            center0, 0, "infer_depth")
    cases += sampling_cases(device, gen, "hyp", B, g.grid_size,
                            *batch_hypothesis_points(device), 6,
                            "infer_depth")

    # propagation_blend at the three upsampling sizes; the logits are the
    # NCHW output of a conv handed over as an [N, H, W, 9] view
    for h, w in ((H // 4, W // 4), (H // 2, W // 2), (H, W)):
        logits = rnd(R, 9, h, w).permute(0, 2, 3, 1)
        depth = (1.0 + torch.rand(R, h, w, generator=gen) * 3).to(device)
        nbytes = 4 * R * h * w * 11
        cases.append(Case(
            "propagation_blend", f"[{R},{h},{w},9]", 1,
            lambda a=(logits, depth): propagation_blend(*a),
            lambda a=(logits, depth): propagation_blend_ref(*a),
            1e-5, nbytes, R * h * w * 45))

    # softargmax_depth over the regularised cost volume
    D = dc.n_intervals
    cost = (rnd(R, D, *dc.size) * 3).contiguous()
    dvals = camera.linspace_f32(dc.depth_start, dc.depth_end, D, device)
    cases.append(Case(
        "softargmax_depth", f"[{R},{D},{dc.size[0]},{dc.size[1]}]", 1,
        lambda a=(cost, dvals): softargmax_depth(*a),
        lambda a=(cost, dvals): softargmax_depth_ref(*a),
        1e-5, 4 * (cost.numel() + D + R * dc.size[0] * dc.size[1]),
        cost.numel() * 5))

    # scene modelling at infer_depth's size and at the whole scene's: the
    # streamed scenes' refs, bucketed up to whole chunks, into the grid the
    # golden scene gets
    from tdvnet_torch.config import EvalConfig

    # K4 counted on the main path's clouds: the golden batch's and the
    # first streamed scene's scene clouds at ground-truth depth, voxelized
    # by K3 into the grids the main path gives them (its own generator, so
    # the other cases' inputs stay as they were)
    from tdvnet_torch.tools.time_pool_i8 import cloud_pool_cases
    from tdvnet_torch.tools.time_variance import scene_inputs

    g2 = torch.Generator().manual_seed(seed + 11)
    clouds = cloud_pool_cases(device, g2, scene_inputs(device, g2))
    unet = (cfg.unet_dims, cfg.unet_groups, cfg.unet_res)
    P_ref = dc.size[0] * dc.size[1]
    cases += scene_model_cases(device, gen, "infer_depth", "infer_depth",
                               R * P_ref, B, g.grid_size, g.max_anchors, unet,
                               clouds["cloud/infer_depth"])
    ev, rec = EvalConfig(), scene_golden_record()
    n_refs = STREAM_VIEWS - 2 * ev.n_src_on_either_side
    n_slots = -(-n_refs // ev.fused_chunk) * ev.fused_chunk
    cases += scene_model_cases(device, gen, "scene", "scene",
                               n_slots * P_ref, 1, tuple(rec["grid_size"]),
                               ev.eval_max_anchors, unet,
                               clouds["cloud/scene"])
    scene, inputs = scene_cases(device, gen)
    return cases + scene + fast_cases(device, gen, inputs) \
        + eval3d_cases(device)


def scene_cases(device, gen):
    """The calls whole-scene inference makes per 52-view stream scene to the
    source variance (a 16-ref chunk's cost volume and PointFlow pass, the
    48-ref scene cloud, on the first streamed scene's cameras and
    ground-truth depths: `time_variance.scene_inputs`), to the fp32 scene
    sampling (one chunk pass's three U-Net scales in the golden scene's
    grid), and to the propagation blend and the soft-argmax (a chunk), each
    counted per inference of that scene as `expected_launches` counts them.
    Also returns those inputs for the fast path's cases."""
    import torch

    from tdvnet_torch.config import EvalConfig, ModelConfig
    from tdvnet_torch.kernels import (propagation_blend, softargmax_depth,
                                      source_variance)
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera
    from tdvnet_torch.tools.time_sampling_gn import scene_hypothesis_points
    from tdvnet_torch.tools.time_variance import scene_inputs, variance_bytes

    cfg, ev = ModelConfig(), EvalConfig()
    dc = cfg.depth_test
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    n_refs = STREAM_VIEWS - 2 * ev.n_src_on_either_side
    n_chunks = -(-n_refs // ev.fused_chunk)
    n_iters = len(OFFSETS)
    pf = n_chunks * sum(len(o) for o in OFFSETS)
    per_scene = {"cost_volume": n_chunks, "pointflow": pf,
                 "scene_cloud": n_iters}
    inputs = scene_inputs(device, gen)
    cases = []
    for name, per in per_scene.items():
        args = inputs[name]
        pts, feats, src_idx = args[:3]
        R, P = pts.shape[:2]
        S, f = src_idx.shape[1], feats.shape[-1]
        cases.append(Case(
            "source_variance", f"{name} [{R},{P},{f}] x {S} sources", per,
            lambda a=args, pl=(1, P): source_variance(*a, pl),
            lambda a=args: source_variance_ref(*a), 1e-4,
            variance_bytes(args),
            R * S * P * (24 + 11 * f) + R * P * f * 4, path="scene"))

    # one chunk pass's three U-Net scales (B = 1): at the chunk's
    # hypothesis points in the grid `FusedSceneInference` sizes for the
    # scene's cloud, counted per scene; and at uniform queries over the
    # golden scene's grid and a margin around it, checked and timed beside
    rec = scene_golden_record()
    R = ev.fused_chunk
    P = dc.size[0] * dc.size[1]
    Q = R * 7 * P
    edge = cfg.grid.edge_len
    dims0 = tuple(rec["grid_size"])
    origin = rnd(1, 3) * 0.1
    center0 = (origin + 0.5 * edge).contiguous()
    extent = torch.tensor(dims0, dtype=torch.float32, device=device) * edge
    pts_q = (origin[:, None, :] - 0.3
             + torch.rand(1, Q, 3, generator=gen).to(device) * (extent + 0.6)
             ).contiguous()
    cases += sampling_cases(device, gen, "scene", 1, dims0, pts_q, center0,
                            0, "scene")
    pts_h, c0_h, dims_h = scene_hypothesis_points(inputs)
    cases += sampling_cases(device, gen, "scene hyp", 1, dims_h, pts_h, c0_h,
                            pf, "scene")

    # a chunk's propagation blends and soft-argmax
    H, W = cfg.img_size
    for h, w in ((H // 4, W // 4), (H // 2, W // 2), (H, W)):
        logits = rnd(R, 9, h, w).permute(0, 2, 3, 1)
        depth = (1.0 + torch.rand(R, h, w, generator=gen) * 3).to(device)
        cases.append(Case(
            "propagation_blend", f"scene [{R},{h},{w},9]", n_chunks,
            lambda a=(logits, depth): propagation_blend(*a),
            lambda a=(logits, depth): propagation_blend_ref(*a),
            1e-5, 4 * R * h * w * 11, R * h * w * 45, path="scene"))
    D = dc.n_intervals
    cost = (rnd(R, D, *dc.size) * 3).contiguous()
    dvals = camera.linspace_f32(dc.depth_start, dc.depth_end, D, device)
    cases.append(Case(
        "softargmax_depth", f"scene [{R},{D},{dc.size[0]},{dc.size[1]}]",
        n_chunks, lambda a=(cost, dvals): softargmax_depth(*a),
        lambda a=(cost, dvals): softargmax_depth_ref(*a),
        1e-5, 4 * (cost.numel() + D + R * dc.size[0] * dc.size[1]),
        cost.numel() * 5, path="scene"))
    return cases, inputs


def eval3d_preds(poses, K0, depth_gt, scene):
    """The golden recipe's `preds.npz` arrays (numpy only, shared with the
    JAX golden's writer): refs k..n-k-1 of a scene with cam->world `poses`
    [n, 4, 4], intrinsics K0 at the GT resolution and the refs' GT depth
    [n - 2k, H, W]; the depth nearest-resized (index floor(dst * in / out) in
    fp32) to `pred_hw`, times 1 + N(0, noise_sigma), a `drop` share of
    pixels zeroed."""
    import numpy as np

    r = EVAL3D
    k, n = r["k"], poses.shape[0]
    img_idx = np.arange(k, n - k)
    R = poses[img_idx, :3, :3].transpose(0, 2, 1)
    t = -np.einsum("nij,nj->ni", R, poses[img_idx, :3, 3])
    (H, W), (h, w) = r["hw"], r["pred_hw"]
    K = np.repeat(np.asarray(K0, np.float32)[None], len(img_idx), 0)
    K[:, 0, :] *= w / W
    K[:, 1, :] *= h / H
    ys = np.floor(np.arange(h, dtype=np.float32) * np.float32(H / h))
    xs = np.floor(np.arange(w, dtype=np.float32) * np.float32(W / w))
    d = depth_gt[:, ys.astype(np.int64)[:, None], xs.astype(np.int64)[None]]
    rng = np.random.default_rng(r["noise_seed"])
    d = d * (1 + rng.normal(0, r["noise_sigma"], d.shape)).astype(np.float32)
    d[rng.random(d.shape) < r["drop"]] = 0
    return {"scene": scene, "depth_preds": d.astype(np.float32),
            "rotmats": R.astype(np.float32), "tvecs": t.astype(np.float32),
            "K": K, "img_idx": img_idx}


def tsdf_check(got, want):
    """K9a against its twin: the share of voxels whose weights are equal,
    and tsdf and colour within K9_ABS (relative to the largest magnitude,
    at least 1) where they are."""
    import torch

    (tt, tw, tc), (rt, rw, rc) = got, want
    agree = tw == rw
    share = float(agree.double().mean())
    err_t = float((tt - rt).abs()[agree].max())
    err_c = float((tc - rc).abs()[agree].max())
    ok = (share >= TSDF_WEIGHT_SHARE
          and err_t <= K9_ABS * max(1.0, float(rt.abs().max()))
          and err_c <= K9_ABS * max(1.0, float(rc.abs().max())))
    log(f"  tsdf_integrate: weights equal on {share:.7f} of "
        f"{agree.numel()} voxels (limit {TSDF_WEIGHT_SHARE}); where equal "
        f"max |d| tsdf {err_t:.3e}, colour {err_c:.3e}; "
        f"{int((rw > 0).sum())} voxels observed")
    return max(err_t, err_c), ok and bool(torch.isfinite(tt).all())


def fuse_check(got, want):
    """K9b against its twin: the share of pixels whose keep flags are equal
    (at least FUSE_KEEP_SHARE), and points within K9_ABS m where both
    keep."""
    (tp, tk), (rp, rk) = got, want
    share = float((tk == rk).double().mean())
    both = tk & rk
    err = float((tp - rp).abs()[both].max()) if bool(both.any()) else 0.0
    log(f"  consistency_fuse: keep equal on {share:.7f} of {tk.numel()} "
        f"pixels (limit {FUSE_KEEP_SHARE}), {int(rk.sum())} kept; points "
        f"max |d| {err:.3e} m where both keep")
    return err, share >= FUSE_KEEP_SHARE and err <= K9_ABS


def eval3d_cases(device):
    """K9a and K9b at the shapes phase 8a gives them, on the recipe's
    predictions of the golden scene rendered here (52 views at 480x640, 48
    refs; `time_eval3d.golden_inputs`): the TSDF of all 48 frames in the
    default EvalConfig's volume (voxel 0.04 m, margin 1.5 m) with uint8
    colours, as `processresults` hands them over (and with fp32 colours,
    counted 0 times), and the three 16-ref fusion chunks against all 48
    views, the depths nearest-upsampled back to 480x640. Beside the bound
    each case prints the bound over the pairs that the kernel's cull leaves
    (its plain twin) and the shares of pairs culled, in the frustum and
    valid."""
    import torch

    from tdvnet_torch.kernels import consistency_fuse, tsdf_integrate
    from tdvnet_torch.kernels.fusion import consistency_fuse_ref
    from tdvnet_torch.kernels.tsdf import tsdf_integrate_ref
    from tdvnet_torch.tools import time_eval3d as T

    tsdf, fuse = T.golden_inputs(device)
    cases = []
    a = tsdf["golden"]
    st = T.tsdf_pair_stats(a)
    d_dev, colors, dims = a[0], a[1], a[4]
    N, H, W = d_dev.shape
    V = dims[0] * dims[1] * dims[2]
    note = (f"cull leaves {st['run'] / st['pairs']:.4%} of {st['pairs']} "
            f"pairs; in range {st['in_range'] / st['pairs']:.4%}, valid "
            f"{st['valid'] / st['pairs']:.4%}; {st['observed']} voxels "
            f"observed")
    for cols, per, cb in ((colors, 1, 3), (colors.float(), 0, 12)):
        targs = (d_dev, cols) + tuple(a[2:])
        cases.append(Case(
            "tsdf_integrate", f"{dims[0]}x{dims[1]}x{dims[2]} = {V} voxels x "
            f"{N} frames of {H}x{W}, {str(cols.dtype)[6:]} colour", per,
            lambda a=targs: tsdf_integrate(*a), lambda a=targs:
                tsdf_integrate_ref(*a), tsdf_check,
            T.tsdf_bytes(a, cb), T.TSDF_FLOPS * st["pairs"], path="eval3d",
            touched_bound_ms=T.bound_ms(T.tsdf_touched_bytes(a, st, cb),
                                        T.TSDF_FLOPS * st["run"]),
            note=note))

    for name, fargs in fuse.items():
        C = fargs[0].shape[0]
        dmax = d_dev.reshape(N, -1).amax(1)     # once per fusion, as there
        st = T.fuse_pair_stats(fargs, dmax)
        cases.append(Case(
            "consistency_fuse", f"{name} [{C},{H}x{W}] refs x {N} views", 1,
            lambda a=fargs, m=dmax: consistency_fuse(*a, depth_max=m),
            lambda a=fargs: consistency_fuse_ref(*a), fuse_check,
            T.fuse_bytes(fargs),
            T.FUSE_FLOPS * st["pairs"] + T.FUSE_VALID_FLOPS * st["valid"],
            path="eval3d", touched_bound_ms=T.bound_ms(
                T.fuse_touched_bytes(fargs, st),
                T.FUSE_FLOPS * st["run"] + T.FUSE_VALID_FLOPS * st["valid"]),
            note=f"cull leaves {st['run'] / st['pairs']:.4%} of "
                 f"{st['pairs']} pairs; in the frustum "
                 f"{st['frustum'] / st['pairs']:.4%}, valid "
                 f"{st['valid'] / st['pairs']:.4%}"))
    return cases


def check_case(case):
    """Max |kernel - twin| over the outputs and whether it is within the
    tolerance, which is relative to the twin's largest magnitude (at least
    1); a tolerance of 0 asks for equal tensors, BF16_ULP for every element
    within one bf16 ulp of the larger of its two magnitudes, and a callable
    one decides itself: (got, want) -> (max |d|, ok)."""
    import torch

    from tdvnet_torch.tools.timing import bf16_ulp

    got, want = case.run(), case.ref()
    torch.cuda.synchronize()
    same = True
    for what, again in (("a second launch", case.run if case.repeat
                         else None),
                        ("shuffled points", case.shuffled)):
        if again is not None:
            moved = not same_bits(got, again())
            if moved:
                log(f"  {case.kernel} {case.label}: {what} moved bits")
            same &= not moved
    if callable(case.tol):
        err, ok = case.tol(got, want)
        return err, ok and same
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err, ok = 0.0, len(got) == len(want)
    for a, b in zip(got, want):
        ok &= a.shape == b.shape and a.dtype == b.dtype
        diff = (a.double() - b.double()).abs()
        d = float(diff.max()) if a.numel() else 0.0
        err = max(err, d)
        if case.tol == 0.0:
            ok &= torch.equal(a, b)
        elif case.tol == BF16_ULP:
            bad = diff > bf16_ulp(torch.maximum(a.abs(), b.abs()))
            if bad.any():
                i = int((diff * bad).argmax())
                log(f"  {int(bad.sum())} of {bad.numel()} elements over one "
                    f"bf16 ulp, worst {float(a.flatten()[i])} vs "
                    f"{float(b.flatten()[i])} at flat index {i}")
            ok &= not bool(bad.any())
        else:
            scale = max(1.0, float(b.abs().max()))
            ok &= d <= case.tol * scale
            case.rel_err = max(getattr(case, "rel_err", 0.0), d / scale)
    return err, bool(ok and same)


def same_bits(a, b):
    """Whether two results (tensors or tuples of them) hold the same bits,
    NaN payloads included."""
    import torch

    if torch.is_tensor(a):
        a, b = (a,), (b,)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            x = x.contiguous().view({2: torch.int16, 4: torch.int32}.get(
                x.element_size(), torch.int64))
            y = y.contiguous().view(x.dtype)
        if not torch.equal(x, y):
            return False
    return True


def kernel_phase(device, cases=None):
    from tdvnet_torch.tools.timing import time_ms

    ok = True
    per_kernel = {}
    for case in kernel_cases(device) if cases is None else cases:
        err, good = check_case(case)
        ms = time_ms(case.run)
        plain = time_ms(case.ref, iters=3, warmup=1)
        lib = time_ms(case.library) if case.library else None
        tol = getattr(case.tol, "__name__", case.tol)
        rel = getattr(case, "rel_err", None)
        log(f"  {case.kernel:18s} {case.label:48s} max|d|={err:.3e} "
            + (f"({rel:.2e} of the twin's largest) " if rel is not None
               else "")
            + f"{'ok' if good else 'FAIL (tol %s)' % tol} "
            f"kernel={ms:.4f} ms plain={plain:.4f} ms "
            + ("library=-" if lib is None else
               f"library={lib:.4f} ms (x{ms / lib:.2f})") + " "
            f"bound={case.bound_ms:.4f} ms "
            f"({bound_by(case.nbytes, case.flops)}) "
            + ("" if case.touched_bound_ms is None else
               f"touched bound={case.touched_bound_ms:.4f} ms ")
            + f"x{case.per_infer} per {case.path}"
            + (f"; {case.note}" if case.note else ""))
        ok &= good
        zero = lambda: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": None, "nbytes": 0.0, "flops": 0.0,
                        "cases": 0, "library_cases": 0}
        k = per_kernel.setdefault(case.kernel, {
            "max_abs_err": 0.0, "calls": [], "paths": {}})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        # sums over one inference of that path
        tot = k["paths"].setdefault(case.path, zero())
        tot["ms"] += case.per_infer * ms
        tot["plain_ms"] += case.per_infer * plain
        tot["bound_ms"] += case.per_infer * case.bound_ms
        tot["nbytes"] += case.per_infer * case.nbytes
        tot["flops"] += case.per_infer * case.flops
        tot["cases"] += 1
        if lib is not None:
            tot["library_cases"] += 1
            tot["library_ms"] = (tot["library_ms"] or 0.0) \
                + case.per_infer * lib
        k["calls"].append({"shape": case.label, "path": case.path,
                           "per_infer": case.per_infer,
                           "ms": ms, "plain_ms": plain, "library_ms": lib,
                           "bound_ms": case.bound_ms, "max_abs_err": err,
                           "rel_err": rel,
                           "touched_bound_ms": case.touched_bound_ms})
    # a path's library time stands beside its kernel time only where one
    # library call computes every case of it (K3's voxelize has none, K4's
    # concat-back none): the per-call records keep the others
    for k in per_kernel.values():
        for tot in k["paths"].values():
            if tot.pop("library_cases") < tot.pop("cases"):
                tot["library_ms"] = None
    return ok, per_kernel


# ------------------------------------------------------------------ full path
def full_path_phase(model, device):
    import numpy as np
    import torch

    from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts

    with np.load(GOLDEN) as z:
        rec = json.loads(str(z["record"]))
        g_init, g_final = z["depth_init"], z["depth_final"].astype(np.float32)
    if tuple(rec["seeds"]) != GOLDEN_SEEDS:
        raise RuntimeError(f"golden seeds {rec['seeds']} != {GOLDEN_SEEDS}")
    batch = golden_batch(GOLDEN_SEEDS)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.infer_stages(batch, OFFSETS)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    expected = expected_launches(OFFSETS, 1, model.cfg.unet_res)

    init = out["initial"].cpu().numpy()
    final = out["final"].float()
    init_rel = float(np.max(np.abs(init - g_init) / np.abs(g_init)))
    d_final = np.abs(final.cpu().numpy() - g_final)
    med, p99 = float(np.median(d_final)), float(np.percentile(d_final, 99))
    abs_rel = float(calc_2d_depth_metrics(
        final, batch.depth_gt.to(device))["abs_rel"])
    finite = bool(torch.isfinite(final).all())
    stats = {k: int(v) for k, v in out["stats"].items()}
    log(f"  first infer_depth {first_ms:.1f} ms (cold: includes cuDNN "
        f"set-up); final depth {tuple(final.shape)} finite={finite}")
    log(f"  initial depth max rel err vs golden {init_rel:.3e} "
        f"(limit {INIT_MAX_REL:.0e})")
    log(f"  final depth |d| vs golden: median {med:.3e} m (limit "
        f"{FINAL_MEDIAN_ABS:.0e}), p99 {p99:.3e} m")
    log(f"  abs_rel vs synthetic GT {abs_rel:.6f}, golden {rec['abs_rel']:.6f}"
        f" (limit +-{ABS_REL_DELTA})")
    log(f"  n_overflow={stats['n_overflow']} n_out_of_grid="
        f"{stats['n_out_of_grid']} n_points={stats['n_points']} (golden "
        f"n_overflow={rec['n_overflow']} n_out_of_grid={rec['n_out_of_grid']})")
    log(f"  launches in that infer_depth: {json.dumps(counts)} "
        f"(expected {json.dumps(expected)})")
    ok = (finite and init_rel <= INIT_MAX_REL and med <= FINAL_MEDIAN_ABS
          and abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
          and stats["n_overflow"] == rec["n_overflow"]
          and stats["n_out_of_grid"] == rec["n_out_of_grid"]
          and counts == expected
          and all(counts[w] > 0 for w, n in expected.items() if n))
    return ok, counts, first_ms


def serve_phase(model, card):
    import torch

    batches = [golden_batch((2 * s, 2 * s + 1)) for s in SERVE_SEEDS]
    n_refs = batches[0].n_refs
    torch.cuda.reset_peak_memory_stats()
    times = []
    for s, b in zip(SERVE_SEEDS, batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth = model.infer_depth(b, OFFSETS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        times.append(ms)
        if not bool(torch.isfinite(depth).all()):
            raise RuntimeError(f"non-finite depth on batch {s}")
        log(f"  batch {s}: {ms:.1f} ms, {1e3 * n_refs / ms:.2f} ref-frames/s "
            f"[{card}]")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak memory allocated {peak / 2**30:.2f} GiB [{card}]")
    return times, peak, n_refs


# ---------------------------------------------------------------- whole scene
def scene_views(n_views, seed):
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.data import synthetic

    return synthetic.make_scene(n_views=n_views,
                                img_size=ModelConfig().img_size, seed=seed)


def scene_abs_rel(depth, views, k, device):
    import torch

    from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics

    gt = views["depth"][k:views["depth"].shape[0] - k]
    return float(calc_2d_depth_metrics(
        torch.from_numpy(depth).to(device),
        torch.from_numpy(gt).to(device))["abs_rel"])


def scene_golden_phase(inf, device, golden=SCENE_GOLDEN):
    """`predict_scene` on the golden scene against the JAX golden; on the
    fast path also the projection's basis V against the golden's."""
    import numpy as np
    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts

    rec = scene_golden_record(golden)
    with np.load(golden) as z:
        g_mm = z["depth_mm"].astype(np.float32) * 1e-3
        g_V = z["V"] if inf.fast_path else None
    if [tuple(o) for o in rec["offsets"]] != list(inf.offsets_list) \
            or rec["fast_path"] != inf.fast_path:
        raise RuntimeError(f"golden offsets {rec['offsets']} (fast path "
                           f"{rec['fast_path']}) != {inf.offsets_list} "
                           f"(fast path {inf.fast_path})")
    ev = inf.cfg.eval
    views = scene_views(rec["n_views"], rec["seed"])
    n_chunks = -(-rec["n_refs"] // ev.fused_chunk)

    torch.cuda.synchronize()
    reset_launch_counts()
    timings = {}
    t0 = time.perf_counter()
    depth = inf.predict_scene(views, timings)
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    # the fast golden's tables merged into one grid (JAX projects only then)
    expected = expected_launches(
        inf.offsets_list, n_chunks, inf.model.cfg.unet_res, inf.fast_patch,
        1 if inf.fast_path and rec["projected"] else None)

    finite = bool(np.isfinite(depth).all())
    d = np.abs(depth - g_mm)
    med, p99 = float(np.median(d)), float(np.percentile(d, 99))
    abs_rel = scene_abs_rel(depth, views, ev.n_src_on_either_side, device)
    stats, grid = inf.last_scene_stats, tuple(inf.last_grid_size)
    log(f"  first predict_scene {first_ms:.1f} ms ({rec['n_views']} views, "
        f"{rec['n_refs']} refs, {n_chunks} chunks; prep "
        f"{1e3 * timings['prep']:.1f} ms, refine "
        f"{1e3 * timings['refine']:.1f} ms); depth {depth.shape} "
        f"finite={finite}")
    log(f"  depth |d| vs golden: median {med:.3e} m (limit "
        f"{FINAL_MEDIAN_ABS:.0e}), p99 {p99:.3e} m (limit "
        f"{FINAL_P99_ABS:.0e})")
    log(f"  abs_rel vs synthetic depth {abs_rel:.6f}, golden "
        f"{rec['abs_rel']:.6f} (limit +-{ABS_REL_DELTA})")
    log(f"  grid {grid} (golden {tuple(rec['grid_size'])}); stats "
        f"{json.dumps(stats)} (golden {json.dumps(rec['stats'])})")
    log(f"  launches in that predict_scene: {json.dumps(counts)} "
        f"(expected {json.dumps(expected)})")
    ok = (finite and depth.shape == g_mm.shape and med <= FINAL_MEDIAN_ABS
          and p99 <= FINAL_P99_ABS
          and abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
          and grid == tuple(rec["grid_size"]) and stats == rec["stats"]
          and counts == expected
          and all(counts[w] > 0 for w, n in expected.items() if n))
    if inf.fast_path:
        V = inf._proj_V.cpu().numpy() if inf._proj_V is not None else None
        v_err = (float(np.minimum(np.abs(V - g_V), np.abs(V + g_V)).max(0)
                       .max()) if V is not None and V.shape == g_V.shape
                 else float("inf"))
        log(f"  fast path: projected={inf.last_projected} (golden "
            f"{rec['projected']}), tables per iteration {inf.last_n_tables},"
            f" V vs golden up to sign max |d| {v_err:.3e} (limit "
            f"{FAST_V_ABS:.0e}), golden tail {rec['tail']:.4f}")
        ok &= bool(rec["projected"] and inf.last_projected
                   and v_err <= FAST_V_ABS)
    return ok, counts


def scene_stream_phase(inf, device, card, golden=SCENE_GOLDEN):
    """`predict_scenes` over a stream of full-length scenes, timed from one
    result to the next. The golden records the JAX package's `abs_rel` on
    the first scene (the later views of these long synthetic scenes are
    harder than the golden scene's): the first scene is held to it and the
    others stay under it plus a slack."""
    import numpy as np
    import torch

    jax_first = scene_golden_record(golden)["stream"]
    if (jax_first["n_views"], jax_first["seed"]) != (STREAM_VIEWS,
                                                     STREAM_SEEDS[0]):
        raise RuntimeError(f"golden stream scene {jax_first} is not the "
                           f"stream's first")
    abs_rel_limit = jax_first["abs_rel"] + STREAM_ABS_REL_SLACK
    k = inf.cfg.eval.n_src_on_either_side
    scenes = [scene_views(STREAM_VIEWS, s) for s in STREAM_SEEDS]
    n_refs = STREAM_VIEWS - 2 * k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, results = [], []
    t0 = time.perf_counter()
    for depth in inf.predict_scenes(iter(scenes)):
        now = time.perf_counter()
        secs.append(now - t0)
        results.append((depth, tuple(inf.last_grid_size),
                        dict(inf.last_scene_stats)))
        t0 = now
    torch.cuda.synchronize()
    total = sum(secs)
    peak = torch.cuda.max_memory_allocated()
    ok = len(results) == len(scenes)
    for seed, views, sec, (depth, grid, stats) in zip(STREAM_SEEDS, scenes,
                                                      secs, results):
        finite = bool(np.isfinite(depth).all())
        abs_rel = scene_abs_rel(depth, views, k, device)
        good = (finite and depth.shape[0] == n_refs
                and abs_rel <= abs_rel_limit)
        if seed == jax_first["seed"]:
            # the fast path's int8 rounding, bf16 sums and patch anchors
            # flip on smaller differences than the parity path's fp32
            lim = STREAM_ABS_REL_SLACK if inf.fast_path else ABS_REL_DELTA
            good &= (abs(abs_rel - jax_first["abs_rel"]) <= lim
                     and stats == jax_first["stats"])
        ok &= good
        log(f"  scene seed {seed}: {sec:.3f} s after the result before it, "
            f"grid {grid}, stats {json.dumps(stats)}, abs_rel "
            f"{abs_rel:.6f} (limit {abs_rel_limit:.6f}), finite={finite} "
            f"{'ok' if good else 'FAIL'} [{card}]")
    log(f"  {len(secs)} scenes of {STREAM_VIEWS} views ({n_refs} refs) in "
        f"{total:.3f} s: {total / len(secs):.3f} s/scene, "
        f"{len(secs) * n_refs / total:.2f} ref-frames/s; peak memory "
        f"allocated {peak / 2**30:.2f} GiB [{card}]")
    return ok, {
        "scene_seconds": secs, "ref_frames_per_s": len(secs) * n_refs / total,
        "peak_bytes": peak, "n_refs": n_refs}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_phase(run, what, card, prefix="stage_"):
    """One traced call of `run`: the device's busy share of the host's
    window (the union of the intervals in which a kernel, copy or set ran
    on the card), host and device time under each span named `prefix`...,
    and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = all_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    calls = {w: n - before[w] for w, n in all_launch_counts().items()}
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    # a stage span's device-side range covers its kernels: it is no work
    # of its own
    work = [e for e in on_card
            if not (e.is_user_annotation
                    or e.name.startswith(("stage_", "eval_", "train_")))]
    if not work:
        raise RuntimeError("the profiler recorded no work on the card")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in work]) / 1e3
    stages = {}
    for e in events:
        if e.name.startswith(prefix):
            side = "device" if e.device_type == DeviceType.CUDA else "host"
            stages.setdefault(e.name, {"host": 0.0, "device": 0.0})
            stages[e.name][side] += e.time_range.elapsed_us() / 1e3
    by_name = {}
    for e in work:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    log(f"  traced {what} {wall_ms:.1f} ms wall; device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of the window) "
        f"[{card}]")
    for k in sorted(stages):
        log(f"  {k:24s} host {stages[k]['host']:8.2f} ms, device "
            f"{stages[k]['device']:8.2f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, cnt) in top:
        log(f"  {ms:8.3f} ms x{cnt:<4d} {name[:90]}")
    # the port's own kernels on the main path, device time only (phase 2's
    # event timings of the small calls include the wrapper's host time); a
    # source file's kernels are all named <file>_..._kernel, and a device
    # kernel belongs to the longest file name it holds
    # beside them the wrappers' calls in the traced run
    ported = {k: {"ms": 0.0, "launches": 0,
                  "calls": sum(calls[w] for w in KERNEL_META[k][2])}
              for k in KERNEL_META}
    for name, (ms, cnt) in by_name.items():
        owners = [k for k in KERNEL_META if f"{k}_" in name]
        if owners:
            k = max(owners, key=len)
            ported[k]["ms"] += ms
            ported[k]["launches"] += cnt
    for k in KERNEL_META:
        log(f"  port kernel {k:18s} {ported[k]['ms']:8.3f} ms device in "
            f"{ported[k]['launches']} device kernels over "
            f"{ported[k]['calls']} calls")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "stages_ms": stages, "ported_kernels": ported}


# ------------------------------------------------------------------ training
def shuffled_points(seed=99):
    """A permutation maker for the order-free checks: perm(n, device), from
    its own generator so that the cases' seeded inputs stay as they were."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return lambda n, device: torch.randperm(n, generator=gen).to(device)


def variance_backward_case(label, per_step, args, path, perm, plane):
    """K1's backward at `args` (grad, mean, pts, feats, src_idx, src_mask,
    P_all, img_size) and `plane` as the main path calls it, checked for the
    same bits on a second launch and with the points shuffled (the same
    plane tiling then groups other points)."""
    from tdvnet_torch.kernels import source_variance_backward
    from tdvnet_torch.kernels.variance import source_variance_backward_ref

    g, mean, pts, feats, sidx, smask, P_all, img = args
    R, P, f = g.shape
    S = sidx.shape[1]
    active = float(smask.sum())

    def shuffled(a=args):
        i = perm(P, g.device)
        return source_variance_backward(
            a[0][:, i].contiguous(), a[1][:, i].contiguous(),
            a[2][:, i].contiguous(), *a[3:], plane)

    return Case(
        "source_variance_backward", label, per_step,
        lambda a=args: source_variance_backward(*a, plane),
        lambda a=args: source_variance_backward_ref(*a),
        VARIANCE_BACKWARD_TOL,
        4 * (2 * R * P * f + 2 * feats.numel() + pts.numel() + P_all.numel()
             + R * S * 3),
        (active / R) * R * P * (24 + 19 * f), path=path, repeat=True,
        shuffled=shuffled)


def train_cases(device, seed=1):
    """The three backward kernels at the shapes the full-width n_iters=0
    train step gives them, on the golden batch's cameras with seeded
    random features, costs, logits and incoming gradients: the cost
    volume's variance, the soft-argmax and the three propagation blends."""
    import torch

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import (propagation_blend_backward,
                                      softargmax_depth_backward)
    from tdvnet_torch.kernels.propagation import (
        propagation_blend_backward_ref, propagation_blend_ref)
    from tdvnet_torch.kernels.softargmax import (
        softargmax_depth_backward_ref, softargmax_depth_ref)
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera
    from tdvnet_torch.tools.time_depthops import softargmax_backward_cost

    cfg = ModelConfig()
    dc = cfg.depth_train
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    b = golden_batch(GOLDEN_SEEDS).to(device)
    R = b.src_idx.shape[0]
    N = b.n_imgs
    H, W = cfg.img_size
    f = cfg.feat_dim
    ri = b.ref_idx
    cases = []

    feats = rnd(N, H // 4, W // 4, f).contiguous()
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs).contiguous()
    pts = camera.plane_sweep_points(
        dc.depth_start, dc.depth_interval, dc.n_intervals, b.rotmats[ri],
        b.tvecs[ri], b.K[ri], cfg.img_size, dc.size).contiguous()
    P = pts.shape[1]
    _, mean = source_variance_ref(pts, feats, b.src_idx, b.src_mask, P_all,
                                  cfg.img_size, with_mean=True)
    g = rnd(R, P, f)
    args = (g, mean, pts, feats, b.src_idx, b.src_mask, P_all, cfg.img_size)
    hw = f"{dc.size[0]}*{dc.size[1]}"
    cases.append(variance_backward_case(
        f"cost volume [{R},{dc.n_intervals}*{hw},{f}] -> [{N},{H // 4},"
        f"{W // 4},{f}]", 1, args, "train", shuffled_points(),
        plane=dc.size))

    D = dc.n_intervals
    cost = (rnd(R, D, *dc.size) * 3).contiguous()
    dvals = camera.linspace_f32(dc.depth_start, dc.depth_end, D, device)
    depth = softargmax_depth_ref(cost, dvals)
    gd = rnd(R, *dc.size)
    args = (gd, cost, dvals, depth)
    cases.append(Case(
        "softargmax_depth_backward", f"[{R},{D},{dc.size[0]},{dc.size[1]}]",
        1, lambda a=args: softargmax_depth_backward(*a),
        lambda a=args: softargmax_depth_backward_ref(*a), BACKWARD_TOL,
        *softargmax_backward_cost(cost), path="train", repeat=True))

    for h, w in ((H // 4, W // 4), (H // 2, W // 2), (H, W)):
        logits = rnd(R, 9, h, w).permute(0, 2, 3, 1)
        depth = (1.0 + torch.rand(R, h, w, generator=gen) * 3).to(device)
        out = propagation_blend_ref(logits, depth)
        gp = rnd(R, h, w)
        args = (gp, logits, depth, out)
        cases.append(Case(
            "propagation_blend_backward", f"[{R},{h},{w},9]", 1,
            lambda a=args: propagation_blend_backward(*a),
            lambda a=args: propagation_blend_backward_ref(*a),
            BACKWARD_TOL, 4 * R * h * w * 22, R * h * w * 90, path="train"))
    return cases


def train_refine_cases(device, seed=2, real=()):
    """The backward kernels that n_iters >= 1 adds, at the shapes the
    full-width n_iters=1 step gives them (per step: one scene modelling,
    three offset passes), on seeded random inputs: the variance's backward
    at the scene cloud and the hypotheses (K2), the dense scatter's, the
    pools' and concat-backs', the masked GroupNorm's at the three U-Net
    levels and both tails, and the three scales' sampling; the sampling's
    also at `real`, the (grad, pts, center0, cell, grid_shape) of one
    offset pass of the golden step (`capture_sampling_backward`)."""
    import torch
    import torch.nn.functional as F

    from tdvnet_torch.config import ModelConfig, TrainConfig
    from tdvnet_torch.kernels import (gather_concat_backward,
                                      masked_group_norm_backward,
                                      scatter_anchors_to_dense_backward,
                                      segment_max, segment_max_backward,
                                      trilinear_sample_backward)
    from tdvnet_torch.kernels import groupnorm, voxelize as vox
    from tdvnet_torch.kernels.segmax import (gather_concat_backward_ref,
                                             segment_max_backward_ref)
    from tdvnet_torch.kernels.trilinear import trilinear_sample_backward_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera
    from tdvnet_torch.tools.time_k6_backward import (backward_bytes,
                                                     uniform_points)

    cfg = ModelConfig()
    dc, g = cfg.depth_train, cfg.grid
    n_off = len(TrainConfig().offsets)
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    b = golden_batch(GOLDEN_SEEDS).to(device)
    R = b.src_idx.shape[0]
    N, B = b.n_imgs, b.n_scenes
    H, W = cfg.img_size
    f = cfg.feat_dim
    ri = b.ref_idx
    hw = f"{dc.size[0]}*{dc.size[1]}"
    P_ref = dc.size[0] * dc.size[1]
    cases = []
    perm = shuffled_points()

    # K2: the variance's backward at the scene cloud (one point per pixel)
    # and the hypotheses (seven), on plane-sweep points of those counts
    feats = rnd(N, H // 4, W // 4, f).contiguous()
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs).contiguous()
    for label, planes, per_step in ((f"scene cloud [{R},{hw},{f}]", 1, 1),
                                    (f"hypotheses [{R},7*{hw},{f}]", 7,
                                     n_off)):
        interval = dc.depth_interval * (dc.n_intervals - 1) / max(planes - 1,
                                                                   1)
        pts = camera.plane_sweep_points(
            dc.depth_start, interval, planes, b.rotmats[ri], b.tvecs[ri],
            b.K[ri], cfg.img_size, dc.size).contiguous()
        P = pts.shape[1]
        _, mean = source_variance_ref(pts, feats, b.src_idx, b.src_mask,
                                      P_all, cfg.img_size, with_mean=True)
        args = (rnd(R, P, f), mean, pts, feats, b.src_idx, b.src_mask, P_all,
                cfg.img_size)
        cases.append(variance_backward_case(label, per_step, args, "train1",
                                            perm, plane=dc.size))

    # the scene modelling of the step: the scene cloud's points voxelized
    # into the batch grid (seeded points in a box a little larger than it)
    P = R * P_ref
    edge = g.edge_len
    span = torch.tensor([d * edge * 1.02 for d in g.grid_size])
    pts = (torch.rand(P, 3, generator=gen) * span).to(device).contiguous()
    scene = torch.arange(P, device=device) * B // P
    valid = (torch.rand(P, generator=gen) > 0.1).to(device)
    vg = vox.voxelize(pts, scene, valid, edge, g.grid_size, g.max_anchors, B)
    A = g.max_anchors
    n_valid = int(vg.anchor_valid.sum())
    C = 2 * f
    gd = rnd(B, *g.grid_size, C)
    flat = vox._anchor_cells(vg, g.grid_size)[vg.anchor_valid]
    valid_ids = vg.anchor_valid.nonzero()[:, 0]
    sargs = (gd, vg, g.grid_size, B)
    # the library yardstick computes the same [A, C]: zeros, then the valid
    # anchors' rows gathered from the grid
    cases.append(Case(
        "scatter_dense_backward",
        f"[{B},{g.grid_size[0]}^3,{C}] -> [{A},{C}] ({n_valid} valid)", 1,
        lambda a=sargs: scatter_anchors_to_dense_backward(*a),
        lambda a=sargs: vox.scatter_anchors_to_dense_backward_ref(*a),
        0.0, n_valid * 4 * C + A * (24 + 8 + 1) + A * 4 * C, 0,
        library=lambda a=(gd, C, flat): torch.zeros(A, a[1], device=device)
        .index_put_((valid_ids,), a[0].view(-1, a[1])[a[2]]),
        path="train1"))

    C = 4 * f                                  # the PointNet's hidden width
    n_seg = A + 1
    y = rnd(P, C)
    p2a, pv = vg.point2anchor, vg.point_valid
    pooled = segment_max(y, p2a, pv, n_seg)
    margs = (rnd(n_seg, C), y, p2a, pv, pooled)
    cases.append(Case(
        "segment_max_backward", f"pool [{n_seg},{C}] -> [{P},{C}]", 4,
        lambda a=margs: segment_max_backward(*a),
        lambda a=margs: segment_max_backward_ref(*a), BACKWARD_TOL,
        P * (4 * C + 8 + 1) + 2 * min(P, n_seg) * 4 * C + P * 4 * C, P * C,
        path="train1", repeat=True))
    # its segment sum is an integer sum (fixed point); the twin's index_add_
    # on the card runs on float atomics in a run-dependent order; here the
    # dump slot sums the ~27k points that overflow the anchors

    def concat_shuffled(a):
        i = perm(P, device)
        gy, gp = gather_concat_backward(a[0][i], a[1][i], a[2], a[3][i],
                                        a[4])
        return torch.empty_like(gy).index_copy_(0, i, gy), gp

    cargs = (rnd(P, 2 * C), y, pooled, p2a, True)
    cases.append(Case(
        "segment_max_backward", f"concat-back [{P},{2 * C}] -> [{P},{C}] + "
        f"[{n_seg},{C}]", 3,
        lambda a=cargs: gather_concat_backward(*a),
        lambda a=cargs: gather_concat_backward_ref(*a), ATOMIC_BACKWARD_TOL,
        P * (8 * C + 4 * C + 8) + min(P, n_seg) * 4 * C * 2 + P * 4 * C,
        P * 2 * C, path="train1", repeat=True,
        shuffled=lambda a=cargs: concat_shuffled(a)))

    # the masked GroupNorm's backward at the three U-Net levels, both tails,
    # on the forward kernel's own output and statistics
    some = lambda t: tuple(x for x in t if x is not None)
    for lvl, ((n_relu, n_skip), C, G) in enumerate(
            zip(group_norm_calls(cfg.unet_res), cfg.unet_dims,
                cfg.unet_groups)):
        dims = tuple(d >> lvl for d in g.grid_size)
        V = dims[0] * dims[1] * dims[2]
        mask = (torch.rand(B, 1, *dims, generator=gen) > 0.85).float()
        mask[-1, :, dims[0] // 2:] = 0          # scenes differ in their count
        mask = mask.to(device)
        x = (rnd(B, C, *dims) * 2 + 1) * mask
        w, bias = rnd(C), rnd(C)
        for tail, count, skip in (("relu", n_relu, None),
                                  ("skip", n_skip, rnd(B, C, *dims) * mask)):
            out, stats = groupnorm._masked_group_norm(
                x, mask, G, w, bias, 1e-5, skip is None, skip)
            kw = {"relu": skip is None, "skip": skip is not None}
            a = (rnd(B, C, *dims), x, mask, G, w, out, stats, 1e-5)
            n_out = 2 if tail == "skip" else 1
            cases.append(Case(
                "masked_group_norm_backward",
                f"{tail} [{B},{C},{dims[0]}^3] G={G}", count,
                # with the bias, as the main path calls it (the ReLU seen
                # from the recomputed forward)
                lambda a=a, kw=kw, bias=bias: some(
                    masked_group_norm_backward(*a, **kw, bias=bias)),
                lambda a=a, kw=kw: some(
                    groupnorm.masked_group_norm_backward_ref(
                        *a[:6], a[7], **kw)),
                BACKWARD_TOL,
                4 * (B * C * V * (3 + n_out) + B * V + 3 * C + B * G * 4),
                B * C * V * 16, path="train1", repeat=True))

    def sampling_case(label, gq, pts_q, center0, cell, shape, path):
        B, X, Y, Z, C = shape
        qn = (pts_q - center0[:, None, :]) / cell
        lim = torch.tensor([X - 1, Y - 1, Z - 1], device=device,
                           dtype=torch.float32)
        gs_grid = (qn / lim * 2 - 1).flip(-1).reshape(B, -1, 1, 1, 3)
        gs_in = torch.zeros(B, C, X, Y, Z, device=device, requires_grad=True)
        gs_g = gq.permute(0, 2, 1).reshape(B, C, -1, 1, 1)
        targs = (gq, pts_q, center0, cell, shape)
        Q = pts_q.shape[1]

        def shuffled(a=targs):
            i = perm(Q, device)
            return trilinear_sample_backward(a[0][:, i].contiguous(),
                                             a[1][:, i].contiguous(), *a[2:])

        return Case(
            "trilinear_sample_backward",
            f"{label} s={round(cell / edge)} [{B},{Q},{C}] -> "
            f"[{B},{X}^3,{C}]", 3 * n_off,
            lambda a=targs: trilinear_sample_backward(*a),
            lambda a=targs: trilinear_sample_backward_ref(*a),
            BACKWARD_TOL, backward_bytes(gq, pts_q, shape),
            B * Q * (30 + 16 * C),
            library=lambda a=(gs_in, gs_grid, gs_g): torch.autograd.grad(
                F.grid_sample(a[0], a[1], mode="bilinear",
                              padding_mode="zeros", align_corners=True),
                a[0], a[2]),
            path=path, repeat=True, shuffled=shuffled)

    # the three scales' sampling backward at the hypotheses of one offset
    # pass (queries over the grid and a margin around it)
    Q = (R // B) * 7 * P_ref
    origins = rnd(B, 3) * 0.1
    center0 = (origins + 0.5 * edge).contiguous()
    pts_q = uniform_points(origins, g.grid_size[0] * edge, Q, gen)
    for stride, C in zip((1, 2, 4), cfg.unet_dims):
        dims = tuple(d // stride for d in g.grid_size)
        cases.append(sampling_case("uniform", rnd(B, Q, C), pts_q, center0,
                                   stride * edge, (B, *dims, C), "train1"))
    # and at one offset pass of the golden batch's n_iters=1 step, whose
    # hypotheses lie along the rays near the surfaces (another path key:
    # the kernels line keeps the uniform case's sums). Its incoming
    # gradients are ~1e-9..1e-6: scaled by a power of two (exact, and the
    # backward is linear, so kernel and twin scale alike) to a largest
    # magnitude in [0.5, 1), BACKWARD_TOL reads them at their own scale
    for grad, pts, c0, cell, shape in real:
        unit = grad * 2.0 ** -math.frexp(float(grad.abs().max()))[1]
        cases.append(sampling_case("golden", unit, pts, c0, cell, shape,
                                   "train1_golden"))
    return cases


def variance_reading(device, seed=3):
    """Where the source variance's kernel and its fp32 twin sit against the
    twin in float64 (the same fp32 cameras and points, the features and
    incoming gradients widened), forward and backward, at the cost volume
    and at the two K2 shapes of training; and where all three sit against
    the twin in float64 with float64 geometry (projections not rounded to
    fp32). For the kernel's worst element, where it sits:
    forward, its point's depth in each source camera and whether a tap of
    its footprint falls off the map; backward, whether the feature pixel
    lies on the map's border and the smallest depth in that camera of the
    points whose footprint covers it. Returns (ok: every reading finite,
    the readings)."""
    import torch

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import source_variance_backward
    from tdvnet_torch.kernels.variance import (_feature_scale,
                                               source_variance_backward_ref,
                                               source_variance_ref)
    from tdvnet_torch.kernels.variance import _source_variance
    from tdvnet_torch.ops import camera

    cfg = ModelConfig()
    dc = cfg.depth_train
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device)
    b = golden_batch(GOLDEN_SEEDS).to(device)
    R, S = b.src_idx.shape
    N = b.n_imgs
    H, W = cfg.img_size
    f = cfg.feat_dim
    ri = b.ref_idx
    feats = rnd(N, H // 4, W // 4, f).contiguous()
    Hf, Wf = feats.shape[1:3]
    P_all = camera.projection_matrix(b.K, b.rotmats, b.tvecs).contiguous()
    sx, sy = _feature_scale(feats, cfg.img_size)
    img = cfg.img_size
    out, ok = {}, True

    def depth_in(pts, n):
        """Camera depth z and feature-grid coordinates of pts [P, 3] in
        camera n (fp64 arithmetic on the fp32 inputs)."""
        M = P_all[n].double()
        xyz = pts.double() @ M[:, :3].T + M[:, 3]
        den = xyz[:, 2].abs() + 1e-8
        return xyz[:, 2], xyz[:, 0] / den * sx, xyz[:, 1] / den * sy

    for label, planes in ((f"cost volume D={dc.n_intervals}",
                           dc.n_intervals), ("scene cloud", 1),
                          ("hypotheses x7", 7)):
        interval = dc.depth_interval * (dc.n_intervals - 1) / max(planes - 1,
                                                                  1)
        pts = camera.plane_sweep_points(
            dc.depth_start, interval, planes, b.rotmats[ri], b.tvecs[ri],
            b.K[ri], img, dc.size).contiguous()
        P = pts.shape[1]
        g = rnd(R, P, f)
        a32 = (pts, feats, b.src_idx, b.src_mask, P_all, img)
        a64 = (pts, feats.double(), b.src_idx, b.src_mask, P_all, img)
        ag = (pts.double(), feats.double(), b.src_idx, b.src_mask,
              P_all.double(), img)
        k_var, k_mean = _source_variance(*a32, True)
        t_var, t_mean = source_variance_ref(*a32, with_mean=True)
        d_var, d_mean = source_variance_ref(*a64, with_mean=True)
        g_var, g_mean = source_variance_ref(*ag, with_mean=True)
        k_bw = source_variance_backward(g, k_mean, *a32, dc.size)
        t_bw = source_variance_backward_ref(g, t_mean, *a32)
        d_bw = source_variance_backward_ref(g.double(), d_mean, *a64)
        g_bw = source_variance_backward_ref(g.double(), g_mean, *ag)
        torch.cuda.synchronize()
        rec = {}
        for what, k, t, d, gg in (("forward", k_var, t_var, d_var, g_var),
                                  ("backward", k_bw, t_bw, d_bw, g_bw)):
            # a point whose projection is not finite is NaN on every side
            fin = torch.isfinite(d)
            top = float(d[fin].abs().max())
            errs = {}
            for side, x, ref in (("kernel", k, d), ("twin32", t, d),
                                 ("twin64_geometry64", gg, d),
                                 ("kernel_vs_geometry64", k, gg),
                                 ("twin32_vs_geometry64", t, gg)):
                diff = torch.where(fin, (x.double() - ref).abs(),
                                   torch.zeros_like(d))
                errs[side] = (float(diff.max()), float(diff.max()) / top,
                              int(diff.argmax()))
            ok &= all(math.isfinite(e[0]) for e in errs.values())
            worst = errs["kernel"][2]
            where = {}
            if what == "forward":
                r, p = divmod(worst // f, P)
                for s in range(S):
                    if not bool(b.src_mask[r, s]):
                        continue
                    n = int(b.src_idx[r, s])
                    z, x, y = depth_in(pts[r, p:p + 1], n)
                    x0, y0 = float(torch.floor(x)), float(torch.floor(y))
                    where[f"source {n}"] = {
                        "z": float(z), "x": float(x), "y": float(y),
                        "tap_off_map": x0 < 0 or x0 + 1 > Wf - 1 or y0 < 0
                        or y0 + 1 > Hf - 1}
            else:
                n, rest = divmod(worst // f, Hf * Wf)
                yy, xx = divmod(rest, Wf)
                zs = []
                for r in range(R):
                    for s in range(S):
                        if int(b.src_idx[r, s]) != n or not bool(
                                b.src_mask[r, s]):
                            continue
                        z, x, y = depth_in(pts[r], n)
                        cover = ((torch.floor(x) - xx).abs() <= 1) & \
                            (torch.floor(x) <= xx) & \
                            ((torch.floor(y) - yy).abs() <= 1) & \
                            (torch.floor(y) <= yy)
                        if bool(cover.any()):
                            zs.append(float(z[cover].abs().min()))
                where = {"image": n, "pixel": [yy, xx],
                         "on_border": yy in (0, Hf - 1) or xx in (0, Wf - 1),
                         "min_depth_of_covering_points":
                             min(zs) if zs else None}
            rec[what] = {"max_abs_f64": top, "errors": {
                side: {"max_abs": e[0], "rel_to_max": e[1]}
                for side, e in errs.items()}, "worst_kernel_element": where}
            log(f"  {label:22s} {what:8s} |f64| max {top:.4e}: kernel "
                f"{errs['kernel'][0]:.3e} ({errs['kernel'][1]:.2e}), twin32 "
                f"{errs['twin32'][0]:.3e} ({errs['twin32'][1]:.2e}), twin64 "
                f"with f64 geometry {errs['twin64_geometry64'][0]:.3e} "
                f"({errs['twin64_geometry64'][1]:.2e}); against that: "
                f"kernel {errs['kernel_vs_geometry64'][0]:.3e} "
                f"({errs['kernel_vs_geometry64'][1]:.2e}), twin32 "
                f"{errs['twin32_vs_geometry64'][0]:.3e} "
                f"({errs['twin32_vs_geometry64'][1]:.2e}); the kernel's "
                f"worst {json.dumps(where)}")
        out[label] = rec
        del k_bw, t_bw, d_bw, g_bw
    torch.cuda.empty_cache()
    return bool(ok), out


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


class TrainRun:
    """What one n_iters regime of phase 9b reads and how its golden is
    held: the JAX golden's file, the epoch whose lambda it trains at, the
    gradient leaves and BatchNorms it records, its limits (per step for the
    losses, per quantity for the gradients) and the float64 referee's
    gradient limits (per quantity)."""

    def __init__(self, n_iters, golden, epoch, leaves, bns, loss_rel,
                 grad_rel, referee_grad_rel, steps=TRAIN_STEPS,
                 stats_rel=TRAIN_STATS_REL):
        self.n_iters, self.golden, self.epoch = n_iters, golden, epoch
        self.leaves, self.bns = leaves, bns
        self.loss_rel, self.grad_rel = loss_rel, grad_rel
        self.referee_grad_rel = referee_grad_rel
        self.steps = steps
        self.stats_rel = stats_rel


TRAIN_RUNS = (
    TrainRun(0, TRAIN_GOLDEN, 0, TRAIN_LEAVES, (TRAIN_BN,), GOLDEN_LOSS_REL,
             GOLDEN_GRAD_REL, TRAIN_GRAD_REL),
    TrainRun(1, TRAIN_REFINE_GOLDEN, TRAIN_REFINE_EPOCH, TRAIN_REFINE_LEAVES,
             TRAIN_REFINE_BNS, GOLDEN_REFINE_LOSS_REL, GOLDEN_REFINE_GRAD_REL,
             REFEREE_REFINE_GRAD_REL, stats_rel=GOLDEN_REFINE_STATS_REL),
    # n_iters_late from the switch epoch on; one step, the referee alone
    TrainRun(2, None, TRAIN_LATE_EPOCH, TRAIN_REFINE_LEAVES, TRAIN_REFINE_BNS,
             None, None, REFEREE_REFINE_GRAD_REL, steps=1))


def train_steps_record(state, step, batch, lam, run, before_step=None,
                       after_step=None):
    """Run `run.steps` steps (calling `before_step(i, model)` before step
    i, and `after_step(i, model)` after it); the losses of each, step 1's
    gradient norm per module of
    TRAIN_MODULES and its gradients of `run.leaves` (float64 numpy), the
    running statistics of `run.bns` after the steps, and the steps' host ms
    (to a synchronise on the loss)."""
    import numpy as np

    model = state.model
    rec = {"loss": [], "loss_2d": [], "ms": []}
    for i in range(run.steps):
        if before_step is not None:
            before_step(i, model)
        t0 = time.perf_counter()
        _, mets = step(state, batch, lam)
        rec["loss"].append(float(mets["loss"]))
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["loss_2d"].append(float(mets["loss_2d"]))
        if i == 0:
            rec.update(_grad_record(model, run.leaves))
        if after_step is not None:
            after_step(i, model)
    rec["bns"] = _bns_record(model, run.bns)
    if not np.isfinite(rec["loss"]).all():
        raise RuntimeError(f"non-finite training loss {rec['loss']}")
    return rec


def _grad_record(model, leaves):
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return {"grad_norms": {m: math.sqrt(sum(
        float((g.double() ** 2).sum()) for k, g in grads.items()
        if k.startswith(m + "."))) for m in TRAIN_MODULES},
        "leaves": {k: grads[k].double().cpu().numpy() for k in leaves}}


def _bn_record(model, bn=TRAIN_BN):
    bn = model.get_submodule(bn)
    # a copy: a later forward updates the statistics in place
    return {"running_mean": bn.running_mean.double().cpu().numpy().copy(),
            "running_var": bn.running_var.double().cpu().numpy().copy()}


def _bns_record(model, bns):
    return {b: _bn_record(model, b) for b in bns}


def train_golden_record(run):
    """The JAX golden of `run` in the layout of `train_steps_record`."""
    import numpy as np

    with np.load(run.golden) as z:
        rec = json.loads(str(z["record"]))
        rec["leaves"] = {k[len("grad:"):]: z[k].astype(np.float64)
                         for k in z.files if k.startswith("grad:")}
        if run.n_iters == 0:
            rec["bns"] = {TRAIN_BN: {
                "running_mean": z["bn_running_mean"].astype(np.float64),
                "running_var": z["bn_running_var"].astype(np.float64)}}
        else:
            rec["bns"] = {b: {k: z[f"bn:{b}.{k}"].astype(np.float64)
                              for k in ("running_mean", "running_var")}
                          for b in run.bns}
    if tuple(rec["seeds"]) != GOLDEN_SEEDS or rec["steps"] != run.steps \
            or rec["n_iters"] != run.n_iters:
        raise RuntimeError(f"train golden settings {rec['seeds']}, "
                           f"{rec['steps']} steps, n_iters {rec['n_iters']} "
                           f"differ from the script's")
    if sorted(rec["leaves"]) != sorted(run.leaves):
        raise RuntimeError(f"train golden leaves {sorted(rec['leaves'])}")
    return rec


def _limit(lim, key):
    """A limit given as one number, per step (a tuple) or per quantity (a
    dict: the key's own entry, else that of the longest module holding it,
    else the "" entry)."""
    if isinstance(lim, tuple):
        return lim[key]
    if isinstance(lim, dict):
        if key in lim:
            return lim[key]
        owners = [m for m in lim if m and key.startswith(m + ".")]
        return lim[max(owners, key=len)] if owners else lim[""]
    return lim


def _verdict(e, lim):
    return "ok" if e <= lim else "FAIL (limit %.1e)" % lim


def compare_train_records(got, want, name, loss_rel, grad_rel, stats_rel,
                          steps, n_steps=TRAIN_STEPS):
    """Log `got` against `want` and return whether every quantity is within
    its limit: the losses of the first `steps` steps relative, gradient
    norms relative (a zero norm must stay zero), the leaves both records
    hold in relative L2, and, when `steps` covers all `n_steps` the runs
    took, the running statistics of every BatchNorm both hold
    (`compare_bn`). A limit is a number, per step or per quantity
    (`_limit`)."""
    import numpy as np

    ok = True
    for i in range(steps):
        e = max(_rel(got["loss"][i], want["loss"][i]),
                _rel(got["loss_2d"][i], want["loss_2d"][i]))
        log(f"  step {i}: loss {got['loss'][i]:.7f} vs {name} "
            f"{want['loss'][i]:.7f}, loss_2d {got['loss_2d'][i]:.7f} vs "
            f"{want['loss_2d'][i]:.7f}: rel {e:.2e} "
            f"{_verdict(e, _limit(loss_rel, i))}")
        ok &= e <= _limit(loss_rel, i)
    for m in TRAIN_MODULES:
        g, w = got["grad_norms"][m], want["grad_norms"][m]
        e = (0.0 if g == 0.0 else math.inf) if w == 0.0 else _rel(g, w)
        log(f"  grad norm {m:18s} {g:.6e} vs {name} {w:.6e}: rel {e:.2e} "
            f"{_verdict(e, _limit(grad_rel, m))}")
        ok &= e <= _limit(grad_rel, m)
    for k in sorted(set(got["leaves"]) & set(want["leaves"])):
        g, w = got["leaves"][k], want["leaves"][k]
        e = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        log(f"  grad {k:44s} rel L2 {e:.2e} vs {name} "
            f"{_verdict(e, _limit(grad_rel, k))}")
        ok &= e <= _limit(grad_rel, k)
    if steps < n_steps:
        return bool(ok)
    for b in sorted(set(got.get("bns", {})) & set(want.get("bns", {}))):
        ok &= compare_bn(got["bns"][b], want["bns"][b], name, stats_rel, b,
                         n_steps)
    return bool(ok)


def compare_bn(got, want, name, stats_rel, bn=TRAIN_BN,
               n_steps=TRAIN_STEPS):
    """A BatchNorm's running statistics after the steps: the mean in units
    of the spread (a mean near zero has no scale of its own), the variance
    relative to its largest."""
    import numpy as np

    scale = {"running_mean": np.sqrt(want["running_var"]).max(),
             "running_var": np.abs(want["running_var"]).max()}
    ok = True
    for k in ("running_mean", "running_var"):
        e = float(np.abs(got[k] - want[k]).max() / max(scale[k], 1e-30))
        log(f"  {bn}.{k} after {n_steps} steps: rel {e:.2e} vs "
            f"{name} {_verdict(e, stats_rel)}")
        ok &= e <= stats_rel
    return bool(ok)


def update_check(p0, p1, grads, lr, name, noise=True,
                 grad_rel=TRAIN_GRAD_REL):
    """Log and return the worst ratio, over the trained parameters, of the
    port's first Adam update (p0 -> p1) off a float64 one from `grads`
    (optax's first step, whose bias corrections cancel: p0 - lr * g / (|g|
    + eps)) to its limit: TRAIN_UPDATE_REL * lr plus one fp32 ulp of the
    parameter. With `noise` (gradients other than the port's own), an
    element whose gradient is rounding noise (nonzero and |g| at most the
    leaf's limit in `grad_rel` of its largest, or in ZERO_GRADS) moves in a
    direction the noise picks: it is held only to move by at most lr (plus
    the same margin). Returns that ratio (at most 1 passes) and the share
    of such elements."""
    import torch

    worst, worst_lr, n_noise, n_all, worst_leaf = 0.0, 0.0, 0, 0, None
    for k, a in p0.items():
        g, a = grads[k].double(), a.double()
        b = p1[k].double()
        want = a - lr * g / (g.abs() + ADAM_EPS)
        w32 = want.float()
        ulp = (torch.nextafter(w32, torch.full_like(w32, math.inf))
               - w32).double()
        margin = TRAIN_UPDATE_REL * lr + ulp
        mag = g.abs()
        if not noise:
            loud = torch.ones_like(mag, dtype=torch.bool)
        elif k in ZERO_GRADS:
            loud = torch.zeros_like(mag, dtype=torch.bool)
        else:
            loud = (mag > _limit(grad_rel, k) * mag.max()) | (mag == 0)
        d = (b - want).abs()
        ratio = torch.where(loud, d / margin, (b - a).abs() / (lr + margin))
        if float(ratio.max()) > worst:
            worst, worst_leaf = float(ratio.max()), k
        if bool(loud.any()):
            worst_lr = max(worst_lr, float(d[loud].max()) / lr)
        n_noise += int((~loud).sum())
        n_all += g.numel()
    share = n_noise / max(n_all, 1)
    log(f"  step 1's update vs {name}: worst {worst_lr:.2e} lr off, "
        f"{worst:.2e} of its limit (in {worst_leaf}) "
        f"{'ok' if worst <= 1.0 else 'FAIL'}"
        + (f"; {n_noise} of {n_all} elements ({share:.2%}) with noise-level "
           f"gradients held to move by at most lr" if noise else ""))
    return worst, share


@contextlib.contextmanager
def float64_twins():
    """Within the block every kernel call site of the training path runs
    its plain twin, which keeps float64 and which autograd differentiates:
    the float64 reference run on the card. The geometry stays as the
    port's: the points are taken in fp32 where they meet the fp32 cameras
    (the variance's projections) and the grid (voxelization, which would
    otherwise move a point on a cell face into another cell and change the
    graph; scene sampling), as the port's fp32 run computes them."""
    import tdvnet_torch.models.hypothesis as hypothesis
    import tdvnet_torch.models.layers as layers
    import tdvnet_torch.models.mvsnet as mvsnet
    import tdvnet_torch.models.pointnet as pointnet
    import tdvnet_torch.models.upsampling as upsampling
    import tdvnet_torch.ops.costvolume as costvolume
    import tdvnet_torch.ops.voxelize as vox
    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.kernels.segmax import (gather_concat_ref,
                                             segment_max_ref,
                                             segment_plan_ref)
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.kernels.voxelize import (scatter_anchors_to_dense_ref,
                                               voxelize_ref)

    fp32 = lambda x: x.detach().float().contiguous()
    swaps = (
        (mvsnet, "softargmax_depth", softargmax_depth_ref),
        (upsampling, "propagation_blend", propagation_blend_ref),
        (costvolume, "source_variance",
         lambda pts, feats, sidx, smask, P_all, img, plane, out_dtype=None:
         source_variance_ref(fp32(pts), feats, sidx, smask, P_all, img)),
        (vox, "voxelize", lambda pts, *a: voxelize_ref(fp32(pts), *a)),
        (vox, "scatter_anchors_to_dense", scatter_anchors_to_dense_ref),
        (pointnet, "segment_plan", segment_plan_ref),
        (pointnet, "segment_max",
         lambda y, seg, valid, n_seg, plan=None:
         segment_max_ref(y, seg, valid, n_seg)),
        (pointnet, "gather_concat", gather_concat_ref),
        (layers, "masked_group_norm", masked_group_norm_ref),
        (hypothesis, "trilinear_sample_scale",
         lambda grid, pts, *a: trilinear_sample_ref(grid, fp32(pts), *a)))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class Float64Referee:
    """Before each of the port's steps, the same parameters, buffers and
    batch in float64 through the twins (the cameras, the projections and
    the points where they meet the grid stay fp32, as in the port's run;
    `float64_twins`): the loss the step should compute, at step 1 its
    gradients and the faulty loss of the composition control, after the
    last step the BatchNorm statistics. Each step starts from the port's
    own state, so fp32 noise that Adam's sign-like first updates amplify
    does not compound into the reference. It also keeps the port's trained
    parameters before and after step 1 and TRAIN_BN's statistics before
    each step, for `update_check` and the BatchNorm control."""

    def __init__(self, cfg, batch, lam, device, run):
        import dataclasses

        from tdvnet_torch.models.threedvnet import ThreeDVNet
        from tdvnet_torch.train import loop as L

        self.model = ThreeDVNet(cfg.model).to(device).double()
        # the regime's frozen leaves, and step 1's lr
        self.lr = L.make_optimizer(cfg, self.model, 1).sched(0)
        self.batch = dataclasses.replace(
            batch, images=batch.images.double(),
            depth_gt=batch.depth_gt.double())
        self.lam = lam
        self.run = run
        self.offsets = list(cfg.train.offsets)
        self.bb_train = bool(cfg.train.finetune)
        self.record = {"loss": [], "loss_2d": []}
        self.bn_before = []
        self.seconds = 0.0

    def _forward(self):
        m = self.model
        for p in m.parameters():
            p.grad = None
        with float64_twins():
            return m(self.batch, self.offsets, self.run.n_iters, self.lam,
                     with_metrics=False, backbone_train=self.bb_train)

    def __call__(self, i, model):
        import torch

        t0 = time.perf_counter()
        m = self.model
        if i == 0:
            self.p0 = {k: p.detach().clone()
                       for k, p in model.named_parameters()
                       if p.requires_grad}
        self.bn_before.append(_bn_record(model))
        m.load_state_dict(model.state_dict())
        m.train()
        out = self._forward()
        self.record["loss"].append(out["loss"].item())
        self.record["loss_2d"].append(out["loss_2d"].item())
        # this forward's update of the running statistics is the step's
        self.record["bns"] = _bns_record(m, self.run.bns)
        if i == 0:
            with float64_twins():
                out["loss"].backward()
            self.record.update(_grad_record(m, self.run.leaves))
            self.grads = {k: torch.zeros_like(p) if p.grad is None
                          else p.grad for k, p in m.named_parameters()
                          if k in self.p0}
            # the control's statistics are not read: its forward's update
            # is overwritten by the next step's load
            out = self._forward()
            loss = out["loss"] + (CONTROL_STAGE_WEIGHT - 1.0) \
                * out["final"]["loss_2d"]
            with float64_twins():
                loss.backward()
            self.control = {"loss": [loss.item()],
                            "loss_2d": [out["loss_2d"].item()],
                            **_grad_record(m, self.run.leaves)}
        del out
        self.seconds += time.perf_counter() - t0

    def after(self, i, model):
        """After the port's step i: step 1's parameters and gradients."""
        if i == 0:
            self.p1 = {k: p.detach().clone()
                       for k, p in model.named_parameters() if k in self.p0}
            self.port_grads = {k: p.grad.detach().clone()
                               for k, p in model.named_parameters()
                               if k in self.p0}


def bn_control(before, after, momentum=0.9):
    """TRAIN_BN's running statistics after the steps had each update
    weighted the other way round (flax's momentum 0.9 given to torch as
    0.9): each step's batch statistic b_t recovered from the port's
    r_{t+1} = momentum r_t + (1 - momentum) b_t, then r' = (1 - momentum) r'
    + momentum b_t from the same start."""
    rec = {}
    for k in ("running_mean", "running_var"):
        r = [x[k] for x in before] + [after[k]]
        out = r[0]
        for t in range(len(r) - 1):
            b = (r[t + 1] - momentum * r[t]) / (1.0 - momentum)
            out = (1.0 - momentum) * out + momentum * b
        rec[k] = out
    return rec


def train_golden_phase(state, step, batch, lam, cfg, device, run):
    """`run.steps` steps of the port from the synth48 weights at
    `run.n_iters`, against the float64 referee and (where `run` has one)
    the JAX golden, then the controls; returns (ok, launch counts of those
    steps, the steps' host ms)."""
    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts

    golden = train_golden_record(run) if run.golden else None
    referee = Float64Referee(cfg, batch, lam, device, run)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = train_steps_record(state, step, batch, lam, run,
                             before_step=referee, after_step=referee.after)
    counts = launch_counts()
    n = run.steps
    cmp = lambda a, b, name, loss_rel, grad_rel, steps=n, \
        stats_rel=TRAIN_STATS_REL: compare_train_records(
            a, b, name, loss_rel, grad_rel, stats_rel, steps, n)
    log(f"  float64 referee: {referee.seconds:.1f} s over the {n} steps")
    log("  the port (fp32) against the float64 referee:")
    ok = cmp(got, referee.record, "float64", TRAIN_LOSS_REL,
             run.referee_grad_rel)
    # the optimizer alone: Adam in float64 from the port's own gradients,
    # every element; then from the referee's, every element whose gradient
    # is above rounding noise (each leaf's gradient in sign and size)
    worst, _ = update_check(referee.p0, referee.p1, referee.port_grads,
                            referee.lr, "float64 Adam of its own gradients",
                            noise=False)
    ok &= worst <= 1.0
    worst, share = update_check(referee.p0, referee.p1, referee.grads,
                                referee.lr, "float64 Adam of the float64 "
                                "gradients", grad_rel=run.referee_grad_rel)
    if run.n_iters == 0:
        ok &= worst <= 1.0 and share <= TRAIN_NOISE_SHARE
    else:
        # a reading only: behind the PointNet's max pools and the scene
        # U-Net an element at a thousandth of its leaf's largest gradient
        # carries the fp32 forward's noise, so its sign is no test; the
        # update from the port's own gradients above holds every element
        log("  (a reading at n_iters >= 1, not a gate)")
    if golden is not None:
        log("  the port (fp32) against the JAX golden (fp32):")
        ok &= cmp(got, golden, "JAX", run.loss_rel, run.grad_rel,
                  stats_rel=run.stats_rel)
        log("  the JAX golden against the float64 referee at step 1 (the "
            "same parameters; later steps follow another trajectory):")
        cmp(golden, referee.record, "float64", run.loss_rel, run.grad_rel,
            steps=1)
    expected = train_expected_launches(n, run.n_iters,
                                       len(cfg.train.offsets),
                                       cfg.model.unet_res)
    log(f"  launches in those steps: {json.dumps(counts)} (expected "
        f"{json.dumps(expected)})")
    ok &= counts == expected
    # each control must fail the limits that stand for it: a FAIL below is
    # the limit seeing the fault
    refs = [("float64", referee.record, TRAIN_LOSS_REL,
             run.referee_grad_rel, TRAIN_STATS_REL)]
    if golden is not None:
        refs.append(("JAX", golden, run.loss_rel, run.grad_rel,
                     run.stats_rel))
    seen = {}
    for name, want, loss_rel, grad_rel, _ in refs:
        log(f"  control: the final stage's loss term x{CONTROL_STAGE_WEIGHT}"
            f" (float64) against the {name} reference:")
        seen[f"composition vs {name}"] = not cmp(
            referee.control, want, name, loss_rel, grad_rel, steps=1)
    log(f"  control: the port's update against a float64 Adam update at "
        f"lr x{CONTROL_LR}:")
    seen["optimizer"] = update_check(
        referee.p0, referee.p1, referee.port_grads, referee.lr * CONTROL_LR,
        f"float64 Adam of its own gradients at lr x{CONTROL_LR}",
        noise=False)[0] > 1.0
    log("  control: the BatchNorm updates weighted the other way round "
        "(momentum 0.9 as torch's):")
    swapped = bn_control(referee.bn_before, got["bns"][TRAIN_BN])
    for name, want, _, _, stats_rel in refs:
        seen[f"batchnorm vs {name}"] = not compare_bn(
            swapped, want["bns"][TRAIN_BN], name, stats_rel, TRAIN_BN, n)
    log(f"  controls seen by their limits: {json.dumps(seen)}")
    ok &= all(seen.values())
    del referee
    torch.cuda.empty_cache()
    return bool(ok), counts, got["ms"]


def _bits(t):
    """A sum of the tensor's bit patterns: it moves with any bit of it."""
    import torch

    if t.is_floating_point():
        return int(t.detach().float().contiguous().view(torch.int32)
                   .long().sum())
    return int(t.detach().long().sum())


def _tensors(o):
    import torch

    if torch.is_tensor(o):
        return [o]
    if isinstance(o, (list, tuple)):
        return [x for y in o for x in _tensors(y)]
    if isinstance(o, dict):
        return [x for y in o.values() for x in _tensors(y)]
    return []


def repeat_phase(cfg, batch, lam, device, n_iters):
    """Two train-mode forwards at `n_iters`, each from freshly loaded
    weights: every module's output must repeat bit for bit, or the first
    module whose output moved is named. cuDNN's run-dependent sums in the
    up-convs moved the n_iters=2 loss 7e-6 to 7e-5 off the float64
    referee's from run to run (PERF.md, section 6): the PointNet's pools
    amplify any such noise."""
    from tdvnet_torch.weights import load_threedvnet

    runs = []
    for _ in range(2):
        model = load_threedvnet(WEIGHTS, device=device)
        model.train()
        seq = []
        hooks = [m.register_forward_hook(
            lambda mod, i, o, name=name: seq.append(
                (name, [_bits(t) for t in _tensors(o)])))
            for name, m in model.named_modules() if name]
        out = model(batch, list(cfg.train.offsets), n_iters, lam,
                    with_metrics=False,
                    backbone_train=bool(cfg.train.finetune))
        for h in hooks:
            h.remove()
        runs.append((seq, float(out["loss"])))
        del model, out
    (a, la), (b, lb) = runs
    moved = [x[0] for x, y in zip(a, b) if x != y]
    ok = len(a) == len(b) and not moved and la == lb
    log(f"  two fresh n_iters={n_iters} forwards: losses {la!r}, {lb!r}; "
        f"{len(moved)} of {len(a)} module outputs moved"
        + (f", the first {moved[0]}" if moved else "")
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def train_run_record(cfg, batch, device, run, model_cfg=None):
    """`run.steps` steps of `make_train_step` at `run.n_iters` from freshly
    loaded weights (a `model_cfg` model: a bf16 one in phase 9h): the losses
    of each step, and after the last every parameter, gradient, Adam moment
    and buffer (the BatchNorm statistics), with the order in which the last
    backward finished the parameters' gradients."""
    import torch

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    lam = L.lambda_for_epoch(cfg, run.epoch)
    model = load_threedvnet(WEIGHTS, model_cfg or ModelConfig(),
                            device=device)
    state = L.TrainState(model, L.make_optimizer(cfg, model, 1))
    step = L.make_train_step(model, cfg, run.n_iters)
    order = []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, k=k: order.append(k))
        for k, p in model.named_parameters() if p.requires_grad]
    leaves = {}
    for i in range(run.steps):
        order.clear()
        _, mets = step(state, batch, lam)
        leaves[f"step {i + 1} loss"] = mets["loss"].clone()
        leaves[f"step {i + 1} loss_2d"] = mets["loss_2d"].clone()
    for h in hooks:
        h.remove()
    adam = state.optimizer.adam.state
    for k, p in model.named_parameters():
        leaves[f"parameter {k}"] = p.detach().clone()
        if p.grad is not None:
            leaves[f"gradient {k}"] = p.grad.clone()
        for m in ("exp_avg", "exp_avg_sq"):
            if m in adam.get(p, {}):
                leaves[f"Adam {m} {k}"] = adam[p][m].clone()
    for k, t in model.named_buffers():
        leaves[f"buffer {k}"] = t.clone()
    del state, step, model
    return leaves, list(dict.fromkeys(order))


def train_repeat_phase(cfg, batch, device):
    """Phase 9b'': two fresh runs from freshly loaded weights, each the
    golden steps at n_iters 0 and 1: every parameter, gradient, Adam moment,
    BatchNorm statistic and loss must be the same bits in both, or the first
    leaf that moved is named, in the order the backward finished the
    parameters' gradients (then the losses, then the rest)."""
    import torch

    ok = True
    for run in TRAIN_RUNS[:2]:
        (a, order), (b, _) = (train_run_record(cfg, batch, device, run)
                              for _ in range(2))
        torch.cuda.empty_cache()
        moved = [k for k in a if k not in b or not same_bits(a[k], b[k])]
        first = None
        for k in order:
            for what in ("gradient", "parameter", "Adam exp_avg",
                         "Adam exp_avg_sq"):
                if first is None and f"{what} {k}" in moved:
                    first = f"{what} {k}"
        first = first or (moved[0] if moved else None)
        good = not moved and len(a) == len(b)
        losses = [float(a[f"step {i + 1} loss"]) for i in range(run.steps)]
        log(f"  two fresh runs of {run.steps} n_iters={run.n_iters} steps: "
            f"losses {losses}; {len(moved)} of {len(a)} leaves moved"
            + (f", the first in backward order {first}" if moved else "")
            + f" {'ok' if good else 'FAIL'}")
        ok &= good
        del a, b
    return ok


def train_time_phase(state, step, batch, lam, card, n_iters,
                     n_steps=TRAIN_TIMED):
    """`n_steps` warm steps, each timed on the host clock to a synchronise;
    peak device memory over them. `n_iters` labels the regime (its n_iters
    and knobs)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        _, mets = step(state, batch, lam)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(float(mets["loss"])):
            raise RuntimeError("non-finite training loss")
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    log(f"  warm n_iters={n_iters} train step median {med:.1f} ms (min "
        f"{min(times):.1f}, max {max(times):.1f}); "
        f"{1e3 * batch.n_refs / med:.2f} ref-frames/s trained; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return {"n_iters": n_iters, "step_ms": times, "median_ms": med,
            "ref_frames_per_s": 1e3 * batch.n_refs / med, "peak_bytes": peak}


def fit_phase(device, card):
    """Phase 9e: `fit` with the default TrainConfig (n_iters_early = 1 at
    epoch 0) for one epoch over two in-memory golden batches, validated on
    one, from the regime's own initialisation: the steps must train the
    scene stages on the card (every backward wrapper launched) and log
    finite losses."""
    import tempfile

    import numpy as np

    from tdvnet_torch.config import Config
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.train import loop as L

    cfg = Config()
    batches = [golden_batch(GOLDEN_SEEDS), golden_batch(
        (2 * SERVE_SEEDS[0], 2 * SERVE_SEEDS[0] + 1))]
    reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tdvnet_fit_") as root:
        _, state = L.fit(cfg, batches, lambda: batches[:1], n_epochs=1,
                         log_dir=os.path.join(root, "runs"),
                         ckpt_dir=os.path.join(root, "ckpt"), device=device)
        with open(os.path.join(root, "runs", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    train = [r["train/loss"] for r in recs if "train/loss" in r]
    val = [r["val/loss"] for r in recs if "val/loss" in r]
    backward = {k: v for k, v in counts.items() if k.endswith("_backward")}
    ok = (L.n_iters_for_epoch(cfg, 0) == cfg.train.n_iters_early == 1
          and state.optimizer.count == len(batches) and len(train) >= 1
          and np.isfinite(train + val).all() and len(val) == 1
          and all(v > 0 for v in backward.values()))
    log(f"  fit, default TrainConfig (n_iters={L.n_iters_for_epoch(cfg, 0)}"
        f", lambda {L.lambda_for_epoch(cfg, 0)}), one epoch of "
        f"{len(batches)} batches: {seconds:.1f} s, optimizer steps "
        f"{state.optimizer.count}, train losses {train}, val loss {val}; "
        f"backward launches {json.dumps(backward)} "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    del state
    return ok, {"seconds": seconds, "train_loss": train, "val_loss": val,
                "launches": counts}


def train_phase(device, card):
    """Phase 9: the backward kernels against their twins and the variance
    reading; golden steps at n_iters 0 and 1 and a referee step at n_iters
    2, each timed warm; traces of an n_iters 0 and 1 step; `fit` with the
    default TrainConfig. Returns the phases' verdicts and readings."""
    import torch

    from tdvnet_torch.config import Config
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    log("phase 9a: backward kernels against their twins at the train "
        "steps' shapes (the scene sampling's also at one offset pass of the "
        "golden batch's n_iters=1 step)")
    from tdvnet_torch.tools.time_k6_backward import capture_sampling_backward

    real = capture_sampling_backward(WEIGHTS, device)
    torch.cuda.empty_cache()
    k_ok, per_kernel = kernel_phase(
        device, train_cases(device) + train_refine_cases(device, real=real))
    del real
    log("phase 9a: the source variance, kernel and fp32 twin against the "
        "twin in float64")
    v_ok, reading = variance_reading(device)
    cfg = Config()
    batch = golden_batch(GOLDEN_SEEDS).to(device)
    log("phase 9b'': two fresh runs of the golden steps at n_iters 0 and 1 "
        "must repeat bit for bit")
    out = {"kernels_ok": k_ok and v_ok, "per_kernel": per_kernel,
           "variance_reading": reading, "ok": {}, "counts": {},
           "timing": {}, "trace": {},
           "repeat_ok": train_repeat_phase(cfg, batch, device)}
    for run in TRAIN_RUNS:
        lam = L.lambda_for_epoch(cfg, run.epoch)
        tag = "9b" if run.n_iters < 2 else "9b'"
        log(f"phase {tag}: n_iters={run.n_iters} train steps (lambda {lam}, "
            f"epoch {run.epoch}'s) against a float64 referee"
            + (" and the JAX golden" if run.golden else ""))
        model = load_threedvnet(WEIGHTS, device=device)
        state = L.TrainState(model, L.make_optimizer(cfg, model, 1))
        step = L.make_train_step(model, cfg, run.n_iters)
        ok, counts, first_ms = train_golden_phase(state, step, batch, lam,
                                                  cfg, device, run)
        if run.n_iters == 2:
            ok &= repeat_phase(cfg, batch, lam, device, run.n_iters)
        out["ok"][run.n_iters], out["counts"][run.n_iters] = ok, counts
        log(f"  the first {run.steps} steps (cold): "
            f"{', '.join('%.1f ms' % t for t in first_ms)}")
        torch.cuda.empty_cache()
        log(f"phase 9c: warm n_iters={run.n_iters} train steps")
        timing = train_time_phase(state, step, batch, lam, card, run.n_iters)
        timing["first_step_ms"] = first_ms
        out["timing"][run.n_iters] = timing
        if run.n_iters < 2:
            log(f"phase 9d: trace of one n_iters={run.n_iters} train step")
            out["trace"][run.n_iters] = profile_phase(
                lambda: step(state, batch, lam),
                f"n_iters={run.n_iters} train step", card, prefix="train_")
        del state, model, step
        torch.cuda.empty_cache()
    log("phase 9e: fit with the default TrainConfig")
    out["fit_ok"], out["fit"] = fit_phase(device, card)
    torch.cuda.empty_cache()
    log("phase 9f: remat steps at n_iters 0 and 1 against the plain steps, "
        "bit for bit")
    out["remat_ok"], out["remat"] = remat_phase(cfg, batch, device, card)
    torch.cuda.empty_cache()
    log("phase 9g: grad_accum_steps=2 over the golden batch and a second "
        "one")
    batch2 = golden_batch((2 * SERVE_SEEDS[0], 2 * SERVE_SEEDS[0] + 1)).to(
        device)
    out["accum_ok"], out["accum"] = accum_phase(cfg, batch, batch2, device,
                                                card)
    del batch2
    torch.cuda.empty_cache()
    log("phase 9h: bf16 training at full width against JAX's own bf16 "
        "error")
    out["bf16_ok"], out["bf16"] = bf16_train_phase(cfg, batch, device, card)
    torch.cuda.empty_cache()
    log("phase 9h': fit with bf16_compute, remat and grad_accum_steps=2")
    out["fit16_ok"], out["fit16"] = fit_knobs_phase(device, card)
    torch.cuda.empty_cache()
    return out


def probe_phase(device):
    """Phase 10: both probe tools' cases on the card against the twins;
    per kernel the sums over the cases of one probe run (the launches
    counted). Then, outside the count: `batched_dot` at the ragged shapes,
    `take_along_axis` on out-of-range indices along both axes (NaN
    positions equal), and one `take_along_axis` call with the sync debug
    mode at "error" (a control first: a host reduction must raise there)."""
    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.kernels.probes import (batched_dot, batched_dot_ref,
                                             take_along_axis,
                                             take_along_axis_ref)
    from tdvnet_torch.tools import probe_batched_dot, probe_gather
    from tdvnet_torch.tools.timing import bf16_ulp_ok

    reset_launch_counts()
    dot = probe_batched_dot.run(device)
    gather = probe_gather.run(device)
    counts = launch_counts()
    per_kernel = {}
    for name, recs in (("batched_dot", [dot]), ("take_along_axis", gather)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "nbytes": 0.0, "flops": 0.0}
        for r in recs:
            flops = r.get("flops", 0.0)
            for k in ("ms", "plain_ms", "library_ms", "nbytes"):
                tot[k] += r[k]
            tot["flops"] += flops
            tot["bound_ms"] += 1e3 * max(r["nbytes"] / HBM_BYTES_PER_S,
                                         flops / BF16_FLOPS)
        per_kernel[name] = {
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in recs),
            "paths": {"probe": tot},
            "calls": [{**{k: v for k, v in r.items() if k != "name"},
                       "shape": r["name"], "path": "probe"} for r in recs]}
        log(f"  {name}: {tot['ms']:.4f} ms, library {tot['library_ms']:.4f} "
            f"ms ({tot['ms'] / tot['library_ms']:.3f}x the library), bound "
            f"{tot['bound_ms']:.5f} ms ({tot['bound_ms'] / tot['ms']:.3f} of "
            f"it)" + (f", {dot['bit_equal']:.6f} of elements bit-equal to "
                      f"the twin" if name == "batched_dot" else ""))
    ok = all(r["ok"] for r in [dot] + gather)

    for lead, Q, Y, C in probe_batched_dot.RAGGED:
        W, F = probe_batched_dot.make_shaped(device, lead, Q, Y, C, seed=5)
        got, want = batched_dot(W, F), batched_dot_ref(W, F)
        good = bf16_ulp_ok(got, want)
        log(f"  batched_dot {tuple(lead)} x [{Q},{Y}]@[{Y},{C}]: "
            f"{'ok' if good else 'FAIL'} (one bf16 ulp), "
            f"{float((got == want).double().mean()):.6f} bit-equal")
        ok &= good
    for name, axis, vals, idx in probe_gather.out_of_range_inputs():
        v, i = torch.from_numpy(vals).to(device), torch.from_numpy(idx).to(
            device)
        got, want = take_along_axis(v, i, axis), take_along_axis_ref(v, i,
                                                                     axis)
        good = bool(torch.equal(got.isnan(), want.isnan())
                    and torch.equal(got.nan_to_num(), want.nan_to_num())
                    and got.isnan().any())
        log(f"  take_along_axis {name}: {'ok' if good else 'FAIL'} "
            f"({int(got.isnan().sum())} NaN of {got.numel()})")
        ok &= good

    torch.cuda.synchronize()
    caught = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for what, fn in (("control int(idx.min())", lambda: int(i.min())),
                         ("take_along_axis", lambda: take_along_axis(
                             v, i, axis))):
            try:
                fn()
                caught[what] = False
            except RuntimeError:
                caught[what] = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    good = caught["control int(idx.min())"] and not caught["take_along_axis"]
    log(f"  sync debug mode 'error': the control raised "
        f"{caught['control int(idx.min())']}, take_along_axis synced "
        f"{caught['take_along_axis']}: {'ok' if good else 'FAIL'}")
    ok &= good
    return ok, per_kernel, counts, {"batched_dot": dot, "gather": gather}


# ----------------------------------------------------------- 3D evaluation
# the files `harness.main` writes per scene and beside the scenes
EVAL3D_SCENE_FILES = ("preds.npz", "metrics_2d.json",
                      "metrics_3d_0.010_3v_masked.json",
                      "fused_0.010_3v_masked.ply", "tsdf_mesh_masked.ply",
                      "metrics_tsdf_masked.json")
EVAL3D_AVG_FILES = ("metrics_2d.json", "metrics_3d_0.010_3v_masked.json",
                    "metrics_tsdf_masked.json")


def eval3d_record(path=EVAL3D_GOLDEN):
    import numpy as np

    with np.load(path) as z:
        return json.loads(str(z["record"]))


def eval3d_expected_launches(n_refs, ecfg):
    """Launches per wrapper in one scene's depth-3D and TSDF evaluation:
    one fusion per chunk of FUSION_REF_CHUNK refs, one TSDF integration per
    `tsdf_img_batch` frames."""
    from tdvnet_torch.kernels import WRAPPERS

    out = {w: 0 for w in WRAPPERS}
    out["consistency_fuse"] = -(-n_refs // FUSION_REF_CHUNK)
    out["tsdf_integrate"] = -(-n_refs // ecfg.tsdf_img_batch)
    return out


class recording_fused_points:
    """Within the block, every `fuse_point_cloud` of `fusion_module`
    appends its point count (before the downsample) to `counts`."""

    def __init__(self, fusion_module, counts):
        self.mod, self.counts = fusion_module, counts

    def __enter__(self):
        self.inner = inner = self.mod.fuse_point_cloud

        def recorded(*args, **kwargs):
            pts, rgb = inner(*args, **kwargs)
            self.counts.append(int(pts.shape[0]))
            return pts, rgb
        self.mod.fuse_point_cloud = recorded
        return self.counts

    def __exit__(self, *exc):
        self.mod.fuse_point_cloud = self.inner
        return False


def eval3d_metrics_ok(name, want, got):
    """One metrics file against the golden's, with the limits above."""
    ok = set(got) == set(want)
    for k, w in want.items():
        g = got.get(k, float("nan"))
        if k in EVAL3D_ABS:
            good = abs(g - w) <= EVAL3D_ABS[k]
        elif k.startswith("n_") or k == "n":
            good = abs(g - w) <= EVAL3D_COUNT_REL * max(abs(w), 1)
        else:
            good = abs(g - w) <= EVAL3D_REL_2D * max(abs(w), 1e-12)
        if not good:
            log(f"  {name} {k}: {g!r} against the golden's {w!r}")
        ok &= good
    return ok


def eval3d_golden_phase(root, device):
    """The golden scene written here, the recipe's predictions, then the 2D,
    fused-cloud and TSDF metrics with the GT-mesh masking, held to the JAX
    golden; K9 launches counted over the evaluation."""
    import numpy as np
    import torch

    from tdvnet_torch.config import EvalConfig
    from tdvnet_torch.data.synthetic_dataset import make_scene_dir
    from tdvnet_torch.eval import processresults as PR
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.ops import fusion, ply

    rec = eval3d_record()
    if rec["recipe"] != EVAL3D or rec["eval_overrides"] != EVAL3D_EVAL:
        raise RuntimeError(f"golden recipe {rec['recipe']} "
                           f"{rec['eval_overrides']} != {EVAL3D} "
                           f"{EVAL3D_EVAL}")
    r = EVAL3D
    t0 = time.perf_counter()
    scene = make_scene_dir(root, r["scene"], r["n_views"], r["hw"], r["seed"],
                           device)
    write_s = time.perf_counter() - t0
    with open(os.path.join(scene, "info.json")) as f:
        info = json.load(f)
    verts, faces, _ = ply.read_ply(info["gt_mesh"])
    poses = np.stack([np.asarray(fr["pose"], np.float32)
                      for fr in info["frames"]])
    k, n = r["k"], r["n_views"]
    preds = eval3d_preds(poses, info["intrinsics"],
                         PR.load_gt_depth(np.arange(k, n - k), scene),
                         r["scene"])
    save = os.path.join(root, "eval3d_golden")
    os.makedirs(save)
    np.savez(os.path.join(save, "preds.npz"), **preds)
    ecfg = EvalConfig(**EVAL3D_EVAL)
    fused, timings = [], {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recording_fused_points(fusion, fused):
        got = {"metrics_2d.json": PR.process_scene_2d_metrics(
            scene, save, device=device, timings=timings)}
        name3 = (f"metrics_3d_{ecfg.z_thresh:.3f}_"
                 f"{ecfg.n_consistent_thresh}v_masked.json")
        got[name3] = PR.process_depth_3d_metrics(
            scene, save, ecfg, True, device=device, timings=timings)
    eval_s = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(save, "metrics_tsdf_masked.json")) as f:
        got["metrics_tsdf_masked.json"] = json.load(f)
    expected = eval3d_expected_launches(len(preds["img_idx"]), ecfg)

    ok = set(got) == set(rec["metrics"])
    for name, want in rec["metrics"].items():
        m_ok = eval3d_metrics_ok(name, want, got.get(name, {}))
        log(f"  {name}: {json.dumps(got.get(name))} "
            f"{'ok' if m_ok else 'FAIL'}")
        ok &= m_ok
    n_fused = fused[0] if fused else -1
    fused_ok = abs(n_fused - rec["n_fused_points"]) \
        <= EVAL3D_COUNT_REL * rec["n_fused_points"]
    mesh_ok = abs(len(verts) - rec["gt_mesh_vertices"]) \
        <= EVAL3D_MESH_REL * rec["gt_mesh_vertices"]
    log(f"  scene written in {write_s:.2f} s (GT mesh {len(verts)} vertices,"
        f" {len(faces)} faces; golden {rec['gt_mesh_vertices']}, limit "
        f"{EVAL3D_MESH_REL:.1%}); evaluated in {eval_s:.2f} s; fused points "
        f"before the downsample {n_fused} (golden {rec['n_fused_points']})")
    log(f"  stage host seconds: {json.dumps(timings)}")
    log(f"  launches in that evaluation: {json.dumps(counts)} (expected "
        f"{json.dumps(expected)})")
    ok &= fused_ok and mesh_ok and counts == expected
    return ok, counts


def eval3d_config(save_dir):
    import dataclasses

    from tdvnet_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, fast_path=True, save_dir=save_dir, **EVAL3D_EVAL))


def eval3d_stream_phase(model, root, device, card):
    """`harness.main` with the model's fast-path `pred_fn` over three
    scenes written here: s/scene end to end, each stage's share of the
    summed stage seconds, the averaged metrics, every reference-named file;
    then a second call, which must reuse every cached file."""
    import math

    import torch

    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir
    from tdvnet_torch.eval import harness

    cfg = eval3d_config(os.path.join(root, "results"))
    t0 = time.perf_counter()
    scenes = [ensure_scene_dir(os.path.join(root, STREAM_DIR),
                               f"synth_{s:04d}", STREAM_VIEWS, EVAL3D["hw"],
                               s, device)
              for s in EVAL3D_STREAM_SEEDS]
    write_s = time.perf_counter() - t0
    inner = harness.make_3dvnet_pred_fn(model, cfg)
    calls = []

    def pred_fn(views, scene_dir, dset):
        calls.append(scene_dir)
        return inner(views, scene_dir, dset)

    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = harness.main("fast", pred_fn, cfg, scenes=scenes, device=device,
                       timings=timings)
    wall = time.perf_counter() - t0
    save = os.path.join(cfg.eval.save_dir, "fast")
    missing = [os.path.join(os.path.basename(sc), f) for sc in scenes
               for f in EVAL3D_SCENE_FILES
               if not os.path.exists(os.path.join(save, "scenes",
                                                  os.path.basename(sc), f))]
    missing += [f for f in EVAL3D_AVG_FILES
                if not os.path.exists(os.path.join(save, f))]
    total = sum(timings.values())
    shares = {k: v / total for k, v in sorted(timings.items())}
    finite = all(math.isfinite(v) for m in avg.values() for v in m.values())
    log(f"  {len(scenes)} scenes of {STREAM_VIEWS} views written in "
        f"{write_s:.2f} s; harness.main {wall:.3f} s: "
        f"{wall / len(scenes):.3f} s/scene end to end [{card}]")
    log(f"  stage host seconds {json.dumps(timings)}; shares "
        f"{json.dumps({k: round(v, 4) for k, v in shares.items()})}")
    for name, m in sorted(avg.items()):
        log(f"  averaged {name}: {json.dumps(m)}")

    stamp = lambda: {os.path.join(d, f): os.stat(os.path.join(
        save, "scenes", d, f)).st_mtime_ns
        for d in os.listdir(os.path.join(save, "scenes"))
        for f in os.listdir(os.path.join(save, "scenes", d))}
    before, n_calls = stamp(), len(calls)
    t0 = time.perf_counter()
    again = harness.main("fast", pred_fn, cfg, scenes=scenes, device=device)
    again_s = time.perf_counter() - t0
    reused = stamp() == before and len(calls) == n_calls and again == avg
    log(f"  second call {again_s:.3f} s, every cached file reused: {reused};"
        f" missing files: {missing}")
    ok = (not missing and reused and finite and len(calls) == len(scenes)
          and set(avg) == set(EVAL3D_AVG_FILES))
    return ok, {"seconds": wall, "s_per_scene": wall / len(scenes),
                "stage_seconds": timings, "stage_shares": shares,
                "metrics": avg, "second_call_s": again_s}, scenes


def eval3d_trace_phase(model, scene, root, device, card):
    """One scene's evaluation in this thread under the profiler (the
    harness runs the metrics on a thread the profiler does not see): load,
    predict, the 2D, fused-cloud and TSDF metrics, by stage span."""
    from tdvnet_torch.data import frameselector
    from tdvnet_torch.data.dataset import Dataset
    from tdvnet_torch.eval import harness
    from tdvnet_torch.eval.stages import stage

    cfg = eval3d_config(os.path.join(root, "trace"))
    e = cfg.eval
    dset = Dataset([scene], frameselector.NextPoseDistSelector(e.pdist, 20),
                   None, depth_img_size=e.depth_img_size,
                   img_size=cfg.batch.img_size,
                   n_src_on_either_side=e.n_src_on_either_side)
    save = os.path.join(e.save_dir, os.path.basename(scene))
    os.makedirs(save)
    pred_fn = harness.make_3dvnet_pred_fn(model, cfg)

    def run():
        with stage("eval_load"):
            views = dset.load_views(0, seed_idx=0)
        harness.write_scene_preds(views, scene, save, pred_fn, dset, e)
        harness.scene_metrics(scene, save, e, device=device)

    return profile_phase(run, f"3D evaluation of {os.path.basename(scene)}",
                         card, prefix="eval_")


# the command-line entry points (phase 11): the metrics both 11a and phase
# 8b compute (8b adds the TSDF's), and the training run's size
CLI_METRICS = ("metrics_2d.json", "metrics_3d_0.010_3v_masked.json")
CLI_TRAIN = ["--synthetic", "2", "--epochs", "1", "--steps-per-epoch", "2"]


def cli_eval_phase(root, stream):
    """11a: `eval_3dvnet.main` from the shipped `.npz` on the fast path
    over phase 8b's scenes (its own save dir; the CLI's config, in which
    the TSDF is off): the averaged 2D and fused-cloud metrics equal phase
    8b's, or else hold within section 2's limits."""
    from tdvnet_torch.tools import eval_3dvnet

    t0 = time.perf_counter()
    got = eval_3dvnet.main([
        "--ckpt-dir", WEIGHTS, "--dataset",
        f"synthetic:{os.path.join(root, STREAM_DIR)}", "--fast-path",
        "--save-dir", os.path.join(root, "cli_eval")])
    wall = time.perf_counter() - t0
    want = stream["metrics"]
    exact = all(got.get(f) == want.get(f) for f in CLI_METRICS)
    ok = set(got) == set(CLI_METRICS) and (exact or all(
        eval3d_metrics_ok(f, want[f], got[f]) for f in CLI_METRICS))
    for f in CLI_METRICS:
        log(f"  {f}: {json.dumps(got.get(f))}")
    log(f"  eval_3dvnet over {len(EVAL3D_STREAM_SEEDS)} scenes in "
        f"{wall:.2f} s; equal to phase 8b's: {exact} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, {"seconds": wall, "equal": exact}


def cli_train_phase(root):
    """11b: `train_3dvnet.main` at the default full-width config, 2
    synthetic scenes of 16 views (the cache in `root`), one epoch: one
    n_iters=1 step of 2 x 9 views at 256x320, then validation. Finite
    losses, the epoch's checkpoint and `.npz` export, and the launches of
    every training kernel, forward and backward (the backward exactly one
    step's: validation and the scenes' GT meshes launch forwards only)."""
    import tempfile

    import torch

    from tdvnet_torch.config import ModelConfig, TrainConfig
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.tools import train_3dvnet
    from tdvnet_torch.train import checkpoints as C

    out = {x: os.path.join(root, x) for x in ("ckpt", "log", "w.npz")}
    keep, tempfile.tempdir = tempfile.tempdir, root
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_3dvnet.main(CLI_TRAIN + [
            "--ckpt-dir", out["ckpt"], "--log-dir", out["log"],
            "--export-npz", out["w.npz"], "--export-every", "1"])
    finally:
        tempfile.tempdir = keep
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(out["log"], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = {k: v for r in recs for k, v in r.items()
              if k.endswith("loss") or k.endswith("loss_2d")}
    want = train_expected_launches(1, TrainConfig().n_iters_early,
                                   len(TrainConfig().offsets),
                                   ModelConfig().unet_res)
    trained = [w for w, n in want.items() if n]
    launches_ok = all(counts[w] == want[w] if w.endswith("_backward")
                      else counts[w] >= want[w] for w in trained)
    ok = (bool(losses) and "train/loss" in losses
          and all(math.isfinite(v) for v in losses.values())
          and C.latest_epoch(out["ckpt"]) == 1
          and os.path.exists(out["w.npz"]) and launches_ok)
    log(f"  train_3dvnet {' '.join(CLI_TRAIN)} in {wall:.2f} s: losses "
        f"{json.dumps(losses)}; checkpoint epoch "
        f"{C.latest_epoch(out['ckpt'])}")
    log(f"  launches {json.dumps({w: counts[w] for w in trained})} "
        f"(one step's {json.dumps({w: want[w] for w in trained})}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, {"seconds": wall, "losses": losses}, out


def cli_export_phase(root, trained):
    """11c: `export_weights.main` over 11b's checkpoint: the same arrays,
    bit for bit, as 11b's own `.npz` export (both fp16); then
    `eval_3dvnet.main` from that `.npz` over phase 8a's scene (the parity
    path): finite metrics."""
    import numpy as np

    from tdvnet_torch.tools import eval_3dvnet, export_weights

    t0 = time.perf_counter()
    path = export_weights.main(["--ckpt-dir", trained["ckpt"], "--out",
                                os.path.join(root, "exported.npz")])
    with np.load(path) as a, np.load(trained["w.npz"]) as b:
        same = sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a.files)
    avg = eval_3dvnet.main(["--ckpt-dir", path, "--dataset",
                            f"synthetic:{root}", "--save-dir",
                            os.path.join(root, "cli_export_eval")])
    wall = time.perf_counter() - t0
    finite = bool(avg) and all(math.isfinite(v) for m in avg.values()
                               for v in m.values())
    ok = same and finite and set(avg) == set(CLI_METRICS)
    log(f"  export equal to the training run's bit for bit: {same}; "
        f"eval of {EVAL3D['scene']} from it: {json.dumps(avg)} in "
        f"{wall:.2f} s {'ok' if ok else 'FAIL'}")
    return ok, {"seconds": wall, "metrics": avg}


# ---------------------------------------------------------------------- bf16
# bf16 inference (ModelConfig(dtype=bfloat16), parameters fp32): the JAX
# golden of its infer_depth and parity scene, which also records JAX's own
# bf16 error against unquantized fp32 runs of the same inputs
BF16_GOLDEN = os.path.join(ROOT, "tests", "data",
                           "torch_golden_bf16_synth48.npz")
# the port's bf16 depth against fp32 (median and p99 of |d depth|) at most
# this times JAX's own bf16 error, as the CPU tests hold it; on the card the
# port's fp32 run of the same batch or scene stands for JAX's fp32 (phases 3
# and 6a hold the two together)
BF16_ERR_RATIO = 1.5
# K1/K2's bf16 form against its float64 referee (the exact variance of the
# bf16 features' bilinear samples), relative to E[F^2], F the bilinear
# sample of the features' magnitudes (F >= |f|; where the taps cancel, the
# sample's fp32 rounding scales with F, not f): each sample rounds once to
# bf16 (unit roundoff 2^-8: |df| <= 2^-8 F), and to first order d var =
# (2/S) sum_s df_s (f_s - E f), so |d var| <= 2^-7 (E[F^2] + E[F]^2) <=
# 2^-6 E[F^2], and 1% more for the fp32 arithmetic around it; against its
# twin (the same roundings, the sample formed by fma in the kernel, so
# that a sample may round to the neighbouring bf16 value): 2^-6 E[F^2]; a
# bf16 variance adds one rounding of |var| <= E[F^2] to both
BF16_VAR_REL = 1.01 * 2.0 ** -6
BF16_VAR_TWIN_REL = 2.0 ** -6
# phase 11a': `eval_3dvnet --bf16` against the fp32 eval of the same scene,
# each metric within this share of the fp32 one: 1.5x the largest shift
# that JAX's own bf16 run makes in a golden's abs_rel (0.0281 -> 0.0305,
# 8.5%, the parity scene); counts within 1%
BF16_EVAL_REL = 0.13
BF16_EVAL_COUNT_REL = 1e-2
# the wrappers whose bf16 form a bf16 inference launches instead
BF16_OF = {"source_variance": "source_variance_bf16",
           "trilinear_sample": "trilinear_sample_bf16",
           "scatter_anchors_to_dense": "scatter_anchors_to_dense_bf16",
           "segment_max": "segment_max_bf16",
           "gather_concat": "gather_concat_bf16",
           "masked_group_norm": "masked_group_norm_bf16"}


def expected_bf16_launches(offsets_list, n_chunks, unet_res):
    """(fp32 wrapper launches, bf16 form launches) in one bf16 inference:
    `expected_launches` with the six calls that have a bf16 form moved to
    it; the bf16 backward forms none."""
    fp = expected_launches(offsets_list, n_chunks, unet_res)
    bf = {**{BF16_OF[w]: fp[w] for w in BF16_OF},
          **{b: 0 for b in BF16_BACKWARD_OF.values()}}
    fp.update({w: 0 for w in BF16_OF})
    return fp, bf


def all_launch_counts():
    from tdvnet_torch.kernels import bf16_launch_counts, launch_counts

    return {**launch_counts(), **bf16_launch_counts()}


def bf16_ulps(a, b, scale):
    """|a - b| in bf16 ulps at the magnitudes `scale` (float64)."""
    from tdvnet_torch.tools.timing import bf16_ulp

    return (a.double() - b.double()).abs() / bf16_ulp(scale.double().abs())


def gn_bf16_referee(x, mask, G, weight, bias, relu=False, skip=None):
    """The float64 referee of the bf16 masked GroupNorm and its tail: the
    statistics in float64 and the normalisation in fp32 of them, as the
    form specifies (an exact normalisation lands on the other side of a
    bf16 midpoint than the fp32 one about once in a million elements, which
    moves the result by two ulps), then the bf16 stores of the JAX
    package's graph (the normalised x, its product with the bf16 weight,
    the sum with the bf16 bias, the residual add) in float64. Returns (the
    result in float64, per element the magnitude its ops round at: the
    largest of the product, the bias and the skip)."""
    import torch

    B, C = x.shape[:2]
    bf = torch.bfloat16
    r = lambda a: a.to(bf).double()
    xg = x.double().reshape(B, G, C // G, -1)
    m = mask.double().reshape(B, 1, 1, -1)
    cnt = (m.sum(dim=(2, 3)) * (C // G)).clamp(min=1.0)
    mean = (xg * m).sum(dim=(2, 3)) / cnt
    var = (xg * xg * m).sum(dim=(2, 3)) / cnt - mean * mean
    rstd = torch.rsqrt(var.clamp(min=0.0) + 1e-5)
    xn = ((xg.float() - mean.float()[..., None, None])
          * rstd.float()[..., None, None]).double()
    shape = (1, C) + (1,) * (x.dim() - 2)
    xn = r(xn.reshape(x.shape))
    prod = r(xn * r(weight).reshape(shape))
    b = r(bias).reshape(shape)
    mk = mask.double()
    y = r(prod + b) * mk
    scale = torch.maximum(prod.abs(), b.abs().expand_as(prod))
    if skip is not None:
        y = r(y + skip.double())
        scale = torch.maximum(scale, skip.double().abs())
    if relu or skip is not None:
        y = y.clamp(min=0.0) * mk
    return y, scale


# the bf16 backward forms (bf16 training, phase 9h and the card tests):
# each against its plain twin (the fp32 backward on the widened inputs,
# rounded once to bf16) and its float64 referee (the same in float64 with
# the bf16 form's roundings: K1/K2's samples, K5's cast weight). K3's
# gather and K4's pool (g / n, rounded once) are bit-equal to both; the
# others' results are sums rounded once to bf16, within one bf16 ulp of
# the larger of |referee| and 2^-8 of the sum of their terms' magnitudes
# (where the terms cancel, the fp32 sums' rounding scales with those).
# K1/K2 resamples each source and rounds the sample to bf16 as the forward
# does; a sample whose fp32 value (an fma blend in the kernel) lies on the
# other side of a bf16 midpoint than the exact one rounds to the
# neighbouring bf16 value, which moves its terms by g 2 m / cnt w ulp(f),
# ulp(f) <= 2^-7 |f| <= 2^-7 F (F the sample of the features'
# magnitudes): its limit adds 2^-7 T, T the sum over an element's terms of
# |g| 2 m / cnt w F
BF16_VAR_BACKWARD_FLIP = 2.0 ** -7
# K1/K2's kernel projects the points with its own fma order, the twin with
# a matmul: their feature-space coordinates (below 128) differ by about an
# ulp (2^-17), VARIANCE_BACKWARD_TOL's cause in fp32; four allowed
BF16_VAR_BACKWARD_COORD_ULPS = 4
# K1/K2's, K6's and the concat-back's sums are fixed point
# (csrc/fixed_sum.cuh): each term is rounded to a multiple of 2^-k, k set per
# call from a bound on the terms (the inputs' largest magnitudes) and on how
# many an element can take, so an element of n terms lies within
# n 2^-(k+1) of the exact sum of its terms, whatever its own size. Where an
# element is far below the call's largest (a node or a feature pixel at the
# edge of the points) that floor passes its bf16 ulp, in the fp32 form as in
# the bf16 one; each of the three forms' limits adds it
# (`fixed_point_allowance`, n counted from the inputs as the kernel takes
# them).


def bf16_grad_check(got, twin, ref64, terms=None, exact=False, extra=None):
    """(max |got - twin| and |got - ref64| in bf16 ulps at the scale, ok)
    for one bf16 backward result (bf16 values, in the twin's dtype):
    bit-equal to the twin and to the
    referee's bf16 rounding with `exact`, else each within one bf16 ulp of
    the larger of |ref64| and 2^-8 `terms`, plus `extra` (float64, per
    element) where given."""
    import torch

    # bf16, or (K5's d weight and d bias) bf16 values held in fp32
    if got.dtype != twin.dtype or not same_bits(
            got, got.to(torch.bfloat16).to(got.dtype)):
        return float("inf"), float("inf"), False
    if exact:
        ok = same_bits(got, twin) and same_bits(got, ref64.to(torch.bfloat16))
        e = float((got.double() - ref64).abs().max()) if got.numel() else 0.
        return e, e, ok
    scale = ref64.abs()
    if terms is not None:
        scale = torch.maximum(scale, terms * 2.0 ** -8)
    ulp = bf16_ulp_of(scale)
    if extra is not None:
        ulp = ulp + extra
    d_twin = (got.double() - twin.double()).abs() / ulp
    d_ref = (got.double() - ref64).abs() / ulp
    m_twin = float(d_twin.max()) if got.numel() else 0.0
    m_ref = float(d_ref.max()) if got.numel() else 0.0
    return m_twin, m_ref, m_twin <= 1.0 and m_ref <= 1.0


def bf16_ulp_of(scale):
    from tdvnet_torch.tools.timing import bf16_ulp

    return bf16_ulp(scale.double())


def variance_backward_bf16_referee(grad, mean, pts, feats, sidx, smask,
                                   P_all, img):
    """K1/K2's bf16 backward in float64: (the referee, the allowance: for
    samples that round to the neighbouring bf16 value, BF16_VAR_BACKWARD_FLIP
    T, plus the fixed-point sum's and the projection's,
    `variance_backward_fixed_allowance`)."""
    import torch

    from tdvnet_torch.kernels.variance import source_variance_backward_ref

    rest = (sidx, smask, P_all, img)
    ref = source_variance_backward_ref(
        grad.double(), mean.double(), pts, feats.double(), *rest,
        sample_dtype=torch.bfloat16)
    terms = source_variance_backward_ref(
        grad.double().abs(), torch.zeros_like(mean, dtype=torch.float64),
        pts, feats.double().abs(), *rest)
    more = variance_backward_fixed_allowance(grad, mean, feats, pts, sidx,
                                             smask, P_all, img)
    return ref, BF16_VAR_BACKWARD_FLIP * terms + more.to(terms.device)


def _amax_exp(t):
    """fixedsum.exp_of of the largest finite |t| (as the kernels' amax
    pass reads it)."""
    import torch

    from tdvnet_torch.kernels.fixedsum import exp_of

    f = t.float().reshape(-1)
    f = f[torch.isfinite(f)]
    return exp_of(float(f.abs().max()) if f.numel() else 0.0)


def fixed_point_allowance(k, counts):
    """n 2^-(k+1): how far a fixed-point sum of n terms at scale 2^k can
    lie from the exact sum of its terms (float64)."""
    return counts.double() * 2.0 ** (-k - 1)


def variance_backward_fixed_allowance(grad, mean, feats, pts, sidx, smask,
                                      P_all, img):
    """K1/K2's backward beyond its rounding and the samples' flips, per
    element [N, Hf, Wf, C]: the fixed-point floor (every term below
    2^(e_g + e_f + 5), at most R P S an element: the kernel's scale; n the
    active sources' in-map taps on the pixel) plus the projection's:
    the kernel projects with its own fma order, so its feature-space
    coordinates may sit up to BF16_VAR_BACKWARD_COORD_ULPS fp32 ulps (of a
    coordinate below 128) from the twin's, which moves each tap's bilinear
    weight by at most 2 of them and may move a tap to the neighbouring
    pixel; an element then changes by at most that times the sum, over the
    points whose taps lie within one pixel of it, of a point's term
    without its weight, |g| 2 m / cnt (F + |mean|), F the sample of
    |features|."""
    import torch
    import torch.nn.functional as F_

    from tdvnet_torch.kernels.fixedsum import log2_ceil, scale_exp
    from tdvnet_torch.kernels.variance import _feature_scale, _source_xy
    from tdvnet_torch.ops.sampling import _floor_in, bilinear_sample_batched

    R, P, C = grad.shape
    N, Hf, Wf, _ = feats.shape
    S = sidx.shape[1]
    k = scale_exp(_amax_exp(grad) + _amax_exp(feats) + 5,
                  log2_ceil(max(R * P * S, 1)))
    sx, sy = _feature_scale(feats, img)
    scale = torch.tensor([sx, sy], dtype=torch.float32, device=pts.device)
    f64 = torch.float64
    counts = torch.zeros(N * Hf * Wf, 1, dtype=f64, device=pts.device)
    terms = torch.zeros(N * Hf * Wf, C, dtype=f64, device=pts.device)
    mask = smask.to(f64)
    cnt = mask.sum(dim=1).clamp(min=1.0)
    g_abs = grad.to(f64).abs()
    m_abs = mean.to(f64).abs()
    f_abs = feats.to(f64).abs()
    for s in range(S):
        idx = sidx[:, s]
        xy = _source_xy(pts, P_all, idx, scale)
        x, y = xy[..., 0], xy[..., 1]
        x0f, okx, x0 = _floor_in(x, Wf - 1)
        y0f, oky, y0 = _floor_in(y, Hf - 1)
        ok = okx & oky & torch.isfinite(x) & torch.isfinite(y) \
            & (smask[:, s] != 0)[:, None]
        a = g_abs * (2.0 * mask[:, s] / cnt)[:, None, None] * (
            bilinear_sample_batched(f_abs[idx], xy) + m_abs)
        base = idx[:, None] * (Hf * Wf)
        for xi, yi in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1),
                       (x0 + 1, y0 + 1)):
            inb = ok & (xi >= 0) & (xi <= Wf - 1) & (yi >= 0) \
                & (yi <= Hf - 1)
            rows = (base + yi.clamp(0, Hf - 1) * Wf
                    + xi.clamp(0, Wf - 1)).reshape(-1)
            counts.index_add_(0, rows, inb.reshape(-1, 1).to(f64))
            terms.index_add_(0, rows, torch.where(
                inb[..., None], a, torch.zeros_like(a)).reshape(-1, C))
    near = F_.avg_pool2d(terms.reshape(N, Hf, Wf, C).permute(0, 3, 1, 2),
                         3, stride=1, padding=1,
                         count_include_pad=True) * 9.0
    weight_moves = 2.0 * BF16_VAR_BACKWARD_COORD_ULPS * 2.0 ** -17
    return (fixed_point_allowance(k, counts).reshape(N, Hf, Wf, 1)
            + weight_moves * near.permute(0, 2, 3, 1))


def trilinear_backward_fixed_allowance(grad, pts, c0, cell, shape):
    """K6's grid backward: every term |g w| below 2^(e + 1), at most Q a
    node (the kernel's scale, clamped at 50 - e); n the in-grid taps on
    each node. [B, X, Y, Z, 1]."""
    import itertools

    import torch

    from tdvnet_torch.kernels.fixedsum import log2_ceil, scale_exp
    from tdvnet_torch.kernels.trilinear import _node_coords
    from tdvnet_torch.ops.sampling import _floor_in

    B, X, Y, Z, _ = shape
    e = _amax_exp(grad)
    k = max(min(scale_exp(e + 1, log2_ceil(max(pts.shape[1], 1))), 50 - e),
            -120)
    dims = (X, Y, Z)
    q = _node_coords(pts, c0, cell, 0.0)
    _, ok, i0 = zip(*[_floor_in(q[..., a], dims[a] - 1) for a in range(3)])
    anchor_ok = ok[0] & ok[1] & ok[2] & torch.isfinite(q).all(dim=-1)
    base = torch.arange(B, device=pts.device)[:, None]
    counts = torch.zeros(B * X * Y * Z, dtype=torch.float64,
                         device=pts.device)
    for d in itertools.product((0, 1), repeat=3):
        idx = [i0[a] + d[a] for a in range(3)]
        inb = anchor_ok
        for a in range(3):
            inb = inb & (idx[a] >= 0) & (idx[a] <= dims[a] - 1)
        xi, yi, zi = [idx[a].clamp(0, dims[a] - 1) for a in range(3)]
        rows = ((base * X + xi) * Y + yi) * Z + zi
        counts.index_add_(0, rows.reshape(-1), inb.reshape(-1).double())
    return fixed_point_allowance(k, counts).reshape(B, X, Y, Z, 1)


def concat_backward_fixed_allowance(grad, seg, n_seg):
    """The concat-back's segment sum: every term below 2^(e + 1) (e of
    the pooled half's largest |g|), at most P a segment; n the segment's
    rows. [n_seg, 1]."""
    import torch

    from tdvnet_torch.kernels.fixedsum import log2_ceil, scale_exp

    P, C2 = grad.shape
    k = scale_exp(_amax_exp(grad[:, C2 // 2:]) + 1, log2_ceil(max(P, 1)))
    inr = (seg >= 0) & (seg < n_seg)
    counts = torch.zeros(n_seg, dtype=torch.float64, device=grad.device)
    counts.index_add_(0, seg.clamp(0, n_seg - 1), inr.double())
    return fixed_point_allowance(k, counts)[:, None]


def gn_backward_bf16_referee(grad, x, mask, G, weight, out, relu, skip):
    """K5's bf16 backward in float64 (the bf16-cast weight, the ReLU seen
    in the output): ((d x, d weight, d bias, d skip or None), the sums of
    their terms' magnitudes)."""
    import torch

    from tdvnet_torch.kernels.groupnorm import (
        _group_stats, masked_group_norm_backward_ref)

    bf = torch.bfloat16
    w = weight.to(bf).double()
    ref = masked_group_norm_backward_ref(
        grad.double(), x.double(), mask.double(), G, w, out.double(), 1e-5,
        relu or skip, skip)
    B, C = x.shape[:2]
    xg, mean, var, cnt = _group_stats(x.double(), mask.double(), G)
    rstd = torch.rsqrt(var.clamp(min=0.0) + 1e-5)[..., None, None]
    xn = ((xg - mean[..., None, None]) * rstd).abs()
    m = mask.double().reshape(B, 1, 1, -1)
    g = grad.double().reshape(xg.shape).abs() * m
    if relu or skip:
        g = torch.where(out.double().reshape(xg.shape) > 0, g,
                        torch.zeros_like(g))
    wa = w.abs().reshape(1, G, C // G, 1)
    a = (wa * g).sum(dim=(2, 3)) / cnt
    bx = (wa * g * xn).sum(dim=(2, 3)) / cnt
    t_dx = rstd * (wa * g + m * (a[..., None, None]
                                 + xn * bx[..., None, None]))
    terms = (t_dx.reshape(x.shape), (g * xn).sum(dim=(0, 3)).reshape(C),
             g.sum(dim=(0, 3)).reshape(C), None)
    return ref, terms


class _Recorder:
    """A kernel wrapper's stand-in that records, per signature, its first
    call's inputs (cloned) and how often it is called, then calls it; its
    attributes (the launch counters) stay the wrapped function's."""

    def __init__(self, fn, name, calls):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *a, **kw):
        import torch

        def copy(v):
            if torch.is_tensor(v):
                return v.clone()
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*(copy(x) for x in v))
            if isinstance(v, tuple):
                return tuple(copy(x) for x in v)
            return v

        def sig(v):
            if torch.is_tensor(v):
                return (tuple(v.shape), str(v.dtype))
            if isinstance(v, tuple):
                return tuple(sig(x) for x in v)
            if hasattr(v, "_fields") or hasattr(v, "anchor_idx3"):
                return "table"
            return v

        key = (self._name, sig(a), tuple(sorted((k, sig(v))
                                                for k, v in kw.items())))
        if key not in self._calls:
            self._calls[key] = [copy(a), copy(kw), 0]
        self._calls[key][2] += 1
        return self._fn(*a, **kw)

    def __getattr__(self, k):
        return getattr(self._fn, k)

    def __setattr__(self, k, v):
        setattr(self._fn, k, v)


@contextlib.contextmanager
def _recording(sites, calls):
    """Within the block each (module, name) of `sites` is a `_Recorder`
    into `calls`."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]
    for mod, name, fn in saved:
        setattr(mod, name, _Recorder(fn, name, calls))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def capturing_bf16_calls(calls):
    """Within the block the call sites of the six kernels that have a bf16
    form record, per wrapper and shape, their first call's inputs (cloned)
    and how often that shape is called: the inputs of phase 2c's cases."""
    import tdvnet_torch.models.hypothesis as hypothesis
    import tdvnet_torch.models.layers as layers
    import tdvnet_torch.models.pointnet as pointnet
    import tdvnet_torch.ops.costvolume as costvolume
    import tdvnet_torch.ops.voxelize as vox

    with _recording(((costvolume, "source_variance"),
                     (hypothesis, "trilinear_sample"),
                     (pointnet, "segment_max"), (pointnet, "gather_concat"),
                     (vox, "scatter_anchors_to_dense"),
                     (layers, "masked_group_norm")), calls):
        yield


def bf16_cases(model, device):
    """Phase 2c's cases: each bf16 form on the inputs one bf16
    `infer_depth` of the golden batch gives it (captured), counted per
    inference as often as that path calls the shape, against its twin and
    its float64 referee (K1 within BF16_VAR_REL E[F^2] of the exact
    variance, F the sample of the features' magnitudes; K6 and K5 within one bf16
    ulp of theirs at the magnitude their ops round at; K4 and K3 equal to
    their twins and to the fp32 op on the same values cast to bf16). The
    byte bounds count bf16 storage; K6's library call is `F.grid_sample` in
    bf16 at the same points."""
    import torch
    import torch.nn.functional as F

    from tdvnet_torch.kernels import (gather_concat, masked_group_norm,
                                      scatter_anchors_to_dense, segment_max,
                                      source_variance, trilinear_sample)
    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref
    from tdvnet_torch.kernels.segmax import gather_concat_ref, segment_max_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.kernels.voxelize import scatter_anchors_to_dense_ref
    from tdvnet_torch.tools.time_sampling_gn import touched_cells

    calls = {}
    batch = golden_batch(GOLDEN_SEEDS)
    with capturing_bf16_calls(calls):
        model.infer_depth(batch, OFFSETS)
    torch.cuda.synchronize()
    bf = torch.bfloat16
    cases = []

    def equal_to(*refs):
        """Bit-equal to the twin and to each referee (closures)."""
        def tol(got, want):
            g = got if torch.is_tensor(got) else got[0]
            w = want if torch.is_tensor(want) else want[0]
            err = float((g.double() - w.double()).abs().max()) \
                if g.numel() else 0.0
            ok = same_bits(got, want) and all(
                same_bits(got, r()) for r in refs)
            return err, ok
        return tol

    for (name, _, _), (a, kw, count) in calls.items():
        if name == "source_variance":
            pts, feats, sidx, smask, P_all, img, plane = a
            od = kw.get("out_dtype") or torch.float32
            R, P = pts.shape[:2]
            C = feats.shape[-1]
            v64 = source_variance_ref(pts, feats.double(), sidx, smask,
                                      P_all, img)
            va, ma = source_variance_ref(pts, feats.double().abs(), sidx,
                                         smask, P_all, img, with_mean=True)
            ef2 = (va + ma * ma).clamp(min=1e-30)
            extra = 2.0 ** -8 if od == bf else 0.0
            del va, ma

            def var_tol(got, want, v64=v64, ef2=ef2, extra=extra, od=od):
                rel = lambda x: float(((x.double() - v64).abs() / ef2).max())
                twin = float(((got.double() - want.double()).abs()
                              / ef2).max())
                ref = rel(got)
                log(f"    variance vs float64 referee {ref:.3e} of E[F^2] "
                    f"(limit {BF16_VAR_REL + extra:.3e}), vs twin "
                    f"{twin:.3e} (limit {BF16_VAR_TWIN_REL + extra:.3e}); "
                    f"twin vs referee {rel(want):.3e}")
                err = float((got.double() - want.double()).abs().max())
                return err, (got.dtype == want.dtype == od
                             and twin <= BF16_VAR_TWIN_REL + extra
                             and ref <= BF16_VAR_REL + extra)

            active = float(smask.sum())
            osz = 2 if od == bf else 4
            what = "cost volume" if P > 8 * plane[0] * plane[1] \
                else ("scene cloud" if P == plane[0] * plane[1]
                      else "pointflow")
            cases.append(Case(
                "source_variance_bf16",
                f"{what} [{R},{P},{C}] bf16 -> {str(od)[6:]}", count,
                lambda a=a, od=od: source_variance(*a, out_dtype=od),
                lambda a=a, od=od: source_variance_ref(*a[:6], out_dtype=od),
                var_tol,
                4 * pts.numel() + 2 * feats.numel() + osz * R * P * C
                + 4 * P_all.numel() + 12 * sidx.numel(),
                active * P * (24 + 11 * C) + R * P * C * 4, path="bf16"))
        elif name == "trilinear_sample":
            grid, pts, c0, cell, out, off = a
            B, Q = pts.shape[:2]
            C = grid.shape[-1]
            ref64 = trilinear_sample_ref(grid.double(), pts, c0, cell)
            terms = trilinear_sample_ref(grid.double().abs(), pts, c0, cell)
            scale = torch.maximum(ref64.abs(), terms * 2.0 ** -8)
            del terms

            def tri_tol(got, want, ref64=ref64, scale=scale):
                twin = float(bf16_ulps(got, want, scale).max())
                ref = float(bf16_ulps(got, ref64, scale).max())
                log(f"    samples vs float64 referee {ref:.3f} ulp, vs twin "
                    f"{twin:.3f} ulp (limit 1)")
                err = float((got.double() - want.double()).abs().max())
                return err, got.dtype == bf and twin <= 1.0 and ref <= 1.0

            dims = "x".join(str(d) for d in grid.shape[1:4])
            # F.grid_sample in bf16 at the same points: [B, C, X, Y, Z]
            # with (z, y, x) coordinates normalised, align_corners=True
            lim = torch.tensor([d - 1 for d in grid.shape[1:4]],
                               device=device, dtype=torch.float32)
            gs_grid = ((pts - c0[:, None, :]) / cell / lim * 2 - 1).flip(
                -1).reshape(B, Q, 1, 1, 3).to(bf)
            gs_in = grid.permute(0, 4, 1, 2, 3)
            cases.append(Case(
                "trilinear_sample_bf16",
                f"s={round(cell / 0.08)} [{B},{dims},{C}] x {Q} bf16", count,
                lambda a=a, c=C: trilinear_sample(
                    *a[:4], torch.empty_like(a[4]), a[5])[..., a[5]:a[5] + c],
                lambda a=a: trilinear_sample_ref(*a[:4]), tri_tol,
                2 * (touched_cells(grid.shape, pts, c0, cell) * C + B * Q * C)
                + 4 * (pts.numel() + c0.numel()), B * Q * (30 + 16 * C),
                library=lambda a=(gs_in, gs_grid): F.grid_sample(
                    a[0], a[1], mode="bilinear", padding_mode="zeros",
                    align_corners=True), path="bf16"))
        elif name == "masked_group_norm":
            x, mask, G, w, b = a
            relu, skip = kw.get("relu", False), kw.get("skip")
            ref64, scale = gn_bf16_referee(x, mask, G, w, b, relu, skip)

            def gn_tol(got, want, ref64=ref64, scale=scale):
                twin = float(bf16_ulps(got, want, scale).max())
                ref = float(bf16_ulps(got, ref64, scale).max())
                log(f"    vs float64 referee {ref:.3f} ulp, vs twin "
                    f"{twin:.3f} ulp (limit 1)")
                err = float((got.double() - want.double()).abs().max())
                return err, got.dtype == bf and twin <= 1.0 and ref <= 1.0

            Bn, C = x.shape[:2]
            V = x[0, 0].numel()
            n_in = 2 if skip is not None else 1
            tail = "skip" if skip is not None else "relu"
            cases.append(Case(
                "masked_group_norm_bf16",
                f"{tail} [{Bn},{C},{'x'.join(map(str, x.shape[2:]))}] "
                f"G={G} bf16", count,
                lambda a=a, kw=kw: masked_group_norm(*a, **kw),
                lambda a=a, kw=kw: masked_group_norm_ref(*a, **kw), gn_tol,
                2 * (Bn * C * V * (n_in + 1) + Bn * V) + 8 * C,
                Bn * C * V * 8, path="bf16"))
        elif name == "segment_max":
            y, seg, valid, n_seg, plan = a
            P, C = y.shape
            rows = int((valid & (seg >= 0) & (seg < n_seg)).sum())
            idx = seg.clamp(0, n_seg - 1)[:, None].expand(P, C).contiguous()
            yv = torch.where(valid[:, None], y, torch.full_like(y, -1e30))
            pool0 = torch.full((n_seg, C), -1e30, device=device, dtype=bf)
            cases.append(Case(
                "segment_max_bf16", f"pool [{P},{C}] -> [{n_seg},{C}] bf16",
                count, lambda a=a: segment_max(*a),
                lambda a=a: segment_max_ref(*a[:4]),
                equal_to(lambda a=a: segment_max_ref(
                    a[0].float(), *a[1:4]).to(bf)),
                2 * (rows * C + n_seg * C) + 4 * (n_seg + 1 + rows), P * C,
                library=lambda p=pool0, i=idx, v=yv: p.scatter_reduce(
                    0, i, v, "amax"), path="bf16", repeat=True))
        elif name == "gather_concat":
            y, pooled, seg = a
            relu = kw.get("relu", False)
            P, C = y.shape
            used = torch.unique(seg.clamp(0, pooled.shape[0] - 1)).numel()
            cases.append(Case(
                "segment_max_bf16", f"concat-back [{P},{C}] -> [{P},{2 * C}]"
                " bf16", count,
                lambda a=a, r=relu: gather_concat(*a, relu=r),
                lambda a=a, r=relu: gather_concat_ref(*a, relu=r),
                equal_to(lambda a=a, r=relu: gather_concat_ref(
                    a[0].float(), a[1].float(), a[2], relu=r).to(bf)),
                2 * (P * C + used * C + 2 * P * C) + 8 * P, P * 2 * C,
                path="bf16"))
        elif name == "scatter_anchors_to_dense":
            feats, vg, grid, B = a
            A, C = feats.shape
            n_cells = B * grid[0] * grid[1] * grid[2]
            n_valid = int(vg.anchor_valid.sum())
            flat = (vg.anchor_idx3[:, 0] * grid[1] + vg.anchor_idx3[:, 1]) \
                * grid[2] + vg.anchor_idx3[:, 2]
            seg_a = (vg.anchor_scene * (n_cells // B) + flat)[vg.anchor_valid]
            feats_a = feats[vg.anchor_valid]
            cases.append(Case(
                "voxelize_bf16", f"scatter [{A},{C}] -> {B}x{grid} bf16",
                count, lambda a=a: scatter_anchors_to_dense(*a),
                lambda a=a: scatter_anchors_to_dense_ref(*a),
                equal_to(lambda a=a: tuple(
                    x.to(bf) for x in scatter_anchors_to_dense_ref(
                        a[0].float(), *a[1:]))),
                A + n_valid * (2 * C + 32) + n_cells * 2 * (C + 1), 0,
                library=lambda c=C, n=n_cells, s_=seg_a, f_=feats_a:
                torch.zeros(n, c, device=device, dtype=bf).index_put_(
                    (s_,), f_), path="bf16"))
    return cases


def depth_error_check(what, got16, got32, jax_err):
    """The port's |bf16 - fp32| against JAX's own (the golden's median and
    p99), each at most BF16_ERR_RATIO times."""
    import numpy as np

    d = np.abs(np.asarray(got16, np.float64) - np.asarray(got32, np.float64))
    ok = True
    parts = []
    for k, v in (("median", float(np.median(d))),
                 ("p99", float(np.percentile(d, 99)))):
        lim = BF16_ERR_RATIO * jax_err[k]
        ok &= v <= lim
        parts.append(f"{k} {v:.3e} m (JAX's {jax_err[k]:.3e}, x"
                     f"{v / max(jax_err[k], 1e-30):.2f}, limit x"
                     f"{BF16_ERR_RATIO})")
    log(f"  {what} |bf16 - fp32|: " + ", ".join(parts)
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def bf16_golden_record():
    import numpy as np

    with np.load(BF16_GOLDEN) as z:
        return json.loads(str(z["record"]))


def bf16_full_path_phase(model, device, fp32_out):
    """3': bf16 `infer_depth` on the golden batch: its |bf16 - fp32| per
    stage (against this run's fp32 `infer_stages`, `fp32_out`) within
    BF16_ERR_RATIO of JAX's own, its abs_rel and drop counters against the
    bf16 golden's, the bf16 forms' launch counts."""
    import numpy as np
    import torch

    from tdvnet_torch.eval.metrics2d import calc_2d_depth_metrics
    from tdvnet_torch.kernels import (bf16_launch_counts, launch_counts,
                                      reset_launch_counts)

    rec = bf16_golden_record()
    with np.load(BF16_GOLDEN) as z:
        g_init = z["depth_init"]
    if tuple(rec["seeds"]) != GOLDEN_SEEDS:
        raise RuntimeError(f"bf16 golden seeds {rec['seeds']}")
    batch = golden_batch(GOLDEN_SEEDS)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.infer_stages(batch, OFFSETS)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts, bcounts = launch_counts(), bf16_launch_counts()
    want, bwant = expected_bf16_launches(OFFSETS, 1, model.cfg.unet_res)
    final = out["final"]
    finite = bool(torch.isfinite(final).all()) and final.dtype == \
        torch.float32
    ok = finite
    for k in ("initial", "refined", "final"):
        ok &= depth_error_check(k, out[k].cpu().numpy(),
                                fp32_out[k].cpu().numpy(),
                                rec["jax_bf16_error"][k])
    d_init = np.abs(out["initial"].cpu().numpy() - g_init)
    abs_rel = float(calc_2d_depth_metrics(
        final, batch.depth_gt.to(device))["abs_rel"])
    stats = {k: int(v) for k, v in out["stats"].items()}
    log(f"  first bf16 infer_depth {first_ms:.1f} ms; initial depth vs the "
        f"bf16 golden: median {np.median(d_init):.3e} m, max "
        f"{d_init.max():.3e} m")
    log(f"  abs_rel {abs_rel:.6f}, bf16 golden {rec['abs_rel']:.6f} (limit "
        f"+-{ABS_REL_DELTA}); n_overflow={stats['n_overflow']} "
        f"n_out_of_grid={stats['n_out_of_grid']}")
    log(f"  launches: {json.dumps(counts)}; bf16 forms {json.dumps(bcounts)}"
        f" (expected {json.dumps(bwant)})")
    ok &= (abs(abs_rel - rec["abs_rel"]) <= ABS_REL_DELTA
           and stats["n_overflow"] == rec["n_overflow"]
           and stats["n_out_of_grid"] == rec["n_out_of_grid"]
           and counts == want and bcounts == bwant
           and all(bwant[f] > 0 for f in BF16_OF.values()))
    return ok, {**counts, **bcounts}, first_ms


def bf16_scene_phase(inf16, inf32, device):
    """6a': bf16 `predict_scene` on the golden scene: its |bf16 - fp32|
    against this run's fp32 `predict_scene` of the scene (unquantized
    fetches) within BF16_ERR_RATIO of JAX's own, its grid, drop counters
    and abs_rel against the bf16 golden's, the bf16 forms' launches."""
    import torch

    from tdvnet_torch.kernels import (bf16_launch_counts, launch_counts,
                                      reset_launch_counts)

    rec = bf16_golden_record()
    sc = rec["scene"]
    ev = inf16.cfg.eval
    views = scene_views(sc["n_views"], sc["seed"])
    d32 = inf32.predict_scene(views)
    torch.cuda.synchronize()
    reset_launch_counts()
    timings = {}
    t0 = time.perf_counter()
    d16 = inf16.predict_scene(views, timings)
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts, bcounts = launch_counts(), bf16_launch_counts()
    n_chunks = -(-sc["n_refs"] // ev.fused_chunk)
    want, bwant = expected_bf16_launches(inf16.offsets_list, n_chunks,
                                         inf16.model.cfg.unet_res)
    import numpy as np

    finite = bool(np.isfinite(d16).all())
    ok = finite and d16.shape == d32.shape and depth_error_check(
        "scene", d16, d32, rec["jax_bf16_error"]["scene"])
    abs_rel = scene_abs_rel(d16, views, ev.n_src_on_either_side, device)
    grid, stats = list(inf16.last_grid_size), inf16.last_scene_stats
    log(f"  first bf16 predict_scene {first_ms:.1f} ms; abs_rel "
        f"{abs_rel:.6f}, bf16 golden {sc['abs_rel']:.6f} (limit "
        f"+-{ABS_REL_DELTA}); grid {grid} (golden {sc['grid_size']}); stats "
        f"{json.dumps(stats)} (golden {json.dumps(sc['stats'])})")
    log(f"  bf16 forms' launches {json.dumps(bcounts)} (expected "
        f"{json.dumps(bwant)})")
    ok &= (abs(abs_rel - sc["abs_rel"]) <= ABS_REL_DELTA
           and grid == sc["grid_size"] and stats == sc["stats"]
           and counts == want and bcounts == bwant)
    return ok, {**counts, **bcounts}


def cli_bf16_eval_phase(root):
    """11a': `eval_3dvnet.main --bf16` from the shipped `.npz` over phase
    8a's scene (the parity path), against the fp32 eval of the same scene
    in this run: the averaged 2D and fused-cloud metrics within the bf16
    limits of PERF.md section 2 (BF16_EVAL_*)."""
    from tdvnet_torch.tools import eval_3dvnet

    got = {}
    secs = {}
    for name, flags in (("fp32", []), ("bf16", ["--bf16"])):
        t0 = time.perf_counter()
        got[name] = eval_3dvnet.main([
            "--ckpt-dir", WEIGHTS, "--dataset", f"synthetic:{root}",
            "--save-dir", os.path.join(root, f"cli_eval_{name}")] + flags)
        secs[name] = time.perf_counter() - t0
    ok = set(got["bf16"]) == set(got["fp32"]) == set(CLI_METRICS)
    for f in CLI_METRICS:
        want, have = got["fp32"].get(f, {}), got["bf16"].get(f, {})
        log(f"  {f}: fp32 {json.dumps(want)}")
        log(f"  {f}: bf16 {json.dumps(have)}")
        for k, w in want.items():
            g = have.get(k, float("nan"))
            if k.startswith("n_") or k == "n":
                good = abs(g - w) <= BF16_EVAL_COUNT_REL * max(abs(w), 1)
            else:
                good = abs(g - w) <= BF16_EVAL_REL * max(abs(w), 1e-12)
            if not good:
                log(f"  {f} {k}: bf16 {g!r} against fp32 {w!r}")
            ok &= good
    log(f"  eval_3dvnet of {EVAL3D['scene']}: fp32 {secs['fp32']:.2f} s, "
        f"bf16 {secs['bf16']:.2f} s {'ok' if ok else 'FAIL'}")
    return ok, {"seconds": secs, "metrics": got}


# ------------------------------------------------------ the training knobs
# bf16 training (phase 9h): JAX's own |bf16 - fp32| of one step at the
# settings of the two training goldens, from unquantized runs of both
# (`python tests/test_torch_golden.py --write-bf16-train`); the port's bf16
# step against its fp32 step of this run (phase 9b holds that to JAX's fp32)
# at most BF16_ERR_RATIO times JAX's own, per quantity
BF16_TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                                 "torch_golden_bf16_train_synth48.npz")
# the batches (scene seed pairs) whose errors pool: the golden batch and
# nine more, ten as the CPU test pools ten tiny scenes. One batch alone is
# no measure: its loss, one scalar, moved from 0.26x to 3.4x JAX's own
# error between n_iters 0 and 1 on an H100, and JAX's own error of the
# scene U-Net's gradient norm spans 0.0011 to 0.055 over four batches at
# n_iters=1, where a voxel that a point leaves or enters moves the scene
# stages (PERF.md, section 6)
BF16_TRAIN_SEEDS = (GOLDEN_SEEDS,) + tuple((2 * s, 2 * s + 1)
                                           for s in range(2, 11))
# warm steps timed in the remat and grad-accumulation regimes (phase 9f,
# 9g); the bf16 steps take TRAIN_TIMED, as fp32's
KNOB_TIMED = 5
# phase 11b': train_3dvnet with the three knobs over 11b's scenes, one scene
# a batch, so that the epoch's two microbatches make one update
CLI_TRAIN_KNOBS = CLI_TRAIN + ["--bf16", "--remat", "--grad-accum", "2",
                               "--batch-scenes", "1"]


def bf16_train_golden_record():
    import numpy as np

    with np.load(BF16_TRAIN_GOLDEN) as z:
        return json.loads(str(z["record"]))


def _trained(state):
    """The optimizer's parameters by name."""
    names = {id(p): k for k, p in state.model.named_parameters()}
    return {names[id(p)]: p for p in state.optimizer.params}


def remat_phase(cfg, batch, device, card):
    """9f: at n_iters 0 and 1 the golden steps with `remat=True` against
    the plain steps of this run, each from freshly loaded weights: every
    loss, parameter, gradient, Adam moment and BatchNorm statistic the same
    bits; the remat steps' launches (the forward's twice); the peak memory
    of both, then their warm step times."""
    import dataclasses

    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    cfg_r = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat=True))
    ok, out = True, {}
    for run in TRAIN_RUNS[:2]:
        recs, peaks = {}, {}
        for name, c in (("plain", cfg), ("remat", cfg_r)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            recs[name], _ = train_run_record(c, batch, device, run)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
            counts = launch_counts()
        want = train_expected_launches(run.steps, run.n_iters,
                                       len(cfg.train.offsets),
                                       cfg.model.unet_res, remat=True)
        a, b = recs["plain"], recs["remat"]
        moved = [k for k in a if k not in b or not same_bits(a[k], b[k])]
        good = not moved and len(a) == len(b) and counts == want
        launched = "as expected" if counts == want else \
            "FAIL " + json.dumps(counts)
        log(f"  n_iters={run.n_iters}, {run.steps} steps: remat against "
            f"plain, {len(moved)} of {len(a)} leaves moved"
            + (f" (the first {moved[0]})" if moved else "")
            + f"; launches {launched}; peak memory plain "
            f"{peaks['plain'] / 2**30:.2f} GiB, remat "
            f"{peaks['remat'] / 2**30:.2f} GiB {'ok' if good else 'FAIL'} "
            f"[{card}]")
        del recs, a, b
        ok &= good
        lam = L.lambda_for_epoch(cfg, run.epoch)
        model = load_threedvnet(WEIGHTS, device=device)
        state = L.TrainState(model, L.make_optimizer(cfg_r, model, 1))
        step = L.make_train_step(model, cfg_r, run.n_iters)
        timing = train_time_phase(state, step, batch, lam, card,
                                  f"{run.n_iters} remat", KNOB_TIMED)
        del state, model, step
        out[run.n_iters] = {"peak_bytes": peaks, "timing": timing,
                            "leaves": len(moved)}
    return ok, out


def accum_phase(cfg, batch, batch2, device, card):
    """9g: `grad_accum_steps=2` at n_iters=1 (the golden lambda) from
    freshly loaded weights over the golden batch, then a second batch:
    after microstep 1 every parameter keeps its bits and the BatchNorms'
    statistics have moved; after microstep 2 the mean Adam took is the
    Welford mean of the two microsteps' fp32 gradients as optax forms it
    in fp32, acc + (g - acc) / 2, bit for bit, and the update lies within
    TRAIN_UPDATE_REL lr (plus an fp32 ulp) of a float64 Adam step on that
    mean, every element. (The mean formed in float64 is no yardstick for
    the update: where the two gradients nearly cancel, |mean| comes near
    Adam's eps, and the fp32 mean's rounding moved such elements' first
    step by 2.5e-3 lr on an H100.) With the golden batch twice the update
    is bit-equal to one plain step on it (the mean of two equal values is
    exact). Two steps' launches; then warm microsteps timed."""
    import dataclasses

    import numpy as np
    import torch

    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    cfg_a = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=2))
    run = TRAIN_RUNS[1]
    lam = L.lambda_for_epoch(cfg, run.epoch)

    def fresh(c):
        model = load_threedvnet(WEIGHTS, device=device)
        state = L.TrainState(model, L.make_optimizer(c, model, 1))
        return state, L.make_train_step(model, c, run.n_iters)

    state, step = fresh(cfg_a)
    params = _trained(state)
    grads, means, opt = [], [], state.optimizer
    update = opt.step

    def capturing_step():
        grads.append({k: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).clone()
                      for k, p in params.items()})
        done = update()
        if done:        # the mean Adam took
            means.append({k: p.grad.clone() for k, p in params.items()})
        return done

    opt.step = capturing_step
    p0 = {k: p.detach().clone() for k, p in params.items()}
    bn0 = _bns_record(state.model, run.bns)
    torch.cuda.synchronize()
    reset_launch_counts()
    step(state, batch, lam)
    kept = all(same_bits(p0[k], p) for k, p in params.items()) \
        and opt.count == 0 and opt.mini_step == 1
    bn1 = _bns_record(state.model, run.bns)
    bn_moved = all(not np.array_equal(bn0[b][k], bn1[b][k])
                   for b in run.bns for k in ("running_mean", "running_var"))
    step(state, batch2, lam)
    counts = launch_counts()
    p1 = {k: p.detach().clone() for k, p in params.items()}
    want = train_expected_launches(2, run.n_iters, len(cfg.train.offsets),
                                   cfg.model.unet_res)
    log(f"  microstep 1: parameters {'kept' if kept else 'MOVED'}, "
        f"BatchNorm statistics {'moved' if bn_moved else 'KEPT'}; "
        f"optimizer updates after microstep 2: {opt.count}; launches "
        f"{'as expected' if counts == want else 'FAIL ' + json.dumps(counts)}")
    two = torch.full((), 2.0, device=device)
    welford = {k: grads[0][k] + (grads[1][k] - grads[0][k]) / two
               for k in p0}
    exact = len(means) == 1 and all(same_bits(means[0][k], welford[k])
                                    for k in p0)
    log(f"  the mean Adam took: optax's fp32 Welford mean of the two "
        f"microsteps' gradients {'bit for bit' if exact else 'FAIL'}")
    worst, _ = update_check(p0, p1, welford, cfg.train.lr,
                            "float64 Adam of that mean", noise=False)
    ok = kept and bn_moved and opt.count == 1 and counts == want \
        and exact and worst <= 1.0
    del state, step, grads, means, welford, p0, p1
    torch.cuda.empty_cache()
    state_a, step_a = fresh(cfg_a)
    for _ in range(2):
        step_a(state_a, batch, lam)
    state_p, step_p = fresh(cfg)
    step_p(state_p, batch, lam)
    pa, pp = _trained(state_a), _trained(state_p)
    equal = [k for k in pa if not same_bits(pa[k], pp[k])]
    log(f"  two equal microbatches against one plain step: {len(equal)} of "
        f"{len(pa)} parameters differ"
        + (f" (the first {equal[0]})" if equal else "")
        + f" {'ok' if not equal else 'FAIL'}")
    ok &= not equal
    del state_p, step_p, pa, pp
    torch.cuda.empty_cache()
    timing = train_time_phase(state_a, step_a, batch, lam, card,
                              f"{run.n_iters} grad-accum 2 (microstep)",
                              KNOB_TIMED)
    del state_a, step_a
    torch.cuda.empty_cache()
    return bool(ok), {"update_worst": worst, "timing": timing}


@contextlib.contextmanager
def capturing_bf16_backward_calls(calls):
    """Within the block the six backward wrappers record, per signature,
    their first call's inputs (cloned) and how often it is called: the
    inputs of phase 9h's kernel cases."""
    import tdvnet_torch.kernels.groupnorm as groupnorm
    import tdvnet_torch.kernels.segmax as segmax
    import tdvnet_torch.kernels.trilinear as trilinear
    import tdvnet_torch.kernels.variance as variance
    import tdvnet_torch.kernels.voxelize as voxelize

    with _recording(((variance, "source_variance_backward"),
                     (trilinear, "trilinear_sample_backward"),
                     (voxelize, "scatter_anchors_to_dense_backward"),
                     (segmax, "segment_max_backward"),
                     (segmax, "gather_concat_backward"),
                     (groupnorm, "masked_group_norm_backward")), calls):
        yield


def bf16_backward_cases(calls, device):
    """Phase 9h's cases: each bf16 backward form on the inputs one bf16
    n_iters=1 train step gives it (captured), counted as often as the step
    calls the shape, against its twin and its float64 referee by
    `bf16_grad_check`'s rules, with a second launch (and, for the sums over
    points, shuffled points) the same bits. Byte bounds count bf16
    storage; the library calls: `F.grid_sample`'s input gradient in bf16
    for K6, a row gather (`index_select`) for K3."""
    import torch
    import torch.nn.functional as F

    from tdvnet_torch.kernels import groupnorm, segmax, trilinear, variance
    from tdvnet_torch.kernels import voxelize as vox
    from tdvnet_torch.tools.time_sampling_gn import touched_cells

    bf = torch.bfloat16
    perm = shuffled_points()
    cases = []
    # K5's results without the d skip that a tail without skip leaves None
    some = lambda out: tuple(x for x in out if x is not None)    # noqa: E731

    def tol_of(ref, terms=None, exact=False, extra=None, many=False):
        """A Case tolerance: bf16_grad_check on each output (tuples where
        `many`, None entries skipped), logging its readings."""
        state = {}

        def tol(got, want):
            outs = got if many else (got,)
            wants = want if many else (want,)
            refs = ref if many else (ref,)
            tms = terms if many else (terms,)
            good, worst = True, (0.0, 0.0)
            for i, (g, w, r) in enumerate(zip(outs, wants, refs)):
                if g is None:
                    continue
                t = tms[i] if tms is not None else None
                e = exact[i] if isinstance(exact, tuple) else exact
                m_t, m_r, o = bf16_grad_check(g, w, r, t, e, extra)
                good &= o
                worst = (max(worst[0], m_t), max(worst[1], m_r))
            log(f"    vs twin {worst[0]:.3f}, vs float64 referee "
                f"{worst[1]:.3f} (limit 1)")
            g0 = outs[0]
            err = float((g0.double() - wants[0].double()).abs().max()) \
                if g0.numel() else 0.0
            return err, good
        return tol

    for (name, _, _), (a, kw, count) in calls.items():
        if name == "source_variance_backward":
            grad, mean, pts, feats, sidx, smask, P_all, img, plane = a
            if feats.dtype != bf:
                continue
            R, P, C = grad.shape
            ref, extra = variance_backward_bf16_referee(
                grad, mean, pts, feats, sidx, smask, P_all, img)
            active = float(smask.sum())
            what = "cost volume" if grad.dtype == bf else (
                "scene cloud" if P == plane[0] * plane[1] else "pointflow")

            def shuffled(a=a):
                i = perm(a[0].shape[1], device)
                return variance.source_variance_backward(
                    a[0][:, i].contiguous(), a[1][:, i].contiguous(),
                    a[2][:, i].contiguous(), *a[3:])

            cases.append(Case(
                "source_variance_backward_bf16",
                f"{what} [{R},{P},{C}] grad {str(grad.dtype)[6:]}", count,
                lambda a=a: variance.source_variance_backward(*a),
                lambda a=a: variance.source_variance_backward_ref(*a[:8]),
                tol_of(ref, extra=extra),
                grad.element_size() * grad.numel() + 4 * mean.numel()
                + 2 * 2 * feats.numel() + 4 * pts.numel()
                + 4 * P_all.numel() + 24 * sidx.numel(),
                active * P * (24 + 19 * C), path="train_bf16", repeat=True,
                shuffled=shuffled))
        elif name == "trilinear_sample_backward":
            grad, pts, c0, cell, shape = a
            if grad.dtype != bf:
                continue
            B, X, Y, Z, C = shape
            Q = pts.shape[1]
            ref = trilinear.trilinear_sample_backward_ref(
                grad.double(), pts, c0, cell, shape)
            terms = trilinear.trilinear_sample_backward_ref(
                grad.double().abs(), pts, c0, cell, shape)
            qn = (pts - c0[:, None, :]) / cell
            lim = torch.tensor([X - 1, Y - 1, Z - 1], device=device,
                               dtype=torch.float32)
            gs_grid = (qn / lim * 2 - 1).flip(-1).reshape(
                B, -1, 1, 1, 3).to(bf)
            gs_in = torch.zeros(B, C, X, Y, Z, device=device, dtype=bf,
                                requires_grad=True)
            gs_g = grad.permute(0, 2, 1).reshape(B, C, -1, 1, 1)

            def shuffled(a=a):
                i = perm(a[1].shape[1], device)
                return trilinear.trilinear_sample_backward(
                    a[0][:, i].contiguous(), a[1][:, i].contiguous(), *a[2:])

            cases.append(Case(
                "trilinear_sample_backward_bf16",
                f"s={round(cell / 0.08)} [{B},{Q},{C}] -> [{B},{X}x{Y}x{Z},"
                f"{C}] bf16", count,
                lambda a=a: trilinear.trilinear_sample_backward(*a),
                lambda a=a: trilinear.trilinear_sample_backward_ref(*a),
                tol_of(ref, terms, extra=trilinear_backward_fixed_allowance(
                    grad, pts, c0, cell, shape)),
                2 * (grad.numel() + B * X * Y * Z * C)
                + 4 * (pts.numel() + 3 * B), B * Q * (30 + 16 * C),
                library=lambda a=(gs_in, gs_grid, gs_g): torch.autograd.grad(
                    F.grid_sample(a[0], a[1], mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
                    a[0], a[2]),
                path="train_bf16", repeat=True, shuffled=shuffled))
        elif name == "masked_group_norm_backward":
            grad, x, mask, G, w, out, stats, eps, relu, skip = a
            if x.dtype != bf:
                continue
            bias = kw["bias"]
            ref, terms = gn_backward_bf16_referee(grad, x, mask, G, w, out,
                                                  relu, skip)
            Bn, C = x.shape[:2]
            V = x[0, 0].numel()
            tail = "skip" if skip else ("relu" if relu else "none")
            n_out = 2 if skip else 1
            cases.append(Case(
                "masked_group_norm_backward_bf16",
                f"{tail} [{Bn},{C},{'x'.join(map(str, x.shape[2:]))}] "
                f"G={G} bf16", count,
                lambda a=a, b=bias: some(
                    groupnorm.masked_group_norm_backward(*a, bias=b)),
                lambda a=a: some(groupnorm.masked_group_norm_backward_ref(
                    *a[:6], a[7], a[8], a[9])),
                tol_of(ref, terms, exact=(False, False, False, True),
                       many=True),
                2 * (Bn * C * V * (3 + n_out) + Bn * V)
                + 4 * (4 * C + Bn * G * 4), Bn * C * V * 16,
                path="train_bf16", repeat=True))
        elif name == "segment_max_backward":
            grad, y, seg, valid, pooled = a
            if y.dtype != bf:
                continue
            P, C = y.shape
            n_seg = pooled.shape[0]
            ref = segmax.segment_max_backward_ref(
                grad.double(), y.double(), seg, valid, pooled.double())
            cases.append(Case(
                "segment_max_backward_bf16",
                f"pool [{n_seg},{C}] -> [{P},{C}] bf16", count,
                lambda a=a: segmax.segment_max_backward(*a),
                lambda a=a: segmax.segment_max_backward_ref(*a),
                tol_of(ref, exact=True),
                2 * (4 * P * C) + 9 * P + 4 * n_seg * C, P * C,
                path="train_bf16", repeat=True))
        elif name == "gather_concat_backward":
            grad, y, pooled, seg, relu = a
            if y.dtype != bf:
                continue
            P, C = y.shape
            n_seg = pooled.shape[0]
            d = (grad.double(), y.double(), pooled.double(), seg)
            ref = segmax.gather_concat_backward_ref(*d, relu)
            terms = (None, segmax.gather_concat_backward_ref(
                d[0].abs(), *d[1:], relu)[1])

            def shuffled(a=a):
                i = perm(a[1].shape[0], device)
                gy, gp = segmax.gather_concat_backward(
                    a[0][i], a[1][i], a[2], a[3][i], a[4])
                back = torch.empty_like(gy)
                back[i] = gy
                return back, gp

            cases.append(Case(
                "segment_max_backward_bf16",
                f"concat-back [{P},{2 * C}] -> [{P},{C}], [{n_seg},{C}] "
                f"bf16", count,
                lambda a=a: segmax.gather_concat_backward(*a),
                lambda a=a: segmax.gather_concat_backward_ref(*a),
                tol_of(ref, terms, exact=(True, False), many=True,
                       extra=concat_backward_fixed_allowance(grad, seg,
                                                             n_seg)),
                2 * (2 * P * C + 3 * P * C + n_seg * C) + 8 * P, P * 2 * C,
                path="train_bf16", repeat=True, shuffled=shuffled))
        elif name == "scatter_anchors_to_dense_backward":
            grad, vg, grid, B = a
            if grad.dtype != bf:
                continue
            A = vg.anchor_idx3.shape[0]
            C = grad.shape[-1]
            ref = vox.scatter_anchors_to_dense_backward_ref(
                grad.double(), vg, grid, B)
            cells = torch.where(vg.anchor_valid,
                                vox._anchor_cells(vg, grid), 0)
            n_valid = int(vg.anchor_valid.sum())
            cases.append(Case(
                "scatter_dense_backward_bf16",
                f"gather [{B}x{grid},{C}] -> [{A},{C}] bf16", count,
                lambda a=a: vox.scatter_anchors_to_dense_backward(*a),
                lambda a=a: vox.scatter_anchors_to_dense_backward_ref(*a),
                tol_of(ref, exact=True),
                2 * (n_valid * C + A * C) + 33 * A, 0,
                library=lambda g=grad.reshape(-1, C), c=cells:
                torch.index_select(g, 0, c), path="train_bf16", repeat=True))
    return cases


def bf16_train_errors(got16, got32):
    """|bf16 - fp32| of one step's records: the losses and the gradient
    norms per module as scalars, the median and p99 over each gradient leaf
    and each BatchNorm statistic (the golden's layout)."""
    import numpy as np

    def stats(a, b):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        return {"median": float(np.median(d)),
                "p99": float(np.percentile(d, 99))}

    e = {k: abs(got16[k][0] - got32[k][0]) for k in ("loss", "loss_2d")}
    e["norms"] = {m: abs(got16["grad_norms"][m] - got32["grad_norms"][m])
                  for m in TRAIN_MODULES}
    e["grads"] = {k: stats(got16["leaves"][k], got32["leaves"][k])
                  for k in TRAIN_REFINE_LEAVES}
    e["bn"] = {f"{b}.{k}": stats(got16["bns"][b][k], got32["bns"][b][k])
               for b in TRAIN_REFINE_BNS
               for k in ("running_mean", "running_var")}
    return e


def _pooled(errs):
    """Each quantity of a list of per-batch error records, as its mean
    over the batches: {name: value}."""
    out = {}
    for k in ("loss", "loss_2d"):
        out[k] = sum(e[k] for e in errs) / len(errs)
    for group in ("norms", "grads", "bn"):
        for name in errs[0][group]:
            v = errs[0][group][name]
            if isinstance(v, dict):
                for q in v:
                    out[f"{group} {name} {q}"] = sum(
                        e[group][name][q] for e in errs) / len(errs)
            else:
                out[f"{group} {name}"] = sum(e[group][name]
                                             for e in errs) / len(errs)
    return out


def bf16_train_compare(port_errs, jax_errs, n_iters):
    """The port's |bf16 - fp32| against JAX's own, each quantity pooled
    (its mean over the batches of BF16_TRAIN_SEEDS) at most BF16_ERR_RATIO
    times JAX's; every reading logged beside its limit, with the golden
    batch's own ratio beside it."""
    ok = True
    worst = (0.0, None)
    port, jax = _pooled(port_errs), _pooled(jax_errs)
    first_p, first_j = _pooled(port_errs[:1]), _pooled(jax_errs[:1])
    for name, j in jax.items():
        p = port[name]
        good = p <= BF16_ERR_RATIO * j
        ratio = p / j if j > 0 else (0.0 if p == 0 else math.inf)
        one = (first_p[name] / first_j[name] if first_j[name] > 0
               else (0.0 if first_p[name] == 0 else math.inf))
        if ratio > worst[0]:
            worst = (ratio, name)
        log(f"    {name}: {p:.3e} (JAX {j:.3e}, x{ratio:.2f}; the golden "
            f"batch alone x{one:.2f}) {'ok' if good else 'FAIL'}")
        ok &= good
    log(f"  n_iters={n_iters}, pooled over {len(port_errs)} batches: the "
        f"largest ratio to JAX's own error x{worst[0]:.2f} ({worst[1]}), "
        f"limit x{BF16_ERR_RATIO} {'ok' if ok else 'FAIL'}")
    return ok


def bf16_train_phase(cfg, batch, device, card):
    """9h: bf16 training at full width. Per n_iters in (0, 1) one step of a
    bf16 and of an fp32 model from the synth48 weights on each batch of
    BF16_TRAIN_SEEDS, held to JAX's own |bf16 - fp32| pooled over them
    (`bf16_train_compare`), the golden batch's bf16 step's launches
    counted (every bf16 form, K8a and K8b in fp32); the bf16
    backward forms on a bf16 n_iters=1 step's inputs against their twins and
    float64 referees (`bf16_backward_cases`); two fresh bf16 runs of the
    golden n_iters=1 steps bit for bit; warm bf16 steps at n_iters 0, 1 and
    2 with their peak memory (fp32's are phase 9c's)."""
    import torch

    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.kernels import reset_launch_counts
    from tdvnet_torch.train import loop as L
    from tdvnet_torch.weights import load_threedvnet

    rec = bf16_train_golden_record()
    if [tuple(x) for x in rec["seeds"]] != list(BF16_TRAIN_SEEDS) \
            or rec["leaves"] != list(TRAIN_REFINE_LEAVES) \
            or rec["bns"] != list(TRAIN_REFINE_BNS):
        raise RuntimeError("bf16 train golden settings differ from the "
                           "script's")
    batches = [batch] + [golden_batch(seeds).to(device)
                         for seeds in BF16_TRAIN_SEEDS[1:]]
    mc16 = ModelConfig(dtype=torch.bfloat16)
    ok, out = True, {"counts": {}, "timing": {}}

    def fresh(model_cfg, n_iters):
        model = load_threedvnet(WEIGHTS, model_cfg, device=device)
        state = L.TrainState(model, L.make_optimizer(cfg, model, 1))
        return state, L.make_train_step(model, cfg, n_iters)

    for run in TRAIN_RUNS[:2]:
        lam = L.lambda_for_epoch(cfg, run.epoch)
        one = TrainRun(run.n_iters, None, run.epoch, TRAIN_REFINE_LEAVES,
                       TRAIN_REFINE_BNS, None, None, None, steps=1)
        errs = []
        jax_errs = rec["jax_bf16_error"][str(run.n_iters)]
        for b, (bt, je) in enumerate(zip(batches, jax_errs)):
            got = {}
            for name, mc in (("fp32", ModelConfig()), ("bf16", mc16)):
                state, step = fresh(mc, run.n_iters)
                torch.cuda.synchronize()
                reset_launch_counts()
                got[name] = train_steps_record(state, step, bt, lam, one)
                torch.cuda.synchronize()
                if name == "bf16" and b == 0:
                    counts = all_launch_counts()
                    dtypes = {p.dtype for p in state.model.parameters()}
                del state, step
                torch.cuda.empty_cache()
            errs.append(bf16_train_errors(got["bf16"], got["fp32"]))
            log(f"  n_iters={run.n_iters} seeds {BF16_TRAIN_SEEDS[b]}: loss "
                f"bf16 {got['bf16']['loss'][0]!r}, fp32 "
                f"{got['fp32']['loss'][0]!r} (JAX: {je['bf16_loss']!r}, "
                f"{je['fp32_loss']!r})")
            del got
        fp, bf = train_bf16_expected_launches(1, run.n_iters,
                                              len(cfg.train.offsets),
                                              cfg.model.unet_res)
        want = {**fp, **bf}
        launched = counts == want and dtypes == {torch.float32}
        log(f"  n_iters={run.n_iters}: parameters "
            f"{sorted(map(str, dtypes))}; the golden batch's launches "
            + ("as expected" if counts == want else
               f"FAIL {json.dumps(counts)} (expected {json.dumps(want)})"))
        ok &= launched & bf16_train_compare(errs, jax_errs, run.n_iters)
        out["counts"][run.n_iters] = counts
        out.setdefault("errors", {})[run.n_iters] = errs
    log("phase 9h: the bf16 backward forms against their twins and float64 "
        "referees, on a bf16 n_iters=1 step's inputs")
    calls = {}
    run = TRAIN_RUNS[1]
    state, step = fresh(mc16, run.n_iters)
    with capturing_bf16_backward_calls(calls):
        step(state, batch, L.lambda_for_epoch(cfg, run.epoch))
    torch.cuda.synchronize()
    del state, step
    torch.cuda.empty_cache()
    k_ok, per_kernel = kernel_phase(device, bf16_backward_cases(calls,
                                                                device))
    del calls
    torch.cuda.empty_cache()
    ok &= k_ok
    out["per_kernel"] = per_kernel
    log("phase 9h: two fresh bf16 runs of the golden n_iters=1 steps must "
        "repeat bit for bit")
    (a, order), (b, _) = (train_run_record(cfg, batch, device, run, mc16)
                          for _ in range(2))
    moved = [k for k in a if k not in b or not same_bits(a[k], b[k])]
    first = next((f"{w} {k}" for k in order for w in (
        "gradient", "parameter") if f"{w} {k}" in moved), None)
    rep = not moved and len(a) == len(b)
    log(f"  {len(moved)} of {len(a)} leaves moved"
        + (f", the first {first or moved[0]}" if moved else "")
        + f" {'ok' if rep else 'FAIL'}")
    ok &= rep
    del a, b
    torch.cuda.empty_cache()
    for run in TRAIN_RUNS:
        log(f"phase 9h: warm bf16 n_iters={run.n_iters} train steps")
        state, step = fresh(mc16, run.n_iters)
        out["timing"][run.n_iters] = train_time_phase(
            state, step, batch, L.lambda_for_epoch(cfg, run.epoch), card,
            f"{run.n_iters} bf16")
        del state, step
        torch.cuda.empty_cache()
    return bool(ok), out


def fit_knobs_phase(device, card):
    """9h': `fit` with bf16_compute, remat and grad_accum_steps=2 for one
    epoch over two in-memory golden batches, validated on one: one update,
    finite losses, the epoch's checkpoint (at mini-step 0) and its `.npz`
    export (fp32 weights, loaded back)."""
    import tempfile

    import numpy as np
    import torch

    from tdvnet_torch.config import Config, TrainConfig
    from tdvnet_torch.train import checkpoints as C
    from tdvnet_torch.train import loop as L

    cfg = Config(train=TrainConfig(bf16_compute=True, remat=True,
                                   grad_accum_steps=2))
    batches = [golden_batch(GOLDEN_SEEDS), golden_batch(
        (2 * SERVE_SEEDS[0], 2 * SERVE_SEEDS[0] + 1))]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tdvnet_fit16_") as root:
        npz = os.path.join(root, "w.npz")
        model, state = L.fit(cfg, batches, lambda: batches[:1], n_epochs=1,
                             log_dir=os.path.join(root, "runs"),
                             ckpt_dir=os.path.join(root, "ckpt"),
                             export_npz=npz, export_every=1, device=device)
        with open(os.path.join(root, "runs", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        variables, epoch = C.load_npz(npz)
        saved = torch.load(os.path.join(root, "ckpt", "epoch_00001.pt"),
                           map_location="cpu", weights_only=True)
        ck_ok = (C.latest_epoch(os.path.join(root, "ckpt")) == 1
                 and saved["optimizer"]["mini_step"] == 0
                 and saved["optimizer"]["count"] == 1 and epoch == 1
                 and bool(variables["params"]))
    seconds = time.perf_counter() - t0
    train = [r["train/loss"] for r in recs if "train/loss" in r]
    val = [r["val/loss"] for r in recs if "val/loss" in r]
    ok = (model.cfg.dtype == torch.bfloat16
          and all(p.dtype == torch.float32 for p in model.parameters())
          and state.optimizer.count == 1 and state.optimizer.mini_step == 0
          and len(train) >= 1 and len(val) == 1
          and np.isfinite(train + val).all() and ck_ok)
    log(f"  fit (bf16_compute, remat, grad_accum_steps=2), one epoch of "
        f"{len(batches)} batches: {seconds:.1f} s, optimizer updates "
        f"{state.optimizer.count}, train losses {train}, val loss {val}, "
        f"checkpoint and export {'written' if ck_ok else 'FAIL'} "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    del model, state
    return bool(ok), {"seconds": seconds, "train_loss": train,
                      "val_loss": val}


def cli_train_knobs_phase(root):
    """11b': `train_3dvnet.main` with --bf16 --remat --grad-accum 2 over
    11b's scenes (the cache in `root`), one scene a batch: finite losses,
    the epoch's checkpoint and `.npz` export, and one update's launches of
    the bf16 backward forms and of K8a's and K8b's fp32 backwards (each
    microstep runs one backward)."""
    import tempfile

    import torch

    from tdvnet_torch.config import ModelConfig, TrainConfig
    from tdvnet_torch.kernels import reset_launch_counts
    from tdvnet_torch.tools import train_3dvnet
    from tdvnet_torch.train import checkpoints as C

    out = {x: os.path.join(root, x) for x in ("ckpt16", "log16", "w16.npz")}
    keep, tempfile.tempdir = tempfile.tempdir, root
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        model, state = train_3dvnet.main(CLI_TRAIN_KNOBS + [
            "--ckpt-dir", out["ckpt16"], "--log-dir", out["log16"],
            "--export-npz", out["w16.npz"], "--export-every", "1"])
    finally:
        tempfile.tempdir = keep
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_launch_counts()
    with open(os.path.join(out["log16"], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = {k: v for r in recs for k, v in r.items()
              if k.endswith("loss") or k.endswith("loss_2d")}
    fp, bf = train_bf16_expected_launches(2, TrainConfig().n_iters_early,
                                          len(TrainConfig().offsets),
                                          ModelConfig().unet_res)
    backward = {w: n for w, n in {**fp, **bf}.items()
                if w.endswith("_backward") or w.endswith("_backward_bf16")}
    launches_ok = all(counts[w] == n for w, n in backward.items())
    ok = (bool(losses) and "train/loss" in losses
          and all(math.isfinite(v) for v in losses.values())
          and model.cfg.dtype == torch.bfloat16
          and state.optimizer.count == 1
          and C.latest_epoch(out["ckpt16"]) == 1
          and os.path.exists(out["w16.npz"]) and launches_ok)
    log(f"  train_3dvnet {' '.join(CLI_TRAIN_KNOBS)} in {wall:.2f} s: "
        f"losses {json.dumps(losses)}; updates {state.optimizer.count}; "
        f"checkpoint epoch {C.latest_epoch(out['ckpt16'])}")
    log(f"  backward launches "
        f"{json.dumps({w: counts[w] for w in backward if backward[w]})} "
        f"(two microsteps' "
        f"{json.dumps({w: n for w, n in backward.items() if n})}) "
        f"{'ok' if ok else 'FAIL'}")
    del model, state
    return ok, {"seconds": wall, "losses": losses}


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tdvnet_torch.config import set_fp32_numerics
    from tdvnet_torch.kernels.build import library
    from tdvnet_torch.weights import load_threedvnet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")
    set_fp32_numerics()

    log("phase 1: build")
    info = library().build_info
    log(f"  built={info.built} in {info.seconds:.1f} s ({info.lib_path})")
    for line in info.ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())

    log("phase 2: kernels against their twins")
    k_ok, per_kernel = kernel_phase(device)
    log("phase 2b: the segment plan and K8b's backward at their edge "
        "inputs; K8b past 384 planes, K1 and K6 at odd channel counts")
    edge_ok, _ = kernel_phase(device, edge_cases(device))

    log("phase 2c: the bf16 forms against their twins and float64 "
        "referees, on the inputs of a bf16 infer_depth")
    import dataclasses

    from tdvnet_torch.config import Config, ModelConfig

    model16 = load_threedvnet(WEIGHTS, ModelConfig(dtype=torch.bfloat16),
                              device=device)
    b_ok, bf16_kernels = kernel_phase(device, bf16_cases(model16, device))
    per_kernel.update(bf16_kernels)

    log("phase 3: full-width infer_depth against the JAX golden")
    model = load_threedvnet(WEIGHTS, device=device)
    f_ok, counts, first_ms = full_path_phase(model, device)
    log("phase 3': full-width bf16 infer_depth against this run's fp32 one "
        "and the JAX bf16 golden")
    fp32_out = model.infer_stages(golden_batch(GOLDEN_SEEDS), OFFSETS)
    f16_ok, bf16_counts, first16_ms = bf16_full_path_phase(model16, device,
                                                           fp32_out)
    del fp32_out

    log("phase 4: serve")
    times, peak, n_refs = serve_phase(model, card)
    log("phase 4': serve in bf16")
    times16, peak16, _ = serve_phase(model16, card)
    log(f"  ms per batch: bf16 {[round(t, 1) for t in times16]}, fp32 "
        f"{[round(t, 1) for t in times]} (this run) [{card}]")

    log("phase 5: trace")
    batch = golden_batch((2 * SERVE_SEEDS[0], 2 * SERVE_SEEDS[0] + 1))
    trace = profile_phase(lambda: model.infer_depth(batch, OFFSETS),
                          "infer_depth", card)

    log("phase 6a: whole-scene predict_scene against the JAX golden")
    from tdvnet_torch.eval.fused_scene import FusedSceneInference

    inf = FusedSceneInference(model, Config(), offsets_list=OFFSETS,
                              fetch_mm=True)
    g_ok, scene_counts = scene_golden_phase(inf, device)
    log("phase 6b: predict_scenes over a stream of scenes")
    s_ok, stream = scene_stream_phase(inf, device, card)
    log("phase 6a': bf16 predict_scene against this run's fp32 one and the "
        "JAX bf16 golden")
    cfg16 = dataclasses.replace(Config(), model=model16.cfg)
    g16_ok, scene16_counts = bf16_scene_phase(
        FusedSceneInference(model16, cfg16, offsets_list=OFFSETS,
                            fetch_mm=False),
        FusedSceneInference(model, Config(), offsets_list=OFFSETS,
                            fetch_mm=False), device)
    log("phase 6b': bf16 predict_scenes over the stream")
    inf16 = FusedSceneInference(model16, cfg16, offsets_list=OFFSETS,
                                fetch_mm=True)
    s16_ok, stream16 = scene_stream_phase(inf16, device, card)
    log(f"  s/scene: bf16 {stream16['scene_seconds']}, fp32 "
        f"{stream['scene_seconds']} (this run) [{card}]")
    log("phase 6c: trace of one scene")
    views = scene_views(STREAM_VIEWS, STREAM_SEEDS[0])
    scene_trace = profile_phase(lambda: inf.predict_scene(views),
                                f"predict_scene ({STREAM_VIEWS} views)", card)

    log("phase 7a: fast-path predict_scene against the JAX fast golden")
    cfg = Config()
    fast = FusedSceneInference(
        model, dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, fast_path=True)), fetch_mm=True)
    fg_ok, fast_counts = scene_golden_phase(fast, device, FAST_SCENE_GOLDEN)
    log("phase 7b: fast-path predict_scenes over the stream")
    fs_ok, fast_stream = scene_stream_phase(fast, device, card,
                                            FAST_SCENE_GOLDEN)
    log("phase 7c: trace of one fast-path scene")
    fast_trace = profile_phase(lambda: fast.predict_scene(views),
                               f"fast predict_scene ({STREAM_VIEWS} views)",
                               card)

    # the datasets of phases 8 and 11 live in a temporary directory,
    # removed at the end whatever happens (a finalizer at exit)
    tmp = tempfile.TemporaryDirectory(prefix="tdvnet_eval3d_")
    root = tmp.name
    log("phase 8a: 3D evaluation of the golden scene against the JAX "
        "golden")
    e_ok, eval3d_counts = eval3d_golden_phase(root, device)
    log("phase 8b: harness.main over a stream of scenes (fast path, "
        "TSDF on)")
    es_ok, eval3d_stream, scenes = eval3d_stream_phase(model, root,
                                                       device, card)
    log("phase 8c: trace of one scene's 3D evaluation")
    eval3d_trace = eval3d_trace_phase(model, scenes[0], root, device,
                                      card)

    del model, inf, fast, model16, inf16
    torch.cuda.empty_cache()
    train = train_phase(device, card)
    for name, k in {**train["per_kernel"],
                    **train["bf16"].pop("per_kernel")}.items():
        if name in per_kernel:          # a forward's training shapes
            per_kernel[name]["paths"].update(k["paths"])
            per_kernel[name]["calls"] += k["calls"]
        else:
            per_kernel[name] = k

    log("phase 10: probes")
    p_ok, probe_kernels, probe_counts, probes = probe_phase(device)
    per_kernel.update(probe_kernels)

    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    log("phase 11a: eval_3dvnet over phase 8b's scenes against phase 8b")
    ca_ok, cli = cli_eval_phase(root, eval3d_stream)
    log("phase 11a': eval_3dvnet --bf16 over phase 8a's scene against the "
        "fp32 eval of it")
    ca16_ok, cli["bf16"] = cli_bf16_eval_phase(root)
    log("phase 11b: train_3dvnet at the full-width config")
    cb_ok, cli["train"], trained = cli_train_phase(root)
    log("phase 11b': train_3dvnet --bf16 --remat --grad-accum 2 over 11b's "
        "scenes")
    cb16_ok, cli["train_knobs"] = cli_train_knobs_phase(root)
    log("phase 11c: export_weights of 11b's checkpoint, then eval_3dvnet "
        "from it")
    cc_ok, cli["export"] = cli_export_phase(root, trained)
    cli["phase_seconds"] = time.perf_counter() - t11
    log(f"  phase 11 in {cli['phase_seconds']:.1f} s")
    tmp.cleanup()

    # per kernel, over one run of its main path (the keys of the contract):
    # infer_depth, the fast whole scene for the fast path's kernels, one
    # scene's 3D evaluation for K9; beside them the launches of every
    # wrapper on that path and the launches and sums of the other paths
    kernels = []
    runs = {"infer_depth": (counts, trace), "scene": (scene_counts,
                                                      scene_trace),
            "fast": (fast_counts, fast_trace),
            "eval3d": (eval3d_counts, eval3d_trace),
            "train": (train["counts"][0], train["trace"][0]),
            "train1": (train["counts"][1], train["trace"][1]),
            "probe": (probe_counts, None)}
    # every run's counts with the bf16 forms' (0 where none ran); the bf16
    # infer_depth (phase 3') is the bf16 forms' main path
    from tdvnet_torch.kernels import BF16_FORMS

    runs = {p: ({**{k: 0 for k in BF16_FORMS}, **c}, t)
            for p, (c, t) in runs.items()}
    runs["bf16"] = (bf16_counts, None)
    # one bf16 n_iters=1 train step (phase 9h) is the bf16 backward forms'
    runs["train_bf16"] = (train["bf16"]["counts"][1], None)
    sums = lambda t: t and {x: t[x] for x in (
        "ms", "plain_ms", "bound_ms", "library_ms")}
    for name, k in per_kernel.items():
        src, replaces, wrappers = KERNEL_META[name]
        main_path = MAIN_PATHS.get(name, "infer_depth")
        tot = k["paths"][main_path]
        launches = {p: sum(c[w] for w in wrappers)
                    for p, (c, _) in runs.items()}
        traced = {p: t["ported_kernels"][name]["ms"] if t else None
                  for p, (_, t) in runs.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "main_path": main_path,
            "wrappers": {w: runs[main_path][0][w] for w in wrappers},
            "launches": launches[main_path],
            "max_abs_err": k["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by(tot["nbytes"], tot["flops"]),
            "library_ms": tot["library_ms"],
            "trace_ms": traced[main_path],
            "scene_launches": launches["scene"],
            "bf16_scene_launches": sum(scene16_counts[w] for w in wrappers),
            "fast_scene_launches": launches["fast"],
            "eval3d_launches": launches["eval3d"],
            "train_launches": launches["train"],
            "train1_launches": launches["train1"],
            "train_bf16_launches": launches["train_bf16"],
            "scene": sums(k["paths"].get("scene")),
            "scene_trace_ms": traced["scene"],
            "fast_scene_trace_ms": traced["fast"],
            "calls": k["calls"]})
    log(json.dumps({"serve_ms": times, "first_infer_ms": first_ms,
                    "ref_frames_per_s": [1e3 * n_refs / t for t in times],
                    "peak_bytes": peak, "card": card, "trace": trace,
                    "scene_stream": stream, "scene_trace": scene_trace,
                    "fast_scene_stream": fast_stream,
                    "fast_scene_trace": fast_trace,
                    "eval3d_stream": eval3d_stream,
                    "eval3d_trace": eval3d_trace,
                    "train": train["timing"], "train_trace": train["trace"],
                    "train_launches": train["counts"],
                    "variance_reading": train["variance_reading"],
                    "fit": train["fit"], "probes": probes, "cli": cli,
                    "remat": train["remat"], "accum": train["accum"],
                    "bf16_train": train["bf16"], "fit16": train["fit16"],
                    "bf16": {"serve_ms": times16, "peak_bytes": peak16,
                             "first_infer_ms": first16_ms,
                             "scene_stream": stream16}}))
    # one device kernel a call, in every trace that calls them (the
    # profiler may drop a kernel of a trace, never add one)
    one_launch = {(k, p): t["ported_kernels"][k] for k in ONE_KERNEL_A_CALL
                  for p, (_, t) in runs.items() if t}
    for (k, p), r in one_launch.items():
        log(f"  {k} in the {p} trace: {r['launches']} device kernels over "
            f"{r['calls']} calls")
    phases = {"kernels": k_ok, "edge inputs": edge_ok,
              "bf16 kernels": b_ok, "bf16 full path": f16_ok,
              "bf16 scene golden": g16_ok, "bf16 scene stream": s16_ok,
              "cli eval bf16": ca16_ok,
              "one kernel a call": all(
                  r["launches"] <= r["calls"]
                  and (r["launches"] > 0 or r["calls"] == 0)
                  for r in one_launch.values()),
              "full path": f_ok, "scene golden": g_ok,
              "scene stream": s_ok, "fast scene golden": fg_ok,
              "fast scene stream": fs_ok, "eval3d golden": e_ok,
              "eval3d stream": es_ok,
              "backward kernels": train["kernels_ok"],
              "train n_iters=0": train["ok"][0],
              "train n_iters=1": train["ok"][1],
              "train n_iters=2": train["ok"][2],
              "train repeats": train["repeat_ok"], "fit": train["fit_ok"],
              "remat": train["remat_ok"], "grad accum": train["accum_ok"],
              "bf16 train": train["bf16_ok"], "fit knobs": train["fit16_ok"],
              "probes": p_ok, "cli eval": ca_ok, "cli train": cb_ok,
              "cli train knobs": cb16_ok,
              "cli export": cc_ok}
    if not all(phases.values()):
        return fail(json.dumps({k: v for k, v in phases.items() if not v}))
    if set(per_kernel) != set(KERNEL_META):
        return fail(f"kernels without a case: "
                    f"{sorted(set(KERNEL_META) - set(per_kernel))}")
    from tdvnet_torch.kernels import WRAPPERS

    listed = [w for k in kernels for w in k["wrappers"]]
    if sorted(listed) != sorted([*WRAPPERS, *BF16_FORMS]):
        return fail(f"the kernels line lists wrappers {sorted(listed)}, the "
                    f"package has {sorted([*WRAPPERS, *BF16_FORMS])}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
