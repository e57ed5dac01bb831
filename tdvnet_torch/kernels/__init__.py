"""Hand-written CUDA kernels of the port, one wrapper module each.

Each wrapper checks its arguments, launches its kernel on the current
stream for CUDA tensors (building the library at first use, see `build`),
runs its plain twin `*_ref` for CPU tensors, and counts its launches in
`<wrapper>.launches`. The forwards that training reaches (the source
variance, the soft-argmax, the propagation blend, the dense scatter, the
PointNet's pool and concat-back, the masked GroupNorm and the fp32 scene
sampling) have a hand backward, a wrapper of its own here (`*_backward`),
reached through a `torch.autograd.Function` when autograd records the
call; on CUDA tensors every other wrapper (the fast path's, 3D
evaluation's, voxelization, the probes) raises `NotImplementedError` when an
input requires grad, since its launch returns a tensor without a
`grad_fn`. Six forwards and their six backwards have a bf16 form, for a
bf16 model's inference and training (`BF16_FORMS`), which their wrapper
launches for bf16 inputs; any other dtype raises.
"""
from tdvnet_torch.kernels.fusion import consistency_fuse
from tdvnet_torch.kernels.groupnorm import (masked_group_norm,
                                            masked_group_norm_backward)
from tdvnet_torch.kernels.patchfan import patch_fan_variance
from tdvnet_torch.kernels.probes import batched_dot, take_along_axis
from tdvnet_torch.kernels.propagation import (propagation_blend,
                                              propagation_blend_backward)
from tdvnet_torch.kernels.segmax import (gather_concat,
                                         gather_concat_backward, segment_max,
                                         segment_max_backward, segment_plan)
from tdvnet_torch.kernels.softargmax import (softargmax_depth,
                                             softargmax_depth_backward)
from tdvnet_torch.kernels.variance import (source_variance,
                                           source_variance_backward)
from tdvnet_torch.kernels.trilinear import (trilinear_sample,
                                            trilinear_sample_backward,
                                            trilinear_sample_i8)
from tdvnet_torch.kernels.tsdf import tsdf_integrate
from tdvnet_torch.kernels.voxelize import (
    scatter_anchors_to_dense, scatter_anchors_to_dense_backward)
# under another name, so that `kernels.voxelize` stays the module
from tdvnet_torch.kernels.voxelize import voxelize as voxelize_points

WRAPPERS = {
    "source_variance": source_variance,
    "trilinear_sample": trilinear_sample,
    "trilinear_sample_i8": trilinear_sample_i8,
    "patch_fan_variance": patch_fan_variance,
    "propagation_blend": propagation_blend,
    "softargmax_depth": softargmax_depth,
    "voxelize": voxelize_points,
    "scatter_anchors_to_dense": scatter_anchors_to_dense,
    "segment_plan": segment_plan,
    "segment_max": segment_max,
    "gather_concat": gather_concat,
    "masked_group_norm": masked_group_norm,
    "tsdf_integrate": tsdf_integrate,
    "consistency_fuse": consistency_fuse,
    "source_variance_backward": source_variance_backward,
    "softargmax_depth_backward": softargmax_depth_backward,
    "propagation_blend_backward": propagation_blend_backward,
    "batched_dot": batched_dot,
    "take_along_axis": take_along_axis,
    "scatter_anchors_to_dense_backward": scatter_anchors_to_dense_backward,
    "segment_max_backward": segment_max_backward,
    "gather_concat_backward": gather_concat_backward,
    "masked_group_norm_backward": masked_group_norm_backward,
    "trilinear_sample_backward": trilinear_sample_backward,
}


# the bf16 forms (a bf16 model's inference and training): each counts its
# launches in its wrapper's `bf16_launches` (the fp32 form's stay in
# `launches`)
BF16_FORMS = {
    "source_variance_bf16": source_variance,
    "trilinear_sample_bf16": trilinear_sample,
    "scatter_anchors_to_dense_bf16": scatter_anchors_to_dense,
    "segment_max_bf16": segment_max,
    "gather_concat_bf16": gather_concat,
    "masked_group_norm_bf16": masked_group_norm,
    "source_variance_backward_bf16": source_variance_backward,
    "trilinear_sample_backward_bf16": trilinear_sample_backward,
    "scatter_anchors_to_dense_backward_bf16":
        scatter_anchors_to_dense_backward,
    "segment_max_backward_bf16": segment_max_backward,
    "gather_concat_backward_bf16": gather_concat_backward,
    "masked_group_norm_backward_bf16": masked_group_norm_backward,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in BF16_FORMS.values():
        fn.bf16_launches = 0


def launch_counts() -> dict:
    """Launches by wrapper since the last reset (fp32 forms)."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def bf16_launch_counts() -> dict:
    """Launches by bf16 form since the last reset."""
    return {name: fn.bf16_launches for name, fn in BF16_FORMS.items()}
