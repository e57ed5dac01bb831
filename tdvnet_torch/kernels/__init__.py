"""Hand-written CUDA kernels of the port, one wrapper module each.

Each wrapper checks its arguments, launches its kernel on the current
stream for CUDA tensors (building the library at first use, see `build`),
runs its plain twin `*_ref` for CPU tensors, and counts its launches in
`<wrapper>.launches`.
"""
from tdvnet_torch.kernels.fusion import consistency_fuse
from tdvnet_torch.kernels.groupnorm import masked_group_norm
from tdvnet_torch.kernels.patchfan import patch_fan_variance
from tdvnet_torch.kernels.propagation import propagation_blend
from tdvnet_torch.kernels.segmax import gather_concat, segment_max
from tdvnet_torch.kernels.softargmax import softargmax_depth
from tdvnet_torch.kernels.variance import source_variance
from tdvnet_torch.kernels.trilinear import (trilinear_sample,
                                            trilinear_sample_i8)
from tdvnet_torch.kernels.tsdf import tsdf_integrate
from tdvnet_torch.kernels.voxelize import scatter_anchors_to_dense
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
    "segment_max": segment_max,
    "gather_concat": gather_concat,
    "masked_group_norm": masked_group_norm,
    "tsdf_integrate": tsdf_integrate,
    "consistency_fuse": consistency_fuse,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
