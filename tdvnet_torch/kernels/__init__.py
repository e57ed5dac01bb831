"""Hand-written CUDA kernels of the port, one wrapper module each.

Each wrapper checks its arguments, launches its kernel on the current
stream for CUDA tensors (building the library at first use, see `build`),
runs its plain twin `*_ref` for CPU tensors, and counts its launches in
`<wrapper>.launches`.
"""
from tdvnet_torch.kernels.propagation import propagation_blend
from tdvnet_torch.kernels.softargmax import softargmax_depth
from tdvnet_torch.kernels.variance import source_variance
from tdvnet_torch.kernels.trilinear import trilinear_sample

WRAPPERS = {
    "source_variance": source_variance,
    "trilinear_sample": trilinear_sample,
    "propagation_blend": propagation_blend,
    "softargmax_depth": softargmax_depth,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
