"""Static-capacity voxelization of a batched point cloud (port of
`tdvnet/ops/voxelize.py`).

The functions live beside their CUDA kernel in
`tdvnet_torch.kernels.voxelize`: on CUDA tensors they launch it, on CPU
tensors they run the plain twin.
"""
from tdvnet_torch.kernels.voxelize import (VoxelGrid,
                                           scatter_anchors_to_dense, voxelize)

__all__ = ["VoxelGrid", "scatter_anchors_to_dense", "voxelize"]
