"""Geometry, sampling, cost volumes and voxelization."""
