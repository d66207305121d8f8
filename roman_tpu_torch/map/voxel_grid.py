"""Alias module mirroring reference roman/map/voxel_grid.py.

The reference VoxelGrid wraps open3d voxel indices with integer-aligned
intersection/union/IOU/IOM (voxel_grid.py:32-103). Here the same surface
over the hash-set voxelization of roman_tpu_torch.ops.voxel (a host
copy of roman_tpu/map/voxel_grid.py; batched tensor variants:
ops.voxel.voxel_iou_points / voxel_iou_cross).
"""

from __future__ import annotations

import numpy as np

from roman_tpu_torch.ops.voxel import voxel_set


class VoxelGrid:
    def __init__(self, voxels: set, voxel_size: float):
        self.voxels = voxels
        self.voxel_size = float(voxel_size)

    @classmethod
    def from_points(cls, points: np.ndarray, voxel_size: float) -> "VoxelGrid":
        return cls(voxel_set(np.asarray(points), voxel_size), voxel_size)

    def __len__(self):
        return len(self.voxels)

    def intersection(self, other: "VoxelGrid") -> int:
        return len(self.voxels & other.voxels)

    def union(self, other: "VoxelGrid") -> int:
        return len(self.voxels | other.voxels)

    def iou(self, other: "VoxelGrid") -> float:
        u = self.union(other)
        return self.intersection(other) / u if u else 0.0

    def iom(self, other: "VoxelGrid") -> float:
        m = min(len(self), len(other))
        return self.intersection(other) / m if m else 0.0
