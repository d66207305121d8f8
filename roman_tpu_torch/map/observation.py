"""Per-mask observation: time, camera pose, mask, object point cloud,
semantic descriptor. A host copy of roman_tpu/map/observation.py
(reference roman/map/observation.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class Observation:
    time: float
    pose: np.ndarray                       # (4, 4) T_world_camera
    mask: Optional[np.ndarray] = None
    mask_downsampled: Optional[np.ndarray] = None
    point_cloud: Optional[np.ndarray] = None  # (n, 3) camera frame
    semantic_descriptor: Optional[np.ndarray] = None
    _transformed_points: Optional[np.ndarray] = None
    _voxel_sets: Dict[float, frozenset] = dataclasses.field(default_factory=dict)

    def copy(self, include_mask: bool = True, include_ptcld: bool = False) -> "Observation":
        ptcld = self.point_cloud.copy() if (self.point_cloud is not None and include_ptcld) else None
        if include_mask:
            return Observation(self.time, self.pose.copy(), self.mask,
                               self.mask_downsampled, ptcld, self.semantic_descriptor)
        return Observation(self.time, self.pose.copy(), None, None, ptcld,
                           self.semantic_descriptor)

    @property
    def transformed_points(self) -> np.ndarray:
        """Object points in the world frame (observation.py:45-50)."""
        if self._transformed_points is None:
            R = self.pose[:3, :3]
            t = self.pose[:3, 3]
            self._transformed_points = self.point_cloud @ R.T + t
        return self._transformed_points

    def voxel_set(self, voxel_size: float) -> frozenset:
        if voxel_size not in self._voxel_sets:
            v = np.floor(self.transformed_points / voxel_size).astype(np.int64)
            self._voxel_sets[voxel_size] = frozenset(map(tuple, v))
        return self._voxel_sets[voxel_size]
