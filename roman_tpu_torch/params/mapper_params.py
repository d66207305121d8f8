"""Mapper params: a host copy of roman_tpu/params/mapper_params.py, with
the yaml schema of reference roman/params/mapper_params.py:58-103."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import yaml


@dataclasses.dataclass
class SegmentParams:
    voxel_size: float = 0.05
    outlier_removal_std: Optional[float] = 1.0

    def __post_init__(self):
        if self.outlier_removal_std is not None and (
            self.outlier_removal_std <= 0 or np.isinf(self.outlier_removal_std)
        ):
            self.outlier_removal_std = None


@dataclasses.dataclass
class MapperParams:
    geometric_association_method: str = "iou"
    semantic_association_method: Optional[str] = "none"
    geometric_score_range: Tuple[float, float] = (0.25, 1.0)
    semantic_score_range: Tuple[float, float] = (0.8, 1.0)
    min_2d_iou: Union[float, None] = 0.8

    min_sightings: int = 2
    max_t_no_sightings: float = 0.4
    mask_downsample_factor: int = 8
    min_max_extent: float = 0.25
    clustering_epsilon: float = 0.25
    plane_prune_params: Tuple[float, float, float] = (3.0, 3.0, 0.5)
    segment_graveyard_time: float = 15.0
    segment_graveyard_dist: float = 10.0
    iou_voxel_size: float = 0.2
    segment_voxel_size: float = 0.05
    segment_outlier_removal_std: float = 1.0
    # the device mapper's pool capacities (fixed shapes; not in the
    # reference schema)
    max_segments: int = 256
    max_points_per_segment: int = 256
    # bound on the device mapper's per-frame merge-to-fixpoint loop
    # (reference mapper.py:251-314 restarts until no merge fires; a few
    # chained merges per frame is the practical ceiling)
    max_merges_per_frame: int = 8
    # "host" = reference-semantics python Mapper; "device" = BatchMapper
    # (segment pools kept on the device, updated a frame batch at a time)
    mapper_backend: str = "host"

    def __post_init__(self):
        if (
            isinstance(self.semantic_association_method, str)
            and self.semantic_association_method.lower() == "none"
        ):
            self.semantic_association_method = None

    @classmethod
    def from_yaml(cls, yaml_path: str, run: Optional[str] = None) -> "MapperParams":
        with open(yaml_path) as f:
            data = yaml.safe_load(f)
        if run is not None and run in data:
            data = data[run]
        return cls(**data)

    def get_segment_params(self) -> SegmentParams:
        return SegmentParams(
            voxel_size=self.segment_voxel_size,
            outlier_removal_std=self.segment_outlier_removal_std,
        )
