"""Mapped-object segment: accumulates world-frame points across
observations with voxel-downsample and outlier-removal maintenance,
memoized geometry (PCA OBB volume/extent, shape attributes), a
running-mean semantic descriptor, and camera reprojection helpers.

A host copy of roman_tpu/map/segment.py (reference
roman/object/segment.py, with open3d and shapely replaced by the numpy
twins of roman_tpu_torch.ops). The host Mapper keeps these; alignment
reads their minimal_data() (SegmentData, the reference's
SegmentMinimalData).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.map.observation import Observation
from roman_tpu_torch.map.roman_map import SegmentData
from roman_tpu_torch.ops.pointcloud import largest_cluster_mask_np, statistical_outlier_mask_np
from roman_tpu_torch.ops.voxel import voxel_downsample_np
from roman_tpu_torch.params.mapper_params import SegmentParams


class Segment:
    def __init__(self, observation: Observation, camera_params: CameraParams,
                 id: int = 0, params: SegmentParams = SegmentParams()):
        self.id = id
        self.camera_params = camera_params
        self.params = params
        self.first_seen = observation.time
        self.last_seen = observation.time
        self.num_sightings = 1
        self.last_observation = observation
        self.observations = [observation.copy(include_mask=False)]
        self.points: Optional[np.ndarray] = None
        self.semantic_descriptor: Optional[np.ndarray] = None
        self.semantic_descriptor_cnt = 0
        self._center_ref = "mean"
        self._memo: Dict = {}
        self._add_semantic_descriptor(observation.semantic_descriptor)
        self._integrate_points_from_observation(observation)

    # ------------------------------------------------------------------ #
    # updates
    # ------------------------------------------------------------------ #
    def update(self, observation: Observation, integrate_points: bool = True):
        """segment.py:100-120."""
        if integrate_points:
            self._integrate_points_from_observation(observation)
            if observation.semantic_descriptor is not None:
                self._add_semantic_descriptor(observation.semantic_descriptor)
        self.num_sightings += 1
        self.observations.append(observation.copy(include_mask=False))
        if observation.time > self.last_seen:
            self.last_seen = observation.time
            self.last_observation = observation.copy(include_mask=True)

    def update_from_segment(self, segment: "Segment"):
        """Merge another segment into this one (segment.py:122-131)."""
        for obs in segment.observations:
            if obs.time == segment.last_seen:
                obs = segment.last_observation
            self.update(obs, integrate_points=False)
        if segment.num_points > 0:
            self._add_points(segment.points)
        if segment.semantic_descriptor is not None:
            self._add_semantic_descriptor(
                segment.semantic_descriptor, segment.semantic_descriptor_cnt
            )

    def _integrate_points_from_observation(self, observation: Observation):
        if observation.point_cloud is None:
            return
        self._add_points(observation.transformed_points)

    def _add_points(self, points: np.ndarray):
        assert points.shape[1] == 3
        if points.shape[0] == 0:
            return
        self._memo.clear()
        self.points = points if self.points is None else np.concatenate([self.points, points])
        self._cleanup_points()

    def _cleanup_points(self):
        """Voxel downsample + statistical outlier removal on every insert
        (segment.py:177-193)."""
        if self.points is None:
            return
        pts = voxel_downsample_np(self.points, self.params.voxel_size)
        if self.params.outlier_removal_std is not None and len(pts) > 1:
            keep = statistical_outlier_mask_np(pts, 10, self.params.outlier_removal_std)
            pts = pts[keep]
        self.points = pts if len(pts) else None

    def final_cleanup(self, epsilon: float = 0.25, min_points: int = 10):
        """DBSCAN largest-cluster retirement cleanup (segment.py:195-220)."""
        if self.points is not None:
            keep = largest_cluster_mask_np(self.points, eps=epsilon, min_points=min_points)
            self.points = self.points[keep]
            self._memo.clear()

    def _add_semantic_descriptor(self, descriptor: Optional[np.ndarray], cnt: int = 1):
        """Running normalized mean (segment.py:474-489)."""
        if descriptor is None:
            return
        descriptor = np.asarray(descriptor).reshape(-1)
        if self.semantic_descriptor is None:
            assert cnt == 1
            self.semantic_descriptor = descriptor / np.linalg.norm(descriptor)
            self.semantic_descriptor_cnt = cnt
        else:
            n = self.semantic_descriptor_cnt
            self.semantic_descriptor = (
                self.semantic_descriptor * n / (n + cnt)
                + descriptor / np.linalg.norm(descriptor) * cnt / (n + cnt)
            )
            self.semantic_descriptor_cnt += cnt
        self.semantic_descriptor = self.semantic_descriptor / np.linalg.norm(
            self.semantic_descriptor
        )

    # ------------------------------------------------------------------ #
    # geometry (memoized, reference segment.py:244-285, :433-472)
    # ------------------------------------------------------------------ #
    @property
    def num_points(self) -> int:
        return 0 if self.points is None else len(self.points)

    def reset_memoized(self):
        self._memo.clear()

    def _obb(self):
        # numpy twin of ops.geometry.pca_obb (host hot path: called per
        # segment per frame by merge/prune)
        if "obb" not in self._memo:
            pts = self.points
            mu = pts.mean(axis=0)
            c = pts - mu
            cov = (c.T @ c) / len(pts)
            _, vecs = np.linalg.eigh(cov)
            proj = c @ vecs
            ext = proj.max(axis=0) - proj.min(axis=0)
            ext = np.sort(ext)[::-1]
            self._memo["obb"] = (float(np.prod(ext)), ext)
        return self._memo["obb"]

    @property
    def volume(self) -> float:
        if self.num_points > 4:
            return self._obb()[0]
        return 0.0

    @property
    def extent(self) -> np.ndarray:
        if self.num_points > 4:
            return self._obb()[1]
        return np.zeros(3)

    @property
    def center(self) -> np.ndarray:
        """mean or bottom_middle reference point (segment.py:266-274)."""
        if self._center_ref == "bottom_middle":
            pt = np.median(self.points, axis=0)
            pt[2] = np.min(self.points[:, 2])
            return pt
        return np.mean(self.points, axis=0)

    def set_center_ref(self, ref: str):
        assert ref in ("bottom_middle", "mean")
        self._center_ref = ref

    @property
    def normalized_eigenvalues(self) -> np.ndarray:
        if "eigvals" not in self._memo:
            C = np.cov(self.points.T, bias=True)
            e = np.linalg.svd(C, compute_uv=False)
            self._memo["eigvals"] = e / e.sum()
        return self._memo["eigvals"]

    @property
    def linearity(self) -> float:
        e = self.normalized_eigenvalues
        return float((e[0] - e[1]) / e[0])

    @property
    def planarity(self) -> float:
        e = self.normalized_eigenvalues
        return float((e[1] - e[2]) / e[0])

    @property
    def scattering(self) -> float:
        e = self.normalized_eigenvalues
        return float(e[2] / e[0])

    def voxel_set(self, voxel_size: float) -> frozenset:
        key = ("vox", voxel_size)
        if key not in self._memo:
            v = np.floor(self.points / voxel_size).astype(np.int64)
            self._memo[key] = frozenset(map(tuple, v))
        return self._memo[key]

    def reference_time(self, use_avg_time: bool = True) -> float:
        if not use_avg_time:
            return self.first_seen
        return (self.first_seen + self.last_seen) / 2.0

    # ------------------------------------------------------------------ #
    # camera reprojection (segment.py:307-418)
    # ------------------------------------------------------------------ #
    def _pixels_2d(self, pose: np.ndarray) -> Optional[np.ndarray]:
        if self.points is None:
            return None
        Tinv = np.linalg.inv(pose)
        pts_c = self.points @ Tinv[:3, :3].T + Tinv[:3, 3]
        pts_c = pts_c[pts_c[:, 2] >= 0]
        if len(pts_c) == 0:
            return None
        K = self.camera_params.K
        u = K[0, 0] * pts_c[:, 0] / pts_c[:, 2] + K[0, 2]
        v = K[1, 1] * pts_c[:, 1] / pts_c[:, 2] + K[1, 2]
        px = np.stack([u, v], axis=1)
        inside = (
            (px[:, 0] >= 0) & (px[:, 0] < self.camera_params.width)
            & (px[:, 1] >= 0) & (px[:, 1] < self.camera_params.height)
        )
        px = px[inside]
        return px if len(px) else None

    def reprojected_bbox(self, pose: np.ndarray):
        px = self._pixels_2d(pose)
        if px is None:
            return None
        ul = np.maximum(np.min(px, axis=0).astype(int), [0, 0])
        lr = np.minimum(
            np.max(px, axis=0).astype(int),
            [self.camera_params.width, self.camera_params.height],
        )
        if lr[0] - ul[0] <= 0 or lr[1] - ul[1] <= 0:
            return None
        return ul, lr

    def reconstruct_mask(self, pose: np.ndarray, downsample_factor: int = 1) -> np.ndarray:
        mask = np.zeros(
            (self.camera_params.height, self.camera_params.width), dtype=np.uint8
        )
        bbox = self.reprojected_bbox(pose)
        if bbox is not None:
            ul, lr = bbox
            mask[ul[1]: lr[1], ul[0]: lr[0]] = 1
        if downsample_factor != 1:
            mask = mask[::downsample_factor, ::downsample_factor]
        return mask

    def outline_2d(self, pose: np.ndarray) -> Optional[np.ndarray]:
        from roman_tpu_torch.ops.geometry import convex_hull_2d

        px = self._pixels_2d(pose)
        if px is None:
            return None
        return convex_hull_2d(px)

    # ------------------------------------------------------------------ #
    def transform(self, T: np.ndarray):
        if self.points is not None:
            self.points = self.points @ T[:3, :3].T + T[:3, 3]
            self._memo.clear()

    def minimal_data(self, include_points: bool = True) -> SegmentData:
        """include_points keeps the (voxel-downsampled) cloud in the map
        artifact like the reference pickle does (map.py:18-41) — the
        post-hoc viz tools (association_vid camera overlays, o3d_viz)
        reproject it. Alignment never reads it."""
        return SegmentData(
            id=self.id,
            center=np.asarray(self.center).reshape(3),
            volume=self.volume,
            linearity=self.linearity,
            planarity=self.planarity,
            scattering=self.scattering,
            extent=self.extent,
            semantic_descriptor=self.semantic_descriptor,
            first_seen=self.first_seen,
            last_seen=self.last_seen,
            points=(np.asarray(self.points, np.float32)
                    if include_points and self.points is not None else None),
        )
