"""Incremental open-set segment mapper: GNN data association, the
lifecycle (nursery -> segments -> inactive -> graveyard) and pairwise
merge to fixpoint, on the host.

A host copy of roman_tpu/map/mapper.py (reference
roman/map/mapper.py:30-349). It is the referee of the device
BatchMapper. Two reference-exact rules are kept: a frame without
observations is a no-op beyond the history, and an inactive segment goes
to the graveyard by the robot's distance from its pose at the segment's
last observation.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.map.observation import Observation
from roman_tpu_torch.map.roman_map import RomanMap
from roman_tpu_torch.map.segment import Segment
from roman_tpu_torch.ops.hungarian import assignment_with_rejection_np
from roman_tpu_torch.params.mapper_params import MapperParams

_M = 1e9


def _set_iou(a: frozenset, b: frozenset, iom: bool = False) -> float:
    inter = len(a & b)
    denom = min(len(a), len(b)) if iom else (len(a) + len(b) - inter)
    return inter / denom if denom > 0 else 0.0


class Mapper:
    def __init__(self, params: MapperParams, camera_params: CameraParams):
        self.params = params
        self.camera_params = camera_params
        self.segment_nursery: List[Segment] = []
        self.segments: List[Segment] = []
        self.inactive_segments: List[Segment] = []
        self.segment_graveyard: List[Segment] = []
        self.id_counter = 0
        self.last_pose: Optional[np.ndarray] = None
        self.poses_flu_history: List[np.ndarray] = []
        self.times_history: List[float] = []
        self.frame_descriptors_history: List[np.ndarray] = []
        self._T_camera_flu = np.eye(4)

    # ------------------------------------------------------------------ #
    # similarity (mapper.py:144-212)
    # ------------------------------------------------------------------ #
    def _geometric_score(self, seg: Segment, other: Union[Segment, Observation]) -> float:
        method = self.params.geometric_association_method
        vs = self.params.iou_voxel_size
        if method in ("iou", "iom"):
            return _set_iou(seg.voxel_set(vs), other.voxel_set(vs), iom=(method == "iom"))
        if method == "chamfer":
            pts_o = other.points if isinstance(other, Segment) else other.transformed_points
            d = np.linalg.norm(seg.points[:, None] - pts_o[None], axis=-1)
            return -min(d.min(axis=1).mean(), d.min(axis=0).mean())
        raise ValueError(method)

    def _semantic_score(self, seg: Segment, other) -> float:
        d1 = seg.semantic_descriptor
        d2 = other.semantic_descriptor
        if d1 is None or d2 is None:
            return 1.0
        d1 = np.asarray(d1).reshape(-1)
        d2 = np.asarray(d2).reshape(-1)
        return float(d1 @ d2 / (np.linalg.norm(d1) * np.linalg.norm(d2)))

    def similarity(self, seg: Segment, other) -> np.ndarray:
        if self.params.semantic_association_method is None:
            return np.array([self._geometric_score(seg, other)])
        return np.array(
            [self._geometric_score(seg, other), self._semantic_score(seg, other)]
        )

    @property
    def similarity_range(self) -> np.ndarray:
        """(2, N) thresholds/max (mapper.py:175-180)."""
        if self.params.semantic_association_method is None:
            return np.array(self.params.geometric_score_range).reshape(2, 1)
        return np.array(
            [self.params.geometric_score_range, self.params.semantic_score_range]
        ).T

    @property
    def min_similarity(self) -> np.ndarray:
        return self.similarity_range[0, :]

    def _gnn_associate(self, segments: List[Segment], observations: List[Observation]):
        """Dense score matrix + Hungarian with rejection
        (global_nearest_neighbor.py:5-50)."""
        rng = self.similarity_range
        n1, n2 = len(segments), len(observations)
        scores = np.full((n1, n2), _M)
        for i, seg in enumerate(segments):
            for j, obs in enumerate(observations):
                sim = self.similarity(seg, obs)
                if np.any(sim < rng[0, :]):
                    continue
                norm = (sim - rng[0, :]) / (rng[1, :] - rng[0, :])
                scores[i, j] = -np.power(np.prod(norm), 1.0 / len(sim))
        return assignment_with_rejection_np(scores)

    # ------------------------------------------------------------------ #
    # per-frame update (mapper.py:47-142)
    # ------------------------------------------------------------------ #
    def update(self, t: float, pose: np.ndarray, observations: List[Observation],
               frame_descriptor: Optional[np.ndarray] = None):
        self.poses_flu_history.append(pose @ self._T_camera_flu)
        self.times_history.append(t)
        if frame_descriptor is not None:
            self.frame_descriptors_history.append(frame_descriptor)
        if len(observations) == 0:
            # reference parity: an observation-less frame is a complete
            # no-op beyond the history bookkeeping (mapper.py:56-57
            # 'if len(observations) == 0: return') — the lifecycle does
            # NOT age or retire tracks on empty frames, so a track lost
            # during a featureless detour can still re-fuse with its
            # re-detected duplicate via the merge scan
            return
        self.last_pose = pose.copy()

        pool = self.segments + self.segment_nursery
        pairs = self._gnn_associate(pool, observations)
        n_seg = len(self.segments)
        for seg_idx, obs_idx in pairs:
            if seg_idx < n_seg:
                self.segments[seg_idx].update(observations[obs_idx])
            else:
                self.segment_nursery[seg_idx - n_seg].update(observations[obs_idx])

        # drop masks of segments not seen this frame (mapper.py:87-91)
        for seg in self.segments:
            if not np.isclose(t, seg.last_seen, rtol=0.0):
                seg.last_observation.mask = None

        # segments -> inactive (mapper.py:93-105)
        for seg in [s for s in self.segments
                    if t - s.last_seen > self.params.max_t_no_sightings or s.num_points == 0]:
            self.segments.remove(seg)
            if seg.num_points == 0:
                continue
            try:
                seg.final_cleanup(epsilon=self.params.clustering_epsilon)
                if seg.num_points > 0:
                    self.inactive_segments.append(seg)
            except Exception:
                pass

        # inactive -> graveyard (mapper.py:107-114)
        for seg in [s for s in self.inactive_segments
                    if t - s.last_seen > self.params.segment_graveyard_time
                    or np.linalg.norm(s.last_observation.pose[:3, 3] - pose[:3, 3])
                    > self.params.segment_graveyard_dist]:
            self.segment_graveyard.append(seg)
            self.inactive_segments.remove(seg)

        # nursery pruning (mapper.py:116-120)
        for seg in [s for s in self.segment_nursery
                    if t - s.last_seen > self.params.max_t_no_sightings or s.num_points == 0]:
            self.segment_nursery.remove(seg)

        # nursery -> segments (mapper.py:122-127)
        for seg in [s for s in self.segment_nursery
                    if s.num_sightings >= self.params.min_sightings]:
            self.segment_nursery.remove(seg)
            self.segments.append(seg)

        # new segments (mapper.py:129-138)
        associated = {obs_idx for _, obs_idx in pairs}
        for idx, obs in enumerate(observations):
            if idx in associated:
                continue
            seg = Segment(obs, self.camera_params, self.id_counter,
                          self.params.get_segment_params())
            if seg.num_points == 0:
                continue
            self.segment_nursery.append(seg)
            self.id_counter += 1

        self.merge()

    # ------------------------------------------------------------------ #
    # bad-segment pruning + merge (mapper.py:214-314)
    # ------------------------------------------------------------------ #
    def remove_bad_segments(self, segments: List[Segment], min_volume: float = 0.0,
                            min_max_extent: float = 0.0,
                            plane_prune_params=(np.inf, np.inf, 0.0)) -> List[Segment]:
        keep = []
        for seg in segments:
            try:
                if seg.num_points == 0:
                    continue
                extent = np.sort(seg.extent)
                if seg.volume < min_volume:
                    continue
                if extent[-1] < min_max_extent:
                    continue
                if (extent[2] > plane_prune_params[0]
                        and extent[1] > plane_prune_params[1]
                        and extent[0] < plane_prune_params[2]):
                    continue
                keep.append(seg)
            except Exception:
                continue
        segments[:] = keep
        return segments

    def merge(self):
        """Pairwise merge to fixpoint (mapper.py:251-314)."""
        self.inactive_segments = self.remove_bad_segments(
            self.inactive_segments,
            min_max_extent=self.params.min_max_extent,
            plane_prune_params=self.params.plane_prune_params,
        )
        self.segments = self.remove_bad_segments(self.segments)

        max_iter, n, edited = 100, 0, True
        while n < max_iter and edited:
            edited = False
            n += 1
            for i, seg1 in enumerate(self.segments):
                for j, seg2 in enumerate(self.segments + self.inactive_segments):
                    if i >= j:
                        continue
                    # cheap distance precheck (mapper.py:281-284)
                    if (np.linalg.norm(np.mean(seg1.points, 0) - np.mean(seg2.points, 0))
                            > 0.5 * (np.max(seg1.extent) + np.max(seg2.extent)) + 1.0):
                        continue
                    merge_flag = False
                    if self.params.min_2d_iou is not None and self.last_pose is not None:
                        m1 = seg1.reconstruct_mask(self.last_pose)
                        m2 = seg2.reconstruct_mask(self.last_pose)
                        u = np.logical_or(m1, m2).sum()
                        iou2d = np.logical_and(m1, m2).sum() / u if u > 0 else 0.0
                        merge_flag |= iou2d >= self.params.min_2d_iou
                    merge_flag |= bool(
                        np.all(self.similarity(seg1, seg2) >= self.min_similarity)
                    )
                    if merge_flag:
                        seg1.update_from_segment(seg2)
                        seg1.id = min(seg1.id, seg2.id)
                        if seg1.num_points == 0:
                            self.segments.pop(i)
                        elif j < len(self.segments):
                            self.segments.pop(j)
                        else:
                            self.inactive_segments.pop(j - len(self.segments))
                        edited = True
                        break
                if edited:
                    break

    # ------------------------------------------------------------------ #
    def set_T_camera_flu(self, T: np.ndarray):
        self._T_camera_flu = T

    @property
    def T_camera_flu(self):
        return self._T_camera_flu

    def get_segment_map(self) -> List[Segment]:
        return self.remove_bad_segments(
            self.segment_graveyard + self.inactive_segments + self.segments
        )

    def get_roman_map(self) -> RomanMap:
        """Export the map artifact (mapper.py:335-349). Segments are
        compacted to SegmentData (the alignment stage's input)."""
        return RomanMap(
            segments=[s.minimal_data() for s in self.get_segment_map()],
            trajectory=(np.stack(self.poses_flu_history)
                        if self.poses_flu_history else np.zeros((0, 4, 4))),
            times=np.asarray(self.times_history),
            descriptors=(np.stack(self.frame_descriptors_history)
                         if self.frame_descriptors_history else None),
            poses_are_flu=True,
        )
