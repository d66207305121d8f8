"""Object maps, submaps and submap partitioning (host port of
roman_tpu/map/roman_map.py; reference roman/map/map.py).

RomanMap is the artifact passed from mapping to alignment; Submap is a
gravity-aligned local chunk of the map; submaps_from_roman_map is the
partitioner (new submap every `distance` meters or `time_threshold`
seconds, segment inclusion by radius and first/last-seen time window,
max_size pruning by time or distance, force_fill mode: map.py:244-357).
``submaps_to_features`` packs a robot's submaps into one padded
SubmapFeatures on a device, so the (i, j) pair grid registers in batches.

``load_roman_map`` reads map pickles written by either package. Those of
roman_tpu name roman_tpu.map.roman_map.{RomanMap, SegmentData}; the
unpickler maps them to this module's classes without importing roman_tpu.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from roman_tpu_torch.align.registration import RegistrationConfig, build_features
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.ops import se3_np


@dataclasses.dataclass
class SegmentData:
    """Per-object map entry; field-parity with the reference's
    SegmentMinimalData (segment.py:19-59)."""

    id: int
    center: np.ndarray                      # (3,)
    volume: float
    linearity: float
    planarity: float
    scattering: float
    extent: Optional[np.ndarray] = None     # (3,)
    semantic_descriptor: Optional[np.ndarray] = None
    first_seen: float = 0.0
    last_seen: float = 0.0
    # optional (n, 3) point cloud. The reference's map pickle carries each
    # segment's full (voxel-downsampled) points (ROMANMap of Segments,
    # map.py:18-41) — that is what association_vid/o3d_viz reproject onto
    # camera frames. Alignment ignores this field; None keeps old pickles
    # loading unchanged.
    points: Optional[np.ndarray] = None

    def __getattr__(self, name):
        # map pickles written before a newer optional field existed
        # restore without it; treat it as its default instead of raising
        if name == "points":
            return None
        raise AttributeError(name)

    def reference_time(self, use_avg_time: bool = True) -> float:
        if not use_avg_time:
            return self.first_seen
        return (self.first_seen + self.last_seen) / 2.0

    def transformed(self, T: np.ndarray) -> "SegmentData":
        c = T[:3, :3] @ np.asarray(self.center).reshape(3) + T[:3, 3]
        pts = (np.asarray(self.points) @ T[:3, :3].T + T[:3, 3]
               if self.points is not None else None)
        return dataclasses.replace(self, center=c, points=pts)

    @property
    def pca_attrs(self) -> np.ndarray:
        return np.array([self.linearity, self.planarity, self.scattering])


@dataclasses.dataclass
class RomanMap:
    """Map artifact: segments + trajectory + times (+ frame descriptors).
    Parity with ROMANMap (map.py:18-59)."""

    segments: List[SegmentData]
    trajectory: np.ndarray                  # (T, 4, 4) FLU poses
    times: np.ndarray                       # (T,)
    descriptors: Optional[np.ndarray] = None  # (T, D) frame descriptors
    poses_are_flu: bool = True

    def __post_init__(self):
        self.trajectory = np.asarray(self.trajectory)
        self.times = np.asarray(self.times)
        if len(self.trajectory) != len(self.times):
            raise ValueError("trajectory and times differ in length")

    def save(self, path: str):
        with open(os.path.expanduser(path), "wb") as f:
            pickle.dump(self, f)


class _MapUnpickler(pickle.Unpickler):
    """Reads map pickles of either package: roman_tpu's map classes map to
    this module's; any other class of roman_tpu is refused."""

    _CLASSES = {"RomanMap", "SegmentData"}

    def find_class(self, module, name):
        if module.startswith("roman_tpu.") or module == "roman_tpu":
            if module == "roman_tpu.map.roman_map" and name in self._CLASSES:
                return globals()[name]
            raise pickle.UnpicklingError(
                f"{module}.{name} has no counterpart in roman_tpu_torch")
        return super().find_class(module, name)


def load_roman_map(path: str) -> RomanMap:
    """Load a map pickle written by roman_tpu or by this package. (Maps
    of the reference mit-acl/roman are converted by roman_tpu.interop,
    which is not ported yet.)"""
    with open(os.path.expanduser(path), "rb") as f:
        m = _MapUnpickler(f).load()
    if not isinstance(m, RomanMap):
        raise TypeError(f"{path} holds a {type(m).__name__}, not a RomanMap")
    return m


@dataclasses.dataclass
class Submap:
    """Parity with reference Submap (map.py:94-162); segments are expressed
    in the gravity-aligned submap center frame."""

    id: int
    time: float
    segments: List[SegmentData]
    pose_flu: np.ndarray
    pose_flu_gt: Optional[np.ndarray] = None
    segment_frame: str = "submap_gravity_aligned"
    descriptor: Optional[np.ndarray] = None

    @property
    def pose_gravity_aligned(self) -> np.ndarray:
        return se3_np.transform_rm_roll_pitch(self.pose_flu)

    @property
    def pose_gravity_aligned_gt(self) -> np.ndarray:
        return se3_np.transform_rm_roll_pitch(self.pose_flu_gt)

    @property
    def position(self):
        return self.pose_flu[:3, 3]

    @property
    def position_gt(self):
        return self.pose_flu_gt[:3, 3]

    @property
    def has_gt(self) -> bool:
        return self.pose_flu_gt is not None

    @property
    def first_seen(self):
        return min(s.first_seen for s in self.segments)

    @property
    def last_seen(self):
        return max(s.last_seen for s in self.segments)

    @property
    def segments_as_global_points(self) -> np.ndarray:
        T = self.pose_gravity_aligned_gt if self.has_gt else self.pose_gravity_aligned
        c = np.stack([np.asarray(s.center).reshape(3) for s in self.segments])
        return c @ T[:3, :3].T + T[:3, 3]

    def __len__(self):
        return len(self.segments)

    @staticmethod
    def similarity(sm1: "Submap", sm2: "Submap") -> float:
        """Submap-descriptor similarity (map.py:144-162): plain cosine for
        1-d descriptors, max pairwise cosine for stacked descriptors."""
        d1, d2 = sm1.descriptor, sm2.descriptor
        if d1 is None or d2 is None:
            return float("inf")
        d1, d2 = np.asarray(d1), np.asarray(d2)
        if d1.ndim == 1 and d2.ndim == 1:
            denom = np.linalg.norm(d1) * np.linalg.norm(d2)
            return float(d1 @ d2 / denom) if denom > 1e-9 else 0.0
        a = d1.reshape(-1, d1.shape[-1])
        b = d2.reshape(-1, d2.shape[-1])
        denom = np.linalg.norm(a, axis=1)[:, None] * np.linalg.norm(b, axis=1)[None, :]
        sims = np.where(denom > 1e-9, a @ b.T / np.maximum(denom, 1e-9), 0.0)
        return float(np.max(sims))


@dataclasses.dataclass
class SubmapParams:
    """Parity with reference SubmapParams (map.py:165-192)."""

    max_size: int = 40
    force_fill_submaps: bool = False
    overlap: int = 20
    radius: Optional[float] = 15.0
    distance: float = 10.0
    time_threshold: float = float("inf")
    pruning_method: str = "time"
    object_center_ref: str = "mean"
    use_minimal_data: bool = True
    submap_descriptor: Optional[str] = None
    frame_descriptor_dist: Optional[float] = None

    @classmethod
    def from_submap_align_params(cls, sap) -> "SubmapParams":
        return cls(
            max_size=sap.submap_max_size,
            force_fill_submaps=sap.force_fill_submaps,
            overlap=sap.submap_overlap,
            radius=sap.submap_radius,
            distance=sap.submap_center_dist,
            time_threshold=sap.submap_center_time,
            pruning_method=sap.submap_pruning_method,
            submap_descriptor=sap.submap_descriptor,
            frame_descriptor_dist=sap.frame_descriptor_dist,
        )


def submaps_from_roman_map(
    roman_map: RomanMap,
    params: SubmapParams,
    gt_pose_data: Optional[PoseData] = None,
) -> List[Submap]:
    """Partition a map into submaps; semantics of map.py:244-357."""
    submaps: List[Submap] = []

    if params.force_fill_submaps:
        segs = sorted(roman_map.segments, key=lambda s: s.reference_time())
        step = max(params.max_size - params.overlap, 1)
        for i in range(0, len(segs), step):
            sm_segs = segs[i: i + params.max_size]
            if not sm_segs:
                continue
            t_avg = float(np.mean([s.reference_time() for s in sm_segs]))
            k = int(np.argmin(np.abs(roman_map.times - t_avg)))
            t_sm = float(roman_map.times[k])
            sm = Submap(
                id=len(submaps),
                time=t_sm,
                segments=list(sm_segs),
                pose_flu=roman_map.trajectory[k],
                pose_flu_gt=gt_pose_data.pose(t_sm) if gt_pose_data is not None else None,
            )
            T_center_odom = np.linalg.inv(sm.pose_gravity_aligned)
            sm.segments = [s.transformed(T_center_odom) for s in sm.segments]
            submaps.append(sm)
    else:
        # submap centers every `distance` m / `time_threshold` s (map.py:300-309)
        for i, (pose, t) in enumerate(zip(roman_map.trajectory, roman_map.times)):
            if (
                i == 0
                or np.linalg.norm(pose[:-1, -1] - submaps[-1].pose_flu[:-1, -1]) > params.distance
                or (t - submaps[-1].time > params.time_threshold)
            ):
                submaps.append(
                    Submap(
                        id=len(submaps),
                        time=float(t),
                        segments=[],
                        pose_flu=pose,
                        pose_flu_gt=gt_pose_data.pose(float(t)) if gt_pose_data is not None else None,
                    )
                )

        # segment inclusion by radius + time window (map.py:311-326)
        for i, sm in enumerate(submaps):
            tm1 = submaps[i - 1].time if i > 0 else -np.inf
            tp1 = submaps[i + 1].time if i < len(submaps) - 1 else np.inf
            for seg in roman_map.segments:
                in_time = not (
                    seg.first_seen > tp1 + params.time_threshold
                    or seg.last_seen < tm1 - params.time_threshold
                )
                in_radius = params.radius is None or (
                    np.linalg.norm(np.asarray(seg.center).reshape(3) - sm.pose_flu[:3, 3])
                    < params.radius
                )
                if in_radius and in_time:
                    sm.segments.append(seg)

            T_center_odom = np.linalg.inv(sm.pose_gravity_aligned)
            sm.segments = [s.transformed(T_center_odom) for s in sm.segments]

            # prune to max_size (map.py:332-339)
            if params.max_size is not None:
                if params.pruning_method == "time":
                    key = lambda s: abs(s.reference_time() - sm.time)  # noqa: E731
                else:
                    key = lambda s: np.linalg.norm(np.asarray(s.center).reshape(3))  # noqa: E731
                sm.segments = sorted(sm.segments, key=key)[: params.max_size]

    submaps = [sm for sm in submaps if len(sm.segments) > 0]
    for new_id, sm in enumerate(submaps):
        sm.id = new_id

    # submap descriptors (map.py:343-355 + extract_submap_descriptors)
    if params.submap_descriptor == "mean_semantic":
        for sm in submaps:
            sm.descriptor = np.mean(
                [np.asarray(s.semantic_descriptor).reshape(-1) for s in sm.segments], axis=0
            )
    elif params.submap_descriptor is not None:
        _extract_submap_descriptors(submaps, roman_map, params)
    return submaps


def _extract_submap_descriptors(submaps, roman_map: RomanMap, params: SubmapParams):
    """mean/stacked frame descriptor extraction (map.py:210-242)."""
    if roman_map.descriptors is None:
        raise ValueError(
            "ROMAN map must have frame descriptors to compute submap descriptors")
    times = np.asarray(roman_map.times)
    descs = np.asarray(roman_map.descriptors)
    positions = roman_map.trajectory[:, :3, 3]
    for sm in submaps:
        mask = (times >= sm.first_seen) & (times <= sm.last_seen)
        if params.submap_descriptor == "mean_frame_descriptor":
            sm.descriptor = descs[mask].mean(axis=0)
        elif params.submap_descriptor == "stacked_frame_descriptors":
            if params.frame_descriptor_dist is None:
                sm.descriptor = descs[mask]
            else:
                stacked, last = [], None
                for fd, fp in zip(descs[mask], positions[mask]):
                    if last is None or np.linalg.norm(fp - last) >= params.frame_descriptor_dist:
                        stacked.append(fd)
                        last = fp
                sm.descriptor = np.vstack(stacked)
        else:
            raise ValueError(f"unknown submap descriptor {params.submap_descriptor!r}")


# ---------------------------------------------------------------------------
# Batching submaps into padded device tensors
# ---------------------------------------------------------------------------

def submaps_to_features(
    submaps: List[Submap], cfg: RegistrationConfig, capacity: Optional[int] = None,
    desc_dim: Optional[int] = None, device=None,
):
    """Pack a robot's submaps into one batched SubmapFeatures on `device`
    (default cuda; see device.resolve_device) + host aux arrays.

    Returns (features, aux) where aux holds per-submap poses/times/segment
    ids needed by submap alignment and the result writers.
    """
    device = resolve_device(device)
    S = len(submaps)
    cap = capacity or max((len(sm) for sm in submaps), default=1)
    if desc_dim is None:
        desc_dim = 0
        for sm in submaps:
            for s in sm.segments:
                if s.semantic_descriptor is not None:
                    desc_dim = len(np.asarray(s.semantic_descriptor).reshape(-1))
                    break
            if desc_dim:
                break

    centers = np.zeros((S, cap, 3), np.float32)
    pca = np.zeros((S, cap, 3), np.float32)
    volume = np.zeros((S, cap), np.float32)
    extent = np.zeros((S, cap, 3), np.float32)
    desc = np.zeros((S, cap, desc_dim), np.float32)
    valid = np.zeros((S, cap), bool)
    seg_ids = np.full((S, cap), -1, np.int64)

    for i, sm in enumerate(submaps):
        n = min(len(sm.segments), cap)
        for j, s in enumerate(sm.segments[:n]):
            centers[i, j] = np.asarray(s.center).reshape(3)
            pca[i, j] = s.pca_attrs
            volume[i, j] = s.volume
            if s.extent is not None:
                extent[i, j] = np.asarray(s.extent).reshape(3)
            if desc_dim and s.semantic_descriptor is not None:
                d = np.asarray(s.semantic_descriptor).reshape(-1)
                desc[i, j] = d / max(np.linalg.norm(d), 1e-9)
            valid[i, j] = True
            seg_ids[i, j] = s.id

    def dev(x):
        return torch.as_tensor(x, device=device)

    feats = build_features(
        dev(centers), dev(valid), cfg, pca_attrs=dev(pca), volume=dev(volume),
        extent=dev(extent), descriptors=dev(desc),
    )
    aux = dict(
        times=np.array([sm.time for sm in submaps]),
        poses_flu=np.stack([sm.pose_flu for sm in submaps]) if S else np.zeros((0, 4, 4)),
        poses_gravity=np.stack([sm.pose_gravity_aligned for sm in submaps]) if S else np.zeros((0, 4, 4)),
        poses_gravity_gt=(
            np.stack([sm.pose_gravity_aligned_gt for sm in submaps])
            if S and submaps[0].has_gt else None
        ),
        positions=np.stack([sm.position for sm in submaps]) if S else np.zeros((0, 3)),
        positions_gt=(
            np.stack([sm.position_gt for sm in submaps]) if S and submaps[0].has_gt else None
        ),
        seg_ids=seg_ids,
        descriptors=[sm.descriptor for sm in submaps],
    )
    return feats, aux
