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
Map pickles of the reference mit-acl/roman are converted by
``roman_tpu_torch.interop``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import List, Optional

import numpy as np

from roman_tpu_torch.align.object_registration import pack_objects
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.data.pose_data import PoseData
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
        """Pickle the map as roman_tpu names it, so that either package
        reads it (_MapPickler)."""
        with open(os.path.expanduser(path), "wb") as f:
            _MapPickler(f, protocol=pickle.DEFAULT_PROTOCOL).dump(self)

    @classmethod
    def from_pickle(cls, path: str) -> "RomanMap":
        """A map pickle of either package (through _MapUnpickler)."""
        with open(os.path.expanduser(path), "rb") as f:
            m = _MapUnpickler(f).load()
        if not isinstance(m, cls):
            raise TypeError(f"{path} holds a {type(m).__name__}, not a RomanMap")
        return m

    @classmethod
    def concatenate(cls, maps: List["RomanMap"]) -> "RomanMap":
        """Chunked-mapping merge (map.py:61-92): shifts segment ids of later
        chunks past the running max."""
        maps = [m for m in maps if len(m.times) > 0] or maps[:1]
        out = maps[0]
        for other in maps[1:]:
            if out.poses_are_flu != other.poses_are_flu:
                raise ValueError("cannot concatenate maps whose poses_are_flu differ")
            max_id = max((s.id for s in out.segments), default=0)
            shifted = [dataclasses.replace(s, id=s.id + max_id) for s in other.segments]
            desc = None
            if out.descriptors is not None and other.descriptors is not None:
                desc = np.concatenate([out.descriptors, other.descriptors])
            out = cls(
                segments=out.segments + shifted,
                trajectory=np.concatenate([out.trajectory, other.trajectory]),
                times=np.concatenate([out.times, other.times]),
                descriptors=desc,
                poses_are_flu=out.poses_are_flu,
            )
        return out

    def get_segment_by_id(self, seg_id: int) -> Optional[SegmentData]:
        for s in self.segments:
            if s.id == seg_id:
                return s
        return None


class _MapPickler(pickle._Pickler):
    """Writes RomanMap and SegmentData under roman_tpu's class paths
    (roman_tpu.map.roman_map), the same fields in the same layout.
    roman_tpu's loader then reads the port's map pickles (under this
    module's own path it read them as empty maps), and _MapUnpickler maps
    the names back here. The class references are written without
    importing roman_tpu."""

    def save_global(self, obj, name=None):
        if obj not in (RomanMap, SegmentData):
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save("roman_tpu.map.roman_map")
            self.save(obj.__name__)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + b"roman_tpu.map.roman_map\n"
                       + obj.__name__.encode() + b"\n")
        self.memoize(obj)


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
    """Load a map pickle written by roman_tpu or by this package, or a
    ROMANMap of the reference mit-acl/roman (converted by
    roman_tpu_torch.interop, no reference install needed).

    The fallback catches what roman_tpu's loader catches
    (roman_tpu/map/roman_map.py:133-141), with TypeError standing for its
    failed isinstance assertion."""
    try:
        return RomanMap.from_pickle(path)
    except (TypeError, ModuleNotFoundError, AttributeError):
        from roman_tpu_torch.interop import load_reference_map

        return load_reference_map(os.path.expanduser(path))


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
    (default cuda; see device.resolve_device) + host aux arrays: each
    submap's segments through ``align.object_registration.pack_objects``.

    Returns (features, aux) where aux holds per-submap poses/times/segment
    ids needed by submap alignment and the result writers.
    """
    S = len(submaps)
    feats, seg_ids = pack_objects([sm.segments for sm in submaps], cfg, capacity,
                                  desc_dim, device)
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


# ---------------------------------------------------------------------------
# segment-slam JSON interop (map.py:361-422)
# ---------------------------------------------------------------------------

def load_segment_slam_segments(json_file: str, robot_name=None, as_dict=False):
    with open(json_file) as f:
        data = json.load(f)
    segments = {}
    for seg in data["segments"]:
        if robot_name is not None and seg["robot_name"] != robot_name:
            continue
        c = seg["centroid_odom"]
        center = np.array([c["x"], c["y"], c["z"]]) if isinstance(c, dict) else np.asarray(c)
        segments[seg["segment_index"]] = SegmentData(
            id=seg["segment_index"],
            center=center,
            volume=seg["shape_attributes"]["volume"],
            linearity=seg["shape_attributes"]["linearity"],
            planarity=seg["shape_attributes"]["planarity"],
            scattering=seg["shape_attributes"]["scattering"],
            extent=None,
            semantic_descriptor=None,
            first_seen=seg["first_seen"]["seconds"] + seg["first_seen"]["nanoseconds"] * 1e-9,
            last_seen=seg["last_seen"]["seconds"] + seg["last_seen"]["nanoseconds"] * 1e-9,
        )
    return segments if as_dict else list(segments.values())


def load_segment_slam_submaps(json_file: str, robot_name=None) -> List[Submap]:
    with open(json_file) as f:
        data = json.load(f)
    segments = load_segment_slam_segments(json_file, robot_name, as_dict=True)
    submaps = []
    for sj in data["submaps"]:
        if robot_name is not None and sj["robot_name"] != robot_name:
            continue
        tf = sj["T_odom_submap"]
        T = se3_np.xyz_quat_to_T(
            np.array([tf["tx"], tf["ty"], tf["tz"]]),
            np.array([tf["qx"], tf["qy"], tf["qz"], tf["qw"]]),
        )
        submaps.append(
            Submap(
                id=sj["submap_index"],
                time=sj["seconds"] + sj["nanoseconds"] * 1e-9,
                segments=[segments[k] for k in sj["segment_indices"] if k in segments],
                pose_flu=T,
                segment_frame="odom",
            )
        )
    return submaps
