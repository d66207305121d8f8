"""Reference-artifact interop: load mit-acl/roman ``ROMANMap`` pickles
without the reference package installed, and write pickles it can load
(host copy of roman_tpu/interop.py; numpy and pickle only).

Reference maps are pickled ``roman.map.map.ROMANMap`` dataclasses holding
``roman.object.segment.Segment`` / ``SegmentMinimalData`` objects
(reference map.py:18-59, segment.py:19-59) plus robotdatapy helpers.
``_RefUnpickler`` resolves those class paths to empty stub classes (pickle
restores attribute dicts without running constructors), and the converters
below map the attribute layout onto this package's RomanMap/SegmentData.

Full ``Segment`` objects carry raw world-frame points; their shape
attributes are recomputed here in numpy (OBB volume/extent, covariance
attributes — reference segment.py:244-274, :433-472).
``SegmentMinimalData`` carries the precomputed values and converts field
for field.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import types
from typing import Optional

import numpy as np

from roman_tpu_torch.map.roman_map import RomanMap, SegmentData

_REFERENCE_ROOTS = ("roman", "robotdatapy", "fastsam", "clipperpy", "open3d")
_STUBS = {}


def _stub_class(module: str, name: str):
    key = (module, name)
    if key not in _STUBS:
        _STUBS[key] = type(name, (), {"__module__": module})
    return _STUBS[key]


class _RefUnpickler(pickle.Unpickler):
    """Resolves reference-package class paths to attribute-only stubs."""

    def find_class(self, module, name):
        if module.split(".")[0] in _REFERENCE_ROOTS:
            return _stub_class(module, name)
        return super().find_class(module, name)


def load_reference_map(path: str) -> RomanMap:
    """Load a reference ROMANMap pickle and convert it to RomanMap."""
    with open(path, "rb") as f:
        obj = _RefUnpickler(f).load()
    return convert_reference_map(obj)


def is_reference_map(obj) -> bool:
    """True for a reference ROMANMap object (a class named ROMANMap from a
    module under a `roman` package), False for a RomanMap or anything
    else."""
    return (type(obj).__module__.startswith("roman")
            and type(obj).__name__ == "ROMANMap")


def convert_reference_map(obj) -> RomanMap:
    """Map reference ROMANMap attributes (map.py:18-41) to RomanMap."""
    d = obj.__dict__
    segments = []
    for s in d.get("segments", []):
        conv = convert_reference_segment(s)
        if conv is not None:
            segments.append(conv)
    trajectory = np.stack([np.asarray(T) for T in d.get("trajectory", [])]) \
        if len(d.get("trajectory", [])) else np.zeros((0, 4, 4))
    times = np.asarray(d.get("times", np.zeros(0)))
    descriptors = d.get("descriptors")
    if descriptors is not None and len(descriptors):
        descriptors = np.stack([np.asarray(x) for x in descriptors])
    else:
        descriptors = None
    return RomanMap(
        segments=segments,
        trajectory=trajectory,
        times=times,
        descriptors=descriptors,
        poses_are_flu=bool(d.get("poses_are_flu", True)),
    )


def convert_reference_segment(s) -> Optional[SegmentData]:
    """Convert a reference Segment or SegmentMinimalData stub."""
    d = s.__dict__
    if "points" in d:  # full Segment (segment.py:61-175)
        pts = d.get("points")
        if pts is None or len(np.atleast_2d(pts)) < 3:
            return None
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        center = (
            _bottom_middle(pts)
            if d.get("_center_ref") == "bottom_middle" else pts.mean(axis=0)
        )
        vol, extent, attrs = _geometry_from_points(pts)
        desc = d.get("semantic_descriptor")
        return SegmentData(
            id=int(d.get("id", 0)),
            center=center,
            volume=float(vol),
            linearity=float(attrs[0]),
            planarity=float(attrs[1]),
            scattering=float(attrs[2]),
            extent=extent,
            semantic_descriptor=(np.asarray(desc).reshape(-1)
                                 if desc is not None else None),
            first_seen=float(d.get("first_seen", 0.0)),
            last_seen=float(d.get("last_seen", 0.0)),
            points=pts.astype(np.float32),
        )
    # SegmentMinimalData (segment.py:19-59; the Object base sets centroid
    # (3, 1), _volume, _descriptor — object.py:6-16)
    centroid = np.asarray(d.get("centroid")).reshape(-1)[:3]
    desc = d.get("semantic_descriptor", d.get("_descriptor"))
    return SegmentData(
        id=int(d.get("id", 0)),
        center=centroid,
        volume=float(d.get("_volume") or 0.0),
        linearity=float(d.get("_linearity") or 0.0),
        planarity=float(d.get("_planarity") or 0.0),
        scattering=float(d.get("_scattering") or 0.0),
        extent=(np.asarray(d["extent"]).reshape(-1)
                if d.get("extent") is not None else None),
        semantic_descriptor=(np.asarray(desc).reshape(-1)
                             if desc is not None else None),
        first_seen=float(d.get("first_seen", 0.0)),
        last_seen=float(d.get("last_seen", 0.0)),
    )


# --------------------------------------------------------------------- #
# export direction: pickles loadable by the reference package itself
# (reference format: roman/map/map.py:18-59 ROMANMap of
# SegmentMinimalData, roman/align/results.py:18-44 SubmapAlignResults)
# --------------------------------------------------------------------- #

_EXPORT_MODULES = {
    "ROMANMap": "roman.map.map",
    "SegmentMinimalData": "roman.object.segment",
    "SubmapAlignResults": "roman.align.results",
    "SubmapAlignParams": "roman.params.submap_align_params",
    "SubmapAlignInputOutput": "roman.params.submap_align_params",
}

# SubmapAlignParams fields with no reference schema counterpart, stripped
# from exported params so reference-side readers see a clean schema
_NON_REFERENCE_PARAM_FIELDS = ("use_pallas", "pallas_pairs_per_step",
                               "per_pair_timing")


class _reference_module_scope:
    """Temporarily install fake ``roman.*`` modules exposing the export
    stub classes, so pickle's save-by-reference records the reference's
    class paths. Pickle restores instances through a __dict__ update
    without running constructors, so the real reference classes (frozen
    dataclasses included) load these bytes directly. Modules already
    present (a real reference install) are left untouched."""

    def __enter__(self):
        self._added = []
        needed = set()
        for module in _EXPORT_MODULES.values():
            parts = module.split(".")
            for k in range(1, len(parts) + 1):
                needed.add(".".join(parts[:k]))
        for modname in sorted(needed):
            if modname not in sys.modules:
                sys.modules[modname] = types.ModuleType(modname)
                self._added.append(modname)
        for name, module in _EXPORT_MODULES.items():
            mod = sys.modules[module]
            if not hasattr(mod, name):
                setattr(mod, name, _stub_class(module, name))
        return self

    def __exit__(self, *exc):
        for modname in self._added:
            sys.modules.pop(modname, None)
        return False


def _ref_instance(name: str, attrs: dict):
    """Instance with the reference class path, built without running any
    constructor (as unpickling restores it). A class already resident in
    sys.modules (a real reference install, or test fakes) is used, since
    pickle's save-by-reference needs the resident class object."""
    module = _EXPORT_MODULES[name]
    mod = sys.modules.get(module)
    cls = (getattr(mod, name) if mod is not None and hasattr(mod, name)
           else _stub_class(module, name))
    obj = cls.__new__(cls)
    obj.__dict__.update(attrs)
    return obj


def _segment_to_reference(s) -> object:
    """SegmentData -> reference SegmentMinimalData attribute layout
    (segment.py:19-59 through the Object base, object.py:8-16: dim,
    centroid (3, 1), id, _volume, _descriptor)."""
    desc = (np.asarray(s.semantic_descriptor).reshape(-1)
            if s.semantic_descriptor is not None else None)
    return _ref_instance("SegmentMinimalData", dict(
        dim=3,
        centroid=np.asarray(s.center, np.float64).reshape(3, 1),
        id=int(s.id),
        _volume=float(s.volume),
        _descriptor=None,
        _linearity=float(s.linearity),
        _planarity=float(s.planarity),
        _scattering=float(s.scattering),
        extent=(np.asarray(s.extent, np.float64).reshape(-1)
                if s.extent is not None else None),
        semantic_descriptor=desc,
        first_seen=float(s.first_seen),
        last_seen=float(s.last_seen),
    ))


def reference_map_object(roman_map: RomanMap):
    """The reference-layout ROMANMap object graph (not yet pickled).
    trajectory/times/descriptors are lists: the reference's
    ROMANMap.concatenate list-appends them (map.py:61-92)."""
    traj = [np.asarray(T, np.float64) for T in roman_map.trajectory]
    times = [float(t) for t in np.asarray(roman_map.times).reshape(-1)]
    descs = (None if roman_map.descriptors is None
             else [np.asarray(d) for d in roman_map.descriptors])
    return _ref_instance("ROMANMap", dict(
        segments=[_segment_to_reference(s) for s in roman_map.segments],
        trajectory=traj,
        times=times,
        descriptors=descs,
        poses_are_flu=bool(getattr(roman_map, "poses_are_flu", True)),
    ))


def save_reference_map(roman_map: RomanMap, path: str) -> None:
    """Write a RomanMap as a ROMANMap pickle the reference package loads
    (the inverse of load_reference_map)."""
    obj = reference_map_object(roman_map)
    with _reference_module_scope():
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def save_reference_align_results(results, path: Optional[str] = None) -> None:
    """Write SubmapAlignResults as a reference-layout pickle
    (roman.align.results.SubmapAlignResults with roman.params.* params
    classes; field names match 1:1, reference results.py:18-44)."""
    sp = {k: v for k, v in dataclasses.asdict(
        results.submap_align_params).items()
        if k not in _NON_REFERENCE_PARAM_FIELDS}
    io = dataclasses.asdict(results.submap_io)
    attrs = dict(
        robots_nearby_mat=results.robots_nearby_mat,
        clipper_angle_mat=results.clipper_angle_mat,
        clipper_dist_mat=results.clipper_dist_mat,
        clipper_num_associations=results.clipper_num_associations,
        similarity_mat=results.similarity_mat,
        submap_yaw_diff_mat=results.submap_yaw_diff_mat,
        associated_objs_mat=results.associated_objs_mat,
        T_ij_mat=results.T_ij_mat,
        T_ij_hat_mat=results.T_ij_hat_mat,
        timing_list=list(results.timing_list),
        submap_align_params=_ref_instance("SubmapAlignParams", sp),
        submap_io=_ref_instance("SubmapAlignInputOutput", io),
        total_time=float(results.total_time),
    )
    obj = _ref_instance("SubmapAlignResults", attrs)
    path = path or results.submap_io.output_pkl
    with _reference_module_scope():
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def _bottom_middle(pts: np.ndarray) -> np.ndarray:
    """Reference center_ref='bottom_middle' (segment.py:266-274): median
    x/y, min z."""
    return np.array([np.median(pts[:, 0]), np.median(pts[:, 1]),
                     np.min(pts[:, 2])])


def _geometry_from_points(pts: np.ndarray, min_points: int = 5):
    """OBB volume/extent and covariance shape attributes of one point set
    (roman_tpu/interop.py:288-315)."""
    pts = np.asarray(pts, np.float64)
    mu = pts.mean(axis=0)
    c = pts - mu
    cov = c.T @ c / len(pts)
    evals, vecs = np.linalg.eigh(cov)  # ascending
    e = np.clip(evals[::-1], 0.0, None)
    e = e / max(e.sum(), 1e-12)
    e1 = max(e[0], 1e-12)
    attrs = np.array([(e[0] - e[1]) / e1, (e[1] - e[2]) / e1, e[2] / e1])
    if len(pts) >= min_points:
        proj = c @ vecs[:, ::-1]  # principal-axis frame (descending)
        extent = proj.max(axis=0) - proj.min(axis=0)
    else:
        extent = np.zeros(3)
    return float(np.prod(extent)), extent, attrs
