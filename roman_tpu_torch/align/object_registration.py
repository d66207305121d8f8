"""The reference's per-pair registration classes over the port's batched
engine (port of roman_tpu/align/object_registration.py; reference
roman/align/object_registration.py:17-159).

The reference solves one submap pair at a time through C++ clipperpy.
These classes keep its surface over ``align.registration``, which
registers a whole batch of pairs at once:

    reg = ROMANRegistration(ROMANParams(...))   # roman_registration.py
    A   = reg.register(segs1, segs2)            # (k, 2) association indices
    T   = reg.T_align(segs1, segs2, A)          # 4x4 aligning map2 -> map1

Each side is packed at its own size (no padding), so one pair of n and m
objects runs the four kernels of the fused path at N = n*m. The kernels
take N up to the shared memory of a block (see ``fused_register.
check_shape``); above it a call on the card raises ValueError and
launches nothing. Every call returns numpy on the host, so it waits for
the card. For throughput, register many pairs at once with
``submap_align.PairGridRegistrar``.

Classes run on ``cuda`` unless constructed with ``device="cpu"`` (the
plain PyTorch path); on a host without a card the constructor raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from roman_tpu_torch import tracing
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import (RegistrationConfig,
                                                RegistrationResult, build_features,
                                                get_MCA as _get_MCA_fn,
                                                mno_clipper as _mno_clipper_fn,
                                                register_clipper)
from roman_tpu_torch.device import resolve_device, to_device, to_host
from roman_tpu_torch.ops.se3_np import arun_np


class InsufficientAssociationsException(Exception):
    """Raised by T_align when < dim correspondences are available
    (reference object_registration.py:8-15, :106-108)."""

    def __init__(self, map1_len, map2_len, n_associations=None):
        self.map1_len = map1_len
        self.map2_len = map2_len
        self.n_associations = n_associations
        super().__init__(
            f"Insufficient associations. Map 1 length: {map1_len}. "
            f"Map 2 length: {map2_len}. Associations: {n_associations}"
        )


def _center_of(obj) -> np.ndarray:
    return np.asarray(obj.center).reshape(-1)[:3]


def _shape_attrs(obj):
    """(pca (3,), volume) of an object exposing pca_attrs or
    linearity/planarity/scattering, and volume."""
    if hasattr(obj, "pca_attrs"):
        pca = np.asarray(obj.pca_attrs).reshape(3)
    elif hasattr(obj, "linearity"):
        pca = np.array([obj.linearity, obj.planarity, obj.scattering])
    else:
        pca = np.zeros(3)
    return pca, getattr(obj, "volume", 0.0)


def pack_objects(lists: Sequence[Sequence], cfg: RegistrationConfig,
                 capacity: Optional[int] = None, desc_dim: Optional[int] = None,
                 device=None):
    """Pack S object lists (SegmentData or reference-like objects exposing
    center, volume, extent, linearity/planarity/scattering or pca_attrs,
    semantic_descriptor, id) into batched SubmapFeatures of shape
    (S, capacity, ·) on `device` (default cuda), and their (S, capacity)
    int64 segment ids, -1 where no object is: the feature layout of
    ROMANRegistration._object_to_clipper_list (roman_registration.py:98-108).

    capacity defaults to the longest list (at least 1); a list past it is
    cut. desc_dim None takes D from the first object that has a descriptor
    (0 when none has one); a descriptor row is the object's descriptor over
    its norm, and zero where the object has none or D is 0. Each field goes
    up in one copy."""
    device = resolve_device(device)
    S = len(lists)
    cap = capacity or max(1, max(map(len, lists), default=0))
    if desc_dim is None:
        d0 = next((o.semantic_descriptor for objs in lists for o in objs
                   if getattr(o, "semantic_descriptor", None) is not None), None)
        desc_dim = 0 if d0 is None else np.asarray(d0).size
    centers = np.zeros((S, cap, 3), np.float32)
    pca = np.zeros((S, cap, 3), np.float32)
    volume = np.zeros((S, cap), np.float32)
    extent = np.zeros((S, cap, 3), np.float32)
    desc = np.zeros((S, cap, desc_dim), np.float32)
    valid = np.zeros((S, cap), bool)
    seg_ids = np.full((S, cap), -1, np.int64)
    for i, objs in enumerate(lists):
        for j, o in enumerate(objs[:cap]):
            centers[i, j] = _center_of(o)
            pca[i, j], volume[i, j] = _shape_attrs(o)
            e = getattr(o, "extent", None)
            if e is not None:
                extent[i, j] = np.asarray(e).reshape(3)
            d = getattr(o, "semantic_descriptor", None)
            if desc_dim and d is not None:
                d = np.asarray(d).reshape(-1)
                desc[i, j] = d / max(np.linalg.norm(d), 1e-9)
            valid[i, j] = True
            seg_ids[i, j] = getattr(o, "id", -1)
    feats = build_features(to_device(centers, device), to_device(valid, device), cfg,
                           pca_attrs=to_device(pca, device),
                           volume=to_device(volume, device),
                           extent=to_device(extent, device),
                           descriptors=to_device(desc, device))
    return feats, seg_ids


def segments_to_features(objs: Sequence, cfg: RegistrationConfig,
                         capacity: Optional[int] = None,
                         device=None) -> SubmapFeatures:
    """Pack one object list into unbatched SubmapFeatures on `device`
    (default cuda): row 0 of pack_objects([objs]). The capacity is
    len(objs) unless given."""
    return pack_objects([objs], cfg, capacity, device=device)[0].map(lambda x: x[0])


class ObjectRegistration:
    """Per-pair adapter over the batched engine. Subclasses pick the
    method through their RegistrationConfig (reference template:
    object_registration.py:17-86)."""

    def __init__(self, cfg: Optional[RegistrationConfig] = None, dim: int = 3,
                 device=None):
        self.cfg = cfg if cfg is not None else RegistrationConfig(dim=dim)
        self.dim = self.cfg.dim
        self.device = resolve_device(device)

    def _features(self, map1, map2):
        """Both sides as SubmapFeatures on this registration's device."""
        if isinstance(map1, SubmapFeatures):
            return (map1.map(lambda x: to_device(x, self.device)),
                    map2.map(lambda x: to_device(x, self.device)))
        return (segments_to_features(map1, self.cfg, device=self.device),
                segments_to_features(map2, self.cfg, device=self.device))

    @staticmethod
    def _size(m) -> int:
        """Object count of a list or an (unbatched) SubmapFeatures."""
        if isinstance(m, SubmapFeatures):
            return int(to_host(m.valid.sum()))
        return len(m)

    def _solve(self, f1: SubmapFeatures, f2: SubmapFeatures) -> RegistrationResult:
        """The engine's result for the packed pair, on this device."""
        return register_clipper(f1, f2, self.cfg)

    def register(self, map1: List, map2: List) -> np.ndarray:
        """Solve the pair; the (k, 2) selected association indices, the
        reference's return contract (:22-29). An empty side launches
        nothing and gives np.array([[]])."""
        with tracing.span("per_pair.register"):
            if self._size(map1) == 0 or self._size(map2) == 0:
                return np.array([[]])
            with tracing.span("per_pair.pack"):
                f1, f2 = self._features(map1, map2)
            sel = self._solve(f1, f2).sel
            with tracing.span("per_pair.home"):
                return np.argwhere(to_host(sel).numpy())

    def T_align(self, map1: List, map2: List,
                correspondences: Optional[np.ndarray] = None) -> np.ndarray:
        """4x4 aligning map2 -> map1 by Arun's SVD on the corresponding
        centers (:88-129)."""
        n1, n2 = self._size(map1), self._size(map2)
        if n1 == 0 or n2 == 0:
            raise InsufficientAssociationsException(n1, n2)
        if correspondences is None:
            correspondences = self.register(map1, map2)
        correspondences = np.asarray(correspondences).reshape(-1, 2)
        if len(correspondences) < self.dim:
            raise InsufficientAssociationsException(
                n1, n2, len(correspondences))

        def centers(m, idx):
            if isinstance(m, SubmapFeatures):
                return to_host(m.centers).numpy()[idx]
            return np.stack([_center_of(m[k]) for k in idx])

        pts1 = centers(map1, correspondences[:, 0])
        pts2 = centers(map2, correspondences[:, 1])
        return arun_np(pts1, pts2)

    def get_MCA(self, map1: List, map2: List):
        """Affinity M, constraint C and the all-to-all association list A
        (:50-55), as numpy: N = n*m over the valid objects only, the
        reference's shapes."""
        f1, f2 = self._features(map1, map2)
        M, C, A = _get_MCA_fn(f1, f2, self.cfg)
        n, m = self._size(map1), self._size(map2)
        keep = np.array([a * f2.capacity + b for a in range(n) for b in range(m)])
        M = to_host(M).numpy()[np.ix_(keep, keep)]
        C = to_host(C).numpy()[np.ix_(keep, keep)]
        A = np.stack([keep // f2.capacity, keep % f2.capacity], axis=-1)
        return M, C, A

    def mno_clipper(self, map1: List, map2: List, num_solutions: int = 2):
        """Multiple non-overlapping solutions (:57-86): a list of ((k, 2)
        associations, score) a solution."""
        f1, f2 = self._features(map1, map2)
        sols = _mno_clipper_fn(f1, f2, self.cfg, num_solutions=num_solutions)
        return [(np.argwhere(to_host(sel).numpy()), float(F)) for sel, _, F in sols]
