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
import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import (RegistrationConfig,
                                                RegistrationResult, build_features,
                                                get_MCA as _get_MCA_fn,
                                                mno_clipper as _mno_clipper_fn,
                                                register_clipper)
from roman_tpu_torch.device import resolve_device
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


def _descriptors(objs: Sequence, cap: int) -> Optional[np.ndarray]:
    """(cap, D) unit semantic descriptors, D from the first object that has
    one (zero rows where an object has none), or None when none has one."""
    d0 = next((np.asarray(o.semantic_descriptor).reshape(-1) for o in objs
               if getattr(o, "semantic_descriptor", None) is not None), None)
    if d0 is None:
        return None
    out = np.zeros((cap, d0.shape[0]), np.float32)
    for j, o in enumerate(objs[:cap]):
        d = getattr(o, "semantic_descriptor", None)
        if d is not None:
            d = np.asarray(d).reshape(-1)
            out[j] = d / max(np.linalg.norm(d), 1e-9)
    return out


def segments_to_features(objs: Sequence, cfg: RegistrationConfig,
                         capacity: Optional[int] = None,
                         device=None) -> SubmapFeatures:
    """Pack one object list (SegmentData or reference-like objects exposing
    center, volume, extent, linearity/planarity/scattering or pca_attrs,
    semantic_descriptor) into unbatched SubmapFeatures on `device`
    (default cuda): the feature layout of
    ROMANRegistration._object_to_clipper_list (roman_registration.py:98-108).
    The capacity is len(objs) unless given."""
    device = resolve_device(device)
    cap = capacity or max(len(objs), 1)
    centers = np.zeros((cap, 3), np.float32)
    pca = np.zeros((cap, 3), np.float32)
    volume = np.zeros((cap,), np.float32)
    extent = np.zeros((cap, 3), np.float32)
    valid = np.zeros((cap,), bool)
    desc = _descriptors(objs, cap)
    if desc is None:
        desc = np.zeros((cap, 0), np.float32)
    for j, s in enumerate(objs[:cap]):
        centers[j] = _center_of(s)
        pca[j], volume[j] = _shape_attrs(s)
        e = getattr(s, "extent", None)
        if e is not None:
            extent[j] = np.asarray(e).reshape(3)
        valid[j] = True

    def dev(x):
        tracing.count_sync(device)  # a copy from host memory returns when it is done
        return torch.as_tensor(x, device=device)

    return build_features(dev(centers), dev(valid), cfg, pca_attrs=dev(pca),
                          volume=dev(volume), extent=dev(extent),
                          descriptors=dev(desc))


def _host(x: torch.Tensor) -> np.ndarray:
    tracing.count_sync(x.device)
    return x.cpu().numpy()


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
            def up(x):
                if x.device.type == "cpu":
                    tracing.count_sync(self.device)
                return x.to(self.device)

            return map1.map(up), map2.map(up)
        return (segments_to_features(map1, self.cfg, device=self.device),
                segments_to_features(map2, self.cfg, device=self.device))

    @staticmethod
    def _size(m) -> int:
        """Object count of a list or an (unbatched) SubmapFeatures."""
        if isinstance(m, SubmapFeatures):
            tracing.count_sync(m.valid.device)
            return int(m.valid.sum())
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
                return np.argwhere(_host(sel))

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
                return _host(m.centers)[idx]
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
        M = _host(M)[np.ix_(keep, keep)]
        C = _host(C)[np.ix_(keep, keep)]
        A = np.stack([keep // f2.capacity, keep % f2.capacity], axis=-1)
        return M, C, A

    def mno_clipper(self, map1: List, map2: List, num_solutions: int = 2):
        """Multiple non-overlapping solutions (:57-86): a list of ((k, 2)
        associations, score) a solution."""
        f1, f2 = self._features(map1, map2)
        sols = _mno_clipper_fn(f1, f2, self.cfg, num_solutions=num_solutions)
        return [(np.argwhere(_host(sel)), float(F)) for sel, _, F in sols]
