"""DistRegWithPruning, the "clipper+prune" baseline (port of
roman_tpu/align/dist_reg_with_pruning.py; reference
roman/align/dist_reg_with_pruning.py:15-99).

Euclidean-distance CLIPPER over candidate associations pre-pruned by
semantic cosine and shape-ratio thresholds, with a post-hoc gravity
(roll/pitch) check. It goes through ``registration.register_clipper_prune``,
so a call on the card runs the four kernels with the pruned association
mask.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.object_registration import (  # noqa: F401 (roman_tpu's names)
    ObjectRegistration, segments_to_features)
from roman_tpu_torch.align.registration import (RegistrationConfig, RegistrationResult,
                                                register_clipper_prune)
from roman_tpu_torch.ops.se3_np import T_to_xyzrpy


class GravityConstraintError(Exception):
    """Estimated alignment violates the roll/pitch bound
    (dist_reg_with_pruning.py:12, :37-44)."""


class DistRegWithPruning(ObjectRegistration):
    """Constructor signature of reference dist_reg_with_pruning.py:17-18:
    (sigma, epsilon, mindist=0.0, shape_epsilon=0.0, cos_min=0.85,
    dim=3, use_gravity=False, roll_pitch_thresh=np.deg2rad(5)), then
    `device` as for ObjectRegistration (default cuda)."""

    def __init__(self, sigma: float, epsilon: float,
                 mindist: float = 0.0, shape_epsilon: float = 0.0,
                 cos_min: float = 0.85, dim: int = 3,
                 use_gravity: bool = False,
                 roll_pitch_thresh: float = float(np.deg2rad(5)),
                 device=None):
        if use_gravity and dim != 3:  # the reference's assertion, kept under -O
            raise AssertionError("Gravity can only be used with 3D points")
        cfg = RegistrationConfig(
            method="clipper+prune", dim=dim, sigma=sigma, epsilon=epsilon,
            mindist=mindist, cos_min=cos_min, epsilon_shape=shape_epsilon,
            roll_pitch_thresh=roll_pitch_thresh,
        )
        super().__init__(cfg, device=device)
        self.use_gravity = use_gravity
        # cos_min <= -1 and shape_epsilon <= 0 prune nothing (the reference
        # always applies both thresholds; these values are no-ops)
        self.prune_semantics = cos_min > -1.0
        self.prune_shape = shape_epsilon > 0.0

    def _solve(self, f1: SubmapFeatures, f2: SubmapFeatures) -> RegistrationResult:
        """clipper+prune on the packed pair. The prune masks read the
        features: for this method their ratio features are [pca (3),
        volume] (build_features' order) and their descriptors unit rows,
        D = 0 on a side where no object has one (then no semantic prune)."""
        kw = {}
        if self.prune_shape:
            if f1.ratio_feats.shape[-1] != 4 or f2.ratio_feats.shape[-1] != 4:
                raise ValueError("DistRegWithPruning needs features packed with its "
                                 "own cfg (ratio features [pca (3), volume])")
            kw.update(pca_attrs1=f1.ratio_feats[..., :3], volume1=f1.ratio_feats[..., 3],
                      pca_attrs2=f2.ratio_feats[..., :3], volume2=f2.ratio_feats[..., 3])
        if (self.prune_semantics and f1.descriptors.shape[-1] > 0
                and f2.descriptors.shape[-1] > 0):
            kw.update(descriptors1=f1.descriptors, descriptors2=f2.descriptors)
        return register_clipper_prune(f1, f2, self.cfg, **kw)

    def T_align(self, map1: List, map2: List,
                correspondences: Optional[np.ndarray] = None) -> np.ndarray:
        T = super().T_align(map1, map2, correspondences)
        if self.use_gravity:
            _, _, _, roll, pitch, _ = T_to_xyzrpy(T)
            if (abs(roll) > self.cfg.roll_pitch_thresh
                    or abs(pitch) > self.cfg.roll_pitch_thresh):
                raise GravityConstraintError(
                    f"roll={roll:.3f} pitch={pitch:.3f} exceed "
                    f"{self.cfg.roll_pitch_thresh:.3f} rad")
        return T
