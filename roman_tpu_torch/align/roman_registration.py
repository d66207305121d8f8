"""ROMANRegistration and its parameters (port of
roman_tpu/align/roman_registration.py; reference
roman/align/roman_registration.py).

The reference configures the C++ ROMAN invariant through ROMANParams and
solves with CLIPPERPairwiseAndSingle (roman_registration.py:38-96); here
the same parameters configure the port's fused path, so a call on the
card runs the four kernels (``align.fused_register``) on one pair.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

from roman_tpu_torch.align.object_registration import ObjectRegistration
from roman_tpu_torch.align.registration import RegistrationConfig


class FusionMethod(Enum):
    """Consistency-fusion modes (roman_registration.py:11-14)."""

    GEOMETRIC_MEAN = "geometric_mean"
    ARITHMETIC_MEAN = "arithmetic_mean"
    PRODUCT = "product"


@dataclasses.dataclass
class ROMANParams:
    """Field-parity with reference ROMANParams (roman_registration.py:17-36)."""

    point_dim: int = 3
    fusion_method: FusionMethod = FusionMethod.GEOMETRIC_MEAN

    sigma: float = 0.4
    epsilon: float = 0.6
    mindist: float = 0.2

    gravity: bool = False
    volume: bool = False
    pca: bool = False
    extent: bool = False
    semantics_dim: int = 0
    gravity_unc_ang_rad: float = 0.0872665

    cos_min: float = 0.85
    cos_max: float = 1.0
    epsilon_shape: Optional[float] = None


def _method_for(p: ROMANParams) -> str:
    """The method-table name of the feature-flag combination
    (submap_align_params.py:98-116). A combination outside the table keeps
    the name "roman"; the config carries the exact flags through
    feature_overrides either way, since the reference adds any
    combination (roman_registration.py:55-70)."""
    flags = (p.gravity, p.volume, p.extent, p.pca, p.semantics_dim > 0)
    table = {
        (True, True, False, True, True): "roman",
        (True, True, True, False, True): "sevg",
        (False, True, False, True, True): "spv",
        (True, False, False, False, True): "semanticgrav",
        (True, True, False, True, False): "pcavolgrav",
        (True, True, True, False, False): "extentvolgrav",
        (True, False, False, False, False): "gravity",
        (False, False, False, False, False): "clipper",
    }
    return table.get(flags, "roman")


class ROMANRegistration(ObjectRegistration):
    """The paper's method with the reference's constructor; `device` as
    for ObjectRegistration (default cuda)."""

    def __init__(self, params: ROMANParams, device=None):
        fusion = (params.fusion_method.value
                  if isinstance(params.fusion_method, FusionMethod)
                  else str(params.fusion_method))
        cfg = RegistrationConfig(
            method=_method_for(params),
            feature_overrides=(params.gravity, params.volume, params.extent,
                               params.pca, params.semantics_dim > 0),
            dim=params.point_dim,
            fusion=fusion,
            sigma=params.sigma,
            epsilon=params.epsilon,
            mindist=params.mindist,
            epsilon_shape=(0.0 if params.epsilon_shape is None
                           else params.epsilon_shape),
            cos_min=params.cos_min,
            cos_max=params.cos_max,
            gravity_unc_ang_rad=params.gravity_unc_ang_rad,
        )
        super().__init__(cfg, device=device)
        self.params = params
