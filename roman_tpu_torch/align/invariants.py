"""The ROMAN consistency invariant as a batched affinity tensor.

Port of roman_tpu/align/invariants.py (the clipperpy ROMAN invariant of
reference roman/align/roman_registration.py:55-96) as plain PyTorch on
tensors. Scores fused per candidate-association pair (i=(a1,b1),
j=(a2,b2)):

- distance consistency: Gaussian kernel on the mismatch of intra-map
  distances, hard-gated at ``epsilon`` and by ``mindist``; the gravity
  variant compares vertical and horizontal components separately with an
  angular slack;
- ratio similarity (per association): geometric mean over shape features
  of min/max ratios, gated by ``ratio_epsilon``;
- cosine similarity (per association): descriptor cosine rescaled from
  [cos_min, cos_max] to [0, 1].

Per-association scores enter the pairwise affinity through the geometric
mean of the two endpoints' scores and fill the diagonal. The (N, N)
affinity (N = n*m) is a broadcast expression over (n, n), (m, m) and
(n, m) tensors, viewed as the 4-tensor M[a1, b1, a2, b2].

This is the plain affinity that the arithmetic-mean and product fusions
run before the CLIPPER solve kernel. Geometric-mean fusion goes through the
fused path (``align.fused_register``), which mirrors the log-space
formulation of the TPU kernel instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class ROMANInvariantParams:
    """Mirrors clipperpy.invariants.ROMANParams (roman_registration.py:55-79)."""

    sigma: float = 0.4
    epsilon: float = 0.6
    mindist: float = 0.2
    cos_min: float = 0.85
    cos_max: float = 1.0
    ratio_epsilon: Optional[torch.Tensor] = None  # (F,) per-feature gate
    distance_weight: float = 1.0
    ratio_weight: float = 1.0
    cosine_weight: float = 1.0
    gravity: bool = False
    gravity_unc_ang_rad: float = 0.0872665
    fusion: str = "geometric_mean"
    use_ratio: bool = True
    use_cosine: bool = True


@dataclasses.dataclass
class SubmapFeatures:
    """Padded per-submap object features (struct of tensors). Leading
    batch dims are allowed on every field."""

    centers: torch.Tensor       # (..., n, 3) f32
    ratio_feats: torch.Tensor   # (..., n, F) f32, F may be 0
    descriptors: torch.Tensor   # (..., n, D) f32, D may be 0
    valid: torch.Tensor         # (..., n) bool

    @property
    def capacity(self) -> int:
        return self.centers.shape[-2]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "SubmapFeatures":
        """A new SubmapFeatures with fn applied to every field."""
        return SubmapFeatures(*(fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)))


def ratio_similarity(r1: torch.Tensor, r2: torch.Tensor,
                     ratio_epsilon) -> torch.Tensor:
    """Per-association shape-feature ratio score, (..., n, F) x (..., m, F)
    -> (..., n, m): per feature rho = min/max in [0, 1], gated to 0 below
    ratio_epsilon[f], combined by geometric mean over features."""
    F = r1.shape[-1]
    if F == 0:
        return torch.ones(r1.shape[:-2] + (r1.shape[-2], r2.shape[-2]),
                          dtype=r1.dtype, device=r1.device)
    a = torch.abs(r1[..., :, None, :])
    b = torch.abs(r2[..., None, :, :])
    rho = torch.minimum(a, b) / torch.clamp(torch.maximum(a, b), min=1e-9)
    if ratio_epsilon is not None:
        rho = torch.where(rho >= ratio_epsilon, rho, 0.0)
    return (torch.exp(torch.mean(torch.log(torch.clamp(rho, min=1e-20)), dim=-1))
            * torch.all(rho > 0, dim=-1))


def cosine_score(d1: torch.Tensor, d2: torch.Tensor, cos_min: float,
                 cos_max: float) -> torch.Tensor:
    """Clamped, rescaled descriptor cosine (..., n, m). Associations with a
    missing (zero) descriptor score 1.0 (reference mapper.py:208-209)."""
    D = d1.shape[-1]
    if D == 0:
        return torch.ones(d1.shape[:-2] + (d1.shape[-2], d2.shape[-2]),
                          dtype=d1.dtype, device=d1.device)
    n1 = torch.linalg.vector_norm(d1, dim=-1)
    n2 = torch.linalg.vector_norm(d2, dim=-1)
    dot = torch.einsum("...nd,...md->...nm", d1, d2)
    denom = n1[..., :, None] * n2[..., None, :]
    cos = torch.where(denom > 1e-9, dot / torch.clamp(denom, min=1e-9), 1.0)
    missing = (n1[..., :, None] < 1e-9) | (n2[..., None, :] < 1e-9)
    score = torch.clamp((cos - cos_min) / max(cos_max - cos_min, 1e-9),
                        0.0, 1.0)
    return torch.where(missing, 1.0, score)


def single_scores(f1: SubmapFeatures, f2: SubmapFeatures,
                  p: ROMANInvariantParams):
    """Fused per-association score (..., n, m) plus its components."""
    comps, weights = [], []
    if p.use_ratio and f1.ratio_feats.shape[-1] > 0:
        comps.append(ratio_similarity(f1.ratio_feats, f2.ratio_feats,
                                      p.ratio_epsilon))
        weights.append(p.ratio_weight)
    if p.use_cosine and f1.descriptors.shape[-1] > 0:
        comps.append(cosine_score(f1.descriptors, f2.descriptors,
                                  p.cos_min, p.cos_max))
        weights.append(p.cosine_weight)
    pair_valid = f1.valid[..., :, None] & f2.valid[..., None, :]
    if not comps:
        fused = torch.ones(pair_valid.shape, dtype=f1.centers.dtype,
                           device=f1.centers.device)
    else:
        fused = _fuse(comps, weights, p.fusion)
    return torch.where(pair_valid, fused, 0.0), comps


def _fuse(comps, weights, fusion: str):
    wsum = max(float(sum(weights)), 1e-9)
    if fusion == "arithmetic_mean":
        out = sum(wi * c for wi, c in zip(weights, comps)) / wsum
        return out * torch.prod(torch.stack([c > 0 for c in comps]), dim=0)
    if fusion == "product":
        out = comps[0]
        for c in comps[1:]:
            out = out * c
        return out
    # geometric mean (default; roman_registration.py FusionMethod.GEOMETRIC_MEAN)
    log_sum = sum(wi * torch.log(torch.clamp(c, min=1e-20))
                  for wi, c in zip(weights, comps))
    gm = torch.exp(log_sum / wsum)
    nonzero = torch.ones_like(comps[0], dtype=torch.bool)
    for c in comps:
        nonzero = nonzero & (c > 0)
    return torch.where(nonzero, gm, 0.0)


def distance_consistency(f1: SubmapFeatures, f2: SubmapFeatures,
                         p: ROMANInvariantParams) -> torch.Tensor:
    """Pairwise distance-consistency tensor (..., n, m, n, m) in [0, 1]."""
    c1, c2 = f1.centers, f2.centers
    diff1 = c1[..., :, None, :] - c1[..., None, :, :]  # (..., n, n, 3)
    diff2 = c2[..., :, None, :] - c2[..., None, :, :]  # (..., m, m, 3)
    D1 = torch.linalg.vector_norm(diff1, dim=-1)
    D2 = torch.linalg.vector_norm(diff2, dim=-1)
    d1 = D1[..., :, None, :, None]  # index [a1, b1, a2, b2] broadcast
    d2 = D2[..., None, :, None, :]
    if p.gravity:
        dz1 = torch.abs(diff1[..., 2])[..., :, None, :, None]
        dz2 = torch.abs(diff2[..., 2])[..., None, :, None, :]
        dxy1 = torch.linalg.vector_norm(diff1[..., :2], dim=-1)[..., :, None, :, None]
        dxy2 = torch.linalg.vector_norm(diff2[..., :2], dim=-1)[..., None, :, None, :]
        slack = math.sin(p.gravity_unc_ang_rad) * torch.maximum(d1, d2)
        cz = torch.clamp(torch.abs(dz1 - dz2) - slack, min=0.0)
        cxy = torch.abs(dxy1 - dxy2)
        c = torch.sqrt(cz ** 2 + cxy ** 2 + 1e-20)
    else:
        c = torch.abs(d1 - d2)
    s = torch.exp(-0.5 * (c / p.sigma) ** 2)
    s = torch.where(c < p.epsilon, s, 0.0)
    # near-coincident object pairs are uninformative -> inconsistent
    return torch.where((d1 > p.mindist) & (d2 > p.mindist), s, 0.0)


def affinity(f1: SubmapFeatures, f2: SubmapFeatures, p: ROMANInvariantParams,
             dtype=torch.float32):
    """Full pairwise + single affinity.

    Returns M4 (..., n, m, n, m) with single scores on the diagonal and
    zeros on constraint-violating / invalid entries, and single (..., n, m).
    """
    single, _ = single_scores(f1, f2, p)
    comps = [distance_consistency(f1, f2, p)]
    weights = [p.distance_weight]
    if p.use_ratio and f1.ratio_feats.shape[-1] > 0:
        sr = ratio_similarity(f1.ratio_feats, f2.ratio_feats, p.ratio_epsilon)
        comps.append(torch.sqrt(torch.clamp(
            sr[..., :, :, None, None] * sr[..., None, None, :, :], min=0.0)))
        weights.append(p.ratio_weight)
    if p.use_cosine and f1.descriptors.shape[-1] > 0:
        sc = cosine_score(f1.descriptors, f2.descriptors, p.cos_min, p.cos_max)
        comps.append(torch.sqrt(torch.clamp(
            sc[..., :, :, None, None] * sc[..., None, None, :, :], min=0.0)))
        weights.append(p.cosine_weight)
    M4 = _fuse(comps, weights, p.fusion)

    n, m = f1.capacity, f2.capacity
    dev = M4.device
    eye_n = torch.eye(n, dtype=torch.bool, device=dev)
    eye_m = torch.eye(m, dtype=torch.bool, device=dev)
    same_a = eye_n[:, None, :, None]
    same_b = eye_m[None, :, None, :]
    conflict = same_a ^ same_b  # one-to-one violation
    diag = same_a & same_b
    v1, v2 = f1.valid, f2.valid
    valid4 = ((v1[..., :, None, None, None] & v2[..., None, :, None, None])
              & (v1[..., None, None, :, None] & v2[..., None, None, None, :]))
    M4 = torch.where(conflict | diag | ~valid4, 0.0, M4)
    M4 = M4 + torch.where(diag & valid4,
                          single[..., :, :, None, None] * torch.ones_like(M4),
                          0.0)
    return M4.to(dtype), single
