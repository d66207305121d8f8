"""Batched object-map registration for the ROMAN method family.

Port of the CLIPPER-based part of roman_tpu/align/registration.py
(reference roman/align/object_registration.py, roman_registration.py and
the method factory of roman/params/submap_align_params.py:86-150): each
method is a function over batched SubmapFeatures that registers every pair
of the batch at once.

Geometric-mean fusion (the default) runs the fused path
(``align.fused_register``: four kernels on the card). Arithmetic-mean and
product fusion run the plain affinity, the CLIPPER solve kernel and the
plain rounding and refinement (registration.py:290-328). Which of a
kernel or its plain twin runs is decided by the device of the tensors.

The clipper+prune and RANSAC baselines (register_clipper_prune,
register_ransac, get_MCA, mno_clipper) are not ported yet: ROADMAP.md,
Queue 1, item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from roman_tpu_torch.align import clipper as clipper_mod
from roman_tpu_torch.align import invariants
from roman_tpu_torch.align.fused_register import (FusedInvariantStatics,
                                                  fused_register)
from roman_tpu_torch.align.invariants import ROMANInvariantParams, SubmapFeatures
from roman_tpu_torch.ops.arun import arun

# methods sharing the ROMAN invariant machinery, and which feature blocks
# they enable (submap_align_params.py:98-116)
_ROMAN_FAMILY = {
    #            gravity  volume  extent  pca    semantics
    "clipper":       (False, False, False, False, False),
    "gravity":       (True,  False, False, False, False),
    "pcavolgrav":    (True,  True,  False, True,  False),
    "extentvolgrav": (True,  True,  True,  False, False),
    "roman":         (True,  True,  False, True,  True),
    "sevg":          (True,  True,  True,  False, True),
    "spv":           (False, True,  False, True,  True),
    "semanticgrav":  (True,  False, False, False, True),
}
_METHOD_ALIASES = {"spvg": "roman", "roman_no_semantics": "pcavolgrav"}


@dataclasses.dataclass
class RegistrationConfig:
    """Host-level registration configuration (roman_tpu/align/
    registration.py:44-137, without the TPU engine knobs)."""

    method: str = "roman"
    dim: int = 3
    fusion: str = "geometric_mean"
    sigma: float = 0.4
    epsilon: float = 0.6
    mindist: float = 0.2
    epsilon_shape: float = 0.0
    cos_min: float = 0.85
    cos_max: float = 1.0
    gravity_unc_ang_rad: float = 0.0872665
    roll_pitch_thresh: float = float(np.deg2rad(5))
    ransac_iter: int = 4096
    max_clique: int = 64
    # explicit (gravity, volume, extent, pca, semantics) flags overriding
    # the method table (roman_registration.py:55-70)
    feature_overrides: Optional[tuple] = None
    solver: clipper_mod.ClipperSolveParams = dataclasses.field(
        default_factory=clipper_mod.ClipperSolveParams)

    def __post_init__(self):
        self.method = _METHOD_ALIASES.get(self.method, self.method)

    @property
    def feature_flags(self):
        """(gravity, volume, extent, pca, semantics): the feature blocks
        build_features packs."""
        if self.feature_overrides is not None:
            return tuple(self.feature_overrides)
        if self.method in _ROMAN_FAMILY:
            return _ROMAN_FAMILY[self.method]
        if self.method == "clipper+prune":
            return (False, True, False, True, True)
        return (False, False, False, False, False)  # ransac: centers only

    @property
    def solve_flags(self):
        """(gravity, use_ratio, use_cosine) the invariant applies at solve
        time (clipper+prune solves a plain Euclidean CLIPPER)."""
        if self.method == "clipper+prune":
            return (False, False, False)
        gravity, volume, extent, pca, semantics = self.feature_flags
        return (gravity, volume or extent or pca, semantics)

    def invariant_params(self, n_ratio_feats: int,
                         device=None) -> ROMANInvariantParams:
        gravity, use_ratio, use_cosine = self.solve_flags
        use_ratio = use_ratio and n_ratio_feats > 0
        return ROMANInvariantParams(
            sigma=self.sigma, epsilon=self.epsilon, mindist=self.mindist,
            cos_min=self.cos_min, cos_max=self.cos_max,
            ratio_epsilon=(torch.full((n_ratio_feats,), self.epsilon_shape,
                                      device=device) if use_ratio else None),
            gravity=gravity, gravity_unc_ang_rad=self.gravity_unc_ang_rad,
            fusion=self.fusion, use_ratio=use_ratio, use_cosine=use_cosine,
        )


@dataclasses.dataclass
class RegistrationResult:
    sel: torch.Tensor      # (..., n, m) bool selected associations
    count: torch.Tensor    # (...,) int32 number of associations
    T_align: torch.Tensor  # (..., 4, 4) aligns map2 -> map1
    ok: torch.Tensor       # (...,) bool: count >= dim
    u: Optional[torch.Tensor]  # (..., n, m) solver eigenvector, or None
    score: torch.Tensor    # (...,) clique objective F
    # (...,) bool: the homotopy finished with no active one-to-one
    # violation; False marks a pair whose iteration budget ran out, which
    # the rescue re-solves at RESCUE_SOLVER budget
    converged: Optional[torch.Tensor] = None


def build_features(centers, valid, cfg: RegistrationConfig, pca_attrs=None,
                   volume=None, extent=None, descriptors=None) -> SubmapFeatures:
    """Per-object feature layout of
    ROMANRegistration._object_to_clipper_list (roman_registration.py:98-108):
    [pca(3)] + [volume(1)] + [sorted extent(3)] as ratio features, plus the
    semantic descriptor block."""
    _, use_volume, use_extent, use_pca, use_sem = cfg.feature_flags
    blocks = []
    if use_pca:
        blocks.append(pca_attrs)
    if use_volume:
        blocks.append(volume[..., None])
    if use_extent:
        blocks.append(torch.sort(extent, dim=-1).values)
    empty = centers.new_zeros(centers.shape[:-1] + (0,))
    ratio = torch.cat(blocks, dim=-1) if blocks else empty
    desc = descriptors if (use_sem and descriptors is not None) else empty
    return SubmapFeatures(centers=centers, ratio_feats=ratio, descriptors=desc,
                          valid=valid)


def _t_align_from_selection(f1: SubmapFeatures, f2: SubmapFeatures,
                            sel: torch.Tensor) -> torch.Tensor:
    """Batched Arun over selected center correspondences. sel (..., n, m)."""
    n, m = sel.shape[-2], sel.shape[-1]
    batch = sel.shape[:-2]
    pts1 = f1.centers[..., :, None, :].expand(batch + (n, m, 3)).reshape(batch + (n * m, 3))
    pts2 = f2.centers[..., None, :, :].expand(batch + (n, m, 3)).reshape(batch + (n * m, 3))
    w = sel.reshape(batch + (n * m,)).to(pts1.dtype)
    return arun(pts1, pts2, w)


# Budget for re-solving the pairs whose homotopy did not converge within the
# default (8, 6, 6) budget (roman_tpu/align/registration.py:209-218).
RESCUE_SOLVER = clipper_mod.ClipperSolveParams(
    warmup_iters=16, outer_iters=16, inner_iters=12)


def rescue_solver(solver: clipper_mod.ClipperSolveParams
                  ) -> clipper_mod.ClipperSolveParams:
    """RESCUE_SOLVER's budget, inheriting the active solver's n_restarts."""
    return dataclasses.replace(RESCUE_SOLVER, n_restarts=solver.n_restarts)


def _homotopy_converged(u: torch.Tensor,
                        solver: clipper_mod.ClipperSolveParams) -> torch.Tensor:
    """True where no entry of u is both active and in violation of the
    one-to-one constraint (the penalty step's predicate on the final u)."""
    Cbu = clipper_mod._cb_matvec(u)
    viol = (u > solver.active_eps) & (Cbu > solver.active_eps)
    return ~torch.any(viol.reshape(viol.shape[:-2] + (-1,)), dim=-1)


def splice_rescued(res: RegistrationResult, res2: RegistrationResult,
                   bad) -> RegistrationResult:
    """Rows `bad` of `res` overwritten by the re-solved `res2`, field by
    field (None fields pass through). The one rescue-splice rule, shared
    by register_clipper_rescued and PairGridRegistrar."""

    def splice(a, b):
        if a is None or b is None:
            return a
        out = a.clone()
        out[torch.as_tensor(bad, device=a.device)] = b.to(a.device)
        return out

    return RegistrationResult(**{
        f.name: splice(getattr(res, f.name), getattr(res2, f.name))
        for f in dataclasses.fields(res)})


def register_clipper_rescued(f1: SubmapFeatures, f2: SubmapFeatures,
                             cfg: RegistrationConfig) -> RegistrationResult:
    """register_clipper, then every pair whose homotopy ran out of budget
    is re-solved once at rescue_solver(cfg.solver) budget through the same
    path and spliced back. Batch must be 1-D."""
    res = register_clipper(f1, f2, cfg)
    bad = torch.nonzero(~res.converged).flatten()
    if bad.numel() == 0:
        return res
    rcfg = dataclasses.replace(cfg, solver=rescue_solver(cfg.solver))
    res2 = register_clipper(f1.map(lambda x: x[bad]), f2.map(lambda x: x[bad]),
                            rcfg)
    return splice_rescued(res, res2, bad)


def register_clipper(f1: SubmapFeatures, f2: SubmapFeatures,
                     cfg: RegistrationConfig,
                     assoc_mask: Optional[torch.Tensor] = None) -> RegistrationResult:
    """ROMAN-family registration, batched over the leading dims of f1/f2.

    Geometric-mean fusion runs the fused path; the other fusions run the
    plain affinity, then the CLIPPER solve, then the plain rounding and
    refinement."""
    if cfg.fusion == "geometric_mean":
        gravity, use_ratio, use_cosine = cfg.solve_flags
        inv = FusedInvariantStatics(
            sigma=cfg.sigma, epsilon=cfg.epsilon, mindist=cfg.mindist,
            cos_min=cfg.cos_min, cos_max=cfg.cos_max,
            eps_shape=cfg.epsilon_shape, gravity=gravity,
            gravity_unc_ang_rad=cfg.gravity_unc_ang_rad,
            use_ratio=use_ratio and f1.ratio_feats.shape[-1] > 0,
            use_cosine=use_cosine and f1.descriptors.shape[-1] > 0,
            max_clique=cfg.max_clique,
        )
        sel, count, u, F = fused_register(f1, f2, inv, cfg.solver,
                                          assoc_mask=assoc_mask)
    else:
        p = cfg.invariant_params(f1.ratio_feats.shape[-1],
                                 device=f1.centers.device)
        M4, _ = invariants.affinity(f1, f2, p)
        valid = f1.valid[..., :, None] & f2.valid[..., None, :]
        if assoc_mask is not None:
            valid = valid & assoc_mask
            keep = (assoc_mask[..., :, :, None, None]
                    & assoc_mask[..., None, None, :, :])
            M4 = torch.where(keep, M4, 0.0)
        max_clique = min(cfg.max_clique, f1.capacity, f2.capacity)
        sel, count, u, F = clipper_mod.solve_and_round(M4, valid, max_clique,
                                                       cfg.solver)
    T = _t_align_from_selection(f1, f2, sel)
    return RegistrationResult(sel=sel, count=count, T_align=T,
                              ok=count >= cfg.dim, u=u, score=F,
                              converged=_homotopy_converged(u, cfg.solver))
