"""Batched object-map registration: the ROMAN method family, and the
clipper+prune and RANSAC baselines.

Port of roman_tpu/align/registration.py (reference
roman/align/object_registration.py, roman_registration.py,
dist_reg_with_pruning.py, ransac_reg.py and the method factory of
roman/params/submap_align_params.py:86-150): each method is a function
over batched SubmapFeatures that registers every pair of the batch at
once.

Geometric-mean fusion (the default, and clipper+prune) runs the fused path
(``align.fused_register``: four kernels on the card). Arithmetic-mean and
product fusion, and ``mno_clipper``, run the plain affinity, then the
CLIPPER solve and round_refine kernels through
``clipper.solve_and_round``. Which of a kernel or its plain twin runs is
decided by the device of the tensors. RANSAC is plain torch code: its
hypothesis triplets come from uniform draws made on the host
(``ransac_draws``), so a seed gives the same triplets on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.align import clipper as clipper_mod
from roman_tpu_torch.align import invariants
from roman_tpu_torch.align.fused_register import (FusedInvariantStatics,
                                                  fused_register)
from roman_tpu_torch.align.invariants import ROMANInvariantParams, SubmapFeatures
from roman_tpu_torch.ops.arun import arun, arun_align
from roman_tpu_torch.ops.se3 import T_to_xyzrpy

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
    """Batched Arun over selected center correspondences. sel (..., n, m).
    On the card one launch of the arun_align kernel, with no wait; on the
    CPU its plain twin (``ops.arun.arun_align_plain``)."""
    return arun_align(f1.centers, f2.centers, sel)


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


def fused_statics(cfg: RegistrationConfig, f1: SubmapFeatures) -> FusedInvariantStatics:
    """The fused path's statics for cfg on features shaped as f1."""
    gravity, use_ratio, use_cosine = cfg.solve_flags
    return FusedInvariantStatics(
        sigma=cfg.sigma, epsilon=cfg.epsilon, mindist=cfg.mindist,
        cos_min=cfg.cos_min, cos_max=cfg.cos_max,
        eps_shape=cfg.epsilon_shape, gravity=gravity,
        gravity_unc_ang_rad=cfg.gravity_unc_ang_rad,
        use_ratio=use_ratio and f1.ratio_feats.shape[-1] > 0,
        use_cosine=use_cosine and f1.descriptors.shape[-1] > 0,
        max_clique=cfg.max_clique,
    )


def solve_clipper(f1: SubmapFeatures, f2: SubmapFeatures, cfg: RegistrationConfig,
                  assoc_mask: Optional[torch.Tensor] = None):
    """The device half of register_clipper: (sel, count, u, F) of every
    pair. Geometric-mean fusion runs the fused path; the other fusions run
    the plain affinity, then the CLIPPER solve, then the plain rounding and
    refinement. On the card it launches the kernels and waits for none of
    them."""
    with tracing.span("registration.solve"):
        if cfg.fusion == "geometric_mean":
            return fused_register(f1, f2, fused_statics(cfg, f1), cfg.solver,
                                  assoc_mask=assoc_mask)
        p = cfg.invariant_params(f1.ratio_feats.shape[-1], device=f1.centers.device)
        M4, _ = invariants.affinity(f1, f2, p)
        valid = f1.valid[..., :, None] & f2.valid[..., None, :]
        if assoc_mask is not None:
            valid = valid & assoc_mask
            keep = (assoc_mask[..., :, :, None, None]
                    & assoc_mask[..., None, None, :, :])
            M4 = torch.where(keep, M4, 0.0)
        max_clique = min(cfg.max_clique, f1.capacity, f2.capacity)
        return clipper_mod.solve_and_round(M4, valid, max_clique, cfg.solver)


def finish_clipper(f1: SubmapFeatures, f2: SubmapFeatures, cfg: RegistrationConfig,
                   sel, count, u, F) -> RegistrationResult:
    """The other half of register_clipper, on solve_clipper's outputs: the
    Arun T_align of the selection, ok and converged. On the card it
    launches the arun_align kernel and torch ops, and waits for none of
    them."""
    with tracing.span("registration.finish"):
        T = _t_align_from_selection(f1, f2, sel)
        return RegistrationResult(sel=sel, count=count, T_align=T,
                                  ok=count >= cfg.dim, u=u, score=F,
                                  converged=_homotopy_converged(u, cfg.solver))


def register_clipper(f1: SubmapFeatures, f2: SubmapFeatures,
                     cfg: RegistrationConfig,
                     assoc_mask: Optional[torch.Tensor] = None) -> RegistrationResult:
    """ROMAN-family registration, batched over the leading dims of f1/f2:
    solve_clipper, then finish_clipper."""
    return finish_clipper(f1, f2, cfg, *solve_clipper(f1, f2, cfg, assoc_mask))


def get_MCA(f1: SubmapFeatures, f2: SubmapFeatures, cfg: RegistrationConfig):
    """Affinity M (..., N, N), constraint C (N, N) and the all-to-all
    association list A (N, 2): the ObjectRegistration.get_MCA surface
    (object_registration.py:50-55). C is built here only for that surface;
    the solver never builds it."""
    p = cfg.invariant_params(f1.ratio_feats.shape[-1], device=f1.centers.device)
    M4, _ = invariants.affinity(f1, f2, p)
    n, m = f1.capacity, f2.capacity
    N = n * m
    M = M4.reshape(M4.shape[:-4] + (N, N))
    idx = torch.arange(N, device=M.device)
    a, b = idx // m, idx % m
    conflict = (a[:, None] == a[None, :]) ^ (b[:, None] == b[None, :])
    C = (~conflict).to(torch.float32)
    A = torch.stack([a, b], dim=-1)
    return M, C, A


def mno_clipper(f1: SubmapFeatures, f2: SubmapFeatures, cfg: RegistrationConfig,
                num_solutions: int = 2):
    """Multiple non-overlapping CLIPPER solutions: solve, zero the solved
    clique's rows and columns of M, solve again
    (object_registration.py:57-86). Returns a list of (sel, count, score);
    on the card each solution launches the solve and round_refine
    kernels."""
    p = cfg.invariant_params(f1.ratio_feats.shape[-1], device=f1.centers.device)
    M4, _ = invariants.affinity(f1, f2, p)
    valid = f1.valid[..., :, None] & f2.valid[..., None, :]
    max_clique = min(cfg.max_clique, f1.capacity, f2.capacity)
    solutions = []
    for _ in range(num_solutions):
        sel, count, _, F = clipper_mod.solve_and_round(M4, valid, max_clique,
                                                       cfg.solver)
        solutions.append((sel, count, F))
        keep = ~(sel[..., :, :, None, None] | sel[..., None, None, :, :])
        M4 = torch.where(keep, M4, 0.0)
        valid = valid & ~sel
    return solutions


def prune_mask(f1: SubmapFeatures, f2: SubmapFeatures, cfg: RegistrationConfig,
               pca_attrs1=None, volume1=None, pca_attrs2=None, volume2=None,
               descriptors1=None, descriptors2=None) -> torch.Tensor:
    """clipper+prune's candidate associations (..., n, m): valid pairs whose
    descriptor cosine is >= cos_min and whose shape attributes' min/max
    ratios are all >= epsilon_shape."""
    assoc = f1.valid[..., :, None] & f2.valid[..., None, :]
    if descriptors1 is not None and descriptors2 is not None:
        cos = torch.einsum("...nd,...md->...nm", descriptors1, descriptors2)
        assoc = assoc & (cos >= cfg.cos_min)
    if volume1 is not None and pca_attrs1 is not None:
        sa1 = torch.cat([volume1[..., None], pca_attrs1], dim=-1)
        sa2 = torch.cat([volume2[..., None], pca_attrs2], dim=-1)
        a = torch.abs(sa1[..., :, None, :])
        b = torch.abs(sa2[..., None, :, :])
        rho = torch.minimum(a, b) / torch.clamp(torch.maximum(a, b), min=1e-9)
        assoc = assoc & torch.all(rho >= cfg.epsilon_shape, dim=-1)
    return assoc


def gravity_check(res: RegistrationResult, cfg: RegistrationConfig) -> RegistrationResult:
    """res with ok False where the result's roll or pitch exceeds
    roll_pitch_thresh (the reference's GravityConstraintError)."""
    rpy = T_to_xyzrpy(res.T_align)[..., 3:]
    grav_ok = ((torch.abs(rpy[..., 0]) < cfg.roll_pitch_thresh)
               & (torch.abs(rpy[..., 1]) < cfg.roll_pitch_thresh))
    return dataclasses.replace(res, ok=res.ok & grav_ok)


def register_clipper_prune(f1: SubmapFeatures, f2: SubmapFeatures,
                           cfg: RegistrationConfig,
                           pca_attrs1=None, volume1=None,
                           pca_attrs2=None, volume2=None,
                           descriptors1=None, descriptors2=None) -> RegistrationResult:
    """clipper+prune baseline (dist_reg_with_pruning.py): Euclidean-distance
    CLIPPER over the candidates of prune_mask, then gravity_check."""
    assoc = prune_mask(f1, f2, cfg, pca_attrs1, volume1, pca_attrs2, volume2,
                       descriptors1, descriptors2)
    return gravity_check(register_clipper(f1, f2, cfg, assoc_mask=assoc), cfg)


RANSAC_CHUNK = 128  # hypotheses scored at once (roman_tpu registration.py:445)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last dim as sqrt(sum(x * x)), the
    expression of jnp.linalg.norm (torch.linalg.norm over a dim of 3 is
    about 100 times slower on the CPU at RANSAC's shapes)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def ransac_draws(seed: int, n_pairs: int, n_hypotheses: int) -> torch.Tensor:
    """(n_pairs, n_hypotheses, 3) uniform [0, 1) draws on the host from a
    torch.Generator seeded by `seed`, row k for the k-th pair of a list.
    register_ransac maps each draw onto a pair's valid candidates, so one
    seed gives the same triplets on any device and at any chunk size."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n_pairs, n_hypotheses, 3), generator=g)


def register_ransac(f1: SubmapFeatures, f2: SubmapFeatures, cfg: RegistrationConfig,
                    draws: torch.Tensor, max_corr_dist: float = 0.5,
                    edge_len: float = 0.95) -> RegistrationResult:
    """RANSAC baseline over object centers with an edge-length check
    (ransac_reg.py:43-51, o3d registration_ransac_based_on_correspondence
    semantics), batched: cfg.ransac_iter hypothesis triplets per pair.

    draws (..., S, 3) in [0, 1) (``ransac_draws``, S = cfg.ransac_iter)
    pick each triplet uniformly, with replacement, among the pair's valid
    candidate associations; a pair with none draws among all n*m, and the
    edge check and the valid mask then reject it (roman_tpu draws with
    jax.random.categorical over logits 0 / -1e9 instead, so the two
    packages agree on outcomes, not on triplets). Hypotheses are scored in
    chunks of RANSAC_CHUNK; the first maximum of the inlier count wins.
    """
    batch = f1.centers.shape[:-2]
    n, m = f1.capacity, f2.capacity
    N = n * m
    S = cfg.ransac_iter
    dev = f1.centers.device
    if tuple(draws.shape) != tuple(batch) + (S, 3):
        raise ValueError(f"draws has shape {tuple(draws.shape)}, expected "
                         f"{tuple(batch) + (S, 3)}")

    valid_pairs = f1.valid[..., :, None] & f2.valid[..., None, :]
    vflat = valid_pairs.reshape(batch + (N,))
    n_valid = vflat.sum(-1)
    n_eff = torch.where(n_valid > 0, n_valid, N)[..., None]  # (..., 1)
    # valid candidates first, in index order: the k-th valid one is order[k]
    order = torch.argsort((~vflat).to(torch.uint8), dim=-1, stable=True)
    u = draws.to(dev).reshape(batch + (S * 3,))
    k = torch.minimum((u * n_eff.to(u.dtype)).long(), n_eff - 1)
    cand = torch.gather(order, -1, k).reshape(batch + (S, 3))
    a, b = cand // m, cand % m

    def gather_pts(centers, idx):  # (..., k, 3), (..., S, 3) -> (..., S, 3, 3)
        flat = idx.reshape(batch + (S * 3, 1)).expand(batch + (S * 3, 3))
        return torch.gather(centers, -2, flat).reshape(batch + (S, 3, 3))

    c1 = gather_pts(f1.centers, a)
    c2 = gather_pts(f2.centers, b)

    def edges(c):  # corresponding triangle edges must have similar length
        return torch.stack([_norm(c[..., 0, :] - c[..., 1, :]),
                            _norm(c[..., 1, :] - c[..., 2, :]),
                            _norm(c[..., 0, :] - c[..., 2, :])], dim=-1)

    e1, e2 = edges(c1), edges(c2)
    edge_ok = torch.all(torch.minimum(e1, e2) > edge_len * torch.maximum(e1, e2),
                        dim=-1)  # (..., S)
    T_h = arun(c1, c2)  # (..., S, 4, 4) aligns c2 -> c1

    # score in chunks to bound the (..., chunk, n, m) tensor
    best_cnts, best_Ts = [], []
    for s0 in range(0, S, RANSAC_CHUNK):
        T_c = T_h[..., s0:s0 + RANSAC_CHUNK, :, :]
        ok_c = edge_ok[..., s0:s0 + RANSAC_CHUNK]
        p2t = (torch.einsum("...sij,...mj->...smi", T_c[..., :3, :3], f2.centers)
               + T_c[..., None, :3, 3])
        d = _norm(f1.centers[..., None, :, None, :] - p2t[..., None, :, :])
        inl = (d < max_corr_dist) & valid_pairs[..., None, :, :]
        cnt = inl.sum(dim=(-2, -1)) * ok_c  # (..., chunk)
        loc = torch.argmax(cnt, dim=-1)
        best_cnts.append(torch.take_along_dim(cnt, loc[..., None], dim=-1)[..., 0])
        best_Ts.append(torch.take_along_dim(
            T_c, loc[..., None, None, None], dim=-3)[..., 0, :, :])
    best_chunk = torch.argmax(torch.stack(best_cnts, dim=-1), dim=-1)
    T_best = torch.take_along_dim(torch.stack(best_Ts, dim=-3),
                                  best_chunk[..., None, None, None], dim=-3)[..., 0, :, :]

    # final inlier set under the best hypothesis
    p2t = (torch.einsum("...ij,...mj->...mi", T_best[..., :3, :3], f2.centers)
           + T_best[..., None, :3, 3])
    d_best = _norm(f1.centers[..., :, None, :] - p2t[..., None, :, :])
    sel_all = (d_best < max_corr_dist) & valid_pairs
    u_like = torch.where(sel_all, 1.0 / (1.0 + d_best), 0.0)
    steps = min(n, m)
    sel, count = clipper_mod.round_greedy(
        u_like, torch.full(batch, float(steps), device=dev),
        min(cfg.max_clique, steps))
    T = _t_align_from_selection(f1, f2, sel)
    return RegistrationResult(sel=sel, count=count, T_align=T, ok=count >= cfg.dim,
                              u=u_like, score=count.to(torch.float32))
