"""Similarity metrics between object point clouds and Gaussians, batched.

Port of roman_tpu/ops/metrics.py (reference
roman/object/similiarity_metrics.py): the min-directional Chamfer
distance, the AABB-diagonal normalized Chamfer similarity, the
2-Wasserstein-style metric between Gaussians and the cosine similarity.
Norms are sqrt(sum(x * x)).
"""

from __future__ import annotations

import torch

_BIG = 1e9


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1))


def chamfer_distance(points1, mask1, points2, mask2) -> torch.Tensor:
    """Min over the two directions of the mean nearest-neighbor distance
    over padded point sets; _BIG when either cloud is empty (the reference
    returns inf, similiarity_metrics.py:63-64)."""
    d = torch.sqrt(torch.clamp(
        ((points1[..., :, None, :] - points2[..., None, :, :]) ** 2).sum(dim=-1),
        min=0.0))
    pair_ok = mask1[..., :, None] & mask2[..., None, :]
    d = torch.where(pair_ok, d, torch.full_like(d, _BIG))
    n1 = torch.clamp(mask1.sum(dim=-1), min=1)
    n2 = torch.clamp(mask2.sum(dim=-1), min=1)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    d12 = torch.where(mask1, d.min(dim=-1).values, zero).sum(dim=-1) / n1
    d21 = torch.where(mask2, d.min(dim=-2).values, zero).sum(dim=-1) / n2
    dist = torch.minimum(d12, d21)
    empty = (mask1.sum(dim=-1) == 0) | (mask2.sum(dim=-1) == 0)
    return torch.where(empty, torch.full_like(dist, _BIG), dist)


def norm_chamfer_similarity(points1, mask1, points2, mask2) -> torch.Tensor:
    """1 - chamfer / joint-AABB diagonal (similiarity_metrics.py:67-88);
    -_BIG when exactly one cloud is empty, 1.0 when both are."""
    cd = chamfer_distance(points1, mask1, points2, mask2)

    def ext(points, mask, fill, fn):
        return fn(torch.where(mask[..., None], points, torch.full_like(points, fill)),
                  dim=-2).values

    lo = torch.minimum(ext(points1, mask1, _BIG, torch.min),
                       ext(points2, mask2, _BIG, torch.min))
    hi = torch.maximum(ext(points1, mask1, -_BIG, torch.max),
                       ext(points2, mask2, -_BIG, torch.max))
    diag = _norm(hi - lo)
    sim = torch.where(diag > 0, 1.0 - cd / torch.clamp(diag, min=1e-12),
                      torch.ones_like(cd))
    e1 = mask1.sum(dim=-1) == 0
    e2 = mask2.sum(dim=-1) == 0
    sim = torch.where(e1 ^ e2, torch.full_like(sim, -_BIG), sim)
    return torch.where(e1 & e2, torch.ones_like(sim), sim)


def _psd_sqrt(A: torch.Tensor) -> torch.Tensor:
    evals, evecs = torch.linalg.eigh(A)
    evals = torch.clamp(evals, min=0.0)
    return torch.einsum("...ik,...k,...jk->...ij", evecs, torch.sqrt(evals), evecs)


def wasserstein_metric(mu1, sigma1, mu2, sigma2) -> torch.Tensor:
    """||mu1 - mu2|| + tr(S1 + S2 - 2 (S2^1/2 S1 S2^1/2)^1/2), the
    reference's formula (similiarity_metrics.py:31-44)."""
    s2r = _psd_sqrt(sigma2)
    cross = _psd_sqrt(torch.einsum("...ij,...jk,...kl->...il", s2r, sigma1, s2r))
    tr = torch.diagonal(sigma1 + sigma2 - 2.0 * cross, dim1=-2, dim2=-1).sum(dim=-1)
    return _norm(mu1 - mu2) + tr


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Cosine similarity along the last axis; 0 when either norm is ~0
    (the Submap.similarity guard, map.py:149-153)."""
    na = _norm(a)
    nb = _norm(b)
    dot = (a * b).sum(dim=-1)
    prod = na * nb
    return torch.where(prod > eps, dot / torch.clamp(prod, min=eps),
                       torch.zeros_like(dot))
