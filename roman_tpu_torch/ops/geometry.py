"""Masked, batched point-cloud geometry: covariance shape attributes
(Weinmann et al.), PCA oriented bounding boxes, AABBs.

Port of roman_tpu/ops/geometry.py, the counterpart of the open3d-backed
attributes of the reference's Segment (roman/object/segment.py:244-285,
:433-472), over a whole pool of padded segments at once. The covariance
products stay f32 with TF32 off (``roman_tpu_torch.device``).

A 3x3 eigendecomposition here may give eigenvectors of other signs, or
another basis of a repeated eigenvalue, than jnp.linalg.eigh; extents,
volumes and normalized eigenvalues do not depend on that choice.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def masked_mean(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., n, 3), (..., n) -> (..., 3)."""
    w = mask.to(points.dtype)[..., None]
    n = torch.clamp(w.sum(dim=-2), min=1.0)
    return (points * w).sum(dim=-2) / n


def masked_covariance(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Covariance over the valid points with a 1/n normalization (o3d
    compute_mean_and_covariance, segment.py:428-431)."""
    w = mask.to(points.dtype)
    n = torch.clamp(w.sum(dim=-1), min=1.0)
    mu = masked_mean(points, mask)
    c = (points - mu[..., None, :]) * w[..., None]
    return torch.einsum("...ni,...nj->...ij", c, c) / n[..., None, None]


def normalized_eigenvalues(cov: torch.Tensor) -> torch.Tensor:
    """Descending eigenvalues of (..., 3, 3) covariances, clipped at 0 and
    normalized to sum 1 (segment.py:433-443)."""
    evals = torch.linalg.eigvalsh(cov)
    evals = torch.clamp(torch.flip(evals, dims=(-1,)), min=0.0)
    return evals / torch.clamp(evals.sum(dim=-1, keepdim=True), min=_EPS)


def shape_attributes_from_eigenvalues(e: torch.Tensor) -> torch.Tensor:
    e1 = torch.clamp(e[..., 0], min=_EPS)
    return torch.stack([(e[..., 0] - e[..., 1]) / e1,
                        (e[..., 1] - e[..., 2]) / e1,
                        e[..., 2] / e1], dim=-1)


def shape_attributes(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., n, 3), (..., n) -> (..., 3) [linearity, planarity, scattering]
    (Weinmann et al. ISPRS 2014, segment.py:446-472)."""
    return shape_attributes_from_eigenvalues(
        normalized_eigenvalues(masked_covariance(points, mask)))


def pca_obb(points: torch.Tensor, mask: torch.Tensor):
    """PCA oriented bounding box over the valid points: center (..., 3),
    axes (..., 3, 3) (rows are principal directions, eigenvalues
    descending), extent (..., 3) (0 where a row has no valid point)."""
    cov = masked_covariance(points, mask)
    _, vecs = torch.linalg.eigh(cov)                  # ascending; columns
    axes = torch.flip(vecs, dims=(-1,)).transpose(-1, -2)
    mu = masked_mean(points, mask)
    proj = torch.einsum("...ij,...nj->...ni", axes, points - mu[..., None, :])
    big = 1e9
    maskf = mask[..., None]
    lo = torch.where(maskf, proj, torch.full_like(proj, big)).min(dim=-2).values
    hi = torch.where(maskf, proj, torch.full_like(proj, -big)).max(dim=-2).values
    nvalid = mask.sum(dim=-1)
    extent = torch.where((nvalid > 0)[..., None], hi - lo, torch.zeros_like(hi))
    center = mu + torch.einsum("...ji,...j->...i", axes, (hi + lo) * 0.5)
    return center, axes, extent


def obb_volume_extent(points: torch.Tensor, mask: torch.Tensor, min_points: int = 5):
    """Volume and extent with the reference's small-cloud guard: both 0
    unless the row has min_points valid points (segment.py:252-263)."""
    _, _, extent = pca_obb(points, mask)
    ok = mask.sum(dim=-1) >= min_points
    extent = torch.where(ok[..., None], extent, torch.zeros_like(extent))
    return extent.prod(dim=-1), extent


def aabb(points: torch.Tensor, mask: torch.Tensor):
    big = 1e9
    maskf = mask[..., None]
    lo = torch.where(maskf, points, torch.full_like(points, big)).min(dim=-2).values
    hi = torch.where(maskf, points, torch.full_like(points, -big)).max(dim=-2).values
    return lo, hi


def aabb_intersects(lo1, hi1, lo2, hi2) -> torch.Tensor:
    """Batched AABB overlap test (reference roman/utils.py:160-169)."""
    return ((lo1 <= hi2) & (hi1 >= lo2)).all(dim=-1)


def convex_hull_2d(points) -> np.ndarray:
    """2D convex hull (Andrew's monotone chain), host-side numpy, CCW
    vertices (k, 2); the reference uses shapely (segment.py:406-418)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points_iter):
        out = []
        for p in points_iter:
            while len(out) >= 2 and cross(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])
