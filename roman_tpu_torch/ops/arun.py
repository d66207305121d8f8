"""Batched, masked, weighted Arun point-set alignment in float32.

Port of roman_tpu/ops/arun.py (reference
roman/align/object_registration.py:88-129): given matched 3D centers,
recover the SE(3) T aligning set 2 to set 1 by SVD with the reflection
fix, over any batch of pairs at once. The cores stay float32 with TF32
off (``roman_tpu_torch.device``): bf16 rounding in these tiny products
moved the demo's ATE by 0.22 m on the TPU (README "f32 geometric cores").
"""

from __future__ import annotations

import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.ops.se3 import make_T

_EPS = 1e-9


def arun(pts1: torch.Tensor, pts2: torch.Tensor,
         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted alignment of pts2 onto pts1.

    pts1, pts2: (..., n, 3); weights: (..., n) nonnegative, rows with
    weight 0 are ignored (how padded correspondences are masked out).
    Returns T (..., 4, 4) with pts1 ~= T @ pts2.

    H = (p1-m1)^T diag(w) (p2-m2), svd(H) = U S Vh, R = U Vh with the last
    row of Vh negated where det < 0 (roman_tpu/ops/arun.py:44-63);
    t = m1 - R m2.
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype,
                             device=pts1.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2), min=_EPS)
    m1 = torch.sum(pts1 * w, dim=-2) / wsum
    m2 = torch.sum(pts2 * w, dim=-2) / wsum
    c1 = pts1 - m1[..., None, :]
    c2 = pts2 - m2[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", c1, c2 * w)
    # on the card the SVD waits twice: to see whether its Jacobi solver
    # converged everywhere, and to check its result
    tracing.count_sync(H.device, 2)
    U, _, Vh = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vh)
    one = torch.ones_like(det)
    flip = torch.stack([one, one, torch.sign(det)], dim=-1)
    R = torch.einsum("...ik,...k,...kj->...ij", U, flip, Vh)
    t = m1 - torch.einsum("...ij,...j->...i", R, m2)
    return make_T(R, t)


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor,
                      with_scale: bool = False):
    """Umeyama alignment of trajectories for ATE evaluation (roman_tpu/
    ops/arun.py:67-95; reference roman/offline_rpgo/evaluate.py:10-53).

    src, dst: (n, 3). Returns (R, t, s) with dst ~= s R src + t.
    """
    n = src.shape[0]
    mu_src = torch.mean(src, dim=0)
    mu_dst = torch.mean(dst, dim=0)
    src_c = src - mu_src
    dst_c = dst - mu_dst
    cov = (dst_c.T @ src_c) / n
    U, D, Vh = torch.linalg.svd(cov)
    S = torch.ones(3, dtype=src.dtype, device=src.device)
    S[2] = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vh))
    R = (U * S[None, :]) @ Vh
    if with_scale:
        var_src = torch.mean(torch.sum(src_c**2, dim=1))
        s = torch.sum(D * S) / torch.clamp(var_src, min=_EPS)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_dst - s * (R @ mu_src)
    return R, t, s
