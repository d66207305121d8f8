"""Batched, masked, weighted Arun point-set alignment in float32.

Port of roman_tpu/ops/arun.py (reference
roman/align/object_registration.py:88-129): given matched 3D centers,
recover the SE(3) T aligning set 2 to set 1 by SVD with the reflection
fix, over any batch of pairs at once. The cores stay float32 with TF32
off (``roman_tpu_torch.device``): bf16 rounding in these tiny products
moved the demo's ATE by 0.22 m on the TPU (README "f32 geometric cores").

``arun_align`` aligns each pair's selected center correspondences, the
registration's T_align: for CUDA tensors one launch of the
``csrc/arun_align.cu`` kernel, which waits for nothing and copies nothing
to or from the host; for CPU tensors its plain twin, ``arun`` over the
expanded centers.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.kernels import build
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


def arun_align_plain(centers1: torch.Tensor, centers2: torch.Tensor,
                     sel: torch.Tensor) -> torch.Tensor:
    """Plain twin of the arun_align kernel: arun over every association
    (a, b) of centers1 (..., n, 3) and centers2 (..., m, 3), weighted by
    sel (..., n, m). Returns T (..., 4, 4) aligning centers2 onto
    centers1."""
    n, m = sel.shape[-2], sel.shape[-1]
    batch = sel.shape[:-2]
    pts1 = centers1[..., :, None, :].expand(batch + (n, m, 3)).reshape(batch + (n * m, 3))
    pts2 = centers2[..., None, :, :].expand(batch + (n, m, 3)).reshape(batch + (n * m, 3))
    w = sel.reshape(batch + (n * m,)).to(pts1.dtype)
    return arun(pts1, pts2, w)


def arun_align(centers1: torch.Tensor, centers2: torch.Tensor,
               sel: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) aligning each pair's selected centers of map 2 onto
    map 1's: the arun_align kernel for CUDA tensors (float32 centers), the
    plain twin for CPU tensors (see arun_align_plain). The kernel
    launches on the current stream and waits for nothing; while a profiler
    records, it adds its pairs to counter "registration.arun_pairs"."""
    if sel.device.type == "cpu":
        return arun_align_plain(centers1, centers2, sel)
    n, m = sel.shape[-2], sel.shape[-1]
    batch = sel.shape[:-2]
    P = math.prod(batch)
    dev = sel.device
    c1 = centers1.expand(batch + (n, 3)).reshape(P, n, 3).contiguous()
    c2 = centers2.expand(batch + (m, 3)).reshape(P, m, 3).contiguous()
    flags = sel.reshape(P, n, m).to(torch.bool).contiguous()
    build.check_tensor("centers1", c1, (P, n, 3), torch.float32, dev)
    build.check_tensor("centers2", c2, (P, m, 3), torch.float32, dev)
    T = torch.empty((P, 4, 4), dtype=torch.float32, device=dev)
    if P == 0:
        return T.reshape(batch + (4, 4))
    fn = build.function("arun_align", "arun_align_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(flags.data_ptr(), c1.data_ptr(), c2.data_ptr(), T.data_ptr(), P, n, m,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("arun_align", err)
    arun_align.launches += 1
    tracing.count("registration.arun_pairs", P)
    return T.reshape(batch + (4, 4))


arun_align.launches = 0
