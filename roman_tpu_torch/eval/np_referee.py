"""The serial numpy referee: one pair at a time, dense, float64 (a host
copy of bench.py's ``_np_affinity``, ``_np_solve_pair`` and
``_arun_from_sel``, :185-279).

It stands in for the reference's per-pair C++ CLIPPER loop: the full
(N, N) ROMAN affinity of the unpadded pair (N = n * m), the penalty
homotopy with the one-to-one constraint applied as a dense matrix, the
reference's omega rounding and Arun's transform. It shares no code with
the batched engine, which is what makes it a referee.
"""

from __future__ import annotations

import numpy as np


def np_affinity(c1, r1, d1, c2, r2, d2, sigma, eps, mindist, cmin, cmax):
    """The (n*m, n*m) affinity M and the (n, m) single-association scores:
    gravity-aware distance consistency, the ratio features' geometric
    mean and the clipped descriptor cosine, fused by geometric mean."""
    n, m = len(c1), len(c2)
    D1 = np.linalg.norm(c1[:, None] - c1[None], axis=-1)
    D2 = np.linalg.norm(c2[:, None] - c2[None], axis=-1)
    dz1 = np.abs(c1[:, None, 2] - c1[None, :, 2])
    dz2 = np.abs(c2[:, None, 2] - c2[None, :, 2])
    dxy1 = np.linalg.norm(c1[:, None, :2] - c1[None, :, :2], axis=-1)
    dxy2 = np.linalg.norm(c2[:, None, :2] - c2[None, :, :2], axis=-1)
    d1b = D1[:, None, :, None]
    d2b = D2[None, :, None, :]
    slack = np.sin(0.0872665) * np.maximum(d1b, d2b)
    cz = np.maximum(np.abs(dz1[:, None, :, None] - dz2[None, :, None, :]) - slack, 0.0)
    cxy = np.abs(dxy1[:, None, :, None] - dxy2[None, :, None, :])
    c = np.sqrt(cz**2 + cxy**2)
    sd = np.exp(-0.5 * (c / sigma) ** 2) * (c < eps) * (d1b > mindist) * (d2b > mindist)
    # per-association ratio + cosine
    a = np.abs(r1[:, None, :])
    b = np.abs(r2[None, :, :])
    rho = np.minimum(a, b) / np.maximum(np.maximum(a, b), 1e-9)
    sr = np.exp(np.mean(np.log(np.maximum(rho, 1e-20)), axis=-1)) * np.all(rho > 0, -1)
    cos = d1 @ d2.T
    sc = np.clip((cos - cmin) / (cmax - cmin), 0, 1)
    single = (sr * sc) ** 0.5
    srp = np.sqrt(sr[:, :, None, None] * sr[None, None, :, :])
    scp = np.sqrt(sc[:, :, None, None] * sc[None, None, :, :])
    M = (sd * srp * scp) ** (1.0 / 3.0)
    ia = np.arange(n)
    ib = np.arange(m)
    same_a = (ia[:, None, None, None] == ia[None, None, :, None])
    same_b = (ib[None, :, None, None] == ib[None, None, None, :])
    M = np.where(same_a ^ same_b, 0.0, M)
    M = np.where(same_a & same_b, 0.0, M)
    M[ia[:, None], ib[None, :], ia[:, None], ib[None, :]] = single
    return M.reshape(n * m, n * m), single


def np_solve_pair(c1, r1, d1, c2, r2, d2, cfg):
    """One serial solve: affinity, 10 warmup power iterations, 12 penalty
    steps of 10 projected iterations each against the dense constraint,
    rounding to omega = round(u'Mu) one-to-one associations, then Arun.
    ``cfg`` gives sigma, epsilon, mindist, cos_min and cos_max.

    Returns (sel, T): a list of (a, b) index pairs, and the (4, 4)
    transform aligning side 2 to side 1, or None under 3 associations."""
    n1, n2 = len(c1), len(c2)
    M, _ = np_affinity(c1, r1, d1, c2, r2, d2, cfg.sigma, cfg.epsilon,
                       cfg.mindist, cfg.cos_min, cfg.cos_max)
    N = M.shape[0]
    u = np.ones(N) / np.sqrt(N)
    d = 0.0
    for _ in range(10):  # warmup power iterations
        u = np.maximum(M @ u + u, 0)
        u /= max(np.linalg.norm(u), 1e-12)
    # penalty homotopy (the constraint's matvec done densely, as C++ CLIPPER does)
    ia = np.repeat(np.arange(n1), n2)
    ib = np.tile(np.arange(n2), n1)
    conflict = ((ia[:, None] == ia[None, :]) ^ (ib[:, None] == ib[None, :])).astype(np.float64)
    for _ in range(12):
        for _ in range(10):
            g = M @ u - d * (conflict @ u)
            u = np.maximum(g, 0)
            nn = np.linalg.norm(u)
            u = u / nn if nn > 1e-12 else np.ones(N) / np.sqrt(N)
        Cbu = conflict @ u
        viol = (u > 1e-6) & (Cbu > 1e-6)
        if viol.any():
            d += (M @ u)[viol].sum() / max(Cbu[viol].sum(), 1e-9) + 1e-3
    # rounding + Arun
    omega = int(round(u @ (M @ u)))
    order = np.argsort(-u)[: max(omega, 0)]
    ra, rb = set(), set()
    sel = []
    for idx in order:
        a_, b_ = divmod(idx, n2)
        if a_ in ra or b_ in rb or u[idx] <= 0:
            continue
        ra.add(a_)
        rb.add(b_)
        sel.append((a_, b_))
    return sel, arun_from_sel(c1, c2, sel)


def arun_from_sel(c1, c2, sel):
    """Arun's least-squares rotation and translation taking the selected
    side-2 centers onto their side-1 partners; None under 3 pairs."""
    if len(sel) < 3:
        return None
    p1 = c1[[a for a, _ in sel]]
    p2 = c2[[b for _, b in sel]]
    m1, m2 = p1.mean(0), p2.mean(0)
    H = (p2 - m2).T @ (p1 - m1)
    U, _, Vh = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vh))])
    R = (U @ S @ Vh).T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = m1 - R @ m2
    return T
