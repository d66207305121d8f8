"""The align cells' plain reference: ROMAN registration of a batch of
submap pairs in float64, written from the method's description.

One pair of object sets (n and m objects, padded to a common capacity and
masked by `valid`) is registered as ROMAN does it (arXiv 2410.08262, and
CLIPPER, arXiv 2011.10202 and 2402.07284):

1. the affinity M over the N = n*m candidate associations i = (a, b):
   M[i, j] = (s_d * sqrt(s_r[i] s_r[j]) * sqrt(s_c[i] s_c[j]))^(1/3) for
   two associations that share no object, where s_d is the gravity-aware
   distance consistency exp(-c^2 / (2 sigma^2)) gated at c < epsilon and
   by both distances > mindist, s_r the geometric mean of the shape
   features' min/max ratios and s_c the descriptor cosine clipped from
   [cos_min, cos_max] to [0, 1]; the diagonal holds sqrt(s_r s_c); pairs
   that share an object hold 0;
2. CLIPPER's projected power iteration on M - d C (C the one-to-one
   conflicts) from u = 1, with the penalty d raised after each round of
   inner steps by sum(Mu) / sum(Cu) over the violated entries (+1e-3),
   at the solve budget (warm-up, rounds, steps a round); a pair whose
   last u still violates a conflict is solved again from the start at
   the rescue budget when `rescue` is set;
3. greedy one-to-one rounding in decreasing u, above 0.35 max(u), at most
   round(2F) associations (F = u'(M - dC)u), then six rounds of trimming
   the selection to a consistent set (support below max(0.5 * mean
   support, 0.22) goes; while the selection is larger than round(u'Mu),
   the weakest association with an affinity <= 1e-4 to another selected
   one goes);
4. Arun's least-squares transform of the selected centers.

Everything is float64 unless `m_dtype` asks the affinity to be rounded
to a narrower type (and `dtype` the rest to be computed in one), which is
how the control is made. Plain torch on any device; it imports nothing
of the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Params:
    sigma: float = 0.4
    epsilon: float = 0.6
    mindist: float = 0.2
    cos_min: float = 0.5
    cos_max: float = 0.7
    gravity_unc_ang_rad: float = 0.0872665
    max_clique: int = 64
    budget: tuple = (8, 6, 6)
    rescue_budget: tuple = (16, 16, 12)
    active_eps: float = 1e-6
    rel_thresh: float = 0.35
    refine_iters: int = 6
    min_support: float = 0.22
    rel_support: float = 0.5
    edge_eps: float = 1e-4

    @classmethod
    def from_config(cls, config: dict) -> "Params":
        d = config["defaults"]
        return cls(sigma=d["sigma"], epsilon=d["epsilon"], mindist=d["mindist"],
                   cos_min=config["cosine_min"], cos_max=config["cosine_max"],
                   gravity_unc_ang_rad=d["gravity_unc_ang_rad"],
                   max_clique=d["max_clique"])


def _pairwise(c):
    """Per-side distance tables of centers c (B, n, 3): full, vertical and
    horizontal, each (B, n, n)."""
    diff = c[:, :, None, :] - c[:, None, :, :]
    return (torch.linalg.vector_norm(diff, dim=-1), diff[..., 2].abs(),
            torch.linalg.vector_norm(diff[..., :2], dim=-1))


def association_scores(r1, d1, r2, d2, p: Params):
    """Shape-ratio and cosine scores of every association, (B, n, m) each."""
    a, b = r1.abs()[:, :, None, :], r2.abs()[:, None, :, :]
    rho = torch.minimum(a, b) / torch.clamp(torch.maximum(a, b), min=1e-9)
    s_r = torch.where((rho > 0).all(-1),
                      torch.exp(torch.log(torch.clamp(rho, min=1e-300)).mean(-1)), 0.0)
    n1 = torch.linalg.vector_norm(d1, dim=-1)[:, :, None]
    n2 = torch.linalg.vector_norm(d2, dim=-1)[:, None, :]
    cos = torch.bmm(d1, d2.transpose(1, 2)) / torch.clamp(n1 * n2, min=1e-12)
    s_c = torch.clamp((cos - p.cos_min) / (p.cos_max - p.cos_min), 0.0, 1.0)
    s_c = torch.where((n1 < 1e-9) | (n2 < 1e-9), 1.0, s_c)
    return s_r, s_c


def affinity(c1, r1, d1, v1, c2, r2, d2, v2, p: Params):
    """M (B, N, N) over associations i = a * m + b, and the number of its
    nonzero entries off the diagonal a pair (B,)."""
    B, n, m = c1.shape[0], c1.shape[1], c2.shape[1]
    s_r, s_c = association_scores(r1, d1, r2, d2, p)
    single = torch.sqrt(s_r * s_c)                                # (B, n, m)
    D1, z1, h1 = _pairwise(c1)
    D2, z2, h2 = _pairwise(c2)
    # index [a1, b1, a2, b2]
    D1, z1, h1 = (x[:, :, None, :, None] for x in (D1, z1, h1))
    D2, z2, h2 = (x[:, None, :, None, :] for x in (D2, z2, h2))
    slack = math.sin(p.gravity_unc_ang_rad) * torch.maximum(D1, D2)
    cz = torch.clamp((z1 - z2).abs() - slack, min=0.0)
    c = torch.sqrt(cz * cz + (h1 - h2) ** 2)
    s_d = torch.exp(-0.5 * (c / p.sigma) ** 2)
    s_d = torch.where((c < p.epsilon) & (D1 > p.mindist) & (D2 > p.mindist), s_d, 0.0)
    s_rp = torch.sqrt(s_r[:, :, :, None, None] * s_r[:, None, None, :, :])
    s_cp = torch.sqrt(s_c[:, :, :, None, None] * s_c[:, None, None, :, :])
    M = (s_d * s_rp * s_cp) ** (1.0 / 3.0)
    ea = torch.eye(n, dtype=torch.bool, device=c1.device)[:, None, :, None]
    eb = torch.eye(m, dtype=torch.bool, device=c1.device)[None, :, None, :]
    vv = v1[:, :, None] & v2[:, None, :]                           # (B, n, m)
    live = vv[:, :, :, None, None] & vv[:, None, None, :, :]
    M = torch.where(ea | eb | ~live, 0.0, M)
    offdiag = torch.count_nonzero(M.reshape(B, -1), dim=-1)
    M = M + torch.where(ea & eb & live, single[:, :, :, None, None], 0.0)
    return M.reshape(B, n * m, n * m), offdiag


def _conflict_matvec(U, n, m):
    """(C u) for the one-to-one conflicts: the rest of u's row and column."""
    Um = U.reshape(U.shape[0], n, m)
    return (Um.sum(-1, keepdim=True) + Um.sum(-2, keepdim=True) - 2.0 * Um).reshape(U.shape)


def _normalize(U):
    return U / torch.clamp(torch.linalg.vector_norm(U, dim=-1, keepdim=True), min=1e-9)


def solve(M, valid, n, m, budget, active_eps):
    """CLIPPER's homotopy on M (B, N, N), valid (B, N) float. Returns u,
    F = u'(M - dC)u, omega = u'Mu and whether u violates no conflict."""
    warm, rounds, steps = budget
    mv = lambda U: torch.bmm(M, U[:, :, None])[:, :, 0]  # noqa: E731
    U = _normalize(valid + 1e-3)
    for _ in range(warm):
        U = _normalize((mv(U) + U) * valid)
    d = torch.zeros((U.shape[0], 1), dtype=U.dtype, device=U.device)
    for _ in range(rounds):
        for _ in range(steps):
            G = torch.clamp(mv(U) - d * _conflict_matvec(U, n, m), min=0.0) * valid
            nrm = torch.linalg.vector_norm(G, dim=-1, keepdim=True)
            U = torch.where(nrm > 1e-9, G / torch.clamp(nrm, min=1e-9), U).to(M.dtype)
        Mu, Cu = mv(U), _conflict_matvec(U, n, m)
        viol = (U > active_eps) & (Cu > active_eps)
        num = torch.where(viol, Mu, 0.0).sum(-1, keepdim=True)
        den = torch.where(viol, Cu, 0.0).sum(-1, keepdim=True)
        d = d + torch.where(den > 1e-9, num / torch.clamp(den, min=1e-9), 0.0)
        d = (d + torch.where(viol.any(-1, keepdim=True), 1e-3, 0.0)).to(M.dtype)
    Mu, Cu = mv(U), _conflict_matvec(U, n, m)
    F = (U * (Mu - d * Cu)).sum(-1)
    omega = (U * Mu).sum(-1)
    converged = ~((U > active_eps) & (Cu > active_eps)).any(-1)
    return U, F, omega, converged


def round_greedy(U, F, n, m, max_steps, rel_thresh):
    """One-to-one selection (B, N) bool in decreasing u (first index wins a
    tie), above rel_thresh * max(u), at most round(2F) clipped to
    [1, max_steps] entries (max_steps where F <= 0); max_steps (B,)."""
    B, N = U.shape
    cap = torch.where(F > 0, torch.minimum(torch.clamp(torch.round(2.0 * F), min=1.0),
                                           max_steps.to(F.dtype)), max_steps.to(F.dtype))
    cut = rel_thresh * U.amax(-1)
    order = torch.argsort(-U, dim=-1, stable=True).cpu().numpy()
    Uh, cut, cap = (x.double().cpu().numpy() for x in (U, cut, cap))
    sel = torch.zeros((B, N), dtype=torch.bool)
    for k in range(B):
        rows, cols, taken = set(), set(), 0
        for i in order[k].tolist():
            if taken >= cap[k] or not (Uh[k, i] > cut[k] and Uh[k, i] > 0):
                break
            a, b = divmod(i, m)
            if a in rows or b in cols:
                continue
            rows.add(a)
            cols.add(b)
            sel[k, i] = True
            taken += 1
    return sel.to(U.device)


def refine(M, sel, omega, p: Params):
    """Trim each selection (B, N) bool to a consistent set (see the module
    docstring, step 3)."""
    B, N = sel.shape
    v = sel.to(M.dtype)
    Z = (M <= p.edge_eps) & ~torch.eye(N, dtype=torch.bool, device=M.device)
    target = torch.clamp(torch.round(omega), min=0.0)[:, None]
    idx = torch.arange(N, device=M.device)
    for _ in range(p.refine_iters):
        k = v.sum(-1, keepdim=True)
        supp = torch.bmm(v[:, None, :], M)[:, 0] / torch.clamp(k - 1.0, min=1.0)
        mean = (supp * v).sum(-1, keepdim=True) / torch.clamp(k, min=1.0)
        keep = supp >= torch.clamp(p.rel_support * mean, min=p.min_support)
        zc = torch.bmm(v[:, None, :], Z.to(M.dtype))[:, 0]
        viol = (v > 0.5) & (zc > 0.5)
        worst = torch.argmin(torch.where(viol, supp, torch.inf), dim=-1, keepdim=True)
        drop = (idx[None, :] == worst) & viol.any(-1, keepdim=True) & (k > target)
        v = v * keep * (~drop)
    return v > 0.5


def arun(c1, c2, sel, n, m):
    """T (B, 4, 4) taking the selected side-2 centers onto their side-1
    partners by least squares (identity rotation where fewer than 3)."""
    B = sel.shape[0]
    w = sel.reshape(B, n, m).to(c1.dtype)
    wa, wb = w.sum(-1), w.sum(-2)                           # (B, n), (B, m)
    k = torch.clamp(w.sum((-2, -1)), min=1e-12)[:, None]
    m1 = (wa[:, :, None] * c1).sum(1) / k
    m2 = (wb[:, :, None] * c2).sum(1) / k
    x1, x2 = c1 - m1[:, None], c2 - m2[:, None]
    H = torch.einsum("bnm,bni,bmj->bij", w, x1, x2)
    # a narrower type than float32 is decomposed in float32 and rounded back
    wide = H.dtype if H.dtype in (torch.float32, torch.float64) else torch.float32
    U, _, Vh = (x.to(H.dtype) for x in torch.linalg.svd(H.to(wide)))
    s = torch.sign(torch.linalg.det((U @ Vh).to(wide))).to(H.dtype)
    S = torch.diag_embed(torch.stack([torch.ones_like(s), torch.ones_like(s), s], -1))
    R = U @ S @ Vh
    T = torch.eye(4, dtype=c1.dtype, device=c1.device).repeat(B, 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = m1 - (R @ m2[:, :, None])[:, :, 0]
    return T


def register(c1, r1, d1, v1, c2, r2, d2, v2, p: Params, rescue: bool,
             max_steps=None, dtype=torch.float64, m_dtype=None):
    """Register a batch of pairs: every input (B, side, .) on one device,
    v* bool. max_steps (B,) caps the rounding (default min(max_clique,
    capacity)). Returns a dict of sel (B, n, m) bool, count (B,), T
    (B, 4, 4), F (B,), converged (B,), rescued (B,) and live (B,), the
    nonzero entries of M off its diagonal."""
    c1, r1, d1, c2, r2, d2 = (x.to(dtype) for x in (c1, r1, d1, c2, r2, d2))
    B, n, m = c1.shape[0], c1.shape[1], c2.shape[1]
    M, live = affinity(c1, r1, d1, v1, c2, r2, d2, v2, p)
    if m_dtype is not None:
        M = M.to(m_dtype).to(dtype)
    valid = (v1[:, :, None] & v2[:, None, :]).reshape(B, n * m).to(dtype)
    U, F, omega, conv = solve(M, valid, n, m, p.budget, p.active_eps)
    rescued = ~conv
    if rescue and rescued.any():
        bad = torch.nonzero(rescued)[:, 0]
        U2, F2, om2, conv2 = solve(M[bad], valid[bad], n, m, p.rescue_budget,
                                   p.active_eps)
        U, F, omega, conv = U.clone(), F.clone(), omega.clone(), conv.clone()
        U[bad], F[bad], omega[bad], conv[bad] = U2, F2, om2, conv2
    if max_steps is None:
        max_steps = torch.full((B,), min(p.max_clique, n, m), device=c1.device)
    sel = round_greedy(U, F, n, m, max_steps, p.rel_thresh)
    sel = refine(M, sel, omega, p)
    T = arun(c1, c2, sel, n, m)
    return dict(sel=sel.reshape(B, n, m), count=sel.sum(-1), T=T, F=F,
                converged=conv, rescued=rescued & rescue, live=live)
