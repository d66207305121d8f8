"""The plain reference of the no-semantics deployment: ROMAN registration
of a batch of submap pairs in float64 with the method `roman_no_semantics`
(gravity, volume and PCA shape ratios; no descriptor term), written from
the method's description.

It is clipper_f64 (see there) with another affinity. ROMAN's
geometric-mean fusion (arXiv 2410.08262) takes the root of the product of
the terms the method enables, here two: for associations i = (a, b) and
j that share no object,

    M[i, j] = (s_d * sqrt(s_r[i] s_r[j]))^(1/2),

with s_d the gravity-aware distance consistency exactly as clipper_f64
has it and s_r the geometric mean of the shape features' min/max ratios;
the diagonal holds s_r; pairs that share an object, and every entry of an
invalid association, hold 0. The solve, the rounding, the refinement and
Arun's transform are clipper_f64's own functions.

Departures from the published method, as in clipper_f64: the shape
ratios are gated at epsilon_shape 0 (the configuration's), so they gate
nothing; the rounding and refinement are the program's documented rules
(clipper_f64, step 3), not upstream CLIPPER's; no submap-descriptor gate
(the deployment has no frame descriptors, so every pair is registered).

Everything is float64 unless `m_dtype` asks the affinity to be rounded to
a narrower type (and `dtype` the rest to be computed in one): the control.
Plain torch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import clipper_f64
from benchmark.reference.clipper_f64 import Params, arun, refine, round_greedy, solve


def affinity(c1, r1, v1, c2, r2, v2, p: Params):
    """M (B, N, N) over associations i = a * m + b, and the number of its
    nonzero entries off the diagonal a pair (B,)."""
    B, n, m = c1.shape[0], c1.shape[1], c2.shape[1]
    # clipper_f64's shape score; its cosine score, of no descriptors, is unused
    s_r, _ = clipper_f64.association_scores(r1, r1[..., :0], r2, r2[..., :0], p)
    D1, z1, h1 = clipper_f64._pairwise(c1)
    D2, z2, h2 = clipper_f64._pairwise(c2)
    # index [a1, b1, a2, b2]
    D1, z1, h1 = (x[:, :, None, :, None] for x in (D1, z1, h1))
    D2, z2, h2 = (x[:, None, :, None, :] for x in (D2, z2, h2))
    slack = math.sin(p.gravity_unc_ang_rad) * torch.maximum(D1, D2)
    cz = torch.clamp((z1 - z2).abs() - slack, min=0.0)
    c = torch.sqrt(cz * cz + (h1 - h2) ** 2)
    s_d = torch.exp(-0.5 * (c / p.sigma) ** 2)
    s_d = torch.where((c < p.epsilon) & (D1 > p.mindist) & (D2 > p.mindist), s_d, 0.0)
    s_rp = torch.sqrt(s_r[:, :, :, None, None] * s_r[:, None, None, :, :])
    M = torch.sqrt(s_d * s_rp)
    ea = torch.eye(n, dtype=torch.bool, device=c1.device)[:, None, :, None]
    eb = torch.eye(m, dtype=torch.bool, device=c1.device)[None, :, None, :]
    vv = v1[:, :, None] & v2[:, None, :]                           # (B, n, m)
    live = vv[:, :, :, None, None] & vv[:, None, None, :, :]
    M = torch.where(ea | eb | ~live, 0.0, M)
    offdiag = torch.count_nonzero(M.reshape(B, -1), dim=-1)
    M = M + torch.where(ea & eb & live, s_r[:, :, :, None, None], 0.0)
    return M.reshape(B, n * m, n * m), offdiag


def register(c1, r1, v1, c2, r2, v2, p: Params, rescue: bool, max_steps=None,
             dtype=torch.float64, m_dtype=None):
    """Register a batch of pairs, as clipper_f64.register does but with
    this module's affinity and no descriptors: every input (B, side, .) on
    one device, v* bool. Returns the same dict (sel, count, T, F,
    converged, rescued, live)."""
    # a float32 product may run in TF32 on the card unless these are off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c1, r1, c2, r2 = (x.to(dtype) for x in (c1, r1, c2, r2))
    B, n, m = c1.shape[0], c1.shape[1], c2.shape[1]
    M, live = affinity(c1, r1, v1, c2, r2, v2, p)
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
