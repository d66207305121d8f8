"""Robust pose-graph optimization on the card (port of
roman_tpu/rpgo/solver.py).

Replaces the reference's Kimera-RPGO C++ subprocess (RpgoReadG2o, invoked
at demo/demo.py:246-250 as a g2o -> result.g2o transform) with the same
robust-PGO recipe as roman_tpu:

1. **PCM gating** (pairwise consistency maximization): loop closures are
   checked pairwise for consistency against odometry, and the largest
   consistent subset is kept (host numpy, copied from roman_tpu).
2. **GNC-TLS** on the loop closures: truncated-least-squares weights
   graduated from a convex surrogate by the control parameter mu.
3. **Gauss-Newton on SE(3)** with per-edge Jacobians in closed form (the
   forward-mode derivative of the implemented residual at zero right
   perturbation, which roman_tpu takes with ``jax.jacfwd``) and a
   block-Jacobi preconditioned CG whose matvec is an edge gather and a
   segment sum, in float32 on an explicit device.

The loops keep roman_tpu's fixed counts: exactly gn_iters Gauss-Newton
steps per pass, cg_iters CG iterations per step and gnc_iters GNC rounds,
with no early exit and no read of a device value inside them. The segment
sums that scatter edge terms onto vertices add each vertex's terms in one
fixed order (a padded gather table built once per solve, then a sum over
the table's rows), so a solve on the card gives the same bits run after
run, which float atomics (``index_add_`` on CUDA) do not.

Initialization is by maximum-priority spanning-forest composition of
measurements (odometry first, then loop closures by descending PCM clique
size), rooted at the g2o file initials. After GNC, rejected loop closures
are removed and the solve restarts from a fresh forest.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.ops import se3, se3_np
from roman_tpu_torch.rpgo.g2o_io import G2OGraph, is_loop_closure, parse_g2o, write_g2o


def chi2_ppf_even_df(p: float, df: int) -> float:
    """Inverse chi-square CDF for EVEN df (self-contained; no scipy).

    Kimera-RPGO's CLI takes the PCM threshold as a chi2 confidence
    probability (reference demo/demo.py:246-250 passes 0.9); our gate is
    a raw chi2 value, so the CLI converts via this inverse CDF. 6-DoF
    SE(3) residuals always give even df, where the CDF has the closed
    form P(X<=x) = 1 - exp(-x/2) * sum_{k<df/2} (x/2)^k / k!; the
    inverse is a bisection on that monotone form (pinned against
    published chi2 quantile tables in the tests)."""
    if df % 2 != 0 or df <= 0:
        raise ValueError(f"closed-form CDF needs even df > 0, got {df}")
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")

    def cdf(x: float) -> float:
        h = x / 2.0
        term = s = 1.0
        for k in range(1, df // 2):
            term *= h / k
            s += term
        return 1.0 - math.exp(-h) * s

    lo, hi = 0.0, float(df)
    while cdf(hi) < p:
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class RPGOSolverParams:
    # GNC-TLS anneals mu from barc2/(2*r2max - barc2); with large
    # outliers that start is ~1e-3, so reaching a hard threshold needs
    # ~25 x1.4 updates (8 left every weight in the soft <0.5 zone and
    # rejected good LCs wholesale on multi-robot graphs)
    gnc_iters: int = 25
    gn_iters: int = 6
    cg_iters: int = 100
    # TLS inlier threshold on chi2 (information-scaled residual).
    # GTSAM's GncOptimizer defaults barcSq to chi2inv(0.99, dim) — 16.81
    # for 6-DoF edges — which is what Kimera-RPGO runs with; 1.0 was
    # ~7x stricter than the reference backend and rejected good LCs
    # whose map-frame spread exceeded ~2 m at lc_t_std=2 m.
    gnc_barc2: float = 16.81
    gnc_mu_update: float = 1.4
    pcm_gate: bool = True
    pcm_thresh: float = 25.0        # chi2-ish consistency threshold
    # inter-robot LC groups must have >= this many mutually-consistent
    # members; a singleton bridging two frames is unfalsifiable (its
    # residual is exactly satisfiable under gauge freedom)
    pcm_min_inter_clique: int = 2
    damping: float = 1e-6
    gauge_weight: float = 1e6


# ---------------------------------------------------------------------------
# graph -> arrays
# ---------------------------------------------------------------------------

def graph_to_arrays(graph: G2OGraph):
    keys = sorted(graph.vertices.keys())
    key_to_idx = {k: i for i, k in enumerate(keys)}
    V = len(keys)
    xq = np.stack([graph.vertices[k] for k in keys])
    T0 = se3_np.xyz_quat_to_T(xq[:, :3], xq[:, 3:])
    ii = np.array([key_to_idx[e.v1] for e in graph.edges], np.int32)
    jj = np.array([key_to_idx[e.v2] for e in graph.edges], np.int32)
    Tm = np.stack([e.T for e in graph.edges])
    info = np.stack([e.info for e in graph.edges])
    lc = np.array([is_loop_closure(e) for e in graph.edges], bool)
    return keys, key_to_idx, T0, ii, jj, Tm, info, lc


def spanning_tree_init(V: int, ii, jj, Tm, use_edge: np.ndarray,
                       T_file: Optional[np.ndarray] = None,
                       priority: Optional[np.ndarray] = None) -> np.ndarray:
    """Maximum-priority spanning-forest composition of measurements.

    Stitches per-robot odometry frames together through accepted loop
    closures (the fused g2o's VERTEX initials keep each robot in its own
    odom frame). Tree edges are chosen Kruskal-style in descending
    `priority` — odometry edges carry +inf and loop closures their PCM
    clique size — so inter-robot frames connect through the
    best-supported loop closure instead of an arbitrary traversal-order
    one (a singleton false LC must not place a whole robot). Component
    roots start at their file initials when `T_file` is given: a robot
    whose only links were rejected keeps its own odometry-frame
    placement instead of collapsing onto identity.
    """
    order = np.flatnonzero(np.asarray(use_edge))
    if priority is not None:
        order = order[np.argsort(-np.asarray(priority, float)[order],
                                 kind="stable")]
    parent = np.arange(V)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj: List[List[Tuple[int, int, bool]]] = [[] for _ in range(V)]
    for e in order:
        a, b = find(ii[e]), find(jj[e])
        if a == b:
            continue
        parent[a] = b
        adj[ii[e]].append((jj[e], e, False))
        adj[jj[e]].append((ii[e], e, True))

    T = np.tile(np.eye(4), (V, 1, 1))
    visited = np.zeros(V, bool)
    for root in range(V):
        if visited[root]:
            continue
        visited[root] = True
        if T_file is not None:
            T[root] = T_file[root]
        stack = [root]
        while stack:
            u = stack.pop()
            for v, e, inv in adj[u]:
                if visited[v]:
                    continue
                visited[v] = True
                M = np.linalg.inv(Tm[e]) if inv else Tm[e]
                T[v] = T[u] @ M
                stack.append(v)
    return T


# ---------------------------------------------------------------------------
# PCM loop-closure gating
# ---------------------------------------------------------------------------

def pcm_gate(T_init: np.ndarray, ii, jj, Tm, info, lc_mask: np.ndarray,
             thresh: float, return_sizes: bool = False,
             min_inter_clique: int = 1):
    """Pairwise consistency maximization over loop closures.

    Two LCs (i1,j1,T1), (i2,j2,T2) are consistent if the cycle
    odom(i2->i1) . T1 . odom(j1->j2) . T2^-1 is near identity, with
    odometry segments taken from the (odometry-only) initial poses. The
    maximum consistent set is the densest clique of the binary consistency
    graph, solved with projected power iteration + greedy rounding.
    Returns a keep-mask over ALL edges (odometry always kept).
    """
    lc_idx = np.flatnonzero(lc_mask)
    sizes = np.zeros(len(ii), np.float64)
    if len(lc_idx) == 0:
        keep = np.ones(len(ii), bool)
        return (keep, sizes) if return_sizes else keep
    keep = np.ones(len(ii), bool)

    # group LCs by (robot_i, robot_j) pair — PCM operates per robot pair;
    # robot identity = vertex-key high byte order is lost here, so group by
    # the connected component structure instead: robots were stitched per
    # letter upstream, and within graph_to_arrays vertex order is by key,
    # so robot boundaries are where ii/jj cross odometry chains. The caller
    # passes odometry-only T_init, which is per-robot consistent.
    # Here grouping uses (component of i, component of j) from odometry.
    comp = _odometry_components(len(T_init), ii, jj, lc_mask)
    # group by the UNORDERED component pair: LCs between the same two
    # robots may be written in either edge direction (fused graphs can
    # combine a->b and b->a align runs) and must land in one group to
    # mutually confirm; direction is canonicalized by inverting the
    # frame-offset estimate of edges whose components are flipped
    groups: Dict[Tuple[int, int], List[int]] = {}
    for e in lc_idx:
        ca, cb = int(comp[ii[e]]), int(comp[jj[e]])
        groups.setdefault((min(ca, cb), max(ca, cb)), []).append(int(e))

    for (ca, cb), es in groups.items():
        es = np.asarray(es)
        n = len(es)
        # per-LC estimate of the (unknown, shared) frame offset between the
        # two components: T_ab(e) = T_a_i(e) @ T_lc(e) @ inv(T_b_j(e)).
        # consistent inlier LCs agree on T_ab up to noise + odometry drift.
        T_ab = np.einsum(
            "eab,ebc,ecd->ead",
            T_init[ii[es]], Tm[es], np.linalg.inv(T_init[jj[es]]),
        )
        flipped = comp[ii[es]] != ca
        if flipped.any():
            T_ab[flipped] = np.linalg.inv(T_ab[flipped])
        D = np.einsum("eab,fbc->efac", np.linalg.inv(T_ab), T_ab)
        d_log = se3_np.se3_log(D)  # (n, n, 6)
        w = np.array([1.0, 1.0, 1.0, 10.0, 10.0, 10.0])
        chi2 = np.sum((d_log * w) ** 2, axis=-1)
        C = chi2 < thresh
        np.fill_diagonal(C, True)

        # densest consistent subset: projected power iteration on M = C with
        # dense complement penalty + greedy feasible rounding (same solver
        # family as align.clipper, dense-constraint variant)
        M = C.astype(np.float32)
        Cb = 1.0 - M
        np.fill_diagonal(Cb, 0.0)
        u = np.ones(n, np.float32) / np.sqrt(n)
        d = 0.0
        for _ in range(8):
            for _ in range(10):
                g = M @ u - d * (Cb @ u)
                u = np.maximum(g, 0.0)
                nn = np.linalg.norm(u)
                u = u / nn if nn > 1e-12 else np.ones(n, np.float32) / np.sqrt(n)
            Cbu = Cb @ u
            viol = (u > 1e-6) & (Cbu > 1e-6)
            if viol.any():
                d += float(np.sum((M @ u)[viol]) / max(np.sum(Cbu[viol]), 1e-9)) + 1e-3
        order = np.argsort(-u)
        chosen: List[int] = []
        for k in order:
            if u[k] <= 1e-6:
                break
            if all(C[k, c] for c in chosen):
                chosen.append(k)
        # an inter-robot LC that bridges otherwise-unconnected frames is
        # unfalsifiable downstream (gauge freedom makes its residual
        # exactly satisfiable, so GNC sees an inlier) — require mutual
        # confirmation for groups that connect two different components
        inter = ca != cb
        if inter and len(chosen) < min_inter_clique:
            chosen = []
        kept_es = {int(es[c]) for c in chosen}
        for e in es:
            if int(e) in kept_es:
                sizes[e] = float(len(chosen))
            else:
                keep[e] = False
    return (keep, sizes) if return_sizes else keep


def _odometry_components(V: int, ii, jj, lc_mask) -> np.ndarray:
    """Connected components over odometry edges only (per-robot chains)."""
    parent = np.arange(V)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in np.flatnonzero(~lc_mask):
        a, b = find(ii[e]), find(jj[e])
        if a != b:
            parent[a] = b
    return np.array([find(v) for v in range(V)])


# ---------------------------------------------------------------------------
# Gauss-Newton + GNC core (torch, on an explicit device)
# ---------------------------------------------------------------------------

def _edge_residual(Ti, Tj, Tm_inv):
    """r = log(Tm^-1 . Ti^-1 . Tj) in R^6."""
    return se3.se3_log(Tm_inv @ se3.inv_T(Ti) @ Tj)


def _generators(device) -> torch.Tensor:
    """(6, 4, 4) derivatives of se3_exp at 0: translation e_k, then the
    rotation generators skew(e_k). They are exact for the implemented
    se3_exp (its Taylor terms have zero derivative at 0)."""
    G = torch.zeros((6, 4, 4), dtype=torch.float32, device=device)
    for k in range(3):
        G[k, k, 3] = 1.0
    G[3:, :3, :3] = se3.skew(torch.eye(3, dtype=torch.float32, device=device))
    return G


def _se3_log_jvp(A, dA):
    """Forward-mode derivative of se3.se3_log at A (E, 4, 4) along the
    tangents dA (E, K, 4, 4): (E, K, 6). Follows se3_log and so3_log
    operation by operation, through the same branches, as jax.jacfwd does
    through roman_tpu's (a clamped cosine has zero derivative)."""
    R, t = A[:, None, :3, :3], A[:, None, :3, 3]
    dR, dt = dA[..., :3, :3], dA[..., :3, 3]
    # so3_log
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    dtr = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    x = (tr - 1.0) * 0.5
    lo, hi = -1.0 + 1e-7, 1.0 - 1e-7
    cos_t = torch.clamp(x, lo, hi)
    dcos = torch.where((x >= lo) & (x <= hi), dtr * 0.5, 0.0)
    th = torch.acos(cos_t)[..., None, None]
    dth = (-dcos / torch.sqrt(1.0 - cos_t * cos_t))[..., None, None]
    W = 0.5 * (R - R.transpose(-1, -2))
    dW = 0.5 * (dR - dR.transpose(-1, -2))
    small = th < 1e-2
    ths = torch.where(small, 1.0, th)
    dths = torch.where(small, 0.0, dth)
    sin, cos = torch.sin(ths), torch.cos(ths)
    scale = torch.where(small, 1.0 + th**2 / 6.0, ths / sin)
    dscale = torch.where(small, th * dth / 3.0,
                         (dths * sin - ths * cos * dths) / (sin * sin))
    V = scale * W
    dV = dscale * W + scale * dW
    w = torch.stack([V[..., 2, 1], V[..., 0, 2], V[..., 1, 0]], dim=-1)
    dw = torch.stack([dV[..., 2, 1], dV[..., 0, 2], dV[..., 1, 0]], dim=-1)
    # se3_log
    sq = torch.sum(w * w, dim=-1, keepdim=True)
    th = torch.sqrt(torch.clamp(sq, min=se3._EPS))
    dth = torch.where(sq >= se3._EPS, torch.sum(w * dw, dim=-1, keepdim=True) / th,
                      0.0)
    th, dth = th[..., None], dth[..., None]
    K, dK = se3.skew(w), se3.skew(dw)
    K2 = K @ K
    dK2 = dK @ K + K @ dK
    small = th < 1e-2
    ths = torch.where(small, 1.0, th)
    dths = torch.where(small, 0.0, dth)
    sin, cos = torch.sin(ths), torch.cos(ths)
    u, v = ths * sin, 2.0 * (1.0 - cos)
    h = u / v
    dh = ((sin + ths * cos) * v - u * 2.0 * sin) / (v * v)
    coef = torch.where(small, 1.0 / 12.0 + th**2 / 720.0, (1.0 - h) / ths**2)
    dcoef = torch.where(small, th * dth / 360.0,
                        (-dh / ths**2 - 2.0 * (1.0 - h) / ths**3) * dths)
    Vinv = se3._eye(K) - 0.5 * K + coef * K2
    dVinv = -0.5 * dK + dcoef * K2 + coef * dK2
    drho = (dVinv @ t[..., None])[..., 0] + (Vinv @ dt[..., None])[..., 0]
    return torch.cat([drho, dw], dim=-1)


def _edge_jacobians(Ti, Tj, Tm_inv):
    """(E, 6, 6) Jacobians of the edge residual with respect to right
    perturbations T <- T exp(xi) of each endpoint, at xi = 0 (what
    jax.jacfwd of the perturbed residual gives, roman_tpu solver.py:
    316-323). With A = Tm^-1 Ti^-1 Tj and the generators G_k:
    dA/dxi_j,k = A G_k and dA/dxi_i,k = -Tm^-1 G_k Ti^-1 Tj."""
    G = _generators(Ti.device)
    B = se3.inv_T(Ti) @ Tj
    A = Tm_inv @ B
    dA = torch.cat([-(Tm_inv[:, None] @ G) @ B[:, None], A[:, None] @ G], dim=1)
    J = _se3_log_jvp(A, dA).transpose(-1, -2)  # (E, 6, 12)
    return J[..., :6], J[..., 6:]


class _SegmentSum:
    """Deterministic scatter-add of per-term rows onto vertices.

    slots[k] is the vertex that term k belongs to. The table holds, for
    each vertex, the indices of its terms in increasing k, padded with the
    index of an all-zero row; a sum over the table's rows then adds each
    vertex's terms in one fixed order on every run."""

    def __init__(self, slots: np.ndarray, V: int, device: torch.device):
        K = len(slots)
        order = np.argsort(slots, kind="stable")
        counts = np.bincount(slots, minlength=V)
        width = max(int(counts.max(initial=0)), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(K) - np.repeat(starts, counts)
        table = np.full((V, width), K, np.int64)
        table[slots[order], rank] = order
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, terms: torch.Tensor) -> torch.Tensor:
        padded = torch.cat([terms, terms.new_zeros((1,) + terms.shape[1:])])
        return padded[self.table].sum(dim=1)


class _Graph:
    """A solve's edge arrays on the device, with its segment sum. The two
    endpoints of edge e are ends[e] = (ii[e], jj[e])."""

    def __init__(self, V: int, ii, jj, Tm, info, device: torch.device):
        self.V = V
        ends = np.stack([np.asarray(ii), np.asarray(jj)], axis=1).astype(np.int64)
        self.ii = torch.as_tensor(ends[:, 0], device=device)
        self.jj = torch.as_tensor(ends[:, 1], device=device)
        self.ends = torch.as_tensor(ends, device=device)
        self.Tm_inv = torch.as_tensor(np.linalg.inv(Tm), dtype=torch.float32,
                                      device=device)
        self.info = torch.as_tensor(info, dtype=torch.float32, device=device)
        self.segsum = _SegmentSum(ends.reshape(-1), V, device)
        # gauge_weight on the row of vertex 0, which carries the gauge prior
        self.gauge = torch.zeros((V, 1), dtype=torch.float32, device=device)
        self.gauge[0] = 1.0

    def chi2(self, T):
        """Per-edge chi2 r' info r at poses T."""
        r = _edge_residual(T[self.ii], T[self.jj], self.Tm_inv)
        return torch.einsum("ea,eab,eb->e", r, self.info, r)


def _edge_terms(g: _Graph, T, w_edge):
    """g's edges' part of a Gauss-Newton step at poses T: the (E, 12, 12)
    blocks H_e = J_e' W_e J_e, J_e = [J_i J_j] (each formed once a step),
    and their segment sums onto g's vertices: the gradient J'W r (V, 6)
    and the preconditioner's diagonal blocks (V, 6, 6)."""
    E = g.ii.shape[0]
    Ti, Tj = T[g.ii], T[g.jj]
    J = torch.cat(_edge_jacobians(Ti, Tj, g.Tm_inv), dim=-1)  # (E, 6, 12)
    r = _edge_residual(Ti, Tj, g.Tm_inv)
    JtW = J.transpose(-1, -2) @ (g.info * w_edge[:, None, None])
    H = JtW @ J  # (E, 12, 12)
    grad = g.segsum((JtW @ r[..., None]).reshape(2 * E, 6, 1)).reshape(g.V, 6)
    Hd = torch.stack([H[:, :6, :6], H[:, 6:, 6:]], dim=1)  # (E, 2, 6, 6)
    blocks = g.segsum(Hd.reshape(2 * E, 6, 6))
    return H, grad, blocks


def _edge_matvec(g: _Graph, H, x):
    """(H x) summed onto g's vertices, x (V, 6) -> (V, 6): one gather, one
    batched product and one segment sum."""
    E = H.shape[0]
    return g.segsum((H @ x[g.ends].reshape(E, 12, 1)).reshape(2 * E, 6, 1)
                    ).reshape(g.V, 6)


def _pcg_update(T, grad, blocks, matvec, gauge, params: RPGOSolverParams):
    """Block-Jacobi PCG for (H + prior + damping) dx = -grad, exactly
    cg_iters iterations, then T <- T exp(dx). matvec(x) is H x; gauge (V, 1)
    is 1 on vertex 0's row, which carries the gauge prior."""
    # gauge prior on vertex 0, and damping, on the diagonal of H
    diag = params.gauge_weight * gauge + params.damping

    def A_matvec(x):
        return torch.addcmul(matvec(x), diag, x)

    eye = torch.eye(6, dtype=torch.float32, device=T.device)
    blocks = (blocks + (params.damping + 1e-6) * eye
              + params.gauge_weight * gauge[:, :, None] * eye)
    blocks_inv = torch.linalg.inv(blocks)

    def M_inv(x):
        return (blocks_inv @ x[..., None])[..., 0]

    def dot(a, b):
        return torch.vdot(a.reshape(-1), b.reshape(-1))

    x = torch.zeros_like(grad)
    rr = -grad - A_matvec(x)
    zz = M_inv(rr)
    p = zz
    rz = dot(rr, zz)
    for _ in range(params.cg_iters):
        Ap = A_matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, 0.0)
        x = torch.addcmul(x, alpha, p)
        rr = torch.addcmul(rr, alpha, Ap, value=-1.0)
        zz = M_inv(rr)
        rz_new = dot(rr, zz)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, 0.0)
        p = torch.addcmul(zz, beta, p)
        rz = rz_new
    return T @ se3.se3_exp(x)


def _gn_step(g: _Graph, T, w_edge, params: RPGOSolverParams):
    """One Gauss-Newton step: Jacobians, J'W r, block-Jacobi PCG for
    H dx = -J'W r (exactly cg_iters iterations), T <- T exp(dx)
    (roman_tpu solver.py:326-393)."""
    H, grad, blocks = _edge_terms(g, T, w_edge)
    return _pcg_update(T, grad, blocks, lambda x: _edge_matvec(g, H, x),
                       g.gauge, params)


def solve_arrays(
    T_init: np.ndarray,
    ii: np.ndarray,
    jj: np.ndarray,
    Tm: np.ndarray,
    info: np.ndarray,
    lc_mask: np.ndarray,
    params: RPGOSolverParams = RPGOSolverParams(),
    device=None,
):
    """Robust solve on array form, in float32 on `device` (default cuda).
    Returns (T_opt (V, 4, 4) float32, lc_weights (E,)) as numpy arrays."""
    dev = resolve_device(device)
    g = _Graph(len(T_init), ii, jj, Tm, info, dev)
    T = torch.as_tensor(T_init, dtype=torch.float32, device=dev)
    lc = torch.as_tensor(np.asarray(lc_mask, bool), device=dev)
    barc2 = params.gnc_barc2

    def gn_loop(T, w):
        for _ in range(params.gn_iters):
            T = _gn_step(g, T, w, params)
        return T

    # initial GN pass at unit weights
    w = torch.ones(len(ii), dtype=torch.float32, device=dev)
    T = gn_loop(T, w)
    r2max = torch.max(torch.where(lc, g.chi2(T), 0.0))
    mu = barc2 / torch.clamp(2.0 * r2max - barc2, min=1e-6)
    # GNC-TLS on loop closures: weights from the residuals where the
    # iterate stands (Yang et al. eq. 14), then a GN pass at those weights
    for _ in range(params.gnc_iters):
        chi2 = g.chi2(T)
        up = (mu + 1.0) / mu * barc2
        lo = mu / (mu + 1.0) * barc2
        w_lc = torch.where(
            chi2 >= up, 0.0,
            torch.where(chi2 <= lo, 1.0,
                        torch.sqrt(barc2 * mu * (mu + 1.0)
                                   / torch.clamp(chi2, min=1e-12)) - mu))
        w = torch.where(lc, torch.clamp(w_lc, 0.0, 1.0), 1.0)
        T = gn_loop(T, w)
        mu = mu * params.gnc_mu_update
    return T.cpu().numpy(), w.cpu().numpy()


def solve_pose_graph(
    graph: G2OGraph, params: RPGOSolverParams = RPGOSolverParams(), device=None,
) -> Tuple[G2OGraph, Dict]:
    """g2o graph -> optimized g2o graph (the RpgoReadG2o contract). The GN
    and GNC solve runs on `device` (default cuda, which raises on a host
    without a card; device="cpu" asks for the CPU)."""
    device = resolve_device(device)
    keys, key_to_idx, T_file, ii, jj, Tm, info, lc = graph_to_arrays(graph)
    V = len(keys)

    # PCM gating of loop closures against odometry-only structure, rooted
    # at identity so that the pairwise check stays frame-independent
    if params.pcm_gate and lc.any():
        T_odom = spanning_tree_init(V, ii, jj, Tm, ~lc)
        keep, clique = pcm_gate(T_odom, ii, jj, Tm, info, lc,
                                params.pcm_thresh, return_sizes=True,
                                min_inter_clique=params.pcm_min_inter_clique)
    else:
        keep = np.ones(len(ii), bool)
        clique = np.where(lc, 1.0, 0.0)

    # stitch frames through the best-supported LCs (odometry = +inf)
    prio = np.where(lc, clique, np.inf)
    T_init = spanning_tree_init(V, ii, jj, Tm, keep, T_file=T_file,
                                priority=prio)
    use = keep  # rejected LCs removed entirely (Kimera-RPGO PCM behavior)
    T_opt, w = solve_arrays(
        T_init, ii[use], jj[use], Tm[use], info[use], lc[use], params, device)
    gnc_rejected = int((w[lc[use]] < 0.5).sum()) if use.any() else 0

    # second pass: GNC-rejected LCs are removed and the solve restarts from
    # a fresh forest, so a robot whose only links were outliers reverts to
    # its file-initial placement
    rej_local = lc[use] & (w < 0.5)
    if rej_local.any():
        keep2 = keep.copy()
        keep2[np.flatnonzero(use)[rej_local]] = False
        T_init2 = spanning_tree_init(V, ii, jj, Tm, keep2, T_file=T_file,
                                     priority=prio)
        use = keep2
        T_opt, w = solve_arrays(
            T_init2, ii[use], jj[use], Tm[use], info[use], lc[use], params,
            device)
        gnc_rejected += int((w[lc[use]] < 0.5).sum()) if use.any() else 0

    t, q = se3_np.T_to_xyz_quat(T_opt)
    vertices = {k: np.concatenate([t[i], q[i]]) for i, k in enumerate(keys)}
    out = G2OGraph(vertices=vertices, edges=graph.edges)
    diag = dict(
        n_lc=int(lc.sum()),
        n_lc_pcm_rejected=int((~keep & lc).sum()),
        n_lc_gnc_rejected=gnc_rejected,
    )
    return out, diag


def rpgo_solve_g2o(input_g2o: str, output_dir: str,
                   params: RPGOSolverParams = RPGOSolverParams(),
                   device=None) -> str:
    """File-level contract of the RpgoReadG2o subprocess
    (demo/demo.py:246-250): reads <input>.g2o, writes
    <output_dir>/result.g2o. Solves on `device` (default cuda)."""
    device = resolve_device(device)
    graph = parse_g2o(input_g2o)
    out, diag = solve_pose_graph(graph, params, device)
    result = os.path.join(output_dir, "result.g2o")
    write_g2o(out, result)
    print(f"rpgo: {len(out.vertices)} vertices, {len(out.edges)} edges, {diag}")
    return result


def main(argv=None) -> None:
    """CLI of the RpgoReadG2o invocation the reference spawns
    (`RpgoReadG2o 3d <g2o> -1.0 -1.0 0.9 <outdir> v`, demo/demo.py:
    246-250), so scripts driving the reference backend can point here:

        python -m roman_tpu_torch.rpgo.solver 3d in.g2o -1.0 -1.0 0.9 outdir v

    It solves on cuda; ROMAN_TPU_TORCH_RPGO_DEVICE=cpu asks for the CPU."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("dim", choices=["3d", "2d"], help="pose dimension "
                    "(only 3d graphs occur in this pipeline)")
    ap.add_argument("input_g2o")
    ap.add_argument("odom_thresh", type=float, nargs="?", default=-1.0,
                    help="unused (Kimera-RPGO arg slot)")
    ap.add_argument("pcm_t_thresh", type=float, nargs="?", default=-1.0,
                    help="unused (Kimera-RPGO arg slot)")
    ap.add_argument("pcm_thresh", type=float, nargs="?", default=0.9,
                    help="PCM consistency threshold")
    ap.add_argument("output_dir", nargs="?", default=".")
    ap.add_argument("verbosity", nargs="?", default="v")
    args = ap.parse_args(argv)
    if args.dim != "3d":
        raise SystemExit("only 3d graphs are supported")
    p = RPGOSolverParams()
    if 0.0 < args.pcm_thresh < 1.0:
        # Kimera passes a chi2 confidence probability; the gate is a raw
        # chi2 value -> convert via the inverse CDF (6-DoF residual)
        p = dataclasses.replace(
            p, pcm_thresh=chi2_ppf_even_df(args.pcm_thresh, df=6))
    elif args.pcm_thresh >= 1.0:
        p = dataclasses.replace(p, pcm_thresh=float(args.pcm_thresh))
    rpgo_solve_g2o(args.input_g2o, args.output_dir, p,
                   device=os.environ.get("ROMAN_TPU_TORCH_RPGO_DEVICE", "cuda"))


if __name__ == "__main__":
    main()
