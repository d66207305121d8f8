"""Batched CLIPPER densest-clique solver (projected power iteration with
constraint-penalty homotopy), port of roman_tpu/align/clipper.py.

CLIPPER relaxes maximum-weight clique over the association consistency
graph to  max_u u'Mu  s.t. u >= 0, ||u|| = 1, u_i u_j = 0 where the
associations conflict, and solves it by projected power iteration on
M - d*Cb while the penalty d grows until no active violation remains
(arXiv 2011.10202, 2402.07284). The one-to-one constraint product is
rank-structured, (Cb u)[a,b] = rowsum(U)[a] + colsum(U)[b] - 2 U[a,b], so
no constraint matrix is ever built.

The functions here are the plain PyTorch versions and run on any device,
except the 4D entry points ``solve`` and ``solve_and_round`` (the latter
is the entry point of the arithmetic-mean and product fusions): for CUDA
tensors they launch the CLIPPER solve kernel (``align.clipper_solve``),
for CPU tensors they run its plain twin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ClipperSolveParams:
    """Iteration budget and homotopy knobs (roman_tpu/align/clipper.py:46-65).

    (8, 6, 6) is the knee of the TPU budget sweep, whose quality fields
    were identical at every budget. n_restarts > 1 runs R perturbed copies
    of the warmed start through the same homotopy and keeps the feasible
    one with the largest unpenalized omega = u'Mu; restart 0 wins ties.
    """

    warmup_iters: int = 8
    outer_iters: int = 6
    inner_iters: int = 6
    active_eps: float = 1e-6
    n_restarts: int = 1


def restart_noise(n_restarts: int, N: int) -> np.ndarray:
    """Deterministic nonnegative (R, N) f32 restart noise: row 0 is zero
    (restart 0 reproduces the single-start trajectory), rows 1..R-1 are
    uniform [0, 1) from the fixed seed 0x5EED. Every engine consumes this
    exact array, so restart sweeps stay comparable."""
    rng = np.random.default_rng(0x5EED)
    z = rng.uniform(size=(n_restarts, N)).astype(np.float32)
    z[0] = 0.0
    return z


def _cb_matvec(U: torch.Tensor) -> torch.Tensor:
    """(Cb u) for the all-to-all one-to-one constraint structure.
    U: (..., n, m) nonnegative -> (..., n, m)."""
    rows = torch.sum(U, dim=-1, keepdim=True)
    cols = torch.sum(U, dim=-2, keepdim=True)
    return rows + cols - 2.0 * U


def prepare_matrix(M4: torch.Tensor) -> torch.Tensor:
    """The (..., N, N) bf16 affinity, materialized once and shared by the
    solve and the refinement."""
    N = M4.shape[-4] * M4.shape[-3]
    return M4.reshape(M4.shape[:-4] + (N, N)).to(torch.bfloat16).contiguous()


def solve(M4: torch.Tensor, valid: torch.Tensor,
          params: ClipperSolveParams = ClipperSolveParams()):
    """Solve the densest-clique relaxation of a 4D affinity
    (roman_tpu/align/clipper.py:98-114).

    M4 (..., n, m, n, m) with conflicts and padding already zeroed; valid
    (..., n, m) bool. For CUDA tensors the CLIPPER solve kernel runs, for
    CPU tensors its plain twin. Returns u (..., n, m) nonnegative with
    unit norm, the final penalty d (...) and F = u'(M - d Cb)u (...).
    """
    from roman_tpu_torch.align import clipper_solve

    n, m = M4.shape[-4], M4.shape[-3]
    batch = M4.shape[:-4]
    N = n * m
    u, d, F, _ = clipper_solve.clipper_solve(
        prepare_matrix(M4).reshape((-1, N, N)),
        valid.reshape((-1, N)).to(torch.float32).contiguous(), n, m, params)
    return u.reshape(batch + (n, m)), d.reshape(batch), F.reshape(batch)


def solve_2d(M: torch.Tensor, n: int, m: int, valid: torch.Tensor,
             params: ClipperSolveParams = ClipperSolveParams()):
    """Plain solve on a prepared (..., N, N) bf16 M; valid (..., n, m).
    Returns u (..., n, m), d (...), F (...)."""
    from roman_tpu_torch.align.clipper_solve import clipper_solve_plain

    batch = M.shape[:-2]
    N = n * m
    u, d, F, _ = clipper_solve_plain(
        M.reshape((-1, N, N)), valid.reshape((-1, N)).to(torch.float32),
        n, m, params)
    return u.reshape(batch + (n, m)), d.reshape(batch), F.reshape(batch)


def round_greedy(u: torch.Tensor, omega: torch.Tensor, max_steps: int,
                 rel_thresh: float = 0.35):
    """Greedy-feasible rounding of the solution vector
    (roman_tpu/align/clipper.py:234-290).

    Selects associations in decreasing u order (first maximum wins a tie)
    keeping one-to-one row/col feasibility, stopping below
    rel_thresh * max(u) or at round(2 omega) clipped to [1, max_steps]
    (max_steps when omega <= 0).

    u: (..., n, m); omega: (...). Returns sel (..., n, m) bool and count
    (...) int32.
    """
    batch = u.shape[:-2]
    n, m = u.shape[-2], u.shape[-1]
    N = n * m
    dev = u.device
    flat = u.reshape(-1, N)
    B = flat.shape[0]
    om = omega.reshape(B)
    cut = rel_thresh * torch.amax(flat, dim=-1)
    target = torch.where(om > 0, torch.clamp(torch.round(om * 2.0), 1, max_steps),
                         float(max_steps))
    idx_a = torch.arange(N, device=dev) // m
    idx_b = torch.arange(N, device=dev) % m
    rows = torch.arange(B, device=dev)
    row_free = torch.ones((B, n), dtype=torch.bool, device=dev)
    col_free = torch.ones((B, m), dtype=torch.bool, device=dev)
    sel = torch.zeros((B, N), dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        cand = torch.where(row_free[:, idx_a] & col_free[:, idx_b], flat, -1.0)
        idx = torch.argmax(cand, dim=-1)
        val = cand[rows, idx]
        take = (val > cut) & (val > 0.0) & (count < target)
        sel[rows, idx] |= take
        row_free[rows, idx // m] &= ~take
        col_free[rows, idx % m] &= ~take
        count = count + take.to(torch.int32)
    return sel.reshape(batch + (n, m)), count.reshape(batch)


def refine_selection_2d(M: torch.Tensor, sel: torch.Tensor, iters: int = 6,
                        min_support: float = 0.22, rel_support: float = 0.5,
                        edge_eps: float = 1e-4, target=None):
    """Iteratively trim a rounded selection to a consistent clique
    (roman_tpu/align/clipper.py:301-394).

    Per iteration: (1) drop selected associations whose mean affinity to
    the other selected ones falls below max(rel * mean support,
    min_support); (2) while the selection is larger than round(target),
    drop the lowest-support association that has a zero edge
    (affinity <= edge_eps) to another selected one (first minimum wins).

    The support product is v @ M, out[j] = sum_i v_i M[i, j], the
    orientation of the fused TPU kernel; M of the plain affinity is
    symmetric, so it equals M @ v there.

    M: (..., N, N) bf16; sel (..., n, m) bool; target (...) or None.
    Returns sel (..., n, m) bool and count (...) int32.
    """
    batch = sel.shape[:-2]
    n, m = sel.shape[-2], sel.shape[-1]
    N = n * m
    dev = sel.device
    Mf = M.reshape(-1, N, N).float()
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    Z = ((Mf <= edge_eps) & ~eye).float()
    v = sel.reshape(-1, N).float()
    B = v.shape[0]
    if target is None:
        tgt = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    else:
        tgt = torch.clamp(torch.round(target.reshape(B, 1)), min=0.0)
    idxs = torch.arange(N, device=dev)
    for _ in range(iters):
        k = torch.sum(v, dim=-1, keepdim=True)
        mv = torch.bmm(v[:, None, :], Mf)[:, 0]
        supp = mv / torch.clamp(k - 1.0, min=1.0)
        mean_supp = torch.sum(supp * v, dim=-1, keepdim=True) / torch.clamp(k, min=1.0)
        keep = supp >= torch.clamp(rel_support * mean_supp, min=min_support)
        zc = torch.bmm(v[:, None, :], Z)[:, 0]
        viol = (v > 0.5) & (zc > 0.5)
        any_viol = torch.any(viol, dim=-1, keepdim=True) & (k > tgt)
        score = torch.where(viol, supp, 1e30)
        worst = torch.argmin(score, dim=-1, keepdim=True)
        drop = (idxs[None, :] == worst) & any_viol
        v = v * keep * (1.0 - drop.float())
    out = (v > 0.5).reshape(sel.shape)
    return out, torch.sum(out, dim=(-2, -1)).to(torch.int32)


def refine_selection(M4: torch.Tensor, sel: torch.Tensor, iters: int = 6,
                     min_support: float = 0.22, rel_support: float = 0.5,
                     edge_eps: float = 1e-4, target=None):
    """4D-affinity entry point of refine_selection_2d
    (roman_tpu/align/clipper.py:293-299)."""
    return refine_selection_2d(prepare_matrix(M4), sel, iters, min_support,
                               rel_support, edge_eps, target)


def solve_and_round(M4: torch.Tensor, valid: torch.Tensor, max_clique: int,
                    params: ClipperSolveParams = ClipperSolveParams()):
    """Solve + greedy rounding + support refinement on a 4D affinity
    (roman_tpu/align/clipper.py:397-432). For CUDA tensors the solve
    launches the CLIPPER solve kernel and the rounding and refinement the
    round_refine kernel (``align.fused_register``, at its defaults, which
    are round_greedy's and refine_selection_2d's); for CPU tensors both
    run plain.

    The rounding cap uses the penalized F; the refine target uses the
    unpenalized omega = u'Mu, which the solve returns.
    Returns sel (..., n, m) bool, count (...) int32, u (..., n, m), F (...).
    """
    from roman_tpu_torch.align import clipper_solve, fused_register

    n, m = M4.shape[-4], M4.shape[-3]
    batch = M4.shape[:-4]
    N = n * m
    M = prepare_matrix(M4).reshape((-1, N, N))
    u, _, F, omega = clipper_solve.clipper_solve(
        M, valid.reshape((-1, N)).to(torch.float32).contiguous(), n, m, params)
    if M.device.type == "cpu":
        sel, count = round_greedy(u.reshape((-1, n, m)), F, max_clique)
        sel, count = refine_selection_2d(M, sel, target=omega)
    else:  # at most min(n, m) entries can be selected: the same steps
        sel, count = fused_register.round_refine(
            M, u, F, omega, n, m,
            fused_register.FusedInvariantStatics(max_clique=max_clique))
    return (sel.reshape(batch + (n, m)), count.reshape(batch),
            u.reshape(batch + (n, m)), F.reshape(batch))
