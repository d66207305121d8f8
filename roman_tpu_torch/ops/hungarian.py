"""Linear assignment: the host Hungarian with rejection (scipy) and a
batched auction solver on tensors.

Port of roman_tpu/ops/hungarian.py. The reference solves GNN data
association with scipy's linear_sum_assignment over a cost matrix
augmented with "no association" columns
(roman/map/global_nearest_neighbor.py:39-42); the auction keeps a whole
frame's association on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

_M = 1e9  # "no match" cost, the reference's M = 1e9


def assignment_with_rejection_np(scores: np.ndarray) -> list[tuple[int, int]]:
    """Minimize cost with per-item rejection (global_nearest_neighbor.py:
    39-48): [scores | 1] blocks let any row or column opt out at cost 1.0;
    only real-real pairs are kept.

    scores: (n1, n2) cost matrix (lower is better; rejected pairs = M).
    """
    n1, n2 = scores.shape
    if n1 == 0 or n2 == 0:
        return []
    cost = np.concatenate(
        [
            np.concatenate([scores, np.ones((n1, n2))], axis=1),
            np.ones((n1, 2 * n2)),
        ],
        axis=0,
    )
    rows, cols = linear_sum_assignment(cost)
    return [
        (int(r), int(c))
        for r, c in zip(rows, cols)
        if r < n1 and c < n2 and scores[r, c] < _M / 2
    ]


def auction_assignment(benefit: torch.Tensor, row_mask: torch.Tensor,
                       col_mask: torch.Tensor, n_iters: int = 200,
                       eps: float = 1e-3) -> torch.Tensor:
    """Batched auction maximizing total benefit with rejection
    (roman_tpu/ops/hungarian.py:47-105).

    benefit (..., n, m): entries <= 0 mean "prefer no match";
    row_mask/col_mask: validity of rows and columns. Runs n_iters sweeps;
    in each, every unassigned row with a positive best value bids for its
    best column, and each column goes to its highest bidder.

    Ties resolve to the lower index, as jax.lax.top_k and jnp.argmax do:
    the best column is the first maximum (argmax), the second value is the
    maximum with that column masked out, and a column's winner is the first
    highest bidder.

    Returns match (..., n) int64: the column of each row, -1 unassigned.
    """
    n, m = benefit.shape[-2], benefit.shape[-1]
    neg = -_M
    dev = benefit.device
    b = torch.where(row_mask[..., :, None] & col_mask[..., None, :], benefit,
                    torch.full_like(benefit, neg))
    ar_n = torch.arange(n, device=dev)
    ar_m = torch.arange(m, device=dev)
    price = torch.zeros(benefit.shape[:-2] + (m,), dtype=benefit.dtype, device=dev)
    owner = torch.full(benefit.shape[:-2] + (m,), -1, dtype=torch.int64, device=dev)
    neg_t = torch.full((), neg, dtype=benefit.dtype, device=dev)
    ninf = torch.full((), float("-inf"), dtype=benefit.dtype, device=dev)
    for _ in range(n_iters):
        assigned = (owner[..., None, :] == ar_n[:, None]).any(dim=-1)     # (..., n)
        value = b - price[..., None, :]
        best_j = torch.argmax(value, dim=-1)
        is_best = best_j[..., None] == ar_m                               # (..., n, m)
        v1 = torch.gather(value, -1, best_j[..., None])[..., 0]
        v2 = torch.where(is_best, ninf, value).max(dim=-1).values
        bid = v1 - v2 + eps
        want = (~assigned) & (v1 > 0)
        bid_mat = torch.where(want[..., :, None] & is_best, bid[..., :, None], neg_t)
        win_bid = bid_mat.max(dim=-2).values
        win_row = torch.argmax(bid_mat, dim=-2)
        has_bid = win_bid > neg / 2
        price = torch.where(has_bid, price + win_bid, price)
        owner = torch.where(has_bid, win_row, owner)

    owner_eq = owner[..., None, :] == ar_n[:, None]                        # (..., n, m)
    match = torch.argmax(owner_eq.to(torch.int32), dim=-1)
    return torch.where(owner_eq.any(dim=-1), match, torch.full_like(match, -1))
