"""The work a registration needs, counted from the pairs' shapes and what
the solve ran, independently of how the program computes it.

Per pair of n and m objects (N = n*m candidate associations), D-wide
descriptors and F ratio features:

- bytes: each submap's features read once a call (centers, ratio
  features, descriptors, valid flag: (3 + F + D) * 4 + 1 bytes an
  object), and each pair's answers written once (a byte a selection
  entry of the padded n x m block, the count, the 4 x 4 f32 transform);
  the affinity M is not counted, so the count does not depend on whether
  the program keeps M on chip or builds it at all;
- float32 operations: the association terms (a descriptor dot product,
  2 * D, and F ratio terms of 4 operations, an association), each live
  affinity entry (AFFINITY_ENTRY_OPS: the gravity-aware distance gap, the
  Gaussian, the gate and the fused root of its three factors from the
  per-side distance tables), and the per-side distance tables
  (PAIRWISE_OPS an object pair);
- bfloat16 operations: 2 * N^2 a matvec, at the matvecs the solve ran
  (MAIN_MATVECS a pair, and RESCUE_MATVECS more for each pair re-solved
  at the rescue budget).
"""

from __future__ import annotations

import numpy as np

# the solve's matvecs: warm-up 8, then 6 rounds of 6 steps and one for the
# penalty, then one for F and omega; the rescue budget (16, 16, 12)
MAIN_MATVECS = 8 + 6 * (6 + 1) + 1
RESCUE_MATVECS = 16 + 16 * (12 + 1) + 1
AFFINITY_ENTRY_OPS = 20
PAIRWISE_OPS = 12
RATIO_TERM_OPS = 4


def registration_work(n, m, desc_dim: int, n_ratio: int, live, sides,
                      rescued: int, capacity: int = None) -> dict:
    """Work of one call over pairs of n[p] x m[p] objects: {"bytes",
    "f32_ops", "bf16_ops"}. live (P,): the nonzero affinity entries off
    the diagonal of each pair; sides: each robot's submap sizes (every
    submap's features are read once); rescued: pairs re-solved at the
    rescue budget (charged at the mean pair's N)."""
    n, m, live = (np.asarray(x, np.float64) for x in (n, m, live))
    N = n * m
    obj_bytes = (3 + n_ratio + desc_dim) * 4 + 1
    read = sum(float(np.sum(s)) for s in sides) * obj_bytes
    cap = capacity or int(max(n.max(), m.max()))
    written = len(N) * (cap * cap + 4 + 64)
    f32 = float(np.sum(N * (2 * desc_dim + RATIO_TERM_OPS * n_ratio)
                       + live * AFFINITY_ENTRY_OPS
                       + (n * n + m * m) * PAIRWISE_OPS))
    bf16 = float(np.sum(2 * N * N) * MAIN_MATVECS
                 + rescued * float(np.mean(2 * N * N)) * RESCUE_MATVECS)
    return {"bytes": read + written, "f32_ops": f32, "bf16_ops": bf16}


def least_seconds(work: dict) -> float:
    """The least time the card could take for the work: the larger of its
    bytes at HBM bandwidth and its operations at each type's peak."""
    from benchmark.metrics import _peaks

    t_bytes = work["bytes"] / _peaks.HBM_BYTES_PER_S
    t_ops = work["f32_ops"] / _peaks.F32_FLOPS + work["bf16_ops"] / _peaks.BF16_FLOPS
    return max(t_bytes, t_ops)


def ops_seconds(work: dict) -> float:
    """The operations alone at each type's peak."""
    from benchmark.metrics import _peaks

    return work["f32_ops"] / _peaks.F32_FLOPS + work["bf16_ops"] / _peaks.BF16_FLOPS
