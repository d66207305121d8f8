"""The work counts behind registration_roofline and mfu.grid: against a
hand-worked pair, and the matvec counts against FlopCounterMode over the
reference's own solve."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.metrics import _counts, _peaks
from benchmark.reference import clipper_f64


def test_a_hand_worked_pair():
    # n = 2, m = 3, D = 4, F = 4, 5 live entries, capacity 3
    w = _counts.registration_work([2], [3], desc_dim=4, n_ratio=4, live=[5],
                                  sides=[[2], [3]], rescued=0, capacity=3)
    # reads: 5 objects of (3 + 4 + 4) * 4 + 1 bytes; writes: 9 + 4 + 64
    assert w["bytes"] == 5 * 45 + 77
    # N = 6: 6 * (2 * 4 + 4 * 4) + 5 * 20 + (4 + 9) * 12
    assert w["f32_ops"] == 6 * 24 + 100 + 156
    assert w["bf16_ops"] == 2 * 36 * 51
    assert _counts.ops_seconds(w) == w["f32_ops"] / _peaks.F32_FLOPS + w["bf16_ops"] / _peaks.BF16_FLOPS
    assert _counts.least_seconds(w) == max(w["bytes"] / _peaks.HBM_BYTES_PER_S,
                                           _counts.ops_seconds(w))


def test_rescued_pairs_add_the_rescue_budgets_matvecs():
    base = _counts.registration_work([4, 4], [5, 5], 8, 4, [0, 0], [[4, 4], [5, 5]], 0)
    more = _counts.registration_work([4, 4], [5, 5], 8, 4, [0, 0], [[4, 4], [5, 5]], 1)
    assert more["bf16_ops"] - base["bf16_ops"] == 2 * 20 * 20 * (16 + 16 * 13 + 1)


def _solve_flops(budget):
    torch.manual_seed(0)
    n, m = 3, 4
    M = torch.rand(1, n * m, n * m, dtype=torch.float64)
    M = (M + M.transpose(1, 2)) / 2
    valid = torch.ones(1, n * m, dtype=torch.float64)
    with FlopCounterMode(display=False) as fc:
        clipper_f64.solve(M, valid, n, m, budget, 1e-6)
    return fc.get_total_flops(), n * m


def test_matvec_counts_match_the_solve():
    flops, N = _solve_flops(clipper_f64.Params().budget)
    assert flops == 2 * N * N * _counts.MAIN_MATVECS
    flops, N = _solve_flops(clipper_f64.Params().rescue_budget)
    assert flops == 2 * N * N * _counts.RESCUE_MATVECS
