"""Alias module mirroring reference roman/map/global_nearest_neighbor.py
(a host copy of roman_tpu/map/global_nearest_neighbor.py).

The reference builds a dense score matrix with a python double loop and
solves Hungarian with augmented no-association columns
(global_nearest_neighbor.py:5-50); here scoring is batched inside the
mappers and the assignment solver is exposed under the reference name.
"""

import numpy as np

from roman_tpu_torch.ops.hungarian import _M, assignment_with_rejection_np


def global_nearest_neighbor(scores):
    """Maximizing assignment with rejection over a (n_a, n_b) SIMILARITY
    matrix in [0, 1] (non-positive entries never associate — the
    reference thresholds per metric before solving). Returns a list of
    (row, col) pairs — the reference's return contract."""
    scores = np.asarray(scores, float)
    cost = np.where(scores > 0.0, -scores, _M)
    return assignment_with_rejection_np(cost)
