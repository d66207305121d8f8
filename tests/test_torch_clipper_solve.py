"""How the CLIPPER solve kernel's wrapper spreads pairs over the card, on
the CPU: the blocks per pair (the thread block cluster size) that
``cluster_size`` picks from the pair count and the card's SM count."""

import pytest

from roman_tpu_torch.align.clipper_solve import MAX_CLUSTER, cluster_size

H100_SMS = 132


@pytest.mark.parametrize("P, C", [
    (32, 4),    # the main path's chunk: 128 of 132 SMs
    (26, 4),    # the last chunk of the 506-pair grid
    (2, 8), (10, 8), (16, 8),  # rescue chunks
    (1, 8), (3, 8), (8, 8), (33, 4),  # the card tests' batches
    (64, 2), (66, 2), (67, 1), (128, 1),
])
def test_cluster_size_on_an_h100(P, C):
    assert cluster_size(P, H100_SMS) == C


@pytest.mark.parametrize("sms", [1, 7, 78, 114, 132])
def test_cluster_size_fills_at_most_every_sm(sms):
    for P in range(1, 3 * sms):
        C = cluster_size(P, sms)
        assert 1 <= C <= MAX_CLUSTER and C & (C - 1) == 0
        if P <= sms:
            # the largest such power of two: one more doubling would not fit
            assert P * C <= sms and (C == MAX_CLUSTER or P * 2 * C > sms)
        else:
            assert C == 1
