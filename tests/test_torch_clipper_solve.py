"""How the CLIPPER solve kernel's wrapper spreads pairs over the card, on
the CPU: the blocks per pair (the thread block cluster size) that
``cluster_size`` picks from the pair count and the card's SM count; and the
restart noise it keeps on each device (``device_noise``)."""

import numpy as np
import pytest
import torch

from roman_tpu_torch.align.clipper import restart_noise
from roman_tpu_torch.align.clipper_solve import MAX_CLUSTER, cluster_size, device_noise

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


def test_the_restart_noise_is_kept_once_for_each_shape_and_device():
    """One tensor for each (R, N, device), equal to restart_noise(R, N);
    distinct keys give distinct tensors."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    a = device_noise(3, 20, cpu)
    assert device_noise(3, 20, cpu) is a
    assert np.array_equal(a.numpy(), restart_noise(3, 20))
    others = [device_noise(3, 21, cpu), device_noise(2, 20, cpu), device_noise(3, 20, meta)]
    assert len({id(x) for x in [a] + others}) == 4
    assert others[2].device == meta and others[2].shape == (3, 20)
    assert np.array_equal(others[0].numpy(), restart_noise(3, 21))
    assert np.array_equal(others[1].numpy(), restart_noise(2, 20))
