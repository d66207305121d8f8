"""The per-pair registration classes on the card against their CPU runs.

Needs a CUDA card and nvcc; without a card every test skips. Imports
nothing of JAX:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \
        -m cuda tests/test_torch_object_registration_cuda.py

One pair at a time, each side at its own size, so the four kernels run at
shapes the pair grid never gives them: 1 x 1, 1 x m, n != m with N % 8 !=
0 (clipper_solve's register-load path), 100 x 100 (N = 10,000), with no
descriptors (no cosine term), 3-d and 768-d ones. Limits: associations
equal to the CPU's, T_align within 1e-4; the largest square the kernels
take runs (its selections equal to the plain path's on the card), and the
shapes just above the limits of clipper_solve and round_refine raise
ValueError before any launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from roman_tpu_torch.align import fused_register as fr
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.dist_reg_with_pruning import DistRegWithPruning
from roman_tpu_torch.align.object_registration import (ObjectRegistration,
                                                       segments_to_features)
from roman_tpu_torch.align.roman_registration import ROMANParams, ROMANRegistration
from roman_tpu_torch.map.roman_map import SegmentData

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def pair(n, m, D, seed=0):
    """n and m objects; the first min(n, m) of the second map are the first
    map's under a yaw and a shift with 2 cm of noise, their descriptors
    noisy copies (D of them, or none)."""
    rng = np.random.default_rng(seed)
    k = min(n, m)

    def draw(count):
        return (rng.uniform(-20, 20, (count, 3)) * [1.0, 1.0, 0.1],
                rng.uniform(0.5, 4.0, count), rng.dirichlet(np.ones(3), count),
                rng.normal(size=(count, D)) if D else None)

    (c1, v1, p1, d1), (c2, v2, p2, d2) = draw(n), draw(m)
    a = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    t = rng.uniform(-5, 5, 3)
    c2[:k] = (c1[:k] - t) @ R + rng.normal(scale=0.02, size=(k, 3))
    v2[:k], p2[:k] = v1[:k], p1[:k]
    if D:
        d2[:k] = d1[:k] + rng.normal(scale=0.1, size=(k, D))

    def segs(c, v, p, d, id0):
        return [SegmentData(id=id0 + i, center=c[i], volume=float(v[i]),
                            linearity=float(p[i, 0]), planarity=float(p[i, 1]),
                            scattering=float(p[i, 2]), extent=np.ones(3),
                            semantic_descriptor=None if d is None else d[i])
                for i in range(len(c))]

    return segs(c1, v1, p1, d1, 0), segs(c2, v2, p2, d2, 1000)


def classes(device, D):
    return [ROMANRegistration(ROMANParams(gravity=True, volume=True, pca=True,
                                          semantics_dim=D, cos_min=0.5, cos_max=0.9),
                              device=device),
            DistRegWithPruning(0.4, 0.6, mindist=0.2, cos_min=0.5, device=device)]


@pytest.mark.parametrize("D", [0, 3, 768])
@pytest.mark.parametrize("n,m", [(1, 1), (1, 40), (7, 13), (100, 100)])
def test_per_pair_classes_match_the_cpu(dev, n, m, D):
    s1, s2 = pair(n, m, D, seed=n * 1000 + m + D)
    for card, cpu in zip(classes(dev, D), classes("cpu", D)):
        A, B = card.register(s1, s2), cpu.register(s1, s2)
        np.testing.assert_array_equal(A, B)
        if A.size and len(A) >= 3:
            np.testing.assert_allclose(card.T_align(s1, s2, A), cpu.T_align(s1, s2, B),
                                       atol=1e-4)
    if min(n, m) >= 7:
        assert len(A) >= min(n, m, 64) // 2


def test_register_launches_all_four_kernels(dev):
    """A register call of each class launches every kernel of the
    registration once: the fused path's four and the finish's arun_align."""
    s1, s2 = pair(7, 13, 768, seed=5)
    for reg in classes(dev, 768):
        for k in fr.KERNELS:
            k.launches = 0
        reg.register(s1, s2)
        assert all(k.launches == 1 for k in fr.KERNELS), [k.launches for k in fr.KERNELS]


def test_largest_shape_runs_and_the_next_raises_value_error(dev):
    k = fr.largest_side(1, dev)
    assert 64 <= k < fr.ROUND_MAX_SIDE
    reg = ObjectRegistration(dataclasses.replace(
        classes(dev, 768)[0].cfg,
        solver=ClipperSolveParams(warmup_iters=1, outer_iters=1, inner_iters=1)),
        device=dev)
    s1, s2 = pair(k, k, 768, seed=7)
    f1 = segments_to_features(s1, reg.cfg, device=dev)
    f2 = segments_to_features(s2, reg.cfg, device=dev)
    inv = fr.FusedInvariantStatics(cos_min=0.5, cos_max=0.9)
    got = fr.fused_register(f1, f2, inv, reg.cfg.solver)
    ref = fr.fused_register_plain(f1, f2, inv, reg.cfg.solver)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    del got, ref
    for n, m, name in ((k + 1, k + 1, "clipper_solve"), (1, fr.ROUND_MAX_SIDE + 1,
                                                         "round_refine")):
        before = [kk.launches for kk in fr.KERNELS]
        s1, s2 = pair(n, m, 768, seed=8)
        with pytest.raises(ValueError, match=name):
            reg.register(s1, s2)
        assert [kk.launches for kk in fr.KERNELS] == before
