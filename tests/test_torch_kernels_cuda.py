"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA card and nvcc; without a card every test skips. These tests
import nothing of JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \
        -m cuda tests/test_torch_kernels_cuda.py

Inputs are sim pair problems at the bench shapes (capacity 40, 768-d
descriptors, N = 1600 associations per pair), made from a numpy seed.
Tolerances:
- assoc_terms: scores and single scores within 1e-5 (the cosine's f32 dot
  sums in another order than the twin's matrix product), flags equal;
- build_affinity: at most one bf16 ulp per entry (expf/logf/sqrtf may
  differ from PyTorch's in the last f32 bit before the bf16 rounding);
- clipper_solve: u within 2e-3, d, F and omega within rtol 1e-3 (the
  kernel splits each matvec's sums into column slices and row segments,
  the twin's matrix product sums in its own order); two launches on the
  same inputs bitwise equal;
- round_refine and the whole fused path: selections and counts equal.
"""

import numpy as np
import pytest
import torch

from roman_tpu_torch.align import fused_register as fr
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.clipper_solve import (clipper_solve,
                                                 clipper_solve_plain,
                                                 cluster_size)
from roman_tpu_torch.align.registration import rescue_solver
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.sim import world

pytestmark = pytest.mark.cuda

CAP, DESC = 40, 768
INV = fr.FusedInvariantStatics(cos_min=0.5, cos_max=0.9)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _features(dev, P=8, cap1=CAP, cap2=CAP, seed=0):
    """Padded features of P sim pair problems with 25 common objects."""
    rng = np.random.default_rng(seed)
    probs = [world.make_pair_problem(rng, n_common=25, n_only1=cap1 - 26,
                                     n_only2=cap2 - 26, desc_dim=DESC)
             for _ in range(P)]

    def pad(x, cap):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:len(x)] = x
        return out

    feats = []
    for k, cap in ((1, cap1), (2, cap2)):
        def st(fn):
            return torch.tensor(np.stack([pad(fn(p), cap) for p in probs]),
                                device=dev)
        feats.append(SubmapFeatures(
            centers=st(lambda p: getattr(p, f"centers{k}")),
            ratio_feats=st(lambda p: np.concatenate(
                [getattr(p, f"pca{k}"), getattr(p, f"volume{k}")[:, None]], 1)),
            descriptors=st(lambda p: getattr(p, f"desc{k}")),
            valid=torch.tensor(np.stack(
                [np.arange(cap) < len(getattr(p, f"centers{k}")) for p in probs]),
                device=dev)))
    return feats


@pytest.fixture(scope="module")
def stages(dev):
    """Inputs of every stage, each computed by the plain twin of the stage
    before it."""
    f1, f2 = _features(dev)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    assoc = (f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors,
             valid, INV)
    hl, nz, single, vflat = fr.assoc_terms_plain(*assoc)
    build = (f1.centers, f2.centers, hl, nz, single, vflat, INV)
    M = fr.build_affinity_plain(*build)
    return dict(assoc=assoc, build=build, M=M, vflat=vflat)


def test_assoc_terms_matches_plain(stages):
    hl_k, nz_k, single_k, vflat_k = fr.assoc_terms(*stages["assoc"])
    hl_p, nz_p, single_p, vflat_p = fr.assoc_terms_plain(*stages["assoc"])
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.exp(2 * hl_k) * nz_k,
                               torch.exp(2 * hl_p) * nz_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(single_k, single_p, rtol=0, atol=1e-5)
    assert torch.equal(nz_k, nz_p) and torch.equal(vflat_k, vflat_p)


def test_build_affinity_within_one_bf16_ulp(stages):
    M_k = fr.build_affinity(*stages["build"])
    torch.cuda.synchronize()
    ulps = (M_k.view(torch.int16).int() - stages["M"].view(torch.int16).int()).abs()
    assert ulps.max().item() <= 1
    assert (M_k.float() >= 0).all()


@pytest.mark.parametrize("restarts", [1, 3])
def test_clipper_solve_matches_plain(stages, restarts):
    params = ClipperSolveParams(n_restarts=restarts)
    k = clipper_solve(stages["M"], stages["vflat"], CAP, CAP, params)
    p = clipper_solve_plain(stages["M"], stages["vflat"], CAP, CAP, params)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=2e-3)
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    assert torch.isfinite(k[0]).all()


def _prepared(dev, P, cap1=CAP, cap2=CAP, seed=0, invalid=()):
    """The plain twins' (P, N, N) affinity and (P, N) valid mask of P sim
    pair problems; the pairs in `invalid` have no valid object."""
    f1, f2 = _features(dev, P=P, cap1=cap1, cap2=cap2, seed=seed)
    for k in invalid:
        f1.valid[k] = False
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    hl, nz, single, vflat = fr.assoc_terms_plain(
        f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors, valid, INV)
    return fr.build_affinity_plain(f1.centers, f2.centers, hl, nz, single, vflat,
                                   INV), vflat


@pytest.fixture(scope="module")
def batch33(dev):
    return _prepared(dev, P=33, seed=3)


def _assert_solve_close(k, p):
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=2e-3)
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    assert all(torch.isfinite(x).all() for x in k)


@pytest.mark.parametrize("restarts", [1, 3, 8])
@pytest.mark.parametrize("P", [1, 3, 8, 33])
def test_clipper_solve_matches_plain_at_every_cluster_size(batch33, P, restarts):
    """P = 1, 3, 8 and 33 run clusters of 8, 8, 8 and 4 blocks on 132 SMs."""
    M, vflat = batch33[0][:P].contiguous(), batch33[1][:P].contiguous()
    params = ClipperSolveParams(n_restarts=restarts)
    _assert_solve_close(clipper_solve(M, vflat, CAP, CAP, params),
                        clipper_solve_plain(M, vflat, CAP, CAP, params))


@pytest.mark.parametrize("case", ["rescue_budget", "edge_shape"])
def test_clipper_solve_matches_plain_on_edge_cases(dev, batch33, case):
    """The rescue budget (16, 16, 12) on a rescue-sized chunk; and n != m
    with a misaligned N = 39 * 35 (one-column loads) and one all-invalid
    pair, which gives u = 0."""
    if case == "rescue_budget":
        M, vflat = batch33[0][:5].contiguous(), batch33[1][:5].contiguous()
        n, m, params = CAP, CAP, rescue_solver(ClipperSolveParams())
    else:
        M, vflat = _prepared(dev, P=4, cap1=39, cap2=35, seed=1, invalid=(3,))
        n, m, params = 39, 35, ClipperSolveParams(n_restarts=3)
    k = clipper_solve(M, vflat, n, m, params)
    _assert_solve_close(k, clipper_solve_plain(M, vflat, n, m, params))
    if case == "edge_shape":
        assert (k[0][3] == 0).all() and k[2][3] == 0 and k[3][3] == 0


@pytest.mark.parametrize("P", [3, 33])
def test_clipper_solve_is_deterministic(batch33, P):
    M, vflat = batch33[0][:P].contiguous(), batch33[1][:P].contiguous()
    params = ClipperSolveParams(n_restarts=3)
    a = clipper_solve(M, vflat, CAP, CAP, params)
    b = clipper_solve(M, vflat, CAP, CAP, params)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_clipper_solve_does_not_depend_on_the_batch(batch33):
    """Pair 0 alone (a cluster of 8) and inside a batch of 33 (a cluster of
    4): u within 2e-3 and the same rounded and refined selection."""
    M, vflat = batch33
    assert (cluster_size(1, 132), cluster_size(33, 132)) == (8, 4)
    alone = clipper_solve(M[:1].contiguous(), vflat[:1].contiguous(), CAP, CAP)
    batch = clipper_solve(M, vflat, CAP, CAP)
    torch.testing.assert_close(alone[0][0], batch[0][0], rtol=0, atol=2e-3)
    sel_a = fr.round_refine(M[:1].contiguous(), alone[0], alone[2], alone[3], CAP, CAP, INV)
    sel_b = fr.round_refine(M, batch[0], batch[2], batch[3], CAP, CAP, INV)
    assert torch.equal(sel_a[0][0], sel_b[0][0]) and sel_a[1][0] == sel_b[1][0]


def test_round_refine_matches_plain(stages):
    u, _, F, omega = clipper_solve_plain(stages["M"], stages["vflat"], CAP, CAP)
    k = fr.round_refine(stages["M"], u, F, omega, CAP, CAP, INV)
    p = fr.round_refine_plain(stages["M"], u, F, omega, CAP, CAP, INV)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert (k[1] >= 4).all()


def test_fused_register_matches_plain_on_edge_inputs(dev):
    """n != m with an odd N = 39 * 35 (the solve's one-column loads), an
    association mask and one all-invalid pair; every launch is counted."""
    f1, f2 = _features(dev, P=4, cap1=39, cap2=35, seed=1)
    f1.valid[3] = False
    mask = torch.tensor(np.random.default_rng(2).uniform(size=(4, 39, 35)) > 0.1,
                        device=dev)
    before = [k.launches for k in fr.KERNELS]
    k = fr.fused_register(f1, f2, INV, assoc_mask=mask)
    p = fr.fused_register_plain(f1, f2, INV, assoc_mask=mask)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(fr.KERNELS, before)] == [1, 1, 1, 1]
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    torch.testing.assert_close(k[2], p[2], rtol=0, atol=2e-3)
    assert k[1][3].item() == 0 and (k[2][3] == 0).all()
    assert torch.isfinite(k[2]).all() and torch.isfinite(k[3]).all()


@pytest.mark.parametrize("cap", [48, 64])
def test_fused_register_matches_plain_at_larger_capacities(dev, cap):
    """Capacities 48 and 64 (N = 2304 and 4096), where the solve's shared
    memory passes 48 KB."""
    f1, f2 = _features(dev, P=2, cap1=cap, cap2=cap, seed=cap)
    k = fr.fused_register(f1, f2, INV)
    p = fr.fused_register_plain(f1, f2, INV)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    torch.testing.assert_close(k[2], p[2], rtol=0, atol=2e-3)
    assert (k[1] >= 4).all()
