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
  differ from PyTorch's in the last f32 bit before the bf16 rounding); 0
  ulps on the edge cases, as on the bench chunk;
- clipper_solve: u within 2e-3, d, F and omega within rtol 1e-3 (the
  kernel splits each matvec's sums into column slices and row segments,
  the twin's matrix product sums in its own order); two launches on the
  same inputs bitwise equal (so are two launches of assoc_terms and of
  build_affinity);
- round_refine, the whole fused path and arithmetic-mean registration:
  selections and counts equal;
- arun_align (the registration's T_align) against its twin's library
  SVD: where T is unique, the rotation within 1e-4, T within 1e-4 near the
  origin, and 240 m off (where f32 rounds t to about 1e-4) the selected
  centers each T moves within 1e-4 of each other; a proper rotation at every
  count; a pair's T bitwise the same at any batch size and position.
The dense path (the benchmark's no-GPU cell: no descriptors, so nearly
every row of M is live and clipper_solve reads a compact copy of M's
nonzeros) is held to the same tolerances on its grid's first 64 pairs; the
compact form is bitwise the streamed solve on random sparse M.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from roman_tpu_torch.align import clipper_solve as cs_mod
from roman_tpu_torch.align import fused_register as fr
from roman_tpu_torch.align import registration
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.clipper_solve import (clipper_solve,
                                                 clipper_solve_plain,
                                                 cluster_size)
from roman_tpu_torch.align.registration import RegistrationConfig, rescue_solver
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.ops import arun as arun_mod
from roman_tpu_torch.sim import world

from chip_smoke import arun_unique

pytestmark = pytest.mark.cuda

CAP, DESC = 40, 768
INV = fr.FusedInvariantStatics(cos_min=0.5, cos_max=0.9)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _features(dev, P=8, cap1=CAP, cap2=CAP, seed=0):
    """Padded features of P sim pair problems with 25 common objects (fewer
    below capacity 27), one padded slot each."""
    rng = np.random.default_rng(seed)
    common = min(25, cap1 - 2, cap2 - 2)
    probs = [world.make_pair_problem(rng, n_common=common,
                                     n_only1=cap1 - 1 - common,
                                     n_only2=cap2 - 1 - common, desc_dim=DESC)
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


def _grid_chunk(dev, P=64):
    """(M, vflat) of the first P pairs of the benchmark's grid
    (benchmark/world.py's scene under its configuration), by the fused
    path's first two kernels: the sparse M of the demo's grid, where about
    9 of 1,600 rows a pair hold a nonzero."""
    import json

    from benchmark import world as bworld
    from benchmark.entries import align_common

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "roman-demo-align.json")) as f:
        config = json.load(f)
    subs = bworld.make_scene(config)
    pi, pj = (g[:P] for g in bworld.full_grid(subs))
    f1, f2 = (align_common.features(s, dev).map(
        lambda x, k=k: x[torch.as_tensor(k, device=dev)].contiguous())
        for s, k in zip(subs, (pi, pj)))
    inv = registration.fused_statics(align_common.registration_config(config), f1)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    hl, nz, single, vflat = fr.assoc_terms(f1.ratio_feats, f1.descriptors,
                                           f2.ratio_feats, f2.descriptors, valid, inv)
    return fr.build_affinity(f1.centers, f2.centers, hl, nz, single, vflat, inv), vflat


@pytest.fixture(scope="module")
def grid64(dev):
    return _grid_chunk(dev)


def _live_rows(M):
    """Each pair's rows of M that hold a nonzero, counted on the host."""
    return (M != 0).any(dim=-1).sum(dim=-1).cpu()


def _counted_solve(M, vflat, n, m, params):
    """clipper_solve under a profiler, with its counters: (outputs,
    solve.pairs, solve.live_rows, solve.resident_pairs,
    solve.compact_pairs)."""
    from torch.profiler import ProfilerActivity, profile

    from roman_tpu_torch import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = clipper_solve(M, vflat, n, m, params)
    torch.cuda.synchronize()
    counts = [tracing.counter(k) for k in ("solve.pairs", "solve.live_rows",
                                           "solve.resident_pairs",
                                           "solve.compact_pairs")]
    tracing.reset()
    return (out, *counts)


@pytest.mark.parametrize("budget", ["r1", "r2", "r8", "rescue"])
def test_clipper_solve_matches_plain_on_the_grid_chunk(grid64, budget):
    """The cell's sparse chunk (64 pairs, clusters of 2): every pair keeps
    its live rows on chip after the first pass, and the solve agrees with
    the twin at 1, 2 and 8 restarts and at the rescue budget."""
    M, vflat = grid64
    params = (rescue_solver(ClipperSolveParams()) if budget == "rescue"
              else ClipperSolveParams(n_restarts=int(budget[1:])))
    assert cluster_size(64, 132) == 2
    out, pairs, live, resident, compact = _counted_solve(M, vflat, CAP, CAP, params)
    _assert_solve_close(out, clipper_solve_plain(M, vflat, CAP, CAP, params))
    assert (pairs, resident, compact) == (64, 64, 0)
    assert live == _live_rows(M).sum().item() < 0.03 * 64 * CAP * CAP


def _edited(grid64, case):
    """The grid chunk with one pair edited. At 64 pairs a cluster has 2
    blocks of 800 columns each."""
    M, vflat = grid64[0].clone(), grid64[1].clone()
    if case == "overflow_one_block":
        # 400 live rows in block 0's slice: more than its area holds (at
        # most 232,448 / (2 * 800 + 4) rows), but few nonzeros, so it reads
        # them from the compact form; block 1 keeps its few rows
        M[0, :400, :8] = 0.25
    elif case == "live_in_one_slice":
        # a dead row of pair 1 gets one nonzero, in block 1's slice only
        r = int(torch.nonzero((M[1] == 0).all(dim=-1))[0])
        M[1, r, 1500] = 0.5
    elif case == "all_dead":
        M[2] = 0
        vflat[2] = 0
    return M, vflat


@pytest.mark.parametrize("case", ["overflow_one_block", "live_in_one_slice", "all_dead"])
def test_clipper_solve_resident_rows_on_edited_grid_chunks(grid64, case):
    """A block whose live rows overflow its area reads its slice's
    nonzeros from the compact form while the other block of its pair keeps
    its rows; a row live in one block's slice only counts once for the
    pair; an all-dead pair gives u = 0 without NaN."""
    M, vflat = _edited(grid64, case)
    params = ClipperSolveParams(n_restarts=3)
    out, pairs, live, resident, compact = _counted_solve(M, vflat, CAP, CAP, params)
    _assert_solve_close(out, clipper_solve_plain(M, vflat, CAP, CAP, params))
    assert pairs == 64 and live == _live_rows(M).sum().item()
    overflow = case == "overflow_one_block"
    assert (resident, compact) == ((63, 1) if overflow else (64, 0))
    if case == "all_dead":
        assert (out[0][2] == 0).all() and out[2][2] == 0 and out[3][2] == 0


@pytest.mark.parametrize("P", [1, 4])
def test_clipper_solve_register_loads_keep_live_rows(dev, P):
    """Rows of N = 39 * 35 are not 16-byte aligned, so the blocks load M
    into registers; they keep their live rows too (one pair on 8 blocks,
    as a register call runs, and four pairs), and agree with the twin."""
    M, vflat = _prepared(dev, P=P, cap1=39, cap2=35, seed=2)
    params = ClipperSolveParams()
    out, pairs, live, resident, compact = _counted_solve(M, vflat, 39, 35, params)
    _assert_solve_close(out, clipper_solve_plain(M, vflat, 39, 35, params))
    assert (pairs, resident, compact) == (P, P, 0)
    assert live == _live_rows(M).sum().item() > 0


def test_clipper_solve_streams_a_dense_affinity(batch33):
    """A dense M (every row live, as the other fusions build it, and every
    entry a nonzero) streams in every block and agrees with the twin."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    vflat = batch33[1][:8].contiguous()
    M = torch.rand((8, CAP * CAP, CAP * CAP), generator=gen, device="cuda")
    M = M.to(torch.bfloat16)
    params = ClipperSolveParams(n_restarts=2)
    out, pairs, live, resident, compact = _counted_solve(M, vflat, CAP, CAP, params)
    _assert_solve_close(out, clipper_solve_plain(M, vflat, CAP, CAP, params))
    assert (pairs, resident, compact) == (8, 0, 0)
    assert live == _live_rows(M).sum().item() == 8 * CAP * CAP


def _sparse_and_filled(dev, P, n, m, seed):
    """A random M of P pairs of N = n * m at about 4% density, a valid
    mask that marks every other run of 8 columns invalid, and the same M
    with the invalid columns full of nonzeros: every block's slice then
    holds more nonzeros than a quarter of its dense bytes allow."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = n * m
    M = torch.rand((P, N, N), generator=gen, device=dev)
    M = torch.where(torch.rand((P, N, N), generator=gen, device=dev) < 0.04, M, 0.0)
    invalid = torch.arange(N, device=dev) // 8 % 2 == 1
    vflat = (~invalid).float().expand(P, N).contiguous()
    filled = M.clone()
    filled[:, :, invalid] = 0.5 + torch.rand((P, N, int(invalid.sum())),
                                             generator=gen, device=dev)
    return M.to(torch.bfloat16), filled.to(torch.bfloat16), vflat


@pytest.mark.parametrize("path", ["ring", "register_loads"])
def test_clipper_solve_compact_form_is_bitwise_the_streamed_solve(dev, path):
    """On the bulk ring (N = 1600) and the register-load path (N = 39 x 35),
    64 pairs: a sparse M that every block reads from the compact form, and
    the same M with its invalid columns filled, which every block streams.
    An invalid column's entries reach only its own sum, which the valid mask
    zeroes, so u, d, F and omega are bitwise equal."""
    n, m = (CAP, CAP) if path == "ring" else (39, 35)
    M, filled, vflat = _sparse_and_filled(dev, 64, n, m, seed=5)
    params = ClipperSolveParams(n_restarts=2)
    compact = _counted_solve(M, vflat, n, m, params)
    streamed = _counted_solve(filled, vflat, n, m, params)
    assert compact[1:] == (64, 64 * n * m, 0, 64)
    assert streamed[1:] == (64, 64 * n * m, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(compact[0], streamed[0]))
    _assert_solve_close(compact[0], clipper_solve_plain(M, vflat, n, m, params))


def test_clipper_solve_on_the_grid_chunk_is_deterministic_and_batch_independent(grid64):
    """Two launches on the sparse chunk are bitwise equal; its first 40
    pairs, solved alone at the same cluster size, are bitwise those of the
    64; and pair 0 alone (a cluster of 8) rounds to the same selection."""
    M, vflat = grid64
    params = ClipperSolveParams(n_restarts=3)
    a = clipper_solve(M, vflat, CAP, CAP, params)
    b = clipper_solve(M, vflat, CAP, CAP, params)
    assert cluster_size(40, 132) == cluster_size(64, 132)
    c = clipper_solve(M[:40].contiguous(), vflat[:40].contiguous(), CAP, CAP, params)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[:40], y) for x, y in zip(a, c))
    alone = clipper_solve(M[:1].contiguous(), vflat[:1].contiguous(), CAP, CAP, params)
    torch.testing.assert_close(alone[0][0], a[0][0], rtol=0, atol=2e-3)
    sel_a = fr.round_refine(M[:1].contiguous(), alone[0], alone[2], alone[3], CAP, CAP, INV)
    sel_b = fr.round_refine(M, a[0], a[2], a[3], CAP, CAP, INV)
    assert torch.equal(sel_a[0][0], sel_b[0][0]) and sel_a[1][0] == sel_b[1][0]


def _nosem_chunk(dev, P=64):
    """(f1, f2, statics) of the first P pairs of the benchmark's no-GPU
    cell (roman-demo-nogpu-align: method roman_no_semantics on the same
    scene, descriptor block cut to width 0): shape ratios and gravity
    alone, so nearly every association's row of M holds a nonzero."""
    import dataclasses
    import json

    from benchmark import world as bworld
    from benchmark.entries import align_common

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "roman-demo-nogpu-align.json")) as f:
        config = json.load(f)
    subs = [dataclasses.replace(s, desc=s.desc[..., :0])
            for s in bworld.make_scene(config)]
    pi, pj = (g[:P] for g in bworld.full_grid(subs))
    f1, f2 = (align_common.features(s, dev).map(
        lambda x, k=k: x[torch.as_tensor(k, device=dev)].contiguous())
        for s, k in zip(subs, (pi, pj)))
    return f1, f2, registration.fused_statics(align_common.registration_config(config), f1)


@pytest.fixture(scope="module")
def nosem64(dev):
    return _nosem_chunk(dev)


def test_assoc_terms_and_build_affinity_match_plain_on_the_dense_chunk(nosem64):
    """The D = 0 path of assoc_terms (one ratio term, no cosine) and
    build_affinity on the dense chunk, with tracing on: scores within 1e-5,
    flags equal, M within one bf16 ulp, and the kernel's count of nonzeros
    off the diagonal equal to the twin's M's, pair by pair in sum."""
    from torch.profiler import ProfilerActivity, profile

    from roman_tpu_torch import tracing

    f1, f2, inv = nosem64
    assert f1.descriptors.shape[-1] == 0 and inv.use_ratio and not inv.use_cosine
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    args = (f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors, valid, inv)
    hl_k, nz_k, single_k, vflat_k = fr.assoc_terms(*args)
    hl, nz, single, vflat = fr.assoc_terms_plain(*args)
    torch.testing.assert_close(torch.exp(2 * hl_k) * nz_k, torch.exp(2 * hl) * nz,
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(single_k, single, rtol=0, atol=1e-5)
    assert torch.equal(nz_k, nz) and torch.equal(vflat_k, vflat)
    build_args = (f1.centers, f2.centers, hl, nz, single, vflat, inv)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        M_k = fr.build_affinity(*build_args)
    torch.cuda.synchronize()
    pairs, counted = tracing.counter("affinity.pairs"), tracing.counter("affinity.nonzeros")
    tracing.reset()
    M_p = fr.build_affinity_plain(*build_args)
    ulps = (M_k.view(torch.int16).int() - M_p.view(torch.int16).int()).abs()
    assert ulps.max().item() <= 1
    live = (M_p != 0).any(dim=-1).sum(dim=-1)
    assert (live >= 0.95 * vflat.sum(-1)).all()  # dense: nearly every row live
    assert pairs == 64
    assert counted == fr.offdiag_nonzeros(M_p).sum().item() == fr.offdiag_nonzeros(M_k).sum().item()


@pytest.mark.parametrize("budget", ["main", "rescue"])
def test_clipper_solve_and_round_refine_match_plain_on_the_dense_chunk(nosem64, budget):
    """The dense chunk reads M's nonzeros from the compact form in every
    block (no pair keeps its rows on chip, none streams), at the main and
    the rescue budget; the solve agrees with the twin and round_refine, on
    the twin's solve, selects as its twin."""
    f1, f2, inv = nosem64
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    hl, nz, single, vflat = fr.assoc_terms_plain(f1.ratio_feats, f1.descriptors,
                                                 f2.ratio_feats, f2.descriptors, valid, inv)
    M = fr.build_affinity_plain(f1.centers, f2.centers, hl, nz, single, vflat, inv)
    params = (rescue_solver(ClipperSolveParams()) if budget == "rescue"
              else ClipperSolveParams())
    out, pairs, live, resident, compact = _counted_solve(M, vflat, CAP, CAP, params)
    p = clipper_solve_plain(M, vflat, CAP, CAP, params)
    _assert_solve_close(out, p)
    assert (pairs, resident, compact) == (64, 0, 64)
    assert live == _live_rows(M).sum().item()
    k = fr.round_refine(M, p[0], p[2], p[3], CAP, CAP, inv)
    q = fr.round_refine_plain(M, p[0], p[2], p[3], CAP, CAP, inv)
    torch.cuda.synchronize()
    assert torch.equal(k[0], q[0]) and torch.equal(k[1], q[1])


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
    # the fused path's four; the fifth, arun_align, is the finish's
    assert [k.launches - b for k, b in zip(fr.KERNELS, before)] == [1, 1, 1, 1, 0]
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


def _valid(f1, f2):
    return (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()


def _assert_assoc_close(k, p):
    torch.testing.assert_close(torch.exp(2 * k[0]) * k[1],
                               torch.exp(2 * p[0]) * p[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(k[2], p[2], rtol=0, atol=1e-5)
    assert torch.equal(k[1], p[1]) and torch.equal(k[3], p[3])


# name: (P, cap1, cap2, features F and D kept, what else changes)
ASSOC_CASES = {
    "d33": (4, CAP, CAP, None, 33, None),
    "d0_cosine_on": (4, CAP, CAP, None, 0, None),
    "f0": (4, CAP, CAP, 0, None, "no_ratio"),
    "d0_f0": (4, CAP, CAP, 0, 0, "no_terms"),
    "zero_norm": (4, 39, 35, None, None, "zero_norm"),
    "p1": (1, CAP, CAP, None, None, None),
    "p33": (33, CAP, CAP, None, None, None),
    "m70_two_passes": (2, 13, 70, None, None, None),
}


@pytest.mark.parametrize("case", list(ASSOC_CASES))
def test_assoc_terms_matches_plain_on_edge_cases(dev, case):
    """D not a multiple of 4 (one-float copies), D = 0 (every descriptor
    missing), F = 0 and D = 0 with their terms off as the fused path sets
    them, zero-norm descriptors, 1 and 33 pairs, and m = 70 (two passes
    over the columns)."""
    P, cap1, cap2, F, D, what = ASSOC_CASES[case]
    f1, f2 = _features(dev, P=P, cap1=cap1, cap2=cap2, seed=len(case))
    r1, r2 = f1.ratio_feats[..., :F].contiguous(), f2.ratio_feats[..., :F].contiguous()
    d1, d2 = f1.descriptors[..., :D].contiguous(), f2.descriptors[..., :D].contiguous()
    inv = INV
    if what == "no_ratio":
        inv = dataclasses.replace(INV, use_ratio=False)
    elif what == "no_terms":
        inv = dataclasses.replace(INV, use_ratio=False, use_cosine=False)
    elif what == "zero_norm":
        d1[:, ::3] = 0.0
        d2[:, 1::4] = 0.0
    args = (r1, d1, r2, d2, _valid(f1, f2), inv)
    _assert_assoc_close(fr.assoc_terms(*args), fr.assoc_terms_plain(*args))


# name: (P, cap1, cap2, invariant changes, invalid rows)
BUILD_CASES = {
    "n_ne_m": (4, 40, 23, {}, False),
    "misaligned_13x7": (4, 13, 7, {}, False),
    "capacity64": (2, 64, 64, {}, False),
    "no_gravity": (4, CAP, CAP, {"gravity": False}, False),
    "terms0": (4, CAP, CAP, {"use_ratio": False, "use_cosine": False}, False),
    "terms1": (4, CAP, CAP, {"use_ratio": False}, False),
    "terms2": (4, CAP, CAP, {}, False),
    "invalid_rows": (4, CAP, CAP, {}, True),
    "p1": (1, CAP, CAP, {}, False),
    "p3": (3, CAP, CAP, {}, False),
    "p33": (33, CAP, CAP, {}, False),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_affinity_bitwise_on_edge_cases(dev, case):
    """0 bf16 ulps against the twin: n != m, N = 91 (rows not 16-byte
    aligned: 2-byte stores), capacity 64 (more than 48 KB of shared
    memory), gravity off, 0, 1 and 2 terms, invalid rows and an all-invalid
    pair, and 1, 3 and 33 pairs."""
    P, cap1, cap2, changes, invalid = BUILD_CASES[case]
    f1, f2 = _features(dev, P=P, cap1=cap1, cap2=cap2, seed=len(case))
    if invalid:
        f1.valid[:, 5:9] = False
        f2.valid[0, :] = False
    inv = dataclasses.replace(INV, **changes)
    terms = fr.assoc_terms_plain(f1.ratio_feats, f1.descriptors, f2.ratio_feats,
                                 f2.descriptors, _valid(f1, f2), inv)
    args = (f1.centers, f2.centers, *terms, inv)
    M_k, M_p = fr.build_affinity(*args), fr.build_affinity_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(M_k.view(torch.int16), M_p.view(torch.int16))
    if invalid:
        assert (M_k[0] == 0).all()


def test_assoc_terms_and_build_affinity_are_deterministic(stages):
    a, b = fr.assoc_terms(*stages["assoc"]), fr.assoc_terms(*stages["assoc"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    M_a, M_b = fr.build_affinity(*stages["build"]), fr.build_affinity(*stages["build"])
    torch.cuda.synchronize()
    assert torch.equal(M_a.view(torch.int16), M_b.view(torch.int16))


def _round_inputs(dev, P, n, m, seed, u=None, F=None):
    """Random rounding inputs on the card: u with many ties (multiples of
    1/4, so equal values across rows and across columns), M uniform in
    [0.2, 1] with 30% zero entries (zero edges for the refinement), F and
    omega uniform."""
    rng = np.random.default_rng(seed)
    N = n * m
    if u is None:
        u = np.round(rng.uniform(size=(P, N)) * 4) / 4
    M = rng.uniform(0.2, 1.0, size=(P, N, N))
    M[rng.uniform(size=M.shape) < 0.3] = 0.0
    if F is None:
        F = rng.uniform(1, 8, size=P)
    om = rng.uniform(0, 8, size=P)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    return (t(M).to(torch.bfloat16), t(np.broadcast_to(u, (P, N))).contiguous(),
            t(F), t(om), n, m, INV)


def _sim_round_inputs(dev, P, n, m, seed, params=ClipperSolveParams()):
    """Sim pair problems solved by the plain solve, as on the main path."""
    M, vflat = _prepared(dev, P=P, cap1=n, cap2=m, seed=seed)
    u, _, F, om = clipper_solve_plain(M, vflat, n, m, params)
    return M, u, F, om, n, m, INV


def _many_selected(dev, equal_u=False):
    """n = m = 100 (N = 10000, M of 200 MB), max_clique 100: u plants a
    permutation at 0.9-1.0 over 4200 or so other entries above the cut
    (uniform in [0, 0.62)), F = 50 (target 100), so rounding selects 100
    entries after sorting more keys than a band holds; M is zero but for
    the planted block (uniform [0.2, 1], 30% zeros). With equal_u every u
    is 0.5, 10000 keys ordered by index alone, and the block is planted on
    the diagonal entries (i, i) that rounding then selects."""
    n = m = 100
    N = n * m
    rng = np.random.default_rng(100)
    perm = np.arange(m) if equal_u else rng.permutation(m)
    planted = np.arange(n) * m + perm
    u = rng.uniform(0, 0.62, size=N)
    u[planted] = rng.uniform(0.9, 1.0, size=n)
    if equal_u:
        u[:] = 0.5
    block = rng.uniform(0.2, 1.0, size=(n, n))
    block[rng.uniform(size=block.shape) < 0.3] = 0.0
    M = torch.zeros((1, N, N), dtype=torch.bfloat16, device=dev)
    idx = torch.tensor(planted, device=dev)
    M[0, idx[:, None], idx[None, :]] = torch.tensor(
        block, dtype=torch.float32, device=dev).to(torch.bfloat16)
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    return (M, t(u[None]), t([50.0]), t([60.0]), n, m,
            dataclasses.replace(INV, max_clique=100))


# name: inputs on the card (M, u, F, omega, n, m, inv)
ROUND_CASES = {
    "ties_12x9": lambda dev: _round_inputs(dev, 4, 12, 9, 1),
    "all_equal_u": lambda dev: _round_inputs(dev, 2, 13, 7, 2, u=0.5),
    "all_zero_u": lambda dev: _round_inputs(dev, 2, 13, 7, 3, u=0.0),
    "negative_u": lambda dev: _round_inputs(dev, 2, 13, 7, 4, u=-0.25),
    "F_nonpositive": lambda dev: _round_inputs(dev, 2, 13, 7, 5, F=[0.0, -3.0]),
    "F_target_1": lambda dev: _round_inputs(dev, 2, 13, 7, 6, F=[0.3, 0.74]),
    "n_1": lambda dev: _round_inputs(dev, 3, 1, 9, 7),
    "m_1": lambda dev: _round_inputs(dev, 3, 9, 1, 8),
    "sim_13x7": lambda dev: _sim_round_inputs(dev, 3, 13, 7, 9),
    "capacity64": lambda dev: _sim_round_inputs(dev, 2, 64, 64, 64),
    "rescue_p3": lambda dev: _sim_round_inputs(
        dev, 3, CAP, CAP, 3, rescue_solver(ClipperSolveParams())),
    "k_over_64_n100": lambda dev: _many_selected(dev),
    "equal_u_n100": lambda dev: _many_selected(dev, equal_u=True),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_round_refine_matches_plain_on_edge_cases(dev, case):
    """sel and count equal to the twin on inputs chosen to break a sorted
    scan: ties across rows and columns, all-equal u, every u at or below
    the cut, F <= 0 and F giving target 1, n != m and n or m = 1, capacity
    64 (max_steps 64), sim pairs at 13 x 7 and at the rescue budget (the
    rescue launch's 3 pairs), and K > 64 selected at
    n = m = 100 with more keys above the cut than a band holds."""
    M, u, F, om, n, m, inv = ROUND_CASES[case](dev)
    k = fr.round_refine(M, u, F, om, n, m, inv)
    p = fr.round_refine_plain(M, u, F, om, n, m, inv)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if case in ("all_zero_u", "negative_u"):
        assert (k[1] == 0).all()
    if case.endswith("n100"):
        assert k[1].item() > 64


def test_arithmetic_mean_registration_reaches_round_refine(dev, monkeypatch):
    """register_clipper with arithmetic-mean fusion launches the solve and
    round_refine kernels and selects as the plain path does."""
    f1, f2 = _features(dev, P=4, seed=11)
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9,
                             fusion="arithmetic_mean")
    before = (clipper_solve.launches, fr.round_refine.launches)
    out = registration.register_clipper(f1, f2, cfg)
    torch.cuda.synchronize()
    assert clipper_solve.launches > before[0] and fr.round_refine.launches > before[1]
    monkeypatch.setattr(cs_mod, "clipper_solve", clipper_solve_plain)
    monkeypatch.setattr(fr, "round_refine", fr.round_refine_plain)
    ref = registration.register_clipper(f1, f2, cfg)
    assert torch.equal(out.sel, ref.sel) and torch.equal(out.count, ref.count)
    torch.testing.assert_close(out.u, ref.u, rtol=0, atol=2e-3)


def test_clipper_prune_registration_matches_plain(dev, monkeypatch):
    """clipper+prune runs the fused path with no ratio and no cosine term
    and a pruned association mask: all five kernels launch (the fused
    path's four and the finish's arun_align), and it selects and aligns as
    the plain twins do."""
    f1, f2 = _features(dev, P=8, seed=12)
    cfg = RegistrationConfig(method="clipper+prune", cos_min=0.5,
                             epsilon_shape=0.5)
    kw = dict(pca_attrs1=f1.ratio_feats[..., :3], volume1=f1.ratio_feats[..., 3],
              pca_attrs2=f2.ratio_feats[..., :3], volume2=f2.ratio_feats[..., 3],
              descriptors1=f1.descriptors, descriptors2=f2.descriptors)
    before = [k.launches for k in fr.KERNELS]
    out = registration.register_clipper_prune(f1, f2, cfg, **kw)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(fr.KERNELS, before))
    monkeypatch.setattr(registration, "fused_register", fr.fused_register_plain)
    monkeypatch.setattr(registration, "arun_align", fr.arun_align_plain)
    ref = registration.register_clipper_prune(f1, f2, cfg, **kw)
    assert torch.equal(out.sel, ref.sel) and torch.equal(out.count, ref.count)
    assert torch.equal(out.ok, ref.ok) and out.ok.any()
    torch.testing.assert_close(out.T_align, ref.T_align, rtol=0, atol=1e-4)
    # the mask pruned candidates that the plain valid mask keeps
    valid = f1.valid[:, :, None] & f2.valid[:, None, :]
    cos = torch.einsum("pnd,pmd->pnm", f1.descriptors, f2.descriptors)
    assert (valid & (cos < cfg.cos_min)).any()


def test_mno_clipper_on_the_card_matches_the_cpu(dev):
    """mno_clipper launches the solve and round_refine kernels for each
    solution and gives the CPU path's solutions."""
    f1, f2 = _features(dev, P=4, seed=13)
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9)
    before = (clipper_solve.launches, fr.round_refine.launches)
    card = registration.mno_clipper(f1, f2, cfg, num_solutions=2)
    torch.cuda.synchronize()
    assert clipper_solve.launches >= before[0] + 2
    assert fr.round_refine.launches >= before[1] + 2
    cpu = registration.mno_clipper(f1.map(lambda x: x.cpu()),
                                   f2.map(lambda x: x.cpu()), cfg, num_solutions=2)
    for (sel_g, cnt_g, _), (sel_c, cnt_c, _) in zip(card, cpu):
        assert torch.equal(sel_g.cpu(), sel_c) and torch.equal(cnt_g.cpu(), cnt_c)
    assert (card[0][1] >= 4).all()


def test_ransac_grid_is_deterministic_and_agrees_with_the_cpu(dev):
    """One seed gives the same draws on both devices; two card runs give
    the same selections, and the loop-closure decisions are the CPU's."""
    from roman_tpu_torch.align.submap_align import PairGridRegistrar

    f1, f2 = _features(dev, P=6, seed=14)
    cfg = RegistrationConfig(method="ransac")
    ids = np.zeros((6, CAP), np.int64)
    pi = pj = np.arange(6)
    runs = [PairGridRegistrar(cfg, chunk_size=4, device=d)(f1, f2, ids, ids, pi, pj,
                                                           seed=5)
            for d in ("cuda", "cuda", "cpu")]
    for name in ("sel", "count", "T_align"):
        assert np.array_equal(getattr(runs[0], name), getattr(runs[1], name))
    lc = [r.ok & (r.count >= 4) for r in runs]
    assert np.array_equal(lc[0], lc[2])
    assert runs[0].converged is None


def _pose_graph(rng, n=40, n_lc=10, n_outliers=4):
    """Two drifted circular odometry chains with cross-robot loop closures,
    some of them outliers (the graphs of tests/test_rpgo.py, in numpy)."""
    from roman_tpu_torch.ops import se3_np
    from roman_tpu_torch.rpgo import g2o_io

    I_odom = g2o_io.info_upper_from_matrix(g2o_io.information_matrix(0.1, np.deg2rad(0.5)))
    I_lc = g2o_io.info_upper_from_matrix(g2o_io.information_matrix(1.0, np.deg2rad(2.0)))

    def xq(T):
        t, q = se3_np.T_to_xyz_quat(T)
        return np.concatenate([t, q])

    gt, vertices, edges = {}, {}, []
    for r, letter in enumerate("ab"):
        poses = np.stack([world.yaw_T(2 * np.pi * k / n + np.pi / 2, np.array(
            [5.0 * r + 20 * np.cos(2 * np.pi * k / n),
             2.0 * r + 20 * np.sin(2 * np.pi * k / n), 0.5 * r])) for k in range(n)])
        gt[letter] = poses
        odom = [poses[0]]
        for k in range(1, n):
            noise = world.yaw_T(rng.normal() * 0.01, rng.normal(size=3) * 0.05)
            odom.append(odom[-1] @ np.linalg.inv(poses[k - 1]) @ poses[k] @ noise)
        for k in range(n):
            vertices[g2o_io.symbol(letter, k)] = xq(odom[k])
        for k in range(n - 1):
            edges.append(g2o_io.G2OEdge(g2o_io.symbol(letter, k), g2o_io.symbol(letter, k + 1),
                                        xq(np.linalg.inv(odom[k]) @ odom[k + 1]), I_odom))
    for k in rng.choice(n, size=n_lc, replace=False):
        T = np.linalg.inv(gt["a"][k]) @ gt["b"][k]
        edges.append(g2o_io.G2OEdge(g2o_io.symbol("a", int(k)), g2o_io.symbol("b", int(k)),
                                    xq(T), I_lc, lc_count=8))
    for _ in range(n_outliers):
        i, j = rng.integers(0, n, 2)
        T = world.yaw_T(rng.uniform(-np.pi, np.pi), rng.uniform(-30, 30, 3))
        edges.append(g2o_io.G2OEdge(g2o_io.symbol("a", int(i)), g2o_io.symbol("b", int(j)),
                                    xq(T), I_lc, lc_count=8))
    return g2o_io.G2OGraph(vertices=vertices, edges=edges)


def test_rpgo_solve_is_bitwise_repeatable_on_the_card(dev, tmp_path):
    """Two card solves write the same result.g2o (the segment sums add in
    a fixed order); the CPU solve rejects the same loop closures and
    places every vertex within 1e-2 m."""
    from roman_tpu_torch.rpgo import g2o_io, solver

    graph = _pose_graph(np.random.default_rng(3))
    g2o_io.write_g2o(graph, str(tmp_path / "in.g2o"))
    outs = []
    for k, d in enumerate(("cuda", "cuda", "cpu")):
        os.makedirs(tmp_path / str(k))
        outs.append(solver.rpgo_solve_g2o(str(tmp_path / "in.g2o"),
                                          str(tmp_path / str(k)), device=d))
    raw = [open(p, "rb").read() for p in outs]
    assert raw[0] == raw[1]
    pos = [np.stack([v[:3] for _, v in sorted(g2o_io.parse_g2o(p).vertices.items())])
           for p in outs]
    assert np.abs(pos[0] - pos[2]).max() <= 1e-2
    diag = [solver.solve_pose_graph(graph, device=d)[1] for d in ("cuda", "cpu")]
    assert diag[0] == diag[1] and diag[0]["n_lc_pcm_rejected"] >= 3


# ---------------------------------------------------------------------------
# arun_align: the registration's T_align
# ---------------------------------------------------------------------------

def _arun_inputs(dev, P, n, m, counts, offset=0.0, reflect=False, seed=0):
    """(c1, c2, sel) of P pairs of n and m centers within 20 m of `offset`
    (a scalar, or a (P, 3) array), pair p selecting counts[p % len(counts)]
    one-to-one associations. Half the pairs' selected centers of map 2 are
    map 1's under a rotation and a shift, with 2 cm of noise; with
    `reflect`, every pair's are map 1's mirrored in z instead, so the
    determinant of their H is negative."""
    rng = np.random.default_rng(seed)
    off = np.broadcast_to(np.asarray(offset, np.float64), (P, 3))[:, None, :]
    c1 = rng.uniform(-20, 20, (P, n, 3)) + off
    c2 = rng.uniform(-20, 20, (P, m, 3)) + off
    sel = np.zeros((P, n, m), bool)
    for p in range(P):
        k = counts[p % len(counts)]
        a, b = rng.permutation(n)[:k], rng.permutation(m)[:k]
        sel[p, a, b] = True
        if reflect:
            c2[p, b] = (c1[p, a] - off[p]) * [1.0, 1.0, -1.0] + off[p]
        elif p % 2:
            q = rng.normal(size=4)
            w, x, y, z = q / np.linalg.norm(q)
            R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                          [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                          [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
            c2[p, b] = (c1[p, a] - off[p]) @ R + off[p] + rng.uniform(-5, 5, 3)
        c2[p, b] += rng.normal(scale=0.02, size=(k, 3))
    return (torch.tensor(c1, dtype=torch.float32, device=dev),
            torch.tensor(c2, dtype=torch.float32, device=dev),
            torch.tensor(sel, device=dev))


def _scene_selection(dev, P=64):
    """(c1, c2, sel) of the first P pairs of the benchmark's grid, sel as
    the card's fused path selects it."""
    import json

    from benchmark import world as bworld
    from benchmark.entries import align_common

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "roman-demo-align.json")) as f:
        config = json.load(f)
    subs = bworld.make_scene(config)
    pi, pj = (g[:P] for g in bworld.full_grid(subs))
    f1, f2 = (align_common.features(s, dev).map(
        lambda x, k=k: x[torch.as_tensor(k, device=dev)].contiguous())
        for s, k in zip(subs, (pi, pj)))
    sel = registration.solve_clipper(f1, f2, align_common.registration_config(config))[0]
    return f1.centers, f2.centers, sel


ARUN_CASES = {
    # n != m, counts 0-3 and up to m, centers near the origin
    "random_p64": lambda dev: _arun_inputs(dev, 64, 40, 31, [0, 1, 2, 3, 5, 17, 31], seed=1),
    "offset240_p64": lambda dev: _arun_inputs(dev, 64, 40, 40, [0, 1, 2, 3, 40, 12],
                                              offset=240.0, seed=2),
    "reflection_p64": lambda dev: _arun_inputs(dev, 64, 23, 40, [3, 8, 23], reflect=True,
                                               offset=-180.0, seed=3),
    "one_pair": lambda dev: _arun_inputs(dev, 1, 7, 13, [6], seed=4),
    "grid_p506": lambda dev: _arun_inputs(
        dev, 506, 40, 40, list(range(41)),
        offset=np.random.default_rng(5).uniform(-240, 240, (506, 3)), seed=5),
    "scene_p64": _scene_selection,
}


@pytest.mark.parametrize("case", list(ARUN_CASES))
def test_arun_align_matches_the_twin(dev, case):
    """The kernel against the plain twin (arun over the expanded centers,
    a library SVD) on the same f32 inputs on the card. Where T is unique
    (chip_smoke.arun_unique), its rotation within 1e-4 of the twin's, and its translation
    within 1e-4 where the centers lie within 40 m of the origin; where they
    lie up to 240 m off, the twin's own f32 rounding of R times the lever
    arm is of that order, so there both T move each selected center of map
    2 to within 1e-4 of each other. At every count a proper rotation
    (orthonormal within 1e-5, det +1), the bottom row 0 0 0 1, and the
    identity where nothing is selected."""
    c1, c2, sel = ARUN_CASES[case](dev)
    before = arun_mod.arun_align.launches
    T = arun_mod.arun_align(c1, c2, sel)
    ref = arun_mod.arun_align_plain(c1, c2, sel)
    torch.cuda.synchronize()
    assert arun_mod.arun_align.launches == before + 1
    T, ref = T.double().cpu(), ref.double().cpu()
    count = sel.sum(dim=(-2, -1)).cpu()
    R = T[:, :3, :3]
    eye = torch.eye(3, dtype=torch.float64)
    assert (R @ R.transpose(1, 2) - eye).abs().max() <= 1e-5
    assert (torch.linalg.det(R) - 1.0).abs().max() <= 1e-5
    assert torch.equal(T[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(len(T), 4))
    assert torch.equal(T[count == 0], torch.eye(4, dtype=torch.float64).expand(
        int((count == 0).sum()), 4, 4))
    ok = torch.as_tensor(arun_unique(c1, c2, sel))
    assert ok.sum() >= (3 if len(T) > 1 else 1), int(ok.sum())
    torch.testing.assert_close(R[ok], ref[ok, :3, :3], rtol=0, atol=1e-4)
    if c1.abs().max() <= 40:
        torch.testing.assert_close(T[ok], ref[ok], rtol=0, atol=1e-4)
    p2 = c2.double().cpu()[ok]
    moved = p2 @ T[ok, :3, :3].transpose(1, 2) + T[ok, None, :3, 3]
    moved_ref = p2 @ ref[ok, :3, :3].transpose(1, 2) + ref[ok, None, :3, 3]
    chosen = sel.cpu()[ok].any(dim=1)  # map 2's selected centers
    assert (moved - moved_ref).abs().amax(dim=-1)[chosen].max() <= 1e-4


def test_arun_align_does_not_depend_on_the_batch(dev):
    """A pair's T is bitwise the same alone and at position 37 of a batch
    of 64, and from launch to launch."""
    c1, c2, sel = _arun_inputs(dev, 64, 40, 40, list(range(3, 41)), offset=120.0, seed=6)
    batch = arun_mod.arun_align(c1, c2, sel)
    again = arun_mod.arun_align(c1, c2, sel)
    alone = arun_mod.arun_align(c1[37:38].contiguous(), c2[37:38].contiguous(),
                                   sel[37:38].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(batch, again)
    assert torch.equal(alone[0], batch[37])
