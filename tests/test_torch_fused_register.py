"""The port's fused path (plain twins) against roman_tpu's fused Pallas
kernel, run in interpret mode as roman_tpu's own tests run it on the CPU.

Three interpret-mode calls: the default roman configuration, an
association mask with n != m, and all-invalid pairs. sel and count must be
equal; u within 2e-3 and F within rtol 1e-3 (f32 sums in other orders).
The per-stage twins are held to roman_tpu's plain invariants, with the
tolerance of one bf16 ulp for the affinity (its log-space formulation
rounds differently from the plain product)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.align import fused_register as jfr
from roman_tpu.align import invariants as jinv

from roman_tpu_torch.align import clipper
from roman_tpu_torch.align import fused_register as tfr
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.clipper_solve import clipper_solve

from test_torch_invariants import _features

torch.set_num_threads(1)

INV = dict(cos_min=0.5, cos_max=0.9)


def _compare(j_out, t_out):
    sel_j, cnt_j, u_j, F_j = (np.asarray(x) for x in j_out)
    sel_t, cnt_t, u_t, F_t = (x.numpy() for x in t_out)
    np.testing.assert_array_equal(sel_t, sel_j)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_allclose(u_t, u_j, atol=2e-3)
    np.testing.assert_allclose(F_t, F_j, rtol=1e-3, atol=1e-6)
    assert np.isfinite(u_t).all()


def test_fused_plain_matches_pallas_kernel():
    (j1, j2), (t1, t2) = _features(3, P=2)
    ref = jfr.fused_register(j1, j2, jfr.FusedInvariantStatics(**INV),
                             interpret=True)
    _compare(ref, tfr.fused_register_plain(t1, t2, tfr.FusedInvariantStatics(**INV)))
    assert (np.asarray(ref[1]) >= 4).all()


def test_fused_plain_matches_with_assoc_mask_and_unequal_sizes():
    (j1, j2), (t1, t2) = _features(4, P=2)
    j2 = jax.tree.map(lambda x: x[:, :9], j2)
    t2 = t2.map(lambda x: x[:, :9])
    mask = np.random.default_rng(4).uniform(size=(2, 12, 9)) > 0.2
    ref = jfr.fused_register(j1, j2, jfr.FusedInvariantStatics(**INV),
                             assoc_mask=jnp.asarray(mask), interpret=True)
    out = tfr.fused_register_plain(t1, t2, tfr.FusedInvariantStatics(**INV),
                                   assoc_mask=torch.tensor(mask))
    assert out[0].shape == (2, 12, 9)
    _compare(ref, out)


def test_fused_plain_all_invalid_gives_zeros():
    (j1, j2), (t1, t2) = _features(5, P=2)
    j1 = j1.replace(valid=jnp.zeros_like(j1.valid))
    t1 = dataclasses.replace(t1, valid=torch.zeros_like(t1.valid))
    ref = jfr.fused_register(j1, j2, jfr.FusedInvariantStatics(**INV),
                             interpret=True)
    out = tfr.fused_register_plain(t1, t2, tfr.FusedInvariantStatics(**INV))
    _compare(ref, out)
    assert (out[1] == 0).all() and (out[2] == 0).all()


def test_stage_twins_match_the_plain_invariants():
    (j1, j2), (t1, t2) = _features(6)
    inv = tfr.FusedInvariantStatics(**INV)
    P, n, m = 3, t1.capacity, t2.capacity
    N = n * m
    valid = (t1.valid[:, :, None] & t2.valid[:, None, :]).float()
    hl, nz, single, vflat = tfr.assoc_terms_plain(
        t1.ratio_feats, t1.descriptors, t2.ratio_feats, t2.descriptors,
        valid, inv)
    p = jinv.ROMANInvariantParams(gravity=True, ratio_epsilon=jnp.zeros(4), **INV)
    single_j, comps = jinv.single_scores(j1, j2, p)
    np.testing.assert_allclose(single.numpy(), np.asarray(single_j).reshape(P, N),
                               atol=1e-6)
    for t, comp in enumerate(comps):  # ratio, then cosine
        score = np.exp(2.0 * hl[:, t].numpy()) * nz[:, t].numpy()
        np.testing.assert_allclose(score, np.asarray(comp).reshape(P, N),
                                   atol=1e-6)
    np.testing.assert_array_equal(vflat.numpy(), valid.reshape(P, N).numpy())

    M = tfr.build_affinity_plain(t1.centers, t2.centers, hl, nz, single,
                                 vflat, inv)
    M4, _ = jinv.affinity(j1, j2, p)
    M_ref = np.asarray(M4.astype(jnp.bfloat16).astype(jnp.float32)).reshape(P, N, N)
    # one bf16 ulp of a value in [0, 1] is at most 2**-8
    np.testing.assert_allclose(M.float().numpy(), M_ref, atol=2.0 ** -8)


def _grid_stages(P):
    """(single, vflat, M) of the plain twins on the first P pairs of the
    benchmark's grid (benchmark/world.py's scene and configuration)."""
    import json
    import os

    from benchmark import world
    from benchmark.entries import align_common
    from roman_tpu_torch.align import registration

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "roman-demo-align.json")) as f:
        config = json.load(f)
    subs = world.make_scene(config)
    pi, pj = (g[:P] for g in world.full_grid(subs))
    f1, f2 = (align_common.features(s, "cpu").map(lambda x, k=k: x[k])
              for s, k in zip(subs, (pi, pj)))
    inv = registration.fused_statics(align_common.registration_config(config), f1)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float()
    hl, nz, single, vflat = tfr.assoc_terms_plain(
        f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors, valid, inv)
    return single, vflat, tfr.build_affinity_plain(f1.centers, f2.centers, hl, nz,
                                                   single, vflat, inv)


@pytest.mark.parametrize("source", ["sim", "grid"])
def test_live_rows_of_the_affinity_are_valid_with_a_single_score(source):
    """What clipper_solve's resident rows rest on: a row of M holds a
    nonzero only where its association is valid and its single score is
    positive (elsewhere the affinity writes the row as zeros), so on the
    demo's grid few rows live (on sim pairs, and on the first 4 pairs of the
    benchmark's grid, where under 3% do)."""
    if source == "sim":
        _, (t1, t2) = _features(6)
        inv = tfr.FusedInvariantStatics(**INV)
        valid = (t1.valid[:, :, None] & t2.valid[:, None, :]).float()
        hl, nz, single, vflat = tfr.assoc_terms_plain(
            t1.ratio_feats, t1.descriptors, t2.ratio_feats, t2.descriptors, valid, inv)
        M = tfr.build_affinity_plain(t1.centers, t2.centers, hl, nz, single, vflat, inv)
    else:
        single, vflat, M = _grid_stages(4)
    live = (M != 0).any(dim=-1)
    assert live.any()
    assert not (live & ~((single > 0) & (vflat > 0))).any()
    if source == "grid":
        assert live.float().mean() < 0.03


def test_cpu_wrappers_run_the_plain_twins():
    _, (t1, t2) = _features(7)
    inv = tfr.FusedInvariantStatics(**INV)
    counts = [f.launches for f in tfr.KERNELS]
    a = tfr.fused_register(t1, t2, inv, ClipperSolveParams(n_restarts=2))
    b = tfr.fused_register_plain(t1, t2, inv, ClipperSolveParams(n_restarts=2))
    assert [f.launches for f in tfr.KERNELS] == counts  # no kernel on the CPU
    assert tfr.KERNELS[2] is clipper_solve
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _sorted_scan(u, F, max_steps, rel_thresh=0.35):
    """The round_refine kernel's rounding, in numpy: the entries above the
    cut and above 0, sorted by (u descending, index ascending), walked with
    row and column occupancy, accepted until target are taken."""
    P, n, m = u.shape
    flat = u.reshape(P, n * m)
    sel = np.zeros(flat.shape, bool)
    for p in range(P):
        x = flat[p]
        cut = np.float32(rel_thresh) * x.max()
        f2 = np.rint(np.float32(F[p]) * np.float32(2.0))
        target = min(max(f2, 1.0), max_steps) if F[p] > 0 else max_steps
        idx = np.flatnonzero((x > cut) & (x > 0))
        rows, cols = set(), set()
        for j in idx[np.lexsort((idx, -x[idx]))]:
            if len(rows) >= target:
                break
            r, c = divmod(int(j), m)
            if r not in rows and c not in cols:
                rows.add(r)
                cols.add(c)
                sel[p, j] = True
    return sel.reshape(P, n, m)


# name: (n, m, u quantum (0: no planted ties), F of the 4 pairs)
SCAN_CASES = {
    "ties_square": (7, 7, 4, (2.0, 3.3, 0.6, 9.0)),
    "ties_n_gt_m": (9, 5, 3, (1.2, 2.0, 4.0, 0.9)),
    "ties_n_lt_m": (4, 11, 8, (5.0, 0.2, 1.6, 2.5)),
    "all_equal": (6, 8, 1, (2.0, 1.0, 3.0, 40.0)),
    "F_nonpositive": (8, 6, 4, (0.0, -1.0, -0.5, 0.0)),
    "no_ties": (10, 7, 0, (3.0, 2.4, 0.74, 6.0)),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_rounding_is_one_sorted_scan(case):
    """The round_refine kernel rounds by one sorted scan; it selects what
    clipper.round_greedy's arg-max steps select, ties and all."""
    n, m, q, F = SCAN_CASES[case]
    rng = np.random.default_rng(len(case))
    u = rng.uniform(size=(4, n, m)).astype(np.float32)
    if q:
        u = (np.round(u * q) / q).astype(np.float32)
    u[1, 0, :] = u[1, :, 0].max()  # a tie across a row and down a column
    F = np.asarray(F, np.float32)
    max_steps = min(5, n, m)
    sel, count = clipper.round_greedy(torch.tensor(u), torch.tensor(F), max_steps)
    want = _sorted_scan(u, F, max_steps)
    np.testing.assert_array_equal(sel.numpy(), want)
    np.testing.assert_array_equal(count.numpy(), want.sum(axis=(1, 2)))
