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
