"""The port's register_clipper and register_clipper_rescued against
roman_tpu.align.registration on the CPU: the same sel, count and
converged flags, and T_align within 1e-4 where a transform is defined
(count >= 3)."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.align import registration as jreg
from roman_tpu.align.clipper import ClipperSolveParams as JaxSolve

from roman_tpu_torch import convert
from roman_tpu_torch.align import registration as treg
from roman_tpu_torch.ops.arun import arun_align_plain

from test_torch_invariants import _features

torch.set_num_threads(1)


def _configs(fusion="geometric_mean", solver=None):
    jcfg = jreg.RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9,
                                   fusion=fusion, use_pallas=False,
                                   solver=solver or JaxSolve())
    return jcfg, convert.solver_params_from_fields(**dataclasses.asdict(jcfg))


def _compare(rj, rt):
    np.testing.assert_array_equal(rt.sel.numpy(), np.asarray(rj.sel))
    np.testing.assert_array_equal(rt.count.numpy(), np.asarray(rj.count))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    defined = np.asarray(rj.count) >= 3
    np.testing.assert_allclose(rt.T_align.numpy()[defined],
                               np.asarray(rj.T_align)[defined], atol=1e-4)


@pytest.mark.parametrize("fusion", ["geometric_mean", "arithmetic_mean", "product"])
def test_register_clipper_matches_jax(fusion):
    (j1, j2), (t1, t2) = _features(8, P=4)
    jcfg, tcfg = _configs(fusion)
    rj = jreg.register_clipper(j1, j2, jcfg)
    rt = treg.register_clipper(t1, t2, tcfg)
    _compare(rj, rt)
    assert (np.asarray(rj.count) >= 4).all()


@pytest.mark.parametrize("seed,budget,n_bad", [(7, (4, 2, 1), 1),
                                               (6, (3, 1, 3), 3),
                                               (1, (2, 1, 2), 4)])
def test_register_clipper_rescued_matches_jax(seed, budget, n_bad):
    """A small budget leaves pairs unconverged; the rescue re-solves them
    at rescue_solver budget and splices them back."""
    w, o, i = budget
    (j1, j2), (t1, t2) = _features(seed, P=4)
    jcfg, tcfg = _configs(solver=JaxSolve(warmup_iters=w, outer_iters=o,
                                          inner_iters=i))
    assert (tcfg.solver.warmup_iters, tcfg.solver.outer_iters,
            tcfg.solver.inner_iters) == budget
    base = treg.register_clipper(t1, t2, tcfg)
    assert int((~base.converged).sum()) == n_bad
    rj = jreg.register_clipper_rescued(j1, j2, jcfg)
    rt = treg.register_clipper_rescued(t1, t2, tcfg)
    _compare(rj, rt)
    assert rt.converged.all()


def test_solver_params_from_fields():
    jcfg, tcfg = _configs("product", JaxSolve(warmup_iters=3, n_restarts=2))
    assert isinstance(tcfg, treg.RegistrationConfig)
    assert tcfg.fusion == "product" and tcfg.cos_max == 0.9
    assert (tcfg.solver.warmup_iters, tcfg.solver.n_restarts) == (3, 2)
    solver = convert.solver_params_from_fields(
        **dataclasses.asdict(JaxSolve(outer_iters=5)))
    assert solver == treg.clipper_mod.ClipperSolveParams(outer_iters=5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_t_align_on_the_cpu_is_still_the_twin(seed):
    """On the CPU the registration's T_align is the plain twin's, bitwise:
    counts 0, 1, 2, 3 and up, a reflection (map 2's selected centers
    mirrored), centers 240 m off, a batch of 6 and one unbatched pair. Where
    T is unique (count >= 3, and none at 0) it is roman_tpu's: the rotation
    within 1e-5, the translation within 1e-3 (f32 at a 240 m lever arm)."""
    rng = np.random.default_rng(seed)
    P, n, m = 6, 9, 7
    c1 = rng.uniform(-20, 20, (P, n, 3)) + 240.0
    c2 = rng.uniform(-20, 20, (P, m, 3)) + 240.0
    sel = np.zeros((P, n, m), bool)
    for p, k in enumerate([0, 1, 2, 3, 5, 7]):
        a, b = rng.permutation(n)[:k], rng.permutation(m)[:k]
        sel[p, a, b] = True
        if p == 4:
            c2[p, b] = c1[p, a] * [1.0, 1.0, -1.0]
    f1, f2 = (treg.SubmapFeatures(centers=torch.tensor(c, dtype=torch.float32),
                                  ratio_feats=torch.zeros(P, c.shape[1], 0),
                                  descriptors=torch.zeros(P, c.shape[1], 0),
                                  valid=torch.ones(P, c.shape[1], dtype=torch.bool))
              for c in (c1, c2))
    sel = torch.tensor(sel)
    T = treg._t_align_from_selection(f1, f2, sel)
    assert torch.equal(T, arun_align_plain(f1.centers, f2.centers, sel))
    assert torch.equal(T[0], torch.eye(4))
    one = (f1.map(lambda x: x[5]), f2.map(lambda x: x[5]), sel[5])
    assert torch.equal(treg._t_align_from_selection(*one),
                       arun_align_plain(one[0].centers, one[1].centers, one[2]))
    ref = np.asarray(jreg._t_align_from_selection(
        types.SimpleNamespace(centers=jnp.asarray(f1.centers.numpy())),
        types.SimpleNamespace(centers=jnp.asarray(f2.centers.numpy())),
        jnp.asarray(sel.numpy())))
    unique = [0, 3, 4, 5]
    np.testing.assert_allclose(T[unique, :3, :3].numpy(), ref[unique, :3, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(T[unique].numpy(), ref[unique], rtol=0, atol=1e-3)
