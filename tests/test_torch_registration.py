"""The port's register_clipper and register_clipper_rescued against
roman_tpu.align.registration on the CPU: the same sel, count and
converged flags, and T_align within 1e-4 where a transform is defined
(count >= 3)."""

import dataclasses

import numpy as np
import pytest
import torch

from roman_tpu.align import registration as jreg
from roman_tpu.align.clipper import ClipperSolveParams as JaxSolve

from roman_tpu_torch import convert
from roman_tpu_torch.align import registration as treg

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
