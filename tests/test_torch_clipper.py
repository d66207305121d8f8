"""The port's plain CLIPPER solve, rounding and refinement against
roman_tpu.align.clipper, on the bf16 matrix roman_tpu prepared.

Tolerances: sel and count equal; u within 2e-3 and F within rtol 1e-3
(the frameworks sum the f32 matvecs and norms in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.align import clipper as jclip
from roman_tpu.align import invariants as jinv

from roman_tpu_torch.align import clipper as tclip
from roman_tpu_torch.align.clipper_solve import clipper_solve, clipper_solve_plain

from test_torch_invariants import _features

torch.set_num_threads(1)


def _prepared(seed=2):
    (j1, j2), (t1, t2) = _features(seed)
    p = jinv.ROMANInvariantParams(cos_min=0.5, cos_max=0.9, gravity=True,
                                  fusion="arithmetic_mean",
                                  ratio_epsilon=jnp.zeros(4))
    M4, _ = jinv.affinity(j1, j2, p)
    M_j = jclip.prepare_matrix(M4)
    M_t = torch.tensor(np.asarray(M_j.astype(jnp.float32))).to(torch.bfloat16)
    valid = np.asarray(j1.valid[..., :, None] & j2.valid[..., None, :])
    return M4, M_j, M_t, valid, j1.capacity, j2.capacity


@pytest.mark.parametrize("restarts", [1, 3])
def test_solve_round_refine_match_jax(restarts):
    M4, M_j, M_t, valid, n, m = _prepared()
    jp = jclip.ClipperSolveParams(n_restarts=restarts)
    tp = tclip.ClipperSolveParams(n_restarts=restarts)
    u_j, _, F_j = jclip.solve_2d(M_j, n, m, jnp.asarray(valid), jp)
    u_t, _, F_t = tclip.solve_2d(M_t, n, m, torch.tensor(valid), tp)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=2e-3)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-3)

    # rounding and refinement on the same inputs
    max_steps = min(n, m)
    sel_j, cnt_j = jclip.round_greedy(u_j, F_j, max_steps)
    sel_t, cnt_t = tclip.round_greedy(torch.tensor(np.asarray(u_j)),
                                      torch.tensor(np.asarray(F_j)), max_steps)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    omega = jnp.sum(u_j.reshape(u_j.shape[0], -1) * jnp.matmul(
        M_j, u_j.reshape(u_j.shape[0], -1, 1).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)[..., 0], axis=-1)
    ref_j, rcnt_j = jclip.refine_selection_2d(M_j, sel_j, target=omega)
    ref_t, rcnt_t = tclip.refine_selection_2d(
        M_t, torch.tensor(np.asarray(sel_j)), target=torch.tensor(np.asarray(omega)))
    np.testing.assert_array_equal(ref_t.numpy(), np.asarray(ref_j))
    np.testing.assert_array_equal(rcnt_t.numpy(), np.asarray(rcnt_j))

    # and the whole chain
    s_j, c_j, uu_j, FF_j = jclip.solve_and_round(M4, jnp.asarray(valid), max_steps, jp)
    s_t, c_t, uu_t, FF_t = tclip.solve_and_round(
        torch.tensor(np.asarray(M4)), torch.tensor(valid), max_steps, tp)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(uu_t.numpy(), np.asarray(uu_j), atol=2e-3)


def test_restart_noise_is_the_reference_array():
    np.testing.assert_array_equal(tclip.restart_noise(4, 37),
                                  jclip.restart_noise(4, 37))


def test_cpu_wrapper_runs_the_plain_twin_and_handles_all_invalid():
    _, _, M_t, valid, n, m = _prepared()
    v = torch.tensor(valid.reshape(valid.shape[0], -1), dtype=torch.float32)
    v[1] = 0.0  # an all-invalid pair
    p = tclip.ClipperSolveParams(n_restarts=2)
    before = clipper_solve.launches
    a = clipper_solve(M_t, v, n, m, p)
    b = clipper_solve_plain(M_t, v, n, m, p)
    assert clipper_solve.launches == before  # no kernel on the CPU
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    u, d, F, omega = a
    assert torch.isfinite(u).all() and torch.isfinite(F).all()
    assert (u[1] == 0).all() and F[1] == 0 and omega[1] == 0
