"""The port's other registration methods against roman_tpu on the CPU:
clipper+prune, get_MCA, mno_clipper, the 4D CLIPPER entry points, RANSAC,
and PairGridRegistrar's dispatch of all three grid methods.

CLIPPER-based results must agree as register_clipper's do (the same sel,
count and ok, T_align within 1e-4). RANSAC cannot draw JAX's bits, so it
is held on outcomes, on pairs whose inlier set is unambiguous: the same
loop-closure decisions, and T_align within 1e-4 where sel is equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.align import clipper as jclipper
from roman_tpu.align import invariants as jinv
from roman_tpu.align import registration as jreg
from roman_tpu.align.submap_align import PairGridRegistrar as JaxRegistrar
from roman_tpu.sim import world

from roman_tpu_torch import convert
from roman_tpu_torch.align import clipper as tclipper
from roman_tpu_torch.align import invariants as tinv
from roman_tpu_torch.align import registration as treg
from roman_tpu_torch.align.submap_align import PairGridRegistrar

from test_torch_invariants import _features

torch.set_num_threads(1)


def _cfgs(method, **kw):
    jcfg = jreg.RegistrationConfig(method=method, cos_min=0.5, cos_max=0.9,
                                   use_pallas=False, **kw)
    return jcfg, convert.solver_params_from_fields(**dataclasses.asdict(jcfg))


def _port(f):
    return convert.features_from_numpy(
        *jax.tree.map(np.asarray, (f.centers, f.ratio_feats, f.descriptors,
                                   f.valid)), device="cpu")


def _compare(rj, rt, tol=1e-4):
    np.testing.assert_array_equal(np.asarray(rt.sel), np.asarray(rj.sel))
    np.testing.assert_array_equal(np.asarray(rt.count), np.asarray(rj.count))
    np.testing.assert_array_equal(np.asarray(rt.ok), np.asarray(rj.ok))
    defined = np.asarray(rj.count) >= 3
    np.testing.assert_allclose(np.asarray(rt.T_align)[defined],
                               np.asarray(rj.T_align)[defined], atol=tol)


def _prune_args(f, attrs):
    out = {}
    if "shape" in attrs:
        out.update(pca_attrs=f.ratio_feats[..., :3], volume=f.ratio_feats[..., 3])
    if "descriptors" in attrs:
        out.update(descriptors=f.descriptors)
    return out


def _prune(mod, f1, f2, cfg, attrs):
    a1, a2 = _prune_args(f1, attrs), _prune_args(f2, attrs)
    kw = {f"{k}1": v for k, v in a1.items()}
    kw.update({f"{k}2": v for k, v in a2.items()})
    return mod.register_clipper_prune(f1, f2, cfg, **kw)


@pytest.mark.parametrize("attrs", [("shape", "descriptors"), ("descriptors",), ()])
def test_register_clipper_prune_matches_jax(attrs):
    (j1, j2), (t1, t2) = _features(3, P=4)
    jcfg, tcfg = _cfgs("clipper+prune", epsilon_shape=0.3)
    rj = _prune(jreg, j1, j2, jcfg, attrs)
    rt = _prune(treg, t1, t2, tcfg, attrs)
    _compare(rj, rt)
    assert (rt.count >= 4).all()


def test_register_clipper_prune_fails_a_tilted_result():
    """The roll/pitch check: the same pairs with map 2 tilted by 10 degrees
    register, but every result is marked failed, as in roman_tpu."""
    (j1, j2), _ = _features(3, P=4)
    c, s = np.cos(np.deg2rad(10.0)), np.sin(np.deg2rad(10.0))
    tilt = jnp.asarray(np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32))
    j2 = j2.replace(centers=j2.centers @ tilt.T)
    jcfg, tcfg = _cfgs("clipper+prune")
    rj = _prune(jreg, j1, j2, jcfg, ())
    rt = _prune(treg, _port(j1), _port(j2), tcfg, ())
    _compare(rj, rt)
    assert (rt.count >= 4).all() and not rt.ok.any()


def test_get_MCA_matches_jax():
    (j1, j2), (t1, t2) = _features(4, P=2)
    jcfg, tcfg = _cfgs("roman")
    Mj, Cj, Aj = jreg.get_MCA(j1, j2, jcfg)
    Mt, Ct, At = treg.get_MCA(t1, t2, tcfg)
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=1e-6)
    np.testing.assert_array_equal(Ct.numpy(), np.asarray(Cj))
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))


def test_mno_clipper_matches_jax():
    (j1, j2), (t1, t2) = _features(5, P=3)
    jcfg, tcfg = _cfgs("roman")
    sj = jreg.mno_clipper(j1, j2, jcfg, num_solutions=2)
    st = treg.mno_clipper(t1, t2, tcfg, num_solutions=2)
    assert len(st) == len(sj) == 2
    for (sel_j, cnt_j, F_j), (sel_t, cnt_t, F_t) in zip(sj, st):
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    # the second solution shares no association with the first
    assert not (st[0][0] & st[1][0]).any()
    assert (st[0][1] >= 4).all()


def test_clipper_solve_and_refine_selection_match_jax():
    (j1, j2), (t1, t2) = _features(6, P=3)
    kw = dict(cos_min=0.5, cos_max=0.9)
    M_j, _ = jinv.affinity(j1, j2, jinv.ROMANInvariantParams(
        ratio_epsilon=jnp.zeros(4), **kw))
    M_t, _ = tinv.affinity(t1, t2, tinv.ROMANInvariantParams(
        ratio_epsilon=torch.zeros(4), **kw))
    vj = j1.valid[..., :, None] & j2.valid[..., None, :]
    vt = t1.valid[..., :, None] & t2.valid[..., None, :]
    uj, dj, Fj = jclipper.solve(M_j, vj)
    ut, dt, Ft = tclipper.solve(M_t, vt)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=2e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-4)
    sel_j, _ = jclipper.round_greedy(uj, Fj, 12)
    sel = torch.as_tensor(np.asarray(sel_j))
    rj, cj = jclipper.refine_selection(M_j, sel_j, target=Fj)
    rt, ct = tclipper.refine_selection(M_t, sel, target=torch.as_tensor(np.asarray(Fj)))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert (ct >= 4).all()


def _ransac_features(seed, n_match=4, n_mismatch=2, cap=8):
    """Pairs whose inlier set is unambiguous (8 shared objects and no
    other, 2 cm of center noise, far under the 0.5 m inlier radius: 4096
    triplets draw about 8 all-inlier ones) and pairs of two unrelated
    scenes, as both packages' features."""
    rng = np.random.default_rng(seed)
    probs = [world.make_pair_problem(rng, n_common=8, n_only1=0, n_only2=0,
                                     center_noise=0.02, desc_dim=8)
             for _ in range(n_match + 2 * n_mismatch)]
    pads = [world.pad_problem(p, cap) for p in probs]
    pairs = [(p, p) for p in pads[:n_match]]
    pairs += [(pads[n_match + 2 * k], pads[n_match + 2 * k + 1])
              for k in range(n_mismatch)]
    cfg = jreg.RegistrationConfig(method="ransac")
    jf = []
    for side in (1, 2):
        def st(key):
            return jnp.asarray(np.stack([pr[side - 1][f"{key}{side}"] for pr in pairs]))
        jf.append(jreg.build_features(st("centers"), st("valid"), cfg))
    return jf, [_port(f) for f in jf], n_match


def test_register_ransac_matches_jax_on_outcomes():
    (j1, j2), (t1, t2), n_match = _ransac_features(8)
    jcfg, tcfg = _cfgs("ransac")
    P = t1.centers.shape[0]
    rj = jreg.register_ransac(j1, j2, jcfg, jax.random.PRNGKey(0))
    rt = treg.register_ransac(t1, t2, tcfg, treg.ransac_draws(0, P, tcfg.ransac_iter))
    lc_j = np.asarray(rj.ok) & (np.asarray(rj.count) >= 4)
    lc_t = (rt.ok & (rt.count >= 4)).numpy()
    np.testing.assert_array_equal(lc_t, lc_j)
    assert lc_t[:n_match].all() and not lc_t[n_match:].any()
    same = (rt.sel.numpy() == np.asarray(rj.sel)).all(axis=(1, 2))
    assert same[:n_match].all()
    np.testing.assert_allclose(rt.T_align.numpy()[same],
                               np.asarray(rj.T_align)[same], atol=1e-4)
    assert rt.converged is None and rt.u.shape == rt.sel.shape


def test_ransac_draws_need_a_shape_of_the_batch():
    _, (t1, t2), _ = _ransac_features(9, n_match=1, n_mismatch=0)
    _, tcfg = _cfgs("ransac", ransac_iter=16)
    with pytest.raises(ValueError, match="draws"):
        treg.register_ransac(t1, t2, tcfg, treg.ransac_draws(0, 2, 16))


def _grid(seed, P=4, cap=12, shared=0):
    """Both packages' all-submap features for a grid of P pair problems
    (submap k of each robot is pair k's map) and (P, cap) segment ids; the
    first `shared` objects of every submap carry the same id in both."""
    (j1, j2), (t1, t2) = _features(seed, P=P, cap=cap)
    ids1 = np.arange(P * cap).reshape(P, cap)
    ids2 = ids1 + 1000
    ids2[:, :shared] = ids1[:, :shared]
    return (j1, j2), (t1, t2), ids1, ids2


@pytest.mark.parametrize("method,single", [("roman", True),
                                           ("clipper+prune", False),
                                           ("clipper+prune", True)])
def test_pair_grid_dispatch_matches_jax(method, single):
    """PairGridRegistrar runs each CLIPPER method as roman_tpu's registrar
    does (its _register, eager), with single_robot_lc removing the shared
    segments."""
    (j1, j2), (t1, t2), ids1, ids2 = _grid(11, shared=2 if single else 0)
    jcfg, tcfg = _cfgs(method)
    pi, pj = np.array([0, 1, 2, 3, 0]), np.array([0, 1, 2, 3, 1])
    res = PairGridRegistrar(tcfg, single_robot_lc=single, chunk_size=2,
                            device="cpu")(t1, t2, ids1, ids2, pi, pj)
    take = lambda idx: (lambda x: x[jnp.asarray(idx)])  # noqa: E731
    rj = JaxRegistrar(jcfg, single_robot_lc=single)._register(
        jax.tree.map(take(pi), j1), jax.tree.map(take(pj), j2),
        jnp.asarray(ids1)[pi], jnp.asarray(ids2)[pj], jax.random.PRNGKey(0))
    _compare(rj, res)
    np.testing.assert_array_equal(res.converged, np.asarray(rj.converged))
    if single:  # the two shared objects of each pair are never associated
        assert not res.sel[:, :2, :2].any()


def test_pair_grid_rescues_clipper_prune_pairs():
    """At a small budget some clipper+prune pairs do not converge; they are
    re-solved through register_clipper_prune at the rescue budget, as
    roman_tpu's rescue registrar does, so pruning and the gravity check
    apply to them too."""
    from roman_tpu_torch.align.clipper import ClipperSolveParams

    (j1, j2), (t1, t2), ids1, ids2 = _grid(1)
    small = dict(warmup_iters=2, outer_iters=1, inner_iters=2)
    jcfg, tcfg = _cfgs("clipper+prune",
                       solver=jclipper.ClipperSolveParams(**small))
    assert tcfg.solver == ClipperSolveParams(**small)
    pi = pj = np.arange(4)
    registrar = PairGridRegistrar(tcfg, chunk_size=3, device="cpu")
    res = registrar(t1, t2, ids1, ids2, pi, pj)
    base = _prune(treg, t1, t2, tcfg, ("shape", "descriptors"))
    bad = np.flatnonzero(~base.converged.numpy())
    assert registrar.rescued == bad.size > 0
    rcfg = dataclasses.replace(jcfg, solver=jreg.rescue_solver(jcfg.solver))
    rj = jreg.splice_rescued(_prune(jreg, j1, j2, jcfg, ("shape", "descriptors")),
                             _prune(jreg, j1, j2, rcfg, ("shape", "descriptors")),
                             bad)
    _compare(rj, res)
    assert res.converged.all()


def test_pair_grid_ransac_is_one_draw_for_the_pair_list():
    """ransac through PairGridRegistrar: the draws of the whole pair list
    come from the seed, in pair order, so the result does not depend on
    the chunk size, bit for bit; no rescue runs and converged is None."""
    _, (t1, t2), n_match = _ransac_features(10, n_match=3, n_mismatch=1)
    _, tcfg = _cfgs("ransac")
    ids = np.zeros((4, 8), np.int64)
    pi = pj = np.array([0, 1, 2, 3, 1])
    outs = []
    for chunk in (1, 2, 5):
        registrar = PairGridRegistrar(tcfg, chunk_size=chunk, device="cpu")
        outs.append(registrar(t1, t2, ids, ids, pi, pj, seed=3))
        assert registrar.rescued == 0 and outs[-1].converged is None
    for out in outs[1:]:
        for name in ("sel", "count", "ok", "score", "T_align"):
            np.testing.assert_array_equal(getattr(out, name), getattr(outs[0], name))
    take = lambda x: x[torch.as_tensor(pi)]  # noqa: E731
    direct = treg.register_ransac(t1.map(take), t2.map(take), tcfg,
                                  treg.ransac_draws(3, 5, tcfg.ransac_iter))
    np.testing.assert_array_equal(outs[0].sel, direct.sel.numpy())
    np.testing.assert_array_equal(outs[0].T_align, direct.T_align.numpy())
    lc = outs[0].ok & (outs[0].count >= 4)
    np.testing.assert_array_equal(lc, [True, True, True, False, True])
    other = PairGridRegistrar(tcfg, chunk_size=2, device="cpu")(
        t1, t2, ids, ids, pi, pj, seed=4)
    assert not np.array_equal(other.T_align, outs[0].T_align)
