"""The port's mesh (roman_tpu_torch.parallel) on the CPU.

Four virtual shards on the CPU stand in for four devices: the layout of
shard_pairs and replicated, PairGridRegistrar over the mesh against the
unsharded registrar (every method, with and without single_robot_lc, a
pair count that is not a multiple of the chunk, the rescue) and against
roman_tpu's sharded registrar on its virtual CPU mesh, the mesh slot of
submap_align, and steps (b) and (c) of dryrun_multichip. Step (a), the
grid at flagship shapes, runs on the card (chip_smoke.py); the registrar
tests here cover it at a small capacity.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.align import submap_align as jax_sa
from roman_tpu.align.invariants import SubmapFeatures as JaxFeatures
from roman_tpu.align.registration import RegistrationConfig as JaxConfig
from roman_tpu.parallel.mesh import get_mesh as jax_get_mesh

from roman_tpu_torch import convert
from roman_tpu_torch.align import submap_align as sa
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.align.submap_align import PairGridRegistrar
from roman_tpu_torch.map.roman_map import SubmapParams, submaps_from_roman_map
from roman_tpu_torch.parallel import multichip
from roman_tpu_torch.parallel.mesh import (Mesh, get_mesh, home_device,
                                           pad_to_multiple, pair_slices,
                                           replicated, shard_pairs)
from roman_tpu_torch.params.submap_align_params import (SubmapAlignInputOutput,
                                                        SubmapAlignParams)
from roman_tpu_torch.sim import world

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_get_mesh_makes_virtual_shards_only_when_asked():
    mesh = get_mesh(4, device="cpu")
    assert mesh.devices == (CPU,) * 4 and mesh.size == 4
    assert get_mesh(device="cpu").devices == (CPU,)
    assert Mesh(["cpu", torch.device("cpu")]).devices == (CPU, CPU)
    with pytest.raises(ValueError):
        get_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        Mesh(())


def test_get_mesh_raises_without_enough_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(), dict(n_devices=2), dict(n_devices=2, device="cuda:0")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_mesh(**kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert get_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert get_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="asked for 3 CUDA devices, 2 visible"):
        get_mesh(3)
    with pytest.raises(RuntimeError, match="not visible"):
        get_mesh(4, device="cuda:2")


def test_shard_pairs_and_replicated_layouts():
    assert [(s.start, s.stop) for s in pair_slices(10, 4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert [(s.start, s.stop) for s in pair_slices(5, 4)] == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(8, 4) == 8
    mesh = get_mesh(4, device="cpu")
    x = torch.arange(10 * 3).reshape(10, 3)
    feats = SubmapFeatures(centers=torch.rand(10, 5, 3), ratio_feats=torch.rand(10, 5, 4),
                           descriptors=torch.rand(10, 5, 0),
                           valid=torch.ones(10, 5, dtype=torch.bool))
    shards = shard_pairs(dict(x=x, f=(feats, np.arange(10)), tag="pairs"), mesh)
    assert len(shards) == 4
    for s, sl in zip(shards, pair_slices(10, 4)):
        assert torch.equal(s["x"], x[sl]) and s["tag"] == "pairs"
        assert torch.equal(s["f"][0].centers, feats.centers[sl])
        assert s["f"][0].descriptors.shape == (sl.stop - sl.start, 5, 0)
        assert torch.equal(s["f"][1], torch.arange(10)[sl])
    with pytest.raises(ValueError, match="leading axes differ"):
        shard_pairs((x, torch.zeros(3)), mesh)
    copies = replicated((x, np.ones(2)), mesh)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
    assert copies[0][0] is x
    assert torch.equal(copies[0][1], torch.ones(2, dtype=torch.float64))


def test_mesh_and_device_must_agree():
    mesh = get_mesh(2, device="cpu")
    assert home_device(mesh) == CPU and home_device(mesh, "cpu") == CPU
    assert home_device(None, "cpu") == CPU
    with pytest.raises(ValueError, match="disagrees"):
        home_device(mesh, "meta")
    with pytest.raises(ValueError, match="disagrees"):
        PairGridRegistrar(RegistrationConfig(), mesh=mesh, device="meta")
    reg = PairGridRegistrar(RegistrationConfig(), chunk_size=6, mesh=get_mesh(4, device="cpu"))
    assert reg.chunk_size == 8 and reg.device == CPU
    assert PairGridRegistrar(RegistrationConfig(), chunk_size=2,
                             mesh=get_mesh(4, device="cpu")).chunk_size == 4


def _problem(cap=16, desc=16, n_sub=4, shared=0, seed=11):
    """Two robots' submaps (n_sub each) from make_pair_batch's problems,
    segment ids with `shared` ids common to submap k of both robots, and
    13 of the 16 pairs (not a multiple of any chunk used here)."""
    stack = multichip.make_pair_batch(P=n_sub, cap=cap, desc_dim=desc, seed=seed)
    f1, f2 = (multichip.batch_features(stack, s, CPU) for s in (1, 2))
    ids1 = np.arange(n_sub * cap).reshape(n_sub, cap)
    ids2 = ids1 + 1000
    ids2[:, :shared] = ids1[:, :shared]
    gi, gj = (g.reshape(-1)[:13] for g in np.meshgrid(np.arange(n_sub), np.arange(n_sub),
                                                      indexing="ij"))
    return stack, f1, f2, ids1, ids2, gi, gj


def _same(a, b, atol=1e-6):
    np.testing.assert_array_equal(a.sel, b.sel)
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.ok, b.ok)
    if a.converged is None:
        assert b.converged is None
    else:
        np.testing.assert_array_equal(a.converged, b.converged)
    np.testing.assert_allclose(a.T_align, b.T_align, atol=atol)


@pytest.mark.parametrize("method", ["roman", "clipper+prune", "ransac"])
@pytest.mark.parametrize("single", [False, True])
def test_sharded_registrar_equals_unsharded(method, single):
    _, f1, f2, ids1, ids2, gi, gj = _problem(shared=3 if single else 0)
    cfg = RegistrationConfig(method=method, cos_min=0.5, cos_max=0.9,
                             ransac_iter=256)
    ref = PairGridRegistrar(cfg, single_robot_lc=single, chunk_size=6,
                            device="cpu")(f1, f2, ids1, ids2, gi, gj, seed=2)
    mesh = get_mesh(4, device="cpu")
    # chunk 6 -> 8: chunks of 8 and 5 pairs, shards of 2,2,2,2 and 2,2,1,0;
    # chunk 1 -> 4: shards of one pair, the last chunk's 1,0,0,0
    res, times = PairGridRegistrar(cfg, single_robot_lc=single, chunk_size=6, mesh=mesh)(
        f1, f2, ids1, ids2, gi, gj, seed=2, timed=True)
    _same(res, ref)
    assert times.shape == (13,) and (times > 0).all()
    _same(PairGridRegistrar(cfg, single_robot_lc=single, chunk_size=1, mesh=mesh)(
        f1, f2, ids1, ids2, gi, gj, seed=2), ref)
    if single:  # a submap's shared objects are never associated with themselves
        assert not ref.sel[gi == gj][:, :3, :3].any()


def test_rescue_runs_unsharded_on_the_first_device():
    _, f1, f2, ids1, ids2, gi, gj = _problem(seed=1)
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9,
                             solver=ClipperSolveParams(warmup_iters=2, outer_iters=1,
                                                       inner_iters=2))
    plain = PairGridRegistrar(cfg, chunk_size=4, device="cpu")
    ref = plain(f1, f2, ids1, ids2, gi, gj)
    sharded = PairGridRegistrar(cfg, chunk_size=4, mesh=get_mesh(4, device="cpu"))
    res = sharded(f1, f2, ids1, ids2, gi, gj)
    assert sharded.rescued == plain.rescued > 0
    _same(res, ref)


def test_sharded_registrar_matches_roman_tpu_mesh():
    """One roman_tpu PairGridRegistrar over its 8-device virtual CPU mesh,
    against the port's over four CPU shards (capacity 8, 8-d, 13 pairs,
    as tests/test_mesh_sharding.py:89)."""
    stack, f1, f2, ids1, ids2, gi, gj = _problem(cap=8, desc=8)
    jcfg = JaxConfig(method="roman", cos_min=0.5, cos_max=0.9, use_pallas=False)
    tcfg = convert.solver_params_from_fields(**dataclasses.asdict(jcfg))

    def jax_feats(side):
        ratio = np.concatenate([stack[f"pca{side}"], stack[f"volume{side}"][..., None]], -1)
        return JaxFeatures(centers=jnp.asarray(stack[f"centers{side}"]),
                           ratio_feats=jnp.asarray(ratio),
                           descriptors=jnp.asarray(stack[f"desc{side}"]),
                           valid=jnp.asarray(stack[f"valid{side}"]))

    assert len(jax.devices()) >= 4
    rj = jax_sa.PairGridRegistrar(jcfg, chunk_size=8, mesh=jax_get_mesh(4))(
        jax_feats(1), jax_feats(2), ids1, ids2, gi, gj)
    rt = PairGridRegistrar(tcfg, chunk_size=8, mesh=get_mesh(4, device="cpu"))(
        f1, f2, ids1, ids2, gi, gj)
    np.testing.assert_array_equal(rt.sel, np.asarray(rj.sel))
    np.testing.assert_array_equal(rt.count, np.asarray(rj.count))
    assert rt.count.max() >= 3
    defined = np.asarray(rj.count) >= 3
    np.testing.assert_allclose(rt.T_align[defined], np.asarray(rj.T_align)[defined],
                               atol=1e-4)


def test_submap_align_takes_the_mesh_third(tmp_path):
    names = lambda f: list(inspect.signature(f).parameters)[:6]  # noqa: E731
    assert names(sa.submap_align)[:4] == names(jax_sa.submap_align)[:4]
    assert names(sa.align_submap_lists) == names(jax_sa.align_submap_lists)
    rng = np.random.default_rng(3)
    _, runs = world.make_multi_robot_world(
        rng, n_robots=2, n_objects=150, area=(40.0, 40.0, 4.0), traj_len=40.0,
        desc_dim=8)
    maps = [world.roman_map_from_run(r) for r in runs]
    p = SubmapAlignParams(method="roman", semantics_dim=8, submap_max_size=12,
                          cosine_min=0.5, cosine_max=0.9)
    sub = SubmapParams.from_submap_align_params(p)
    submaps = [submaps_from_roman_map(m, sub) for m in maps]

    def io(name):
        return SubmapAlignInputOutput(inputs=["r0.pkl", "r1.pkl"],
                                      output_dir=str(tmp_path), run_name=name)

    out = [sa.submap_align(p, io(name), mesh, 5, submaps, maps, "cpu")
           for name, mesh in (("plain", None), ("mesh", get_mesh(4, device="cpu")))]
    assert np.nansum(out[0].clipper_num_associations) > 0
    np.testing.assert_array_equal(out[0].clipper_num_associations,
                                  out[1].clipper_num_associations)
    np.testing.assert_allclose(out[0].T_ij_hat_mat, out[1].T_ij_hat_mat, atol=1e-6)
    assert (tmp_path / "mesh.g2o").read_text() == (tmp_path / "plain.g2o").read_text()


def test_dryrun_mapping_step_on_cpu_shards():
    out = multichip.mapping_step(get_mesh(4, device="cpu"))
    assert out["robots"] == 4 and min(out["segments"]) >= 1


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_pgo_step_on_cpu_shards(n):
    out = multichip.pgo_step(get_mesh(n, device="cpu"))
    assert (out["vertices"], out["edges"]) == (4 * n, 8 * n)
    assert out["max_abs_err"] <= (0.0 if n == 1 else 1e-5)
    assert np.isfinite(out["chi2"])
