"""The port's pose-graph back end against roman_tpu.rpgo on the CPU.

- SE(3) exp/log, the edge Jacobians, the PCM gate and the spanning forest
  against roman_tpu's;
- solve_pose_graph on the graphs of tests/test_rpgo.py, with outliers: the
  same PCM and GNC rejection counts, vertex positions within 1e-3 m, ATE
  within 1e-3 m;
- the back half of the demo (map pickles -> odometry g2o -> fusion ->
  combined loop closures -> edited information) writes the same bytes as
  roman_tpu's, and the port's CLI solves the result as roman_tpu's
  rpgo_solve_g2o does, with the same ATE.

Three roman_tpu solves in all (each takes seconds on the CPU).
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.ops import se3 as jse3
from roman_tpu.rpgo import combine_loop_closures as jcomb
from roman_tpu.rpgo import evaluate as jeval
from roman_tpu.rpgo import extract_odom as jodom
from roman_tpu.rpgo import fusion as jfusion
from roman_tpu.rpgo import g2o_io as jio
from roman_tpu.rpgo import solver as jsolver
from roman_tpu.sim import world

from roman_tpu_torch.ops import se3 as tse3
from roman_tpu_torch.rpgo import combine_loop_closures as tcomb
from roman_tpu_torch.rpgo import evaluate as teval
from roman_tpu_torch.rpgo import extract_odom as todom
from roman_tpu_torch.rpgo import fusion as tfusion
from roman_tpu_torch.rpgo import g2o_io as tio
from roman_tpu_torch.rpgo import solver as tsolver

from test_rpgo import graph_ate, make_three_robot_graph, make_two_robot_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _tangents(rng, n=64):
    """xi (n, 6): small angles (the Taylor branches), moderate ones, and
    angles within 1e-3 of pi."""
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    w = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
    k = n // 4
    xi[:k, 3:] = w[:k] * rng.uniform(1e-6, 9e-3, (k, 1))
    xi[k:2 * k, 3:] = w[k:2 * k] * rng.uniform(1e-2, 3.0, (k, 1))
    xi[2 * k:, 3:] = w[2 * k:] * (np.pi - rng.uniform(1e-4, 1e-3, (n - 2 * k, 1)))
    return xi.astype(np.float32)


def test_se3_matches_jax_near_identity_and_pi(rng):
    xi = _tangents(rng)
    Tj = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Tt = tse3.se3_exp(torch.as_tensor(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=2e-6)
    np.testing.assert_allclose(tse3.so3_exp(torch.as_tensor(xi[:, 3:])).numpy(),
                               np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:]))),
                               atol=2e-6)
    np.testing.assert_allclose(tse3.so3_log(torch.as_tensor(Tj[:, :3, :3])).numpy(),
                               np.asarray(jse3.so3_log(jnp.asarray(Tj[:, :3, :3]))),
                               atol=5e-5)
    log_t = tse3.se3_log(torch.as_tensor(Tj)).numpy()
    log_j = np.asarray(jse3.se3_log(jnp.asarray(Tj)))
    np.testing.assert_allclose(log_t, log_j, atol=5e-4)
    # away from pi the log inverts the exp
    np.testing.assert_allclose(log_t[:32], xi[:32], atol=5e-5)
    # the remaining helpers on the same poses
    t_t, q_t = tse3.T_to_xyz_quat(torch.as_tensor(Tj))
    t_j, q_j = jse3.T_to_xyz_quat(jnp.asarray(Tj))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=2e-6)
    np.testing.assert_allclose(tse3.xyz_quat_to_T(t_t, q_t).numpy(),
                               np.asarray(jse3.xyz_quat_to_T(t_j, q_j)), atol=2e-6)
    np.testing.assert_allclose(tse3.inv_T(torch.as_tensor(Tj)).numpy(),
                               np.asarray(jse3.inv_T(jnp.asarray(Tj))), atol=2e-6)
    pts = rng.normal(size=(64, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.apply_T(torch.as_tensor(Tj), torch.as_tensor(pts)).numpy(),
        np.asarray(jse3.apply_T(jnp.asarray(Tj), jnp.asarray(pts))), atol=1e-5)
    alpha = rng.uniform(size=32).astype(np.float32)
    np.testing.assert_allclose(
        tse3.interp_T(torch.as_tensor(Tj[:32]), torch.as_tensor(Tj[32:]),
                      torch.as_tensor(alpha)).numpy(),
        np.asarray(jse3.interp_T(jnp.asarray(Tj[:32]), jnp.asarray(Tj[32:]),
                                 jnp.asarray(alpha))), atol=5e-5)


def test_edge_jacobians_match_jax(rng):
    """The closed-form edge Jacobians against jax.jacfwd of roman_tpu's
    perturbed residual, on edges whose residual rotation is tiny (the
    Taylor branches) and up to 1.5 rad."""
    E = 48
    Ti = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(rng, E) * 3.0)))
    Tj = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(rng, E) * 3.0)))
    noise = _tangents(rng, E)
    noise[E // 4:, 3:] *= 1.5 / np.linalg.norm(noise[E // 4:, 3:], axis=1,
                                               keepdims=True) * rng.uniform(
        0.01, 1.0, (E - E // 4, 1))
    meas = np.linalg.inv(Ti) @ Tj @ np.asarray(jse3.se3_exp(jnp.asarray(noise)))
    Tm_inv = np.linalg.inv(meas).astype(np.float32)
    zero = jnp.zeros((E, 6), jnp.float32)
    Jj = jsolver._jac_fn(zero, zero, jnp.asarray(Ti), jnp.asarray(Tj),
                         jnp.asarray(Tm_inv))
    Jt = tsolver._edge_jacobians(*(torch.as_tensor(a) for a in (Ti, Tj, Tm_inv)))
    for a, b in zip(Jt, Jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    r = tsolver._edge_residual(*(torch.as_tensor(x) for x in (Ti, Tj, Tm_inv)))
    assert (torch.linalg.norm(r[:E // 4, 3:], dim=-1) < 1e-2).all()
    assert (torch.linalg.norm(r[E // 4:, 3:], dim=-1) > 1e-2).any()


def _port_graph(graph):
    return tio.G2OGraph(vertices=dict(graph.vertices), edges=[
        tio.G2OEdge(e.v1, e.v2, e.xyz_quat, e.info_upper, e.lc_count)
        for e in graph.edges])


def test_pcm_gate_and_spanning_forest_match_jax():
    graph, _ = make_two_robot_graph(np.random.default_rng(3), n=30, n_lc=8,
                                    n_outliers=4)
    arrays_j = jsolver.graph_to_arrays(graph)
    arrays_t = tsolver.graph_to_arrays(_port_graph(graph))
    keys, _, T_file, ii, jj, Tm, info, lc = arrays_t
    for a, b in zip(arrays_t[2:], arrays_j[2:]):
        np.testing.assert_array_equal(a, b)
    V = len(keys)
    T_odom = tsolver.spanning_tree_init(V, ii, jj, Tm, ~lc)
    np.testing.assert_array_equal(
        T_odom, jsolver.spanning_tree_init(V, ii, jj, Tm, ~lc))
    keep_t, size_t = tsolver.pcm_gate(T_odom, ii, jj, Tm, info, lc, 25.0,
                                      return_sizes=True, min_inter_clique=2)
    keep_j, size_j = jsolver.pcm_gate(T_odom, ii, jj, Tm, info, lc, 25.0,
                                      return_sizes=True, min_inter_clique=2)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(size_t, size_j)
    assert (~keep_t & lc).sum() >= 3
    prio = np.where(lc, size_t, np.inf)
    np.testing.assert_array_equal(
        tsolver.spanning_tree_init(V, ii, jj, Tm, keep_t, T_file=T_file, priority=prio),
        jsolver.spanning_tree_init(V, ii, jj, Tm, keep_t, T_file=T_file, priority=prio))


def _positions(graph):
    return np.stack([graph.vertices[k][:3] for k in sorted(graph.vertices)])


@pytest.mark.parametrize("make", ["two_robots", "three_robots"])
def test_solve_pose_graph_matches_jax(make):
    if make == "two_robots":
        graph, gt = make_two_robot_graph(np.random.default_rng(2), n=50,
                                         drift=0.05, n_lc=12, n_outliers=6)
    else:
        graph, gt = make_three_robot_graph(np.random.default_rng(5))
    out_j, diag_j = jsolver.solve_pose_graph(graph, jsolver.RPGOSolverParams())
    out_t, diag_t = tsolver.solve_pose_graph(_port_graph(graph),
                                             tsolver.RPGOSolverParams(), device="cpu")
    assert diag_t == diag_j
    assert diag_t["n_lc_pcm_rejected"] + diag_t["n_lc_gnc_rejected"] >= 4
    np.testing.assert_allclose(_positions(out_t), _positions(out_j), atol=1e-3)
    if make == "two_robots":
        assert abs(graph_ate(out_t, gt) - graph_ate(out_j, gt)) < 1e-3
        assert graph_ate(out_t, gt) < 0.7


def test_solve_pose_graph_needs_a_device_it_can_use(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph, _ = make_two_robot_graph(np.random.default_rng(0), n=5, n_lc=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsolver.solve_pose_graph(_port_graph(graph))


def test_segment_sum_adds_each_vertex_in_a_fixed_order():
    slots = np.array([2, 0, 2, 1, 2, 0])
    seg = tsolver._SegmentSum(slots, 4, torch.device("cpu"))
    np.testing.assert_array_equal(seg.table.numpy(),
                                  [[1, 5, 6], [3, 6, 6], [0, 2, 4], [6, 6, 6]])
    terms = torch.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(
        seg(terms).numpy(), torch.zeros(4, 2).index_add_(0, torch.as_tensor(slots),
                                                         terms).numpy())


def test_chi2_ppf_even_df_pinned_quantiles():
    pinned = {(0.90, 6): 10.6446, (0.95, 6): 12.5916, (0.99, 6): 16.8119,
              (0.90, 2): 4.6052, (0.99, 12): 26.2170}
    for (p, df), want in pinned.items():
        got = tsolver.chi2_ppf_even_df(p, df)
        assert abs(got - want) < 5e-4, (p, df, got, want)
        assert got == jsolver.chi2_ppf_even_df(p, df)
    for bad in ((0.9, 5), (0.9, 0), (0.0, 6), (1.0, 6)):
        with pytest.raises(ValueError):
            tsolver.chi2_ppf_even_df(*bad)


def test_g2o_writer_and_parser_match_jax(tmp_path):
    graph, _ = make_two_robot_graph(np.random.default_rng(0), n=10, n_lc=3)
    jio.write_g2o(graph, str(tmp_path / "j.g2o"))
    tio.write_g2o(_port_graph(graph), str(tmp_path / "t.g2o"))
    raw = (tmp_path / "t.g2o").read_bytes()
    assert raw == (tmp_path / "j.g2o").read_bytes()
    lines = raw.decode().splitlines()
    assert sum(ln.startswith("# LC: 8") for ln in lines) == 3
    assert all(len(ln.split()) == 31 for ln in lines if ln.startswith("EDGE"))
    assert all(len(ln.split()) == 9 for ln in lines if ln.startswith("VERTEX"))
    back = tio.parse_g2o(str(tmp_path / "t.g2o"))
    assert back.edges[-1].lc_count == 8 and len(back.vertices) == 20
    with pytest.raises(ValueError, match="bad edge line"):
        tio.parse_g2o(["EDGE_SE3:QUAT 0 1 0 0 0"])


# ---------------------------------------------------------------------------
# the back half of the demo, from map pickles
# ---------------------------------------------------------------------------

ROBOTS = ["robot0", "robot1"]


def _write_align_g2o(runs, maps, path, rng, n_lc=8):
    """Loop closures between the robots' dense keyframes nearest in the
    world (their relative GT pose plus noise), as align.g2o writes them."""
    traj = [m.trajectory for m in maps]
    gt = [r.poses for r in runs]
    d = np.linalg.norm(gt[0][:, None, :3, 3] - gt[1][None, :, :3, 3], axis=-1)
    pairs = np.argwhere(d < 3.0)
    pairs = pairs[rng.choice(len(pairs), n_lc, replace=False)]
    assert len(traj[0]) == len(gt[0])
    I = jio.info_upper_from_matrix(jio.information_matrix(0.5, 0.05))
    with open(path, "w") as f:
        for a, b in sorted(map(tuple, pairs)):
            T = np.linalg.inv(gt[0][a]) @ gt[1][b] @ world.yaw_T(
                rng.normal() * 0.01, rng.normal(size=3) * 0.05)
            t, q = (np.asarray(x) for x in jse3.T_to_xyz_quat(jnp.asarray(T)))
            f.write(f"# LC: {int(rng.integers(4, 9))}\n")
            f.write(jio.format_edge(a, b, np.concatenate([t, q]), I) + "\n")


def _back_half(pkg, out, thresh=4):
    """demo/demo.py:183-245 with one package's modules: per-robot odometry
    g2o (sparse at 2 m and dense), fusion, combined loop closures, edited
    loop-closure information. Returns the final g2o and time file."""
    odom, fusion, comb, io = pkg
    for i, run in enumerate(ROBOTS):
        for mode, kf in [("sparse", 2.0), ("dense", None)]:
            odom.roman_map_pkl_to_g2o(
                pkl_file=os.path.join(out, "map", f"{run}.pkl"),
                g2o_file=os.path.join(out, "offline_rpgo", mode, f"{run}.g2o"),
                time_file=os.path.join(out, "offline_rpgo", mode, f"{run}.time.txt"),
                robot_id=i, min_keyframe_dist=kf, t_std=0.1, r_std=np.deg2rad(0.5))
    for mode in ["sparse", "dense"]:
        with open(os.path.join(out, "offline_rpgo", mode, "odom_all.time.txt"), "w") as f:
            for run in ROBOTS:
                with open(os.path.join(out, "offline_rpgo", mode, f"{run}.time.txt")) as f2:
                    f.write(f2.read())
    sparse_all = os.path.join(out, "offline_rpgo/sparse", "odom_all.g2o")
    fusion.g2o_file_fusion(
        fusion.create_config(ROBOTS, os.path.join(out, "offline_rpgo/sparse")),
        sparse_all, thresh=thresh)
    dense_all = os.path.join(out, "offline_rpgo/dense", "odom_and_lc.g2o")
    fusion.g2o_file_fusion(
        fusion.create_config(ROBOTS, os.path.join(out, "offline_rpgo/dense"),
                             submap_align_dir=os.path.join(out, "align"),
                             align_file_name="align"),
        dense_all, thresh=thresh)
    final = os.path.join(out, "offline_rpgo", "odom_and_lc.g2o")
    time_file = os.path.join(out, "offline_rpgo/sparse", "odom_all.time.txt")
    comb.combine_loop_closures(
        g2o_reference=sparse_all, g2o_extra_lc=dense_all,
        vertex_times_reference=time_file,
        vertex_times_extra_lc=os.path.join(out, "offline_rpgo/dense",
                                           "odom_all.time.txt"),
        output_file=final)
    with open(final) as f:
        lines = io.edit_g2o_edge_information(f.readlines(), 1.0, np.deg2rad(2.0),
                                             loop_closures=True)
    with open(final, "w") as f:
        for line in lines:
            f.write(line + "\n")
    return final, time_file


@pytest.fixture(scope="module")
def demo_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_rpgo")
    rng = np.random.default_rng(21)
    _, runs = world.make_multi_robot_world(
        rng, n_robots=2, n_objects=60, area=(30.0, 30.0, 4.0), traj_len=60.0,
        desc_dim=8, odom_drift_per_m=0.01)
    maps = [world.roman_map_from_run(r) for r in runs]
    trees = {}
    for name, pkg in [("jax", (jodom, jfusion, jcomb, jio)),
                      ("port", (todom, tfusion, tcomb, tio))]:
        out = tmp / name
        for sub in ("map", "align/robot0_robot1", "offline_rpgo/sparse",
                    "offline_rpgo/dense"):
            os.makedirs(out / sub)
        for k, m in enumerate(maps):
            m.save(str(out / "map" / f"robot{k}.pkl"))
        _write_align_g2o(runs, maps, str(out / "align/robot0_robot1/align.g2o"),
                         np.random.default_rng(22))
        trees[name] = (str(out),) + _back_half(pkg, str(out))
    gt = {}
    for k, run in enumerate(runs):
        gt[k] = str(tmp / f"gt{k}.csv")
        world.write_gt_csv(run, gt[k])
    return trees, gt


def test_back_half_writes_the_same_bytes(demo_tree):
    trees, _ = demo_tree
    jroot, troot = Path(trees["jax"][0]), Path(trees["port"][0])
    files = sorted(p.relative_to(jroot) for p in (jroot / "offline_rpgo").rglob("*")
                   if p.is_file())
    assert len(files) == 13
    for rel in files:
        assert (troot / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    final = (troot / "offline_rpgo" / "odom_and_lc.g2o").read_text()
    assert "# NEW LOOP CLOSURES" in final
    new_lc = final.split("# NEW LOOP CLOSURES")[1].split("\n")
    assert sum(ln.startswith("EDGE_SE3:QUAT") for ln in new_lc) >= 4


def _diag(printed: str) -> dict:
    """The diagnostics dict of rpgo_solve_g2o's printed line."""
    line = [ln for ln in printed.splitlines() if ln.startswith("rpgo: ")][-1]
    return ast.literal_eval(line.split("edges, ")[1])


def test_cli_solves_the_demo_graph_as_roman_tpu(demo_tree, tmp_path, capsys):
    """python -m roman_tpu_torch.rpgo.solver with the reference's argument
    vector, on the CPU by ROMAN_TPU_TORCH_RPGO_DEVICE; 0.9 is a chi2
    probability. roman_tpu solves the same file with the same threshold."""
    trees, gt = demo_tree
    _, final, time_file = trees["port"]
    env = {**os.environ, "ROMAN_TPU_TORCH_RPGO_DEVICE": "cpu",
           "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "roman_tpu_torch.rpgo.solver", "3d", final,
         "-1.0", "-1.0", "0.9", str(tmp_path), "v"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    diag_t = _diag(out.stdout)
    os.makedirs(tmp_path / "jax")
    params = dataclasses.replace(jsolver.RPGOSolverParams(),
                                 pcm_thresh=jsolver.chi2_ppf_even_df(0.9, 6))
    capsys.readouterr()
    res_j = jsolver.rpgo_solve_g2o(final, str(tmp_path / "jax"), params)
    diag_j = _diag(capsys.readouterr().out)
    assert diag_t == diag_j and diag_t["n_lc"] >= 4
    res_t = str(tmp_path / "result.g2o")
    np.testing.assert_allclose(_positions(tio.parse_g2o(res_t)),
                               _positions(jio.parse_g2o(res_j)), atol=1e-3)
    ate_t = teval.evaluate(res_t, time_file, gt)
    ate_j = jeval.evaluate(res_j, time_file, gt)
    assert np.isfinite(ate_t) and abs(ate_t - ate_j) < 1e-3
