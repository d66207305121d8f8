"""The port's demo CLI and the modules around it, on the CPU.

- align/evaluate.py against roman_tpu.align.evaluate on seeded alignment
  results (PR and its sweep and AUC, place recognition, frustum pruning,
  the recall denominator, the report);
- rpgo/g2o_utils.py against roman_tpu's; result.png well formed;
- ``python -m roman_tpu_torch.demo --cpu`` in-process, with cv2 and
  matplotlib blocked, on a tiny sim world (the output tree, loop
  closures, ATE below odometry alone's, --skip-map rerunning stages 2-3
  to the same bytes) and on tiny ROS1 bags (the recorded-data path:
  odometry composed with the bag's TF extrinsic);
- without --cpu on a host without a card, the CLI raises and writes
  nothing.
"""

import contextlib
import io
import os
import pickle
import sys

import numpy as np
import pytest
import torch
import yaml

from roman_tpu.align import evaluate as j_ev
from roman_tpu.align.results import SubmapAlignResults as JResults
from roman_tpu.data.camera import CameraParams as JCameraParams
from roman_tpu.rpgo import g2o_utils as j_gu
from roman_tpu.rpgo import plot_g2o as j_plot
from roman_tpu.rpgo.g2o_io import parse_g2o as j_parse
from roman_tpu_torch import demo
from roman_tpu_torch.align import evaluate as t_ev
from roman_tpu_torch.align.results import SubmapAlignResults as TResults
from roman_tpu_torch.data import png
from roman_tpu_torch.data.camera import CameraParams as TCameraParams
from roman_tpu_torch.map.roman_map import load_roman_map
from roman_tpu_torch.rpgo import g2o_utils as t_gu
from roman_tpu_torch.rpgo import plot_g2o as t_plot
from roman_tpu_torch.rpgo.g2o_io import parse_g2o as t_parse
from roman_tpu_torch.sim.rgbd_bags import write_bag_world

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_RUNS = ["robot0", "robot1"]


def _yaw_T(rng):
    T = np.eye(4)
    a = rng.uniform(-np.pi, np.pi)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.normal(size=3) * 8.0
    return T


def seeded_results(seed, n0, n1):
    """The fields of one SubmapAlignResults, seeded: nearby pairs (NaN
    where far), errors, counts, similarities, yaw gaps and T_ij."""
    rng = np.random.default_rng(seed)
    nearby = rng.uniform(0, 40, (n0, n1))
    nearby[rng.uniform(size=(n0, n1)) < 0.5] = np.nan
    attempted = rng.uniform(size=(n0, n1)) < 0.9
    return dict(
        robots_nearby_mat=nearby,
        clipper_angle_mat=np.where(attempted, rng.exponential(8.0, (n0, n1)), np.nan),
        clipper_dist_mat=np.where(attempted, rng.exponential(3.0, (n0, n1)), np.nan),
        clipper_num_associations=np.where(attempted, rng.integers(0, 25, (n0, n1)), np.nan),
        similarity_mat=rng.uniform(0, 1, (n0, n1)),
        submap_yaw_diff_mat=rng.uniform(0, 180, (n0, n1)),
        associated_objs_mat=[[np.zeros((0, 2), np.int64)] * n1] * n0,
        T_ij_mat=np.stack([np.stack([_yaw_T(rng) for _ in range(n1)]) for _ in range(n0)]),
        T_ij_hat_mat=np.broadcast_to(np.eye(4), (n0, n1, 4, 4)).copy(),
        timing_list=list(rng.uniform(0.001, 0.01, n0 * n1)),
        submap_align_params=None, submap_io=None)


def pair_sizes(*n):
    """The (rows, cols) of the pair results (0, 1), (0, 2), (1, 2) of three
    robots with n[0], n[1] and n[2] submaps."""
    return [(n[i], n[j]) for i, j in ((0, 1), (0, 2), (1, 2))]


@pytest.mark.parametrize("frustum", [False, True])
def test_evaluate_matches_roman_tpu(frustum):
    """Three robots (three pair results), both packages' evaluators on the
    same seeded matrices: success rates, PR at every threshold with the
    recall denominator over every nearby pair, the PR sweep and its AUC,
    recall@1, aggregated place recognition and its sweep, timing and the
    report; with frustum pruning of nearby pairs when asked."""
    fields = [seeded_results(s, n0, n1) for s, (n0, n1) in enumerate(pair_sizes(7, 6, 5))]
    params = dict(rm_non_camera_overlap=frustum, place_rec_require_pose_success=frustum)
    cams = ([TCameraParams.simple()] * 3, [JCameraParams.simple()] * 3) if frustum else \
        (None, None)
    got = t_ev.SubmapAlignEvaluator([TResults(**{k: (v.copy() if isinstance(v, np.ndarray)
                                                     else v) for k, v in f.items()})
                                     for f in fields], t_ev.EvalParams(**params),
                                    camera_params=cams[0])
    ref = j_ev.SubmapAlignEvaluator([JResults(**{k: (v.copy() if isinstance(v, np.ndarray)
                                                     else v) for k, v in f.items()})
                                     for f in fields], j_ev.EvalParams(**params),
                                    camera_params=cams[1])
    for a, b in zip(got.results, ref.results):
        np.testing.assert_array_equal(a.robots_nearby_mat, b.robots_nearby_mat)
    if frustum:
        pruned = sum(int(np.isnan(r.robots_nearby_mat).sum()) for r in got.results)
        before = sum(int(np.isnan(f["robots_nearby_mat"]).sum()) for f in fields)
        assert pruned > before
    assert got.evaluate_align_success_rate() == ref.evaluate_align_success_rate()
    for thr in range(0, 26):
        assert vars(got.evaluate_precision_recall(thr)) == vars(ref.evaluate_precision_recall(thr))
        assert str(vars(got.evaluate_place_recognition(thr))) == \
            str(vars(ref.evaluate_place_recognition(thr)))
    pr = got.evaluate_precision_recall()
    n_nearby = sum(int((~np.isnan(r.robots_nearby_mat)).sum()) for r in got.results)
    assert pr.tp + pr.fn == n_nearby  # every nearby pair counts against recall
    for name in ("evaluate_precision_recall_sweep", "evaluate_place_recognition_sweep"):
        a, b = getattr(got, name)(), getattr(ref, name)()
        for f in ("thresholds", "precisions", "recalls"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert str(a.auc) == str(b.auc)
    assert got.recall_at_1() == ref.recall_at_1()
    assert got.evaluate_timing() == ref.evaluate_timing()
    assert got.report() == ref.report()
    T = np.eye(4)
    T[0, 3] = 10.0
    T[:2, :2] = [[-1, 0], [0, -1]]
    for rdf in (False, True):
        assert t_ev.camera_views_overlap(T, TCameraParams.simple(), TCameraParams.simple(),
                                         T_ij_uses_rdf=rdf) == \
            j_ev.camera_views_overlap(T, JCameraParams.simple(), JCameraParams.simple(),
                                      T_ij_uses_rdf=rdf)


def test_evaluate_cli_reports_the_pickled_results(tmp_path):
    paths = []
    for s in range(3):
        r = TResults(**seeded_results(10 + s, *pair_sizes(5, 4, 3)[s]))
        paths.append(str(tmp_path / f"align{s}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(r, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_ev.main(paths + ["--min-assoc", "5", "--rm-overlap"])
    ref = j_ev.SubmapAlignEvaluator(
        [JResults(**seeded_results(10 + s, *pair_sizes(5, 4, 3)[s])) for s in range(3)],
        j_ev.EvalParams(min_assoc=5, rm_non_camera_overlap=True),
        camera_params=[JCameraParams.simple()] * 3)
    assert buf.getvalue().strip() == ref.report()


def _graph_lines(seed=0):
    """A fused two-robot g2o with vertices, odometry and a loop closure."""
    rng = np.random.default_rng(seed)
    lines = []
    for r, letter in enumerate("ab"):
        key0 = (ord(letter) << 56)
        for k in range(5):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            lines.append(f"VERTEX_SE3:QUAT {key0 + k} " + " ".join(
                f"{v:.9g}" for v in np.concatenate([rng.normal(size=3) * 5, q])))
            if k:
                lines.append(f"EDGE_SE3:QUAT {key0 + k - 1} {key0 + k} 1 0 0 0 0 0 1 "
                             + " ".join(["1", "0", "0", "0", "0", "0", "1", "0", "0", "0",
                                         "0", "1", "0", "0", "0", "1", "0", "0", "1",
                                         "0", "1"]))
    lines.append(f"EDGE_SE3:QUAT {ord('a') << 56} {(ord('b') << 56) + 2} 0 1 0 0 0 0 1 "
                 + " ".join(["4"] + ["0"] * 5 + ["4"] + ["0"] * 4 + ["4"] + ["0"] * 3
                            + ["100", "0", "0", "100", "0", "100"]))
    return lines


def _same_graph(a, b):
    assert sorted(a.vertices) == sorted(b.vertices)
    for k in a.vertices:
        np.testing.assert_array_equal(a.vertices[k], b.vertices[k])
    assert [(e.v1, e.v2) for e in a.edges] == [(e.v1, e.v2) for e in b.edges]
    for x, y in zip(a.edges, b.edges):
        np.testing.assert_array_equal(x.xyz_quat, y.xyz_quat)
        np.testing.assert_array_equal(x.info_upper, y.info_upper)


def test_g2o_utils_and_plots_match_roman_tpu(tmp_path, monkeypatch):
    lines = _graph_lines()
    path = tmp_path / "fused.g2o"
    path.write_text("\n".join(lines) + "\n")
    tg, jg = t_parse(str(path)), j_parse(str(path))
    T = np.eye(4)
    T[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    T[:3, 3] = [1.0, -2.0, 0.5]
    _same_graph(t_gu.g2o_change_frame(tg, T), j_gu.g2o_change_frame(jg, T))
    _same_graph(t_gu.rm_robots(tg, "a"), j_gu.rm_robots(jg, "a"))
    assert t_plot.rm_robots_g2o(lines, "b") == j_plot.rm_robots_g2o(lines, "b")
    for args in (["change-frame", "--xyz", "1", "-2", "0.5", "--quat", "0", "0", "0.6", "0.8"],
                 ["rm-robots", "--keep", "b"]):
        t_out, j_out = tmp_path / "t.g2o", tmp_path / "j.g2o"
        t_gu.main([args[0], str(path), str(t_out)] + args[1:])
        monkeypatch.setattr(sys, "argv", ["g2o_utils", args[0], str(path), str(j_out)]
                            + args[1:])
        j_gu.main()
        assert t_out.read_bytes() == j_out.read_bytes()
    img = t_plot.plot_result(str(path), str(tmp_path / "result.png"))
    back = png.decode_png((tmp_path / "result.png").read_bytes())
    np.testing.assert_array_equal(back, img)
    assert back.shape == (800, 800, 3)
    for color in (t_plot.DEFAULT_TRAJECTORY_COLORS["a"], t_plot.DEFAULT_TRAJECTORY_COLORS["b"]):
        assert (back == color).all(axis=-1).sum() > 50  # each robot is drawn


@contextlib.contextmanager
def without_cv2_and_matplotlib():
    """The machine with the card has neither: the CLI's path must not
    import them (roman_tpu's demo draws its PNGs with matplotlib)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        mp.setitem(sys.modules, "matplotlib", None)
        yield


def _tree_ok(out, runs, pair):
    for p in [f"map/{runs[0]}.pkl", f"map/{runs[1]}.pkl", f"map/{runs[0]}.time.txt",
              f"align/{pair}/align.g2o", f"align/{pair}/align.png",
              f"align/{pair}/align.pkl", "offline_rpgo/result.g2o",
              "offline_rpgo/result.png", f"offline_rpgo/{runs[0]}.csv",
              f"offline_rpgo/{runs[1]}.csv", "offline_rpgo/ate_rmse.txt",
              "offline_rpgo/sparse/odom_all.g2o", "offline_rpgo/dense/odom_and_lc.g2o",
              "params/data.yaml"]:
        assert (out / p).exists(), p
    png.decode_png((out / "offline_rpgo" / "result.png").read_bytes())


@pytest.fixture(scope="module")
def sim_demo(tmp_path_factory):
    """A two-robot sim world small enough for the host mapper on one
    thread (100 objects, 30 m trajectories, a frame a second)."""
    tmp = tmp_path_factory.mktemp("torch_demo_sim")
    params = tmp / "params"
    params.mkdir()
    with open(params / "data.yaml", "w") as f:
        yaml.dump({"runs": SIM_RUNS, "dt": 1.0, "img_data_params": {
            "type": "sim", "seed": 5, "n_robots": 2, "n_objects": 100,
            "area": [30.0, 30.0, 4.0], "traj_len": 30.0, "desc_dim": 16}}, f)
    with open(params / "submap_align.yaml", "w") as f:
        yaml.dump({"method": "roman", "semantics_dim": 16, "submap_max_size": 20,
                   "cosine_min": 0.5, "cosine_max": 0.9}, f)
    with open(params / "mapper.yaml", "w") as f:
        yaml.dump({"min_2d_iou": None, "min_sightings": 2, "max_t_no_sightings": 1.2,
                   "geometric_score_range": [0.15, 1.0], "min_max_extent": 0.05}, f)
    out = tmp / "out"
    with without_cv2_and_matplotlib():
        stages = demo.main(["-p", str(params), "-o", str(out), "--cpu"])
    return params, out, stages


def test_demo_cli_on_a_sim_world(sim_demo):
    """The output tree, loop closures between the robots, and an ATE below
    that of the odometry alone."""
    from roman_tpu_torch.rpgo.evaluate import evaluate

    _, out, stages = sim_demo
    assert sorted(stages) == ["align", "map", "rpgo"]
    _tree_ok(out, SIM_RUNS, "robot0_robot1")
    g2o = (out / "align" / "robot0_robot1" / "align.g2o").read_text()
    assert g2o.count("EDGE_SE3:QUAT") >= 1
    ate = float((out / "offline_rpgo" / "ate_rmse.txt").read_text())
    # sparse/odom_all.g2o is the two robots' odometry fused with no loop
    # closure and nothing solved
    sparse = out / "offline_rpgo" / "sparse"
    gt = {i: str(out / "gt" / f"{r}.yaml") for i, r in enumerate(SIM_RUNS)}
    ate_odom = evaluate(str(sparse / "odom_all.g2o"), str(sparse / "odom_all.time.txt"), gt)
    assert np.isfinite(ate) and ate < ate_odom, (ate, ate_odom)


def test_demo_cli_skip_map_reruns_alignment_and_pgo_to_the_same_bytes_and_profiles(sim_demo):
    params, out, _ = sim_demo
    files = ["align/robot0_robot1/align.g2o", "offline_rpgo/result.g2o"]
    before = [(out / f).read_bytes() for f in files]
    maps = (out / "map" / "robot0.pkl").stat().st_mtime_ns
    stages = demo.main(["-p", str(params), "-o", str(out), "--cpu", "--skip-map"])
    assert sorted(stages) == ["align", "rpgo"]
    assert (out / "map" / "robot0.pkl").stat().st_mtime_ns == maps
    assert [(out / f).read_bytes() for f in files] == before
    # --profile: a torch.profiler trace of the (alignment-only) run
    demo.main(["-p", str(params), "-o", str(out), "--cpu", "--skip-map", "--skip-rpgo",
               "--skip-self-lc", "--profile", str(out / "profile")])
    trace = (out / "profile" / "trace.json").read_text()
    assert '"traceEvents"' in trace and "aten::" in trace


BAG_FRAMES, BAG_H, BAG_W, BAG_DT = 12, 96, 128, 0.25


def test_demo_cli_on_bags(tmp_path):
    """Two robots' ROS1 bags (rgb8, 16UC1 depth, CameraInfo, Odometry and
    the extrinsic on /tf_static) through the CLI with tiny seeded nets: the
    run completes, and each map's trajectory is the bag's odometry times
    the TF extrinsic."""
    params, odoms, T_base_cam = write_bag_world(
        str(tmp_path), ["r0", "r1"], BAG_FRAMES, BAG_H, BAG_W, BAG_DT, seed=11,
        fastsam={"imgsz": [BAG_H, BAG_W], "seg_arch": "tiny", "vit_arch": "tiny",
                 "batch_frames": 4, "max_masks_per_frame": 8, "max_points_per_mask": 64,
                 "conf": 0.0, "min_mask_len_div": 40, "max_mask_len_div": 1},
        mapper={"min_sightings": 1, "max_t_no_sightings": 2.0,
                "geometric_score_range": [0.05, 1.0], "min_max_extent": 0.02},
        submap_align={"method": "roman", "semantics_dim": 64, "submap_max_size": 20,
                      "cosine_min": 0.5, "cosine_max": 0.9})
    out = tmp_path / "out"
    old = os.environ.get("ROBOT")
    try:
        with without_cv2_and_matplotlib():
            demo.main(["-p", params, "-o", str(out), "--cpu", "--skip-self-lc"])
    finally:
        if old is None:
            os.environ.pop("ROBOT", None)
        else:
            os.environ["ROBOT"] = old
    _tree_ok(out, ["r0", "r1"], "r0_r1")
    assert not (out / "align" / "r0_r0").exists()
    for run in ["r0", "r1"]:
        m = load_roman_map(str(out / "map" / f"{run}.pkl"))
        assert type(m).__module__ == "roman_tpu_torch.map.roman_map"
        assert len(m.times) >= BAG_FRAMES - 2
        idx = np.round(np.asarray(m.times) / BAG_DT).astype(int)
        np.testing.assert_allclose(m.trajectory, (odoms[run] @ T_base_cam)[idx], atol=1e-6)
    assert np.isfinite(float((out / "offline_rpgo" / "ate_rmse.txt").read_text()))


def test_demo_cli_without_a_card_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["-p", os.path.join(ROOT, "params", "demo_sim"), "-o", str(out)])
    assert not out.exists()


def test_viz_matches_roman_tpu_and_names_what_it_lacks(tmp_path, monkeypatch):
    """The map video of the CLI's -3 flag: the port's render equals
    roman_tpu's pixel for pixel; without OpenCV, writing the video raises
    an ImportError naming cv2, and without matplotlib the render names it."""
    from roman_tpu import viz as j_viz
    from roman_tpu.map.roman_map import SegmentData as JSegment
    from roman_tpu_torch import viz as t_viz
    from roman_tpu_torch.map.roman_map import SegmentData as TSegment

    rng = np.random.default_rng(2)
    fields = [dict(id=i, center=rng.uniform(-10, 10, 3), volume=1.0, linearity=0.2,
                   planarity=0.4, scattering=0.4, extent=np.array([1.0, 1.0, 2.0]),
                   semantic_descriptor=None, first_seen=float(i), last_seen=float(i + 5))
              for i in range(5)]
    traj = np.broadcast_to(np.eye(4), (6, 4, 4)).copy()
    traj[:, 0, 3] = np.linspace(0, 5, 6)
    got = t_viz.render_map_frame([TSegment(**f) for f in fields], traj[:4], traj[3], t=3.0,
                                 figsize=(2, 2), dpi=40)
    ref = j_viz.render_map_frame([JSegment(**f) for f in fields], traj[:4], traj[3], t=3.0,
                                 figsize=(2, 2), dpi=40)
    np.testing.assert_array_equal(got, ref)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        t_viz.write_video([got], str(tmp_path / "map.mp4"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        t_viz.render_map_frame([], traj[:1], traj[0])


# ---------------------------------------------------------------------------
# the demo's other CLIs, on the sim demo's tree
# ---------------------------------------------------------------------------

def _edges(path):
    return [ln for ln in path.read_text().splitlines() if ln.startswith("EDGE")]


def test_loop_closures_cli_writes_the_demo_alignment_edges(sim_demo, tmp_path, capsys):
    """python -m roman_tpu_torch.demo.loop_closures --cpu on the demo's two
    maps with its params: the EDGE lines of the demo's alignment stage,
    and demo/loop_closures.py's line."""
    from roman_tpu_torch.demo import loop_closures

    params, out, _ = sim_demo
    lc = tmp_path / "lc"
    loop_closures.main([str(out / "map" / "robot0.pkl"), str(out / "map" / "robot1.pkl"),
                        "-o", str(lc), "-p", str(params / "submap_align.yaml"), "--cpu"])
    got = _edges(lc / "align.g2o")
    assert got and got == _edges(out / "align" / "robot0_robot1" / "align.g2o")
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"{len(got)} loop closures written to {lc / 'align.g2o'}"


def test_merge_demo_output_is_read_by_roman_tpu(sim_demo, tmp_path):
    """The two robots' maps merged as chunks: roman_tpu reads the pickle,
    with roman_tpu's own merge's segment ids, centers, points and times."""
    from roman_tpu.map.roman_map import RomanMap as JRomanMap
    from roman_tpu_torch.demo import merge_demo_output

    _, out, _ = sim_demo
    chunks = [str(out / "map" / f"{r}.pkl") for r in SIM_RUNS]
    merged = tmp_path / "merged.pkl"
    got = merge_demo_output.main(chunks + ["-o", str(merged)])
    back = JRomanMap.from_pickle(str(merged))
    ref = JRomanMap.concatenate([JRomanMap.from_pickle(p) for p in chunks])
    assert type(back) is JRomanMap and len(back.segments) == len(got.segments) > 0
    assert [s.id for s in back.segments] == [s.id for s in ref.segments]
    assert len({s.id for s in back.segments}) == len(back.segments)
    for a, b in zip(back.segments, ref.segments):
        np.testing.assert_array_equal(a.center, b.center)
        np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(back.times, ref.times)
    np.testing.assert_array_equal(back.trajectory, ref.trajectory)


def _run_roman_tpu_cli(script, argv, monkeypatch, entry=None):
    """roman_tpu's demo/<script> in this process, as `python demo/<script>
    argv` runs it (`entry`: a function its module defines instead of its
    __main__ block)."""
    import runpy

    import matplotlib.pyplot as plt

    monkeypatch.setattr(sys, "argv", [script] + argv)
    path = os.path.join(ROOT, "demo", script)
    try:
        if entry:
            runpy.run_path(path, run_name="roman_tpu_demo")[entry]()
        else:
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert not e.code
    plt.close("all")


def _same_pngs(a, b):
    """Every PNG under directory or file `a` equals its namesake under `b`,
    pixel for pixel."""
    files = sorted(p.name for p in a.iterdir()) if a.is_dir() else [None]
    assert files
    import cv2

    for f in files:
        pa, pb = (a / f, b / f) if f else (a, b)
        np.testing.assert_array_equal(cv2.imread(str(pa), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(str(pb), cv2.IMREAD_UNCHANGED))


def test_map_viz_matches_roman_tpu(sim_demo, tmp_path, monkeypatch):
    from roman_tpu_torch.demo import map_viz, o3d_viz

    _, out, _ = sim_demo
    pkl = str(out / "map" / "robot1.pkl")
    flags = ["--no-orig", "-t", "5", "20"]
    _run_roman_tpu_cli("map_viz.py", [pkl, "-o", str(tmp_path / "ref.png")] + flags,
                       monkeypatch)
    assert map_viz.main([pkl, "-o", str(tmp_path / "got.png")] + flags) == \
        str(tmp_path / "got.png")
    _same_pngs(tmp_path / "got.png", tmp_path / "ref.png")
    assert o3d_viz.main is map_viz.main


def test_submap_viz_matches_roman_tpu(sim_demo, tmp_path, monkeypatch):
    """-t: every run's sheet, all runs together and each robot pair's
    matrix sheet (the titles name the output directory, so both packages
    write into the same one in turn)."""
    import shutil

    from roman_tpu_torch.demo import submap_viz

    params, out, _ = sim_demo
    viz = out / "submap_viz"
    argv = ["-p", str(params), "-o", str(out), "-t"]
    _run_roman_tpu_cli("submap_viz.py", argv, monkeypatch, entry="main")
    shutil.move(viz, tmp_path / "ref")
    written = submap_viz.main(argv)
    assert sorted(os.path.basename(p) for p in written) == sorted(os.listdir(tmp_path / "ref"))
    assert "all_runs.png" in os.listdir(viz) and "robot0_robot1_matrix.png" in os.listdir(viz)
    _same_pngs(viz, tmp_path / "ref")
    shutil.rmtree(viz)


def test_association_vid_matches_roman_tpu(sim_demo, tmp_path, monkeypatch):
    """The association figures of every loop closure, and the camera-frame
    video's frames (caught before they are encoded)."""
    from roman_tpu import viz as j_viz
    from roman_tpu_torch.align import align_viz
    from roman_tpu_torch.demo import association_vid

    _, out, _ = sim_demo
    pkl = str(out / "align" / "robot0_robot1" / "align.pkl")
    _run_roman_tpu_cli("association_vid.py", [pkl, "-o", str(tmp_path / "ref")], monkeypatch)
    written = association_vid.main([pkl, "-o", str(tmp_path / "got")])
    assert len(written) == len(os.listdir(tmp_path / "ref")) > 0
    _same_pngs(tmp_path / "got", tmp_path / "ref")

    frames = {}

    def catch(key):
        def write_video(f, path, fps=6.0):
            frames[key] = f
            return path
        return write_video

    monkeypatch.setattr(j_viz, "write_video", catch("ref"))
    monkeypatch.setattr(align_viz, "write_video", catch("got"))
    argv = [pkl, "--camera-video", "--camera-fps", "2"]
    _run_roman_tpu_cli("association_vid.py", argv + ["-o", str(tmp_path / "ref_cam")],
                       monkeypatch)
    association_vid.main(argv + ["-o", str(tmp_path / "got_cam")])
    assert len(frames["got"]) == len(frames["ref"]) > 1
    for a, b in zip(frames["got"], frames["ref"]):
        np.testing.assert_array_equal(a, b)
    assert any((a != a[0, 0]).any() for a in frames["got"])  # outlines drawn


@pytest.mark.parametrize("cli,argv,package", [
    ("map_viz", ["{map}"], "matplotlib"),
    ("o3d_viz", ["{map}", "--show-text"], "matplotlib"),
    ("submap_viz", ["-p", "{params}", "-o", "{out}", "-t"], "matplotlib"),
    ("association_vid", ["{align}", "-o", "{out}/assoc", "--video"], "cv2"),
    ("association_vid", ["{align}", "-o", "{out}/assoc"], "matplotlib"),
    ("association_vid", ["{align}", "-o", "{out}/cam", "--camera-video"], "cv2"),
])
def test_viz_clis_without_cv2_and_matplotlib_name_the_package_and_write_nothing(
        sim_demo, tmp_path, cli, argv, package):
    """As on the machine with the card: each viz CLI raises an ImportError
    naming what it needs, before it writes anything."""
    import importlib
    import shutil

    params, out, _ = sim_demo
    shutil.copytree(out / "map", tmp_path / "map")
    fill = dict(map=str(tmp_path / "map" / "robot0.pkl"), params=str(params),
                out=str(tmp_path), align=str(out / "align" / "robot0_robot1" / "align.pkl"))
    before = sorted(p for p in tmp_path.rglob("*"))
    with without_cv2_and_matplotlib():
        with pytest.raises(ImportError, match=repr(package)):
            importlib.import_module(f"roman_tpu_torch.demo.{cli}").main(
                [a.format(**fill) for a in argv])
    assert sorted(p for p in tmp_path.rglob("*")) == before


def test_chunked_mapping_pickle_equals_roman_tpu(tmp_path):
    """demo/mapping.py::mapping in time chunks of 4 dt on the world of
    tests/test_chunked_mapping.py (seed 5, 150 objects, dt 0.5) writes the
    same map pickle, byte for byte, in both packages."""
    from demo.mapping import mapping as j_mapping
    from roman_tpu_torch.demo.mapping import mapping as t_mapping

    params = tmp_path / "params"
    params.mkdir()
    with open(params / "data.yaml", "w") as f:
        yaml.dump({"runs": ["robot0"], "dt": 0.5, "img_data_params": {
            "type": "sim", "seed": 5, "n_robots": 1, "n_objects": 150,
            "area": [40.0, 40.0, 4.0], "traj_len": 30.0, "desc_dim": 8}}, f)
    j_mapping(str(params), str(tmp_path / "jax"), "robot0", max_time=2.0)
    got = t_mapping(str(params), str(tmp_path / "port"), "robot0", max_time=2.0)
    assert got.times[-1] - got.times[0] >= 29.0 and len(got.segments) > 100
    assert (tmp_path / "port.pkl").read_bytes() == (tmp_path / "jax.pkl").read_bytes()
