"""Full ROMAN pipeline on the port: mapping -> submap alignment -> robust
PGO -> ATE (port of demo/demo.py).

    python -m roman_tpu_torch.demo -p <params_dir> -o <output_dir> [--cpu]

The flags, the output tree (map/ align/ offline_rpgo/{sparse,dense}/
params/ gt/, result.g2o, result.png, <run>.csv, ate_rmse.txt) and the
stage-skip restartability (--skip-map, --skip-align, --skip-rpgo,
--skip-indices, --skip-self-lc, --max-time chunking) are demo/demo.py's.
Every stage runs on cuda, and a host without a card raises before
anything is written; --cpu runs the plain PyTorch path on the CPU.
--profile DIR writes a torch.profiler trace of the run to DIR/trace.json.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import time

import numpy as np
import torch

from roman_tpu_torch.demo import mapping
from roman_tpu_torch.params.data_params import DataParams
from roman_tpu_torch.params.offline_rpgo_params import OfflineRPGOParams
from roman_tpu_torch.params.submap_align_params import (
    SubmapAlignInputOutput,
    SubmapAlignParams,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m roman_tpu_torch.demo")
    parser.add_argument("-p", "--params", required=True,
                        help="Params directory (data.yaml required; fastsam/"
                             "mapper/submap_align/offline_rpgo.yaml optional)")
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-r", "--runs", type=str, nargs="+", default=None)
    parser.add_argument("-m", "--viz-map", action="store_true")
    parser.add_argument("-v", "--viz-observations", action="store_true")
    parser.add_argument("-3", "--viz-3d", action="store_true")
    parser.add_argument("--vid-rate", type=float, default=1.0)
    parser.add_argument("-d", "--save-img-data", action="store_true")
    parser.add_argument("-n", "--num-req-assoc", type=int, default=4)
    parser.add_argument("--max-time", type=float, default=None)
    parser.add_argument("--skip-map", action="store_true")
    parser.add_argument("--skip-align", action="store_true")
    parser.add_argument("--skip-rpgo", action="store_true")
    parser.add_argument("--skip-indices", type=int, nargs="+")
    parser.add_argument("--skip-self-lc", action="store_true")
    parser.add_argument("--skip-distance", type=float, default=np.inf)
    parser.add_argument("--cpu", action="store_true",
                        help="run every stage on the CPU (default: cuda)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the whole run "
                             "to DIR/trace.json")
    return parser.parse_args(argv)


def _profiler(out_dir, device):
    """A torch.profiler context over the run, writing DIR/trace.json."""
    if out_dir is None:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def export(prof):
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))

    return profile(activities=activities, on_trace_ready=export)


def main(argv=None) -> dict:
    """Run the demo; returns each stage's wall seconds ({"map", "align",
    "rpgo"} for the stages that ran)."""
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "the demo on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    params_dir = args.params
    sa_path = os.path.join(params_dir, "submap_align.yaml")
    submap_align_params = (SubmapAlignParams.from_yaml(sa_path)
                           if os.path.exists(sa_path) else SubmapAlignParams())
    rp_path = os.path.join(params_dir, "offline_rpgo.yaml")
    offline_rpgo_params = (OfflineRPGOParams.from_yaml(rp_path)
                           if os.path.exists(rp_path) else OfflineRPGOParams())
    data_params = DataParams.from_yaml(os.path.join(params_dir, "data.yaml"))
    if args.runs is not None:
        data_params.runs = args.runs
    runs = data_params.runs

    # output tree (demo.py:89-95)
    for sub in ["map", "align", "offline_rpgo", "offline_rpgo/sparse",
                "offline_rpgo/dense", "params", "gt"]:
        os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)
    for f in os.listdir(params_dir):
        if f.endswith(".yaml"):
            shutil.copy(os.path.join(params_dir, f),
                        os.path.join(args.output_dir, "params", f))

    stage_s = {}
    with _profiler(args.profile, device):
        if not args.skip_map:
            t0 = time.perf_counter()
            _map_stage(args, runs, device)
            stage_s["map"] = _sync_seconds(t0, device)
        gt_files = _gt_files(args, runs)
        if not args.skip_align:
            t0 = time.perf_counter()
            _align_stage(args, runs, gt_files, data_params, submap_align_params,
                         device)
            stage_s["align"] = _sync_seconds(t0, device)
        if not args.skip_rpgo:
            t0 = time.perf_counter()
            _rpgo_stage(args, runs, gt_files, data_params, offline_rpgo_params,
                        device)
            stage_s["rpgo"] = _sync_seconds(t0, device)
    print("stage wall times: " + ", ".join(f"{k} {v:.2f} s" for k, v in stage_s.items()))
    return stage_s


def _sync_seconds(t0: float, device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _map_stage(args, runs, device):
    """Stage 1: map each run (demo.py:104-133)."""
    for i, run_name in enumerate(runs):
        if args.skip_indices and i in args.skip_indices:
            continue
        print(f"\n----------\nMapping: {run_name}\n----------")
        mapping.mapping(
            params_path=args.params,
            output_path=os.path.join(args.output_dir, "map", run_name),
            run_name=run_name,
            max_time=args.max_time,
            viz_params=mapping.VisualizationParams(
                viz_map=args.viz_map,
                viz_observations=args.viz_observations,
                viz_3d=args.viz_3d,
            ),
            verbose=True,
            gt_csv_path=os.path.join(args.output_dir, "gt", f"{run_name}.csv"),
            device=device,
        )


def _gt_files(args, runs):
    """Ground truth (demo.py:81-87): an explicit gt_pose.yaml, or the csv
    a sim run exported (one yaml each under gt/), else None a run."""
    import yaml

    gt_yaml = os.path.join(args.params, "gt_pose.yaml")
    gt_files = []
    for run_name in runs:
        if os.path.exists(gt_yaml):
            gt_files.append(gt_yaml)
            continue
        csv = os.path.join(args.output_dir, "gt", f"{run_name}.csv")
        if os.path.exists(csv):
            y = os.path.join(args.output_dir, "gt", f"{run_name}.yaml")
            with open(y, "w") as f:
                yaml.dump({"type": "csv", "path": csv}, f)
            gt_files.append(y)
        else:
            gt_files.append(None)
    return gt_files


def _align_stage(args, runs, gt_files, data_params, submap_align_params, device):
    """Stage 2: submap alignment of every robot pair (demo.py:135-161)."""
    from roman_tpu_torch.align.submap_align import submap_align

    for i in range(len(runs)):
        if args.skip_indices and i in args.skip_indices:
            continue
        for j in range(i, len(runs)):
            if args.skip_self_lc and i == j:
                continue
            if args.skip_indices and j in args.skip_indices:
                continue
            out_dir = os.path.join(args.output_dir, "align", f"{runs[i]}_{runs[j]}")
            os.makedirs(out_dir, exist_ok=True)
            sm_io = SubmapAlignInputOutput(
                inputs=[os.path.join(args.output_dir, "map", f"{runs[i]}.pkl"),
                        os.path.join(args.output_dir, "map", f"{runs[j]}.pkl")],
                output_dir=out_dir,
                run_name="align",
                lc_association_thresh=args.num_req_assoc,
                input_gt_pose_yaml=[gt_files[i], gt_files[j]],
                robot_names=[runs[i], runs[j]],
                robot_env=data_params.run_env,
                skip_distance=args.skip_distance,
            )
            submap_align_params.single_robot_lc = (i == j)
            print(f"\n----------\nAligning: {runs[i]} <-> {runs[j]}\n----------")
            submap_align(sm_params=submap_align_params, sm_io=sm_io, device=device)


def _rpgo_stage(args, runs, gt_files, data_params, offline_rpgo_params, device):
    """Stage 3: odometry and loop-closure graphs, the robust solve, the
    plot, the per-run trajectories and the ATE (demo.py:163-302)."""
    from roman_tpu_torch.rpgo.combine_loop_closures import combine_loop_closures
    from roman_tpu_torch.rpgo.evaluate import evaluate
    from roman_tpu_torch.rpgo.extract_odom import roman_map_pkl_to_g2o
    from roman_tpu_torch.rpgo.fusion import create_config, g2o_file_fusion
    from roman_tpu_torch.rpgo.g2o_io import (
        edit_g2o_edge_information,
        g2o_and_time_to_pose_data,
        pose_data_to_csv,
    )
    from roman_tpu_torch.rpgo.plot_g2o import plot_result
    from roman_tpu_torch.rpgo.solver import RPGOSolverParams, rpgo_solve_g2o

    out = args.output_dir
    min_kf = 0.01 if not offline_rpgo_params.sparsified else 2.0
    for i, run_name in enumerate(runs):
        for mode, kf in [("sparse", min_kf), ("dense", None)]:
            roman_map_pkl_to_g2o(
                pkl_file=os.path.join(out, "map", f"{run_name}.pkl"),
                g2o_file=os.path.join(out, "offline_rpgo", mode, f"{run_name}.g2o"),
                time_file=os.path.join(out, "offline_rpgo", mode,
                                       f"{run_name}.time.txt"),
                robot_id=i,
                min_keyframe_dist=kf,
                t_std=offline_rpgo_params.odom_t_std,
                r_std=offline_rpgo_params.odom_r_std,
                verbose=True,
            )
    for mode in ["sparse", "dense"]:
        with open(os.path.join(out, "offline_rpgo", mode, "odom_all.time.txt"),
                  "w") as f:
            for run_name in runs:
                with open(os.path.join(out, "offline_rpgo", mode,
                                       f"{run_name}.time.txt")) as f2:
                    f.write(f2.read())

    sparse_all = os.path.join(out, "offline_rpgo/sparse", "odom_all.g2o")
    g2o_file_fusion(
        create_config(runs, os.path.join(out, "offline_rpgo/sparse")),
        sparse_all, thresh=args.num_req_assoc)
    dense_all = os.path.join(out, "offline_rpgo/dense", "odom_and_lc.g2o")
    g2o_file_fusion(
        create_config(runs, os.path.join(out, "offline_rpgo/dense"),
                      submap_align_dir=os.path.join(out, "align"),
                      align_file_name="align"),
        dense_all, thresh=args.num_req_assoc)

    if offline_rpgo_params.sparsified:
        final_g2o = os.path.join(out, "offline_rpgo", "odom_and_lc.g2o")
        combine_loop_closures(
            g2o_reference=sparse_all,
            g2o_extra_lc=dense_all,
            vertex_times_reference=os.path.join(out, "offline_rpgo/sparse",
                                                "odom_all.time.txt"),
            vertex_times_extra_lc=os.path.join(out, "offline_rpgo/dense",
                                               "odom_all.time.txt"),
            output_file=final_g2o,
        )
        time_file = os.path.join(out, "offline_rpgo/sparse", "odom_all.time.txt")
    else:
        final_g2o = dense_all
        time_file = os.path.join(out, "offline_rpgo/dense", "odom_all.time.txt")

    with open(final_g2o) as f:
        lines = f.readlines()
    lines = edit_g2o_edge_information(
        lines, offline_rpgo_params.lc_t_std, offline_rpgo_params.lc_r_std,
        loop_closures=True)
    with open(final_g2o, "w") as f:
        for line in lines:
            f.write(line + "\n")

    # the robust solve (replaces the RpgoReadG2o subprocess, demo.py:246-250)
    result_g2o = rpgo_solve_g2o(
        final_g2o, os.path.join(out, "offline_rpgo"),
        RPGOSolverParams(gnc_iters=offline_rpgo_params.gnc_iters,
                         gn_iters=offline_rpgo_params.gn_iters,
                         pcm_gate=offline_rpgo_params.pcm_gate),
        device=device)

    # the three projections of the result (demo.py:253-277)
    plot_result(result_g2o, os.path.join(out, "offline_rpgo", "result.png"))

    # per-run optimized trajectories (demo.py:280-285)
    for i, run_name in enumerate(runs):
        pd = g2o_and_time_to_pose_data(result_g2o, time_file, robot_id=i)
        pose_data_to_csv(pd, os.path.join(out, "offline_rpgo", f"{run_name}.csv"))

    # ATE (demo.py:288-302)
    if all(g is not None for g in gt_files):
        ate = evaluate(result_g2o, time_file,
                       {i: gt_files[i] for i in range(len(gt_files))},
                       {i: runs[i] for i in range(len(runs))},
                       data_params.run_env, output_dir=out)
        print("ATE results:\n============")
        print(ate)
        with open(os.path.join(out, "offline_rpgo", "ate_rmse.txt"), "w") as f:
            print(ate, file=f)
