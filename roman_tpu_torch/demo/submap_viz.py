"""Submap browsing renders (port of demo/submap_viz.py; reference
roman/align/submap_viz.py:52-227).

    python -m roman_tpu_torch.demo.submap_viz -p PARAMS -o OUT [-r RUN ...]
        [-t] [-n 4]

The reference opens interactive plotly windows showing, per run, every
submap's segment points (random bright colours), submap centres
(outlined markers) and the centre chain; with -t all runs share one
figure. Here the same content is drawn offscreen with matplotlib, and a
per-pair sheet over the whole alignment result matrix is added where
align results exist: each evaluated (i, j) cell shows both submaps'
centres and association lines, green where the pair was accepted as a
loop closure (>= num_req_assoc associations) and red where rejected.

Outputs under <OUT>/submap_viz/: <run>.png, all_runs.png with -t, and
<r1>_<r2>_matrix.png. Host code only; needs matplotlib, and without it
raises an ImportError naming it before it writes anything.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

from roman_tpu_torch.align.results import SubmapAlignResults
from roman_tpu_torch.align.submap_viz import random_bright_color
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.map.roman_map import (SubmapParams, load_roman_map,
                                           submaps_from_roman_map)
from roman_tpu_torch.params.data_params import DataParams
from roman_tpu_torch.params.submap_align_params import SubmapAlignParams
from roman_tpu_torch.viz import pyplot


def load_run_submaps(params_dir, output_dir, runs=None):
    """Reference submap_viz.py:52-107: per run, load map/<run>.pkl and
    build submaps with the params dir's submap_align.yaml + optional
    gt_pose.yaml."""
    sa_path = os.path.join(params_dir, "submap_align.yaml")
    sm_params = (SubmapAlignParams.from_yaml(sa_path)
                 if os.path.exists(sa_path) else SubmapAlignParams())
    data_params = DataParams.from_yaml(os.path.join(params_dir, "data.yaml"))
    if runs is not None:
        data_params.runs = runs
    gt_yaml = os.path.join(params_dir, "gt_pose.yaml")
    has_gt = os.path.exists(gt_yaml)

    run_submaps = []
    for run in data_params.runs:
        map_file = os.path.join(output_dir, "map", f"{run}.pkl")
        gt_pose_data = None
        if has_gt:
            if data_params.run_env is not None:
                os.environ[data_params.run_env] = run
            with open(gt_yaml) as f:
                gt_pose_data = PoseData.from_yaml_spec(yaml.safe_load(f))
        submap_params = SubmapParams.from_submap_align_params(sm_params)
        submap_params.use_minimal_data = True
        roman_map = load_roman_map(map_file)
        run_submaps.append(
            submaps_from_roman_map(roman_map, submap_params, gt_pose_data))
    return data_params.runs, run_submaps, has_gt


def draw_run(ax, submaps, rng, chain_color=None, label=None):
    """One run's submap browsing content (reference submap_viz.py:140-198):
    per-submap segment points, outlined center markers, half-colored
    chain segments."""
    last_center = None
    last_color = None
    last_colors = []
    for sm in submaps:
        color = random_bright_color(last_colors, rng=rng)
        pts = sm.segments_as_global_points
        if pts is not None and len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], s=4, color=color, alpha=0.7,
                       linewidths=0)
        center = sm.position_gt if sm.has_gt else sm.position
        ax.scatter([center[0]], [center[1]], s=60, color=color,
                   edgecolors="black", linewidths=1.2, zorder=3)
        if last_center is not None:
            mid = (np.asarray(last_center) + np.asarray(center)) / 2
            ax.plot([last_center[0], mid[0]], [last_center[1], mid[1]],
                    color=chain_color or last_color, alpha=0.5, linewidth=2.5)
            ax.plot([mid[0], center[0]], [mid[1], center[1]],
                    color=chain_color or color, alpha=0.5, linewidth=2.5)
        last_center = center
        last_color = color
        last_colors.append(color)
        if len(last_colors) > 3:  # reference COLOR_QUEUE_LEN
            last_colors.pop(0)
    if label is not None:
        ax.plot([], [], color=chain_color, label=label, linewidth=3)


def render_runs(runs, run_submaps, has_gt, out_dir, together=False):
    plt = pyplot("submap_viz")
    written = []
    rng = np.random.default_rng(0)
    if together:
        fig, ax = plt.subplots(figsize=(10, 10))
        palette = plt.cm.tab10(np.linspace(0, 1, max(len(runs), 2)))
        for run, submaps, pc in zip(runs, run_submaps, palette):
            draw_run(ax, submaps, rng, chain_color=tuple(pc[:3]),
                     label=f"{run} ({len(submaps)} submaps)")
        ax.legend(fontsize=12)
        ax.set_title(f"{out_dir} (gt={has_gt})")
        ax.set_xlabel("X")
        ax.set_ylabel("Y")
        ax.set_aspect("equal")
        path = os.path.join(out_dir, "all_runs.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written.append(path)
    for run, submaps in zip(runs, run_submaps):
        fig, ax = plt.subplots(figsize=(10, 10))
        draw_run(ax, submaps, rng)
        ax.set_title(f"{run} ({len(submaps)} submaps, gt={has_gt})")
        ax.set_xlabel("X")
        ax.set_ylabel("Y")
        ax.set_aspect("equal")
        path = os.path.join(out_dir, f"{run}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written.append(path)
    return written


def render_pair_matrix(results, submaps1, submaps2, path,
                       num_req_assoc=4, max_cells=100):
    """Per-pair composite sheet over the result matrix: every EVALUATED
    pair (finite num_associations on a nearby pair) gets a cell with
    both submaps' object centers + association lines, green = accepted
    loop closure, red = rejected."""
    plt = pyplot("submap_viz")
    na = results.clipper_num_associations
    cells = [(i, j) for i in range(na.shape[0]) for j in range(na.shape[1])
             if np.isfinite(results.robots_nearby_mat[i, j])]
    if not cells:
        cells = [(i, j) for i in range(na.shape[0])
                 for j in range(na.shape[1])
                 if np.isfinite(na[i, j]) and na[i, j] > 0]
    cells = cells[:max_cells]
    if not cells:
        return None
    cols = int(np.ceil(np.sqrt(len(cells))))
    rows = int(np.ceil(len(cells) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axes = np.atleast_1d(np.asarray(axes)).reshape(-1)
    for ax in axes[len(cells):]:
        ax.set_axis_off()
    for ax, (i, j) in zip(axes, cells):
        accepted = np.isfinite(na[i, j]) and na[i, j] >= num_req_assoc
        c1 = np.stack([np.asarray(s.center).reshape(3)
                       for s in submaps1[i].segments]) \
            if submaps1[i].segments else np.zeros((0, 3))
        c2 = np.stack([np.asarray(s.center).reshape(3)
                       for s in submaps2[j].segments]) \
            if submaps2[j].segments else np.zeros((0, 3))
        T = results.T_ij_hat_mat[i, j]
        if np.isfinite(T).all():
            c2t = c2 @ T[:3, :3].T + T[:3, 3]
        else:
            c2t = c2
        if len(c1):
            ax.scatter(c1[:, 0], c1[:, 1], s=6, color="maroon")
        if len(c2t):
            ax.scatter(c2t[:, 0], c2t[:, 1], s=6, color="navy")
        assoc = np.asarray(results.associated_objs_mat[i][j]).reshape(-1, 2)
        lc_color = "green" if accepted else "red"
        for a, b in assoc:
            if a < len(c1) and b < len(c2t):
                ax.plot([c1[a, 0], c2t[b, 0]], [c1[a, 1], c2t[b, 1]],
                        color=lc_color, linewidth=0.8)
        n = 0 if not np.isfinite(na[i, j]) else int(na[i, j])
        ax.set_title(f"({i},{j}) {n} assoc", fontsize=8,
                     color=lc_color)
        for spine in ax.spines.values():
            spine.set_edgecolor(lc_color)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m roman_tpu_torch.demo.submap_viz",
        description="Offscreen submap browsing renders "
                    "(reference submap_viz.py CLI parity)")
    parser.add_argument("-p", "--params", type=str, required=True)
    parser.add_argument("-o", "--output-dir", type=str, required=True)
    parser.add_argument("--runs", "-r", type=str, nargs="+", default=None)
    parser.add_argument("--visualize_together", "-t", action="store_true")
    parser.add_argument("-n", "--num-req-assoc", type=int, default=4)
    args = parser.parse_args(argv)
    pyplot("submap_viz")

    runs, run_submaps, has_gt = load_run_submaps(
        args.params, args.output_dir, args.runs)
    viz_dir = os.path.join(args.output_dir, "submap_viz")
    os.makedirs(viz_dir, exist_ok=True)
    written = render_runs(runs, run_submaps, has_gt, viz_dir,
                          together=args.visualize_together)

    # per-pair composites over every robot pair with align results
    align_dir = os.path.join(args.output_dir, "align")
    submaps_by_run = dict(zip(runs, run_submaps))
    if os.path.isdir(align_dir):
        for pair_name in sorted(os.listdir(align_dir)):
            pkl = os.path.join(align_dir, pair_name, "align.pkl")
            if not os.path.exists(pkl):
                continue
            # robust split: run names may themselves contain underscores
            r1 = r2 = None
            for run in runs:
                rest = pair_name[len(run) + 1:]
                if pair_name.startswith(run + "_") and rest in submaps_by_run:
                    r1, r2 = run, rest
                    break
            if r1 is None:
                continue
            results = SubmapAlignResults.load(pkl)
            path = render_pair_matrix(
                results, submaps_by_run[r1], submaps_by_run[r2],
                os.path.join(viz_dir, f"{pair_name}_matrix.png"),
                num_req_assoc=args.num_req_assoc)
            if path:
                written.append(path)
    for w in written:
        print(w)
    return written


if __name__ == "__main__":
    main()
