"""ATE evaluation: associate estimated vs ground-truth trajectories by
timestamp, jointly Umeyama-align, report translation RMSE.

Standalone replacement for the reference's evo-based evaluate
(roman/offline_rpgo/evaluate.py:10-53): evo's sync.associate_trajectories
(max_diff=0.1), traj.align (Umeyama, no scale), APE translation RMSE.
Host copy of roman_tpu/rpgo/evaluate.py; matplotlib is imported only when
a plot is asked for (output_dir).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.ops.se3_np import umeyama_np
from roman_tpu_torch.rpgo.g2o_io import g2o_and_time_to_pose_data


def associate_by_time(t_ref, t_est, max_diff=0.1):
    """evo sync.associate_trajectories equivalent: greedy nearest-time
    matching within max_diff; returns index arrays (ref_idx, est_idx)."""
    ref_idx, est_idx = [], []
    used = set()
    for i, t in enumerate(t_ref):
        k = int(np.argmin(np.abs(t_est - t)))
        if abs(t_est[k] - t) <= max_diff and k not in used:
            ref_idx.append(i)
            est_idx.append(k)
            used.add(k)
    return np.asarray(ref_idx, int), np.asarray(est_idx, int)


def ate_rmse(pd_est: PoseData, pd_gt: PoseData, max_diff: float = 0.1) -> float:
    ri, ei = associate_by_time(pd_gt.times, pd_est.times, max_diff)
    if len(ri) < 3:
        return float("nan")
    p_gt = pd_gt.positions()[ri]
    p_est = pd_est.positions()[ei]
    R, t, s = umeyama_np(p_est, p_gt, with_scale=False)
    p_al = p_est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_al - p_gt) ** 2, axis=1))))


def evaluate(
    est_g2o_file: str,
    est_time_file: str,
    gt_files: Dict[int, str],
    run_names: Optional[Dict[int, str]] = None,
    run_env: Optional[str] = None,
    output_dir: Optional[str] = None,
    max_diff: float = 0.1,
) -> float:
    """Multi-robot ATE: concatenate all robots' associated (gt, est) pairs,
    one joint alignment, one RMSE (reference evaluate.py semantics)."""
    import os

    import yaml

    all_gt, all_est = [], []
    for rid, gt_file in gt_files.items():
        if run_env is not None and run_names is not None:
            os.environ[run_env] = run_names[rid]
        if gt_file.endswith((".yaml", ".yml")):
            with open(gt_file) as f:
                spec = yaml.safe_load(f)
            pd_gt = PoseData.from_yaml_spec(spec)
        else:
            pd_gt = PoseData.from_csv(gt_file)
        pd_est = g2o_and_time_to_pose_data(est_g2o_file, est_time_file, rid)
        ri, ei = associate_by_time(pd_gt.times, pd_est.times, max_diff)
        if len(ri) == 0:
            continue
        all_gt.append(pd_gt.positions()[ri])
        all_est.append(pd_est.positions()[ei])

    if not all_gt:
        return float("nan")
    p_gt = np.concatenate(all_gt)
    p_est = np.concatenate(all_est)
    R, t, _ = umeyama_np(p_est, p_gt, with_scale=False)
    p_al = p_est @ R.T + t
    rmse = float(np.sqrt(np.mean(np.sum((p_al - p_gt) ** 2, axis=1))))

    if output_dir is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.plot(*p_gt.T, label="reference", color="gray")
        ax.plot(*p_al.T, label="estimate (aligned)", color="tab:blue")
        ax.legend()
        os.makedirs(os.path.join(output_dir, "offline_rpgo"), exist_ok=True)
        fig.savefig(os.path.join(output_dir, "offline_rpgo", "aligned_gt_est.png"))
        plt.close(fig)
    return rmse
