"""Map artifact -> odometry g2o + vertex-time files.

Parity with reference roman/offline_rpgo/extract_odom_g2o.py: keyframe
selection by minimum travel distance (or dense), relative-pose
EDGE_SE3:QUAT chain, VERTEX lines at keyframes, and the per-vertex time
file 'robot_id idx t_ns xxx' (:17-118). Host copy of
roman_tpu/rpgo/extract_odom.py; maps are read through the port's
load_roman_map, so reference mit-acl/roman pickles work too.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from roman_tpu_torch.map.roman_map import load_roman_map
from roman_tpu_torch.ops import se3_np
from roman_tpu_torch.rpgo.g2o_io import information_matrix, info_upper_from_matrix


def select_keyframes(poses: np.ndarray, min_keyframe_dist: Optional[float]) -> np.ndarray:
    """Greedy keyframe index selection: keep a pose when it is farther than
    min_keyframe_dist from the previous keyframe (always keep first and
    last; extract_odom_g2o.py:33-70)."""
    n = len(poses)
    if min_keyframe_dist is None:
        return np.arange(n)
    idx = [0]
    for i in range(1, n):
        if np.linalg.norm(poses[i][:3, 3] - poses[idx[-1]][:3, 3]) > min_keyframe_dist:
            idx.append(i)
    if idx[-1] != n - 1:
        idx.append(n - 1)
    return np.asarray(idx)


def extract_odom_g2o(
    poses: np.ndarray,
    times: np.ndarray,
    I: np.ndarray,
    min_keyframe_dist: Optional[float] = None,
):
    """Returns (vertex_lines, edge_lines, selected_times)."""
    poses = np.asarray(poses)
    idx = select_keyframes(poses, min_keyframe_dist)
    kf = poses[idx]
    # batched relative poses T_12 = inv(T_w1) @ T_w2 over consecutive keyframes
    T12 = np.einsum("kab,kbc->kac", np.linalg.inv(kf[:-1]), kf[1:])
    t, q = se3_np.T_to_xyz_quat(T12)
    iu = info_upper_from_matrix(I)

    edge_lines = []
    for k in range(len(T12)):
        line = f"EDGE_SE3:QUAT {k} {k + 1} \t\t"
        line += f"{t[k, 0]} {t[k, 1]} {t[k, 2]} \t\t"
        line += f"{q[k, 0]} {q[k, 1]} {q[k, 2]} {q[k, 3]} \t\t"
        # upper-triangle info blocks, same layout as the reference writer
        pos = 0
        for ii in range(6):
            for jj in range(ii, 6):
                line += f"{iu[pos]} "
                pos += 1
            line += "\t\t"
        edge_lines.append(line + "\n")

    vt, vq = se3_np.T_to_xyz_quat(kf)
    vertex_lines = [
        f"VERTEX_SE3:QUAT {k} {vt[k, 0]} {vt[k, 1]} {vt[k, 2]} "
        f"{vq[k, 0]} {vq[k, 1]} {vq[k, 2]} {vq[k, 3]}\n"
        for k in range(len(kf))
    ]
    selected_times = [float(times[i]) for i in idx]
    return vertex_lines, edge_lines, selected_times


def roman_map_pkl_to_g2o(
    pkl_file: str,
    g2o_file: str,
    time_file: Optional[str] = None,
    robot_id: int = 0,
    min_keyframe_dist: Optional[float] = None,
    t_std: float = 0.005,
    r_std: float = float(np.deg2rad(0.025)),
    verbose: bool = False,
):
    """Parity with extract_odom_g2o.py:80-118."""
    I = information_matrix(t_std, r_std)
    roman_map = load_roman_map(pkl_file)
    vertex_lines, edge_lines, selected_times = extract_odom_g2o(
        roman_map.trajectory, roman_map.times, I, min_keyframe_dist
    )
    with open(os.path.expanduser(g2o_file), "w") as f:
        for line in vertex_lines + edge_lines:
            f.write(line)
    if verbose:
        print(f"Saved g2o to {os.path.abspath(g2o_file)}")
    if time_file is None:
        return
    with open(os.path.expanduser(time_file), "w") as f:
        for i, time in enumerate(selected_times):
            f.write(f"{robot_id} {i} {int(time * 1e9)} xxx\n")
    if verbose:
        print(f"Saved time data to {os.path.abspath(time_file)}")
