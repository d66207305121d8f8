"""Alignment result matrices and artifact writers (host port of
roman_tpu/align/results.py, writing the same bytes).

Parity with reference roman/align/results.py: SubmapAlignResults dataclass
(:18-44), heatmap png (:55-120), matrix/results pickles + timing/params
text files (:122-147), the g2o loop-closure edge writer with '# LC: n'
comment protocol and fixed information matrix (:149-195), the LC json list
(:173-198), and per-robot submap/segment json export (:201-246). These
files are the compatibility surface consumed by the offline RPGO stage.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import List, Optional

import numpy as np

from roman_tpu_torch.data.png import write_png
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.map.roman_map import RomanMap, Submap
from roman_tpu_torch.params.submap_align_params import (
    SubmapAlignInputOutput,
    SubmapAlignParams,
)
from roman_tpu_torch.ops import se3_np


def time_to_secs_nsecs(t, as_dict=False):
    seconds = int(t)
    nanoseconds = int((t - int(t)) * 1e9)
    if not as_dict:
        return seconds, nanoseconds
    return {"seconds": seconds, "nanoseconds": nanoseconds}


@dataclasses.dataclass
class SubmapAlignResults:
    robots_nearby_mat: np.ndarray
    clipper_angle_mat: np.ndarray
    clipper_dist_mat: np.ndarray
    clipper_num_associations: np.ndarray
    similarity_mat: Optional[np.ndarray]
    submap_yaw_diff_mat: np.ndarray
    associated_objs_mat: list                   # [i][j] -> (k, 2) int array
    T_ij_mat: np.ndarray
    T_ij_hat_mat: np.ndarray
    timing_list: List[float]
    submap_align_params: SubmapAlignParams
    submap_io: SubmapAlignInputOutput
    total_time: float = -np.inf

    def save(self):
        with open(self.submap_io.output_pkl, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, file_path) -> "SubmapAlignResults":
        with open(file_path, "rb") as f:
            return pickle.load(f)


# colormap anchors, equally spaced over [0, 1] and interpolated linearly
# (samples of matplotlib's perceptually uniform maps of the same names)
_CMAPS = {
    "viridis": ((68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98),
                (253, 231, 37)),
    "cividis": ((0, 34, 78), (62, 77, 109), (124, 123, 120), (188, 175, 111),
                (254, 232, 56)),
    "inferno_r": ((252, 255, 164), (249, 142, 9), (188, 55, 84),
                  (87, 16, 110), (0, 0, 4)),
}
_MARGIN = 8  # white pixels around and between panels


def _colorize(mat, cmap: str, vmin: float, vmax: Optional[float]) -> np.ndarray:
    """(n0, n1) matrix -> (n0, n1, 3) uint8 through the colormap; NaN and
    inf cells stay white. vmax None is the largest finite entry."""
    mat = np.asarray(mat, float)
    finite = np.isfinite(mat)
    if vmax is None:
        vmax = float(mat[finite].max()) if finite.any() else vmin + 1.0
    t = np.clip((np.where(finite, mat, vmin) - vmin)
                / max(vmax - vmin, 1e-12), 0.0, 1.0)
    anchors = np.asarray(_CMAPS[cmap], float)
    x = t * (len(anchors) - 1)
    k = np.minimum(x.astype(int), len(anchors) - 2)
    w = (x - k)[..., None]
    rgb = anchors[k] * (1.0 - w) + anchors[k + 1] * w
    rgb[~finite] = 255.0
    return np.round(rgb).astype(np.uint8)


def plot_align_results(results: SubmapAlignResults) -> np.ndarray:
    """Heatmap panels over the pairwise submap-alignment grid, as an
    (h, w, 3) uint8 image.

    Serves the same diagnostic role as reference roman/align/results.py
    :55-120 (GT distance / yaw gap / registration errors / association
    counts / similarity as per-pair image grids), with the panels of
    roman_tpu's plot in the same order on a two-column grid. It is drawn
    with numpy alone, so it carries no titles, axes or colorbars. Nothing
    downstream parses the png.
    """
    # A pair counts as failed if EITHER registration-error metric blows
    # its threshold; saturate both panels there so a failure is visible
    # in each (a pair can't look "good in angle" while lost in
    # translation). NaN rows (never attempted) stay NaN/blank.
    dist_cap, angle_cap = 5.0, 10.0
    dist_err = np.asarray(results.clipper_dist_mat, float)
    angle_err = np.asarray(results.clipper_angle_mat, float)
    failed = (dist_err > dist_cap) | (angle_err > angle_cap)
    dist_err = np.where(failed & ~np.isnan(dist_err), dist_cap, dist_err)
    angle_err = np.where(failed & ~np.isnan(angle_err), angle_cap, angle_err)

    has_gt = None not in results.submap_io.input_gt_pose_yaml
    # (title, matrix, cmap, vmin, vmax); gt-dependent panels drop out
    # when no gt poses were supplied.
    panels = []
    if has_gt:
        panels += [
            ("Submaps Center Distance (m)",
             results.robots_nearby_mat, "cividis", 0.0, None),
            ("Submap Center Yaw Diff. (deg)",
             results.submap_yaw_diff_mat, "cividis", 0.0, None),
            ("Registration Translation Error (m)",
             dist_err, "inferno_r", 0.0, dist_cap),
            ("Registration Angle Error (deg)",
             angle_err, "inferno_r", 0.0, angle_cap),
        ]
    panels.append(("Number of Associations",
                   results.clipper_num_associations, "viridis", 0.0, None))
    if results.similarity_mat is not None:
        panels.append(("Similarity Score",
                       results.similarity_mat, "viridis", 0.0, 1.0))

    ncol = 1 if len(panels) == 1 else 2
    nrow = (len(panels) + ncol - 1) // ncol
    n0, n1 = np.shape(results.clipper_num_associations)
    cell = max(1, min(16, 400 // max(n0, n1, 1)))  # pixels per grid cell
    ph, pw = n0 * cell, n1 * cell
    img = np.full((_MARGIN + nrow * (ph + _MARGIN),
                   _MARGIN + ncol * (pw + _MARGIN), 3), 255, np.uint8)
    for k, (_title, mat, cmap, vmin, vmax) in enumerate(panels):
        y = _MARGIN + (k // ncol) * (ph + _MARGIN)
        x = _MARGIN + (k % ncol) * (pw + _MARGIN)
        rgb = _colorize(mat, cmap, vmin, vmax)
        img[y:y + ph, x:x + pw] = np.repeat(np.repeat(rgb, cell, 0), cell, 1)
    return img


def save_submap_align_results(
    results: SubmapAlignResults,
    submaps: List[List[Submap]],
    roman_maps: List[RomanMap],
):
    os.makedirs(results.submap_io.output_dir, exist_ok=True)

    write_png(results.submap_io.output_img, plot_align_results(results))

    with open(results.submap_io.output_matrix, "wb") as f:
        pickle.dump(
            [
                results.robots_nearby_mat,
                results.clipper_angle_mat,
                results.clipper_dist_mat,
                results.clipper_num_associations,
                results.submap_yaw_diff_mat,
            ],
            f,
        )

    results.save()

    with open(results.submap_io.output_timing, "w") as f:
        n0, n1 = len(submaps[0]), len(submaps[1])
        f.write(f"Total number of submaps: {n0} x {n1} = {n0 * n1}\n")
        f.write(
            f"Average time per registration: {np.mean(results.timing_list):.4f} seconds\n"
        )
        f.write(f"Total time: {np.sum(results.timing_list):.4f} seconds\n")
        sizes = [len(sm) for sm in submaps[0] + submaps[1]]
        f.write(f"Total number of objects: {np.sum(sizes)}\n")
        f.write(f"Average number of obects per map: {np.mean(sizes):.2f}\n")

    with open(results.submap_io.output_params, "w") as f:
        f.write(f"{results.submap_align_params}")

    _write_g2o_and_json(results, submaps, roman_maps)
    _write_submap_jsons(results, submaps, roman_maps)


def _write_g2o_and_json(results, submaps, roman_maps):
    """Loop-closure g2o + json writers (reference results.py:149-198)."""
    io = results.submap_io
    I_t = 1 / (io.g2o_t_std**2)
    I_r = 1 / (io.g2o_r_std**2)
    I = np.diag([I_t, I_t, I_t, I_r, I_r, I_r])

    pose_data = [
        PoseData.from_times_and_poses(rm.times, rm.trajectory) for rm in roman_maps
    ]
    json_output = []

    with open(io.output_g2o, "w") as f:
        for i in range(len(submaps[0])):
            for j in range(len(submaps[1])):
                if results.clipper_num_associations[i, j] < io.lc_association_thresh:
                    continue
                if (
                    abs(submaps[0][i].time - submaps[1][j].time)
                    < results.submap_align_params.single_robot_lc_time_thresh
                    and results.submap_align_params.single_robot_lc
                ):
                    continue
                if np.any(np.isnan(results.T_ij_hat_mat[i, j])):
                    continue
                T_ci_cj = results.T_ij_hat_mat[i, j]
                T_odomi_ci = submaps[0][i].pose_gravity_aligned
                T_odomj_cj = submaps[1][j].pose_gravity_aligned
                T_odomi_pi = submaps[0][i].pose_flu
                T_odomj_pj = submaps[1][j].pose_flu
                # loop-closure transform composition (results.py:169-171)
                T_pi_pj = (
                    np.linalg.inv(T_odomi_pi)
                    @ T_odomi_ci
                    @ T_ci_cj
                    @ np.linalg.inv(T_odomj_cj)
                    @ T_odomj_pj
                )
                t, q = se3_np.T_to_xyz_quat(T_pi_pj)
                json_output.append(
                    {
                        "seconds": [int(submaps[0][i].time), int(submaps[1][j].time)],
                        "nanoseconds": [
                            int((submaps[0][i].time % 1) * 1e9),
                            int((submaps[1][j].time % 1) * 1e9),
                        ],
                        "names": io.robot_names,
                        "translation": t.tolist(),
                        "rotation": q.tolist(),
                        "rotation_convention": "xyzw",
                    }
                )
                idx_a = pose_data[0].idx(submaps[0][i].time, force_single=True)
                idx_b = pose_data[1].idx(submaps[1][j].time, force_single=True)
                f.write(f"# LC: {int(results.clipper_num_associations[i, j])}\n")
                f.write(f"EDGE_SE3:QUAT a{idx_a} b{idx_b} \t")
                f.write(f"{t[0]} {t[1]} {t[2]} \t")
                f.write(f"{q[0]} {q[1]} {q[2]} {q[3]} \t")
                for ii in range(6):
                    for jj in range(6):
                        if jj < ii:
                            continue
                        f.write(f"{I[ii, jj]} ")
                    f.write("\t")
                f.write("\n")

    with open(io.output_lc_json, "w") as f:
        json.dump(json_output, f, indent=4)


def _write_submap_jsons(results, submaps, roman_maps):
    """Per-robot segment/submap json export (reference results.py:201-246)."""
    io = results.submap_io
    for i, output_sm in enumerate(io.output_submaps):
        if output_sm is None:
            continue
        roman_map = roman_maps[i]
        sm_json = {"segments": [], "submaps": []}
        for segment in roman_map.segments:
            sm_json["segments"].append(
                {
                    "robot_name": io.robot_names[i],
                    "segment_index": segment.id,
                    "centroid_odom": np.asarray(segment.center).reshape(3).tolist(),
                    "shape_attributes": {
                        "volume": float(segment.volume),
                        "linearity": float(segment.linearity),
                        "planarity": float(segment.planarity),
                        "scattering": float(segment.scattering),
                    },
                    "first_seen": time_to_secs_nsecs(segment.first_seen, as_dict=True),
                    "last_seen": time_to_secs_nsecs(segment.last_seen, as_dict=True),
                }
            )
        for j, sm in enumerate(submaps[i]):
            t, q = se3_np.T_to_xyz_quat(sm.pose_gravity_aligned)
            sm_json["submaps"].append(
                {
                    "submap_index": j,
                    "T_odom_submap": {
                        "tx": float(t[0]), "ty": float(t[1]), "tz": float(t[2]),
                        "qx": float(q[0]), "qy": float(q[1]), "qz": float(q[2]),
                        "qw": float(q[3]),
                    },
                    "robot_name": io.robot_names[i],
                    "seconds": int(sm.time),
                    "nanoseconds": int((sm.time % 1) * 1e9),
                    "segment_indices": [s.id for s in sm.segments],
                }
            )
        with open(output_sm, "w") as f:
            json.dump(sm_json, f, indent=4)
