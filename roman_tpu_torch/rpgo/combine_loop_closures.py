"""Move loop closures from the dense pose graph onto the sparsified one.

Parity with reference roman/offline_rpgo/combine_loop_closures.py: for each
LC edge in the dense graph, find the nearest sparse keyframes, compute the
compensating transforms from the dense odometry, and re-express the LC as
T_p0r_p1r = inv(T_p0e_p0r) @ T_p0e_p1e @ T_p1e_p1r (:119-125). Host copy
of roman_tpu/rpgo/combine_loop_closures.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.ops import se3_np
from roman_tpu_torch.rpgo.g2o_io import (
    g2o_and_time_to_pose_data,
    parse_g2o,
    symbol_chr,
    time_vertex_mapping,
)


@dataclasses.dataclass
class LoopClosure:
    vertex0: int
    vertex1: int
    vertex0_time: float
    vertex1_time: float
    xyz_quat: np.ndarray
    information: np.ndarray

    def vertex(self, robot_num: int) -> int:
        return self.vertex0 if robot_num == 0 else self.vertex1

    def vertex_time(self, robot_num: int) -> float:
        return self.vertex0_time if robot_num == 0 else self.vertex1_time

    def robot_id(self, robot_num: int) -> str:
        return symbol_chr(self.vertex(robot_num))

    def transform(self) -> np.ndarray:
        return se3_np.xyz_quat_to_T(self.xyz_quat[:3], self.xyz_quat[3:])

    def __str__(self):
        return (
            f"EDGE_SE3:QUAT {self.vertex0} {self.vertex1} "
            + " ".join(str(x) for x in self.xyz_quat)
            + " "
            + " ".join(str(x) for x in self.information)
        )


def extract_additional_lc(
    loop_closures: List[LoopClosure],
    pd_ref: Dict[str, PoseData],
    pd_elc: Dict[str, PoseData],
    tv_ref: Dict[str, Dict[float, int]],
) -> List[LoopClosure]:
    """Reference combine_loop_closures.py:45-137."""
    extra = []
    for pd in list(pd_ref.values()) + list(pd_elc.values()):
        pd.interp = True
        pd.time_tol = 700.0

    for lc in loop_closures:
        vxs_ref, times_ref, T_t0_tnear = [], [], []
        ok = True
        for i in range(2):
            robot = lc.robot_id(i)
            if robot not in pd_ref or robot not in pd_elc:
                ok = False
                break
            t0 = lc.vertex_time(i)
            t_near = pd_ref[robot].nearest_time(t0)
            times_ref.append(t_near)
            vxs_ref.append(tv_ref[robot][t_near])
            T_odom_t0_e = pd_elc[robot].pose(t0)
            T_odom_tnear_e = pd_elc[robot].pose(t_near)
            T_t0_tnear.append(np.linalg.inv(T_odom_t0_e) @ T_odom_tnear_e)
        if not ok:
            continue
        T_p0e_p1e = lc.transform()
        T_p0r_p1r = np.linalg.inv(T_t0_tnear[0]) @ T_p0e_p1e @ T_t0_tnear[1]
        t, q = se3_np.T_to_xyz_quat(T_p0r_p1r)
        extra.append(
            LoopClosure(
                vertex0=vxs_ref[0],
                vertex1=vxs_ref[1],
                vertex0_time=times_ref[0],
                vertex1_time=times_ref[1],
                xyz_quat=np.concatenate([t, q]),
                information=lc.information,
            )
        )
    return extra


def combine_loop_closures(
    g2o_reference: str,
    g2o_extra_lc: str,
    vertex_times_reference: str,
    vertex_times_extra_lc: str,
    output_file: Optional[str] = None,
) -> List[str]:
    """Reference combine_loop_closures.py:139-220."""
    with open(g2o_reference) as f:
        ref_lines = [ln.rstrip("\n") for ln in f.readlines()]

    ref_graph = parse_g2o(g2o_reference)
    elc_graph = parse_g2o(g2o_extra_lc)

    robot_symbols = {symbol_chr(k) for k in ref_graph.vertices}

    pd_ref, pd_elc = {}, {}
    for r in robot_symbols:
        rid = ord(r) - ord("a")
        pd_ref[r] = g2o_and_time_to_pose_data(g2o_reference, vertex_times_reference, rid)
        pd_elc[r] = g2o_and_time_to_pose_data(g2o_extra_lc, vertex_times_extra_lc, rid)

    vt_ref = time_vertex_mapping(vertex_times_reference, use_gtsam_idx=True)
    vt_elc = time_vertex_mapping(vertex_times_extra_lc, use_gtsam_idx=True)
    tv_ref: Dict[str, Dict[float, int]] = {r: {} for r in robot_symbols}
    for v, t in vt_ref.items():
        tv_ref[symbol_chr(v)][t] = v

    loop_closures = []
    for e in elc_graph.edges:
        if symbol_chr(e.v1) == symbol_chr(e.v2) and abs(e.v1 - e.v2) == 1:
            continue  # odometry edge
        loop_closures.append(
            LoopClosure(
                vertex0=e.v1,
                vertex1=e.v2,
                vertex0_time=vt_elc[e.v1],
                vertex1_time=vt_elc[e.v2],
                xyz_quat=e.xyz_quat,
                information=e.info_upper,
            )
        )

    extra = extract_additional_lc(loop_closures, pd_ref, pd_elc, tv_ref)
    out_lines = ref_lines + ["# NEW LOOP CLOSURES"] + [str(lc) for lc in extra]
    if output_file is not None:
        with open(output_file, "w") as f:
            for line in out_lines:
                f.write(line.strip() + "\n")
    return out_lines
