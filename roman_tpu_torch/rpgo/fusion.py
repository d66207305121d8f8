"""Multi-robot g2o fusion with gtsam-symbol vertex renaming.

Parity with reference roman/offline_rpgo/g2o_file_fusion.py: merges
per-robot odometry g2o files plus single-/multi-robot loop-closure g2o
files into one graph, renaming integer vertex ids to symbol keys
('a', 'b', ...), filtering LC edges below the association-count threshold
carried by '# LC: n' comments (:63-68), and de-duplicating self
loop-closure pairs (:60-62). Host copy of roman_tpu/rpgo/fusion.py.
"""

from __future__ import annotations

import os
from typing import List, Optional

from roman_tpu_torch.rpgo.g2o_io import (
    format_edge,
    format_vertex,
    parse_g2o,
    symbol,
)
from roman_tpu_torch.utils import expandvars_recursive


def reformat_g2o_vertex_lines(file: str, letter: str) -> List[str]:
    graph = parse_g2o(expandvars_recursive(file))
    return [format_vertex(symbol(letter, k), xq) for k, xq in graph.vertices.items()]


def reformat_g2o_edge_lines(
    file: str, letter1: str, letter2: str, thresh: Optional[int] = None,
    lc: bool = False, self_lc: bool = False,
) -> List[str]:
    graph = parse_g2o(expandvars_recursive(file))
    out = []
    for e in graph.edges:
        if self_lc and e.v1 >= e.v2:
            # self loop closures appear for both (i,j) and (j,i); keep one
            continue
        if lc and thresh is not None:
            if e.lc_count is None:
                raise ValueError("a loop closure must be preceded by a '# LC:' comment")
            if e.lc_count < thresh:
                continue
        out.append(
            format_edge(symbol(letter1, e.v1), symbol(letter2, e.v2), e.xyz_quat, e.info_upper)
        )
    return out


def create_config(robots, odometry_g2o_dir, submap_align_dir=None, align_file_name=None):
    """Parity with g2o_file_fusion.create_config (:78-102)."""
    config = {"robots": [], "odometry": [], "single_lc": [], "multi_lc": []}
    for i, robot in enumerate(robots):
        config["robots"].append({"robot": robot, "letter": chr(ord("a") + i)})
        config["odometry"].append({"robot": robot, "file": f"{odometry_g2o_dir}/{robot}.g2o"})
        if submap_align_dir is not None:
            config["single_lc"].append(
                {"robot": robot,
                 "file": f"{submap_align_dir}/{robot}_{robot}/{align_file_name}.g2o"}
            )
            for j, robot2 in enumerate(robots):
                if i >= j:
                    continue
                config["multi_lc"].append(
                    {"robot1": robot, "robot2": robot2,
                     "file": f"{submap_align_dir}/{robot}_{robot2}/{align_file_name}.g2o"}
                )
    return config


def g2o_file_fusion(config: dict, output: str, thresh: Optional[int] = None):
    """Parity with g2o_file_fusion (:104-144). Missing single_lc files are
    tolerated (a robot pair may simply have produced no alignment run)."""
    robot_letters = {r["robot"]: r["letter"] for r in config["robots"]}
    lines: List[str] = []
    for odom in config["odometry"]:
        letter = robot_letters[odom["robot"]]
        lines += reformat_g2o_edge_lines(odom["file"], letter, letter, thresh, lc=False)
        lines += reformat_g2o_vertex_lines(odom["file"], letter)
    for single in config.get("single_lc", []):
        if not os.path.exists(expandvars_recursive(single["file"])):
            continue
        letter = robot_letters[single["robot"]]
        lines += reformat_g2o_edge_lines(
            single["file"], letter, letter, thresh, lc=True, self_lc=True
        )
    for multi in config.get("multi_lc", []):
        if not os.path.exists(expandvars_recursive(multi["file"])):
            continue
        l1 = robot_letters[multi["robot1"]]
        l2 = robot_letters[multi["robot2"]]
        lines += reformat_g2o_edge_lines(multi["file"], l1, l2, thresh, lc=True)
    with open(output, "w") as f:
        for line in lines:
            f.write(line + "\n")
