"""g2o text format I/O + gtsam-style symbol keys + edge-information editing
(host copy of roman_tpu/rpgo/g2o_io.py).

Covers the reference's g2o plumbing:
- gtsam symbol vertex-id encoding used by g2o fusion
  (g2o_file_fusion.py:38,72-73): key = (ascii(letter) << 56) | index.
- EDGE_SE3:QUAT / VERTEX_SE3:QUAT parsing and formatting (format_g2o_line,
  g2o_file_fusion.py:8-19; 31-token edge lines).
- '# LC: n' comment protocol for loop-closure association counts
  (results.py:184, g2o_file_fusion.py:63-68).
- edit_g2o_edge_information (edit_g2o_edge_information.py): rewrite the
  information matrices of loop-closure (non-consecutive / cross-robot)
  edges or odometry edges.
- g2o_and_time_to_pose_data + time_vertex_mapping
  (g2o_and_time_to_pose_data.py:23-60): optimized g2o + time file ->
  per-robot PoseData.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.ops import se3_np

_IDX_MASK = (1 << 56) - 1


def symbol(letter: str, index: int) -> int:
    """gtsam.symbol-compatible key."""
    return (ord(letter) << 56) | int(index)


def symbol_chr(key: int) -> str:
    return chr((int(key) >> 56) & 0xFF)


def symbol_index(key: int) -> int:
    return int(key) & _IDX_MASK


@dataclasses.dataclass
class G2OEdge:
    v1: int
    v2: int
    xyz_quat: np.ndarray      # (7,) x y z qx qy qz qw
    info_upper: np.ndarray    # (21,) row-major upper triangle
    lc_count: Optional[int] = None  # from preceding '# LC: n' comment

    @property
    def T(self) -> np.ndarray:
        return se3_np.xyz_quat_to_T(self.xyz_quat[:3], self.xyz_quat[3:])

    @property
    def info(self) -> np.ndarray:
        I = np.zeros((6, 6))
        iu = np.triu_indices(6)
        I[iu] = self.info_upper
        return I + np.triu(I, 1).T


@dataclasses.dataclass
class G2OGraph:
    vertices: Dict[int, np.ndarray]  # key -> (7,) xyz_quat
    edges: List[G2OEdge]

    def vertex_T(self, key: int) -> np.ndarray:
        xq = self.vertices[key]
        return se3_np.xyz_quat_to_T(xq[:3], xq[3:])


def info_upper_from_matrix(I: np.ndarray) -> np.ndarray:
    return I[np.triu_indices(6)]


def information_matrix(t_std: float, r_std: float) -> np.ndarray:
    """Diagonal information from std devs (extract_odom_g2o.py:11-15)."""
    I_t = 1 / (t_std**2)
    I_r = 1 / (r_std**2)
    return np.diag([I_t, I_t, I_t, I_r, I_r, I_r])


def _strip_to_int(tok: str) -> int:
    """Vertex tokens may be 'a12' / '12' / gtsam-int; digits-only parse
    (g2o_file_fusion.py:37,70-71 strips non-digits)."""
    digits = "".join(ch for ch in tok if ch.isdigit())
    return int(digits)


def parse_g2o(path_or_lines) -> G2OGraph:
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    vertices: Dict[int, np.ndarray] = {}
    edges: List[G2OEdge] = []
    pending_lc = None
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            if line.startswith("# LC:"):
                pending_lc = int(line.split()[2])
            continue
        tok = line.split()
        if tok[0] == "VERTEX_SE3:QUAT":
            if len(tok) != 9:
                raise ValueError(f"bad vertex line: {line}")
            vertices[_strip_to_int(tok[1])] = np.array([float(x) for x in tok[2:9]])
        elif tok[0] == "EDGE_SE3:QUAT":
            if len(tok) != 31:
                raise ValueError(f"bad edge line: {line}")
            # vertex tokens may carry letter prefixes ('a0 b5' in the LC
            # writer, results.py:185) — strip like g2o_file_fusion.py:70-71
            edges.append(
                G2OEdge(
                    v1=_strip_to_int(tok[1]),
                    v2=_strip_to_int(tok[2]),
                    xyz_quat=np.array([float(x) for x in tok[3:10]]),
                    info_upper=np.array([float(x) for x in tok[10:31]]),
                    lc_count=pending_lc,
                )
            )
            pending_lc = None
        else:
            raise ValueError(f"unknown g2o record {tok[0]!r}")
    return G2OGraph(vertices=vertices, edges=edges)


def format_edge(v1, v2, xyz_quat, info_upper) -> str:
    d = [str(v1), str(v2)] + [f"{x}" for x in xyz_quat] + [f"{x}" for x in info_upper]
    return (
        f"EDGE_SE3:QUAT\t{d[0]} {d[1]} \t{d[2]} {d[3]} {d[4]} \t"
        f"{d[5]} {d[6]} {d[7]} {d[8]} \t"
        f"{d[9]} {d[10]} {d[11]} {d[12]} {d[13]} {d[14]} \t"
        f"{d[15]} {d[16]} {d[17]} {d[18]} {d[19]} \t"
        f"{d[20]} {d[21]} {d[22]} {d[23]} \t{d[24]} {d[25]} {d[26]} \t"
        f"{d[27]} {d[28]} \t{d[29]}"
    )


def format_vertex(key, xyz_quat) -> str:
    vals = " ".join(str(x) for x in xyz_quat)
    return f"VERTEX_SE3:QUAT {key} {vals}"


def write_g2o(graph: G2OGraph, path: str):
    with open(path, "w") as f:
        for key, xq in graph.vertices.items():
            f.write(format_vertex(key, xq) + "\n")
        for e in graph.edges:
            if e.lc_count is not None:
                f.write(f"# LC: {e.lc_count}\n")
            f.write(format_edge(e.v1, e.v2, e.xyz_quat, e.info_upper) + "\n")


def is_loop_closure(edge: G2OEdge) -> bool:
    """LC = cross-robot or non-consecutive same-robot edge
    (edit_g2o_edge_information semantics; combine_loop_closures.py:197)."""
    if symbol_chr(edge.v1) != symbol_chr(edge.v2):
        return True
    return abs(symbol_index(edge.v1) - symbol_index(edge.v2)) != 1


def edit_g2o_edge_information(
    g2o_lines: List[str], t_std: float, r_std: float, loop_closures: bool = True
) -> List[str]:
    """Rewrite information matrices of LC (or odometry) edges
    (reference edit_g2o_edge_information.py, driven from demo.py:231-238)."""
    I_new = info_upper_from_matrix(information_matrix(t_std, r_std))
    out = []
    for raw in g2o_lines:
        line = raw.strip()
        tok = line.split()
        if not tok or tok[0] != "EDGE_SE3:QUAT":
            out.append(line)
            continue
        e = G2OEdge(
            v1=int(tok[1]), v2=int(tok[2]),
            xyz_quat=np.array([float(x) for x in tok[3:10]]),
            info_upper=np.array([float(x) for x in tok[10:31]]),
        )
        if is_loop_closure(e) == loop_closures:
            out.append(format_edge(e.v1, e.v2, e.xyz_quat, I_new))
        else:
            out.append(line)
    return out


# ---------------------------------------------------------------------------
# time files ("robot_id idx t_ns xxx" lines, extract_odom_g2o.py:112-115)
# ---------------------------------------------------------------------------

def read_time_file(path: str) -> List[Tuple[int, int, float]]:
    out = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 3:
                continue
            out.append((int(tok[0]), int(tok[1]), int(tok[2]) * 1e-9))
    return out


def time_vertex_mapping(time_file: str, use_gtsam_idx: bool = False) -> Dict[int, float]:
    """vertex -> time map (g2o_and_time_to_pose_data.py)."""
    out = {}
    for robot_id, idx, t in read_time_file(time_file):
        key = symbol(chr(ord("a") + robot_id), idx) if use_gtsam_idx else idx
        out[key] = t
    return out


def g2o_and_time_to_pose_data(g2o_file: str, time_file: str, robot_id: int) -> PoseData:
    """Optimized g2o + time file -> PoseData for one robot
    (g2o_and_time_to_pose_data.py:23-60)."""
    graph = parse_g2o(g2o_file)
    letter = chr(ord("a") + robot_id)
    entries = [(idx, t) for rid, idx, t in read_time_file(time_file) if rid == robot_id]
    times, poses = [], []
    for idx, t in entries:
        key = symbol(letter, idx)
        if key not in graph.vertices:
            continue
        times.append(t)
        poses.append(graph.vertex_T(key))
    return PoseData(times=np.array(times), poses=np.stack(poses), time_tol=np.inf)


def pose_data_to_csv(pd: PoseData, path: str):
    t, q = se3_np.T_to_xyz_quat(pd.poses)
    data = np.concatenate([pd.times[:, None], t, q], axis=1)
    np.savetxt(path, data, delimiter=",",
               header="t,x,y,z,qx,qy,qz,qw", comments="")
