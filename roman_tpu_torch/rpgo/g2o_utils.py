"""Small g2o graph utilities (host copy of roman_tpu/rpgo/g2o_utils.py).

Parity with reference roman/offline_rpgo/{g2o_change_frame.py,
rm_robots_g2o.py}: re-express all vertices in a different frame, and strip
robots from a fused graph.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from roman_tpu_torch.ops import se3_np
from roman_tpu_torch.rpgo.g2o_io import (
    G2OGraph,
    parse_g2o,
    symbol_chr,
    write_g2o,
)


def g2o_change_frame(graph: G2OGraph, T_new_old: np.ndarray) -> G2OGraph:
    """Left-multiply every vertex pose by T_new_old (edges are relative and
    unchanged). Reference g2o_change_frame.py."""
    vertices = {}
    for key, xq in graph.vertices.items():
        T = se3_np.xyz_quat_to_T(xq[:3], xq[3:])
        t, q = se3_np.T_to_xyz_quat(np.asarray(T_new_old) @ T)
        vertices[key] = np.concatenate([t, q])
    return G2OGraph(vertices=vertices, edges=list(graph.edges))


def rm_robots(graph: G2OGraph, keep_letters: Iterable[str]) -> G2OGraph:
    """Keep only the given robots' vertices/edges (reference
    rm_robots_g2o.py)."""
    keep = set(keep_letters)
    vertices = {k: v for k, v in graph.vertices.items() if symbol_chr(k) in keep}
    edges = [e for e in graph.edges
             if symbol_chr(e.v1) in keep and symbol_chr(e.v2) in keep]
    return G2OGraph(vertices=vertices, edges=edges)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="g2o utilities")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cf = sub.add_parser("change-frame")
    cf.add_argument("input")
    cf.add_argument("output")
    cf.add_argument("--xyz", nargs=3, type=float, default=[0, 0, 0])
    cf.add_argument("--quat", nargs=4, type=float, default=[0, 0, 0, 1])
    rm = sub.add_parser("rm-robots")
    rm.add_argument("input")
    rm.add_argument("output")
    rm.add_argument("--keep", nargs="+", required=True, help="robot letters")
    args = ap.parse_args(argv)

    g = parse_g2o(args.input)
    if args.cmd == "change-frame":
        T = se3_np.xyz_quat_to_T(np.asarray(args.xyz), np.asarray(args.quat))
        out = g2o_change_frame(g, T)
    else:
        out = rm_robots(g, args.keep)
    write_g2o(out, args.output)


if __name__ == "__main__":
    main()
