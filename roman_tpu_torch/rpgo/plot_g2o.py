"""Trajectory plots from g2o files, drawn with numpy and written as PNG
(port of roman_tpu/rpgo/plot_g2o.py; reference
roman/offline_rpgo/plot_g2o.py:50-136).

``roman_tpu`` plots with matplotlib, which the machine with the card
lacks. Here each robot's vertex positions are drawn as a polyline in its
colour on a white panel, at equal scale on both axes; the demo's
``result.png`` puts the three projections on matplotlib's 2 x 2 layout
(x-y large, x-z below it, z-y beside it) with one colour swatch a robot
in the first panel's corner for the legend. No text, axes or ticks are
drawn. Nothing downstream parses the png.

``plot_g2o`` is the library call of the reference: it draws on a
matplotlib axis (pyplot from ``viz.pyplot``, which names matplotlib where
it is missing) and equals ``roman_tpu``'s figure pixel for pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from roman_tpu_torch.data.png import write_png
from roman_tpu_torch.rpgo.g2o_io import parse_g2o, symbol_chr, symbol_index
from roman_tpu_torch.viz import pyplot

# matplotlib's tab10 colours, in the order roman_tpu assigns them to robots
_TAB10 = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
          (188, 189, 34), (23, 190, 207))
DEFAULT_TRAJECTORY_COLORS = {chr(ord("a") + i): c for i, c in enumerate(_TAB10)}


def trajectories(g2o_path: str) -> Dict[str, np.ndarray]:
    """Robot letter -> (n, 3) vertex positions in vertex-index order."""
    by_robot: Dict[str, list] = {}
    for key, xq in parse_g2o(g2o_path).vertices.items():
        by_robot.setdefault(symbol_chr(key), []).append((symbol_index(key), xq[:3]))
    return {r: np.stack([p for _, p in sorted(e, key=lambda e: e[0])])
            for r, e in sorted(by_robot.items())}


@dataclasses.dataclass
class G2OPlotParams:
    axes: Tuple[int, int] = (0, 1)  # which position components to plot
    legend: bool = True
    linewidth: float = 1.0


def plot_g2o(
    g2o_path: str,
    g2o_symbol_to_name: Optional[Dict[str, str]] = None,
    g2o_symbol_to_color: Optional[Dict[str, str]] = None,
    ax=None,
    params: G2OPlotParams = G2OPlotParams(),
):
    """Each robot's vertex positions as a line on a matplotlib axis (a new
    figure's when ax is None), labelled by g2o_symbol_to_name, in
    g2o_symbol_to_color's colours (tab10 by robot letter by default), at
    equal scale. Returns the axis."""
    if ax is None:
        plt = pyplot("plot_g2o")
        _, ax = plt.subplots()
    colors = g2o_symbol_to_color or {
        r: tuple(c / 255 for c in rgb) for r, rgb in DEFAULT_TRAJECTORY_COLORS.items()}
    a0, a1 = params.axes
    for robot, pos in trajectories(g2o_path).items():
        label = (g2o_symbol_to_name or {}).get(robot, robot)
        ax.plot(pos[:, a0], pos[:, a1], label=label, color=colors.get(robot),
                linewidth=params.linewidth)
    if params.legend:
        ax.legend()
    ax.set_aspect("equal")
    return ax


def _draw_polyline(img: np.ndarray, px: np.ndarray, color) -> None:
    """Paint the 1-pixel segments between consecutive (n, 2) pixel points
    (x, y)."""
    if len(px) == 1:
        px = np.concatenate([px, px])
    a, b = px[:-1], px[1:]
    steps = np.maximum(np.abs(b - a).max(axis=1).astype(int), 1) + 1
    seg = np.repeat(np.arange(len(a)), steps)
    t = (np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps, steps)) / \
        np.repeat(steps - 1, steps)
    x, y = np.rint(a[seg] + (b[seg] - a[seg]) * t[:, None]).astype(int).T
    ok = (x >= 0) & (x < img.shape[1]) & (y >= 0) & (y < img.shape[0])
    img[y[ok], x[ok]] = color


def render_trajectories(trajs: Dict[str, np.ndarray], colors: dict,
                        axes: Tuple[int, int] = (0, 1), legend: bool = True,
                        size: Tuple[int, int] = (400, 400),
                        margin: int = 8) -> np.ndarray:
    """One projection of named (n, 3) position sequences, each a polyline
    in its colour, as an (h, w, 3) uint8 image: `axes` picks the
    horizontal and vertical components; both share one scale. `legend`
    puts one colour swatch a name in the top-left corner."""
    h, w = size
    img = np.full((h, w, 3), 255, np.uint8)
    if not trajs:
        return img
    a0, a1 = axes
    allp = np.concatenate([p[:, [a0, a1]] for p in trajs.values()])
    lo, hi = allp.min(axis=0), allp.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    scale = min((w - 1 - 2 * margin) / span[0], (h - 1 - 2 * margin) / span[1])
    center = (lo + hi) / 2
    for name, pos in trajs.items():
        xy = (pos[:, [a0, a1]] - center) * scale
        px = np.stack([(w - 1) / 2 + xy[:, 0], (h - 1) / 2 - xy[:, 1]], axis=1)
        _draw_polyline(img, px, colors.get(name, (0, 0, 0)))
    if legend:
        for k, name in enumerate(trajs):
            img[margin + 10 * k:margin + 10 * k + 6, margin:margin + 12] = \
                colors.get(name, (0, 0, 0))
    return img


def plot_result(g2o_path: str, png_path: str, size: int = 800) -> np.ndarray:
    """The demo's result.png (demo/demo.py:250-277): every robot's
    trajectory in the x-y projection on 5/6 of the width and height, x-z
    below it and z-y beside it."""
    trajs = trajectories(g2o_path)
    big, small = size * 5 // 6, size - size * 5 // 6
    img = np.full((size, size, 3), 255, np.uint8)
    for axes, (y, x, h, w), legend in (((0, 1), (0, 0, big, big), True),
                                       ((0, 2), (big, 0, small, big), False),
                                       ((2, 1), (0, big, big, small), False)):
        img[y:y + h, x:x + w] = render_trajectories(
            trajs, DEFAULT_TRAJECTORY_COLORS, axes, legend, (h, w))
    write_png(png_path, img)
    return img


def rm_robots_g2o(g2o_lines: Sequence[str], keep_letters):
    """Remove robots from a fused g2o (reference rm_robots_g2o.py)."""
    out = []
    for raw in g2o_lines:
        tok = raw.split()
        if not tok:
            continue
        if tok[0] == "VERTEX_SE3:QUAT":
            if symbol_chr(int(tok[1])) in keep_letters:
                out.append(raw)
        elif tok[0] == "EDGE_SE3:QUAT":
            if symbol_chr(int(tok[1])) in keep_letters and symbol_chr(int(tok[2])) in keep_letters:
                out.append(raw)
        else:
            out.append(raw)
    return out
