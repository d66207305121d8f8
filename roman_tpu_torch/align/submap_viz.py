"""Submap views and bright palettes (port of roman_tpu/align/submap_viz.py;
reference roman/align/submap_viz.py:23-44).

The reference renders submap point clouds interactively with open3d and
defines the bright-colour palette helpers; the offscreen renderer is
``align_viz.submap_viz`` (matplotlib, through ``utils.require``), and the
palette helpers are copied.
"""

from __future__ import annotations

import colorsys

import numpy as np

from roman_tpu_torch.align.align_viz import submap_viz  # noqa: F401


def generate_bright_color_palette(num_colors: int) -> list:
    """num_colors evenly-hued, fully-saturated RGB triples in [0, 1]."""
    return [colorsys.hsv_to_rgb(i / max(num_colors, 1), 1.0, 1.0)
            for i in range(num_colors)]


def random_bright_color(last_colors=None, rng=None) -> tuple:
    """A random saturated color, re-drawn to stay distinct from
    last_colors (reference submap_viz.py:33-44 behavior)."""
    rng = rng or np.random.default_rng()
    last = [np.asarray(c) for c in (last_colors or [])]
    for _ in range(32):
        c = np.asarray(colorsys.hsv_to_rgb(rng.uniform(), 1.0, 1.0))
        if all(np.linalg.norm(c - lc) > 0.3 for lc in last):
            return tuple(c)
    return tuple(c)
