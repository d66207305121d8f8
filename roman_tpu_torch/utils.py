"""Host utility helpers: env expansion and AABB tests (copied from
roman_tpu/utils.py; reference roman/utils.py:132-169)."""

from __future__ import annotations

from os.path import expanduser, expandvars

import numpy as np


def expandvars_recursive(path: str) -> str:
    """Recursively expand environment variables (utils.py:132-138)."""
    while True:
        expanded = expandvars(path)
        if expanded == path:
            return expanduser(expanded)
        path = expanded


def aabb_intersects(p1: np.ndarray, p2: np.ndarray) -> bool:
    """Axis-aligned bounding boxes of two point sets intersect
    (utils.py:160-169)."""
    p1_min, p1_max = np.min(p1, axis=0), np.max(p1, axis=0)
    p2_min, p2_max = np.min(p2, axis=0), np.max(p2, axis=0)
    return bool(np.all(p1_min <= p2_max) and np.all(p1_max >= p2_min))
