"""Host utility helpers: env expansion, recursive dict merge and AABB tests
(copied from roman_tpu/utils.py; reference roman/utils.py:132-169), and the
import of an optional package."""

from __future__ import annotations

import importlib
from os.path import expanduser, expandvars

import numpy as np


def expandvars_recursive(path: str) -> str:
    """Recursively expand environment variables (utils.py:132-138)."""
    while True:
        expanded = expandvars(path)
        if expanded == path:
            return expanduser(expanded)
        path = expanded


def combinedicts_recursive(d1: dict, d2: dict) -> dict:
    """Merge d2 over d1, recursing into dict values (utils.py:140-158)."""
    res = {}
    for k, v in d2.items():
        if isinstance(v, dict) and isinstance(d1.get(k), dict):
            res[k] = combinedicts_recursive(d1[k], v)
        else:
            res[k] = v
    for k, v in d1.items():
        if k not in d2:
            res[k] = v
    return res


def require(module: str, what: str):
    """Import an optional package (cv2, matplotlib) where only it does the
    work, or raise an ImportError that names it: the machine with the card
    has no matplotlib, and nothing falls back quietly."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {module!r} package, which is not "
                          "installed") from e


def aabb_intersects(p1: np.ndarray, p2: np.ndarray) -> bool:
    """Axis-aligned bounding boxes of two point sets intersect
    (utils.py:160-169)."""
    p1_min, p1_max = np.min(p1, axis=0), np.max(p1, axis=0)
    p2_min, p2_max = np.min(p2, axis=0), np.max(p2, axis=0)
    return bool(np.all(p1_min <= p2_max) and np.all(p1_max >= p2_min))
