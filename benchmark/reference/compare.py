"""The align cells' comparison of the program's registrations with the
reference's: the numbers that decide `correct`.

- pair_mismatch: the share of answers (a pair's selected associations)
  that differ from the reference's in any association;
- T_gap: the largest entry of |T - T_ref| over the pairs where both sides
  select the same associations and at least three of them (Arun's
  transform of the same correspondences).
"""

from __future__ import annotations

import numpy as np


def compare(sel, count, T, ref: dict) -> dict:
    """The numbers of one set of answers (sel (P, n, m) bool, count (P,),
    T (P, 4, 4)) against the reference's answers to the same pairs."""
    sel = np.asarray(sel, bool)
    rsel = np.asarray(ref["sel"], bool)
    per_pair = (sel ^ rsel).reshape(len(sel), -1).sum(-1)
    same = (per_pair == 0) & (np.asarray(ref["count"]) >= 3)
    gap = (float(np.abs(np.asarray(T)[same] - np.asarray(ref["T"])[same]).max())
           if same.any() else 0.0)
    return dict(pair_mismatch=float(np.mean(per_pair > 0)), T_gap=gap)


def worst(readings: list) -> dict:
    """Each number's largest value over several sets of answers."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, within)] for every number that has a limit."""
    return [(k, numbers[k], limits[k], numbers[k] <= limits[k])
            for k in limits]
