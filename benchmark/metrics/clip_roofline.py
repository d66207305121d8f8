"""clip_roofline: the least time the card could take for the CLIP stage's
work in the traced stretch (metrics/_clip_counts.py, charged by the crops
of the masks the program kept: its bytes at HBM bandwidth or its
operations at each type's peak, the larger), over the union of the device
intervals of the work launched inside the program's span
"perception.clip", in %. None where the stretch holds no such span."""

from benchmark import trace as trace_mod
from benchmark.metrics import _counts


def read(ctx, name):
    if ctx.trace is None or not hasattr(ctx.cell, "clip_work"):
        return None
    n, seconds = trace_mod.launched_in(ctx.trace, "perception.clip")
    if not n or seconds <= 0:
        return None
    return 100.0 * _counts.least_seconds(ctx.cell.clip_work()) / seconds
