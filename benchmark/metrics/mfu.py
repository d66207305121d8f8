"""mfu.<cell family>: the whole step's share of the card's peak: the
operations of the work in the traced stretch at each type's peak
(metrics/_counts.py), over the stretch's wall time, in %."""

from benchmark.metrics import _counts


def read(ctx, name):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    work = ctx.cell.work(ctx.trace.n_ops) if hasattr(ctx.cell, "work") else None
    if work is None:
        return None
    return 100.0 * _counts.ops_seconds(work) / ctx.trace.window_s
