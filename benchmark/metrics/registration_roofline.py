"""registration_roofline: the least time the card could take for the
registration's work in the traced stretch (metrics/_counts.py: its bytes
at HBM bandwidth or its operations at each type's peak, the larger),
over the union of the device intervals of everything the registrar calls
ran in the stretch, in %."""

from benchmark.metrics import _counts


def read(ctx, name):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    work = ctx.cell.work(ctx.trace.n_ops) if hasattr(ctx.cell, "work") else None
    if work is None:
        return None
    return 100.0 * _counts.least_seconds(work) / ctx.trace.busy_s
