"""launches_per_call.<cell family>: device kernel events (copies and sets
left out) in the traced stretch, a call."""


def read(ctx, name):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.kernels / ctx.trace.n_ops
