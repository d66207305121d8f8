"""idle_share.<cell family>: the share of the traced stretch in which no
operation ran on the device, 100 * (1 - union of the device intervals /
stretch), from torch.profiler's raw events."""


def read(ctx, name):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
