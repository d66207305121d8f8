"""masks_per_frame.<cell family>: the valid masks the front end handed the
mapper a frame in the traced stretch, counted from the program's own
`valid` flags (PerceptionOutput) of the batches run while the profiler
recorded: how much lifting and mapping the nets give the mapper. None
where the cell counts no such frames."""


def read(ctx, name):
    if ctx.trace is None or not hasattr(ctx.cell, "masks_per_frame"):
        return None
    return ctx.cell.masks_per_frame()
