"""device_ms.<span>.<cell family>: the union of the device intervals of
the work launched inside one of the program's spans (roman_tpu_torch.tracing,
or a span the cell's entry puts round a call of the program; a launch
belongs to the span it was made in, by the profiler's correlation id) in
the traced stretch, in ms a call, as span_ms reads the span's host time.
None where the stretch holds no such span, or its spans launched nothing
the trace shows."""

from benchmark import trace as trace_mod


def read(ctx, name):
    span = name.split(".", 1)[1].rsplit(".", 1)[0]
    if ctx.trace is None:
        return None
    n, seconds = trace_mod.launched_in(ctx.trace, span)
    if not n or seconds <= 0:
        return None
    return 1e3 * seconds / ctx.trace.n_ops
