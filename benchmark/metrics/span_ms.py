"""span_ms.<span>.<cell family>: the self time of one of the program's
spans (roman_tpu_torch.tracing) in the traced stretch, in ms a call: its
duration less what its child spans cover. The program's tracing is on
exactly while the profiler records, so the spans are those of the
stretch. None where the program has no such span (or no tracing)."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    span = name.split(".", 1)[1].rsplit(".", 1)[0]
    if ctx.trace is None or not any(r.name == span for r in tracing.records()):
        return None
    return tracing.self_ns(span) / 1e6 / ctx.trace.n_ops
