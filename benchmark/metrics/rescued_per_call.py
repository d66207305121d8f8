"""rescued_per_call.<cell family>: the pairs the pair engine re-solved at
the rescue budget in the traced stretch, a call (roman_tpu_torch.tracing's
counter "engine.rescued_pairs", counted from the convergence flags the
engine reads anyway). None where the program has no such counter."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    counted = getattr(tracing, "counted", None)
    if ctx.trace is None or counted is None or not counted("engine.rescued_pairs"):
        return None
    return tracing.counter("engine.rescued_pairs") / ctx.trace.n_ops
