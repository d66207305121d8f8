"""syncs_per_call.<cell family>: the times the program made the host wait
for the card in the traced stretch (roman_tpu_torch.tracing's counter
"sync": blocking copies to and from the card, results checked on the
host), a call. None where the program recorded no span in the stretch
(or has no tracing)."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None or not tracing.records():
        return None
    return tracing.counter("sync") / ctx.trace.n_ops
