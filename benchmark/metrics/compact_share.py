"""compact_share.<cell family>: the share of the pairs clipper_solve
solved in the traced stretch that read a compact copy of M's nonzeros after
the first pass, with no block of the pair streaming M (roman_tpu_torch.
tracing's counters "solve.compact_pairs" over "solve.pairs"), in %. None
where the program counted no solved pair in the stretch, or has no such
counter."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None or not tracing.counted("solve.compact_pairs"):
        return None
    pairs = tracing.counter("solve.pairs")
    if not pairs:
        return None
    return 100.0 * tracing.counter("solve.compact_pairs") / pairs
