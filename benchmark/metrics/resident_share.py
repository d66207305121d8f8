"""resident_share.<cell family>: the share of the pairs clipper_solve
solved in the traced stretch whose blocks all kept their live rows of M
on chip after the first pass (roman_tpu_torch.tracing's counters
"solve.resident_pairs" over "solve.pairs"), in %. None where the program
counted no solved pair in the stretch (or has no such counter)."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    pairs = tracing.counter("solve.pairs")
    if not pairs:
        return None
    return 100.0 * tracing.counter("solve.resident_pairs") / pairs
