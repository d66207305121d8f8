"""m_nonzeros_per_pair.<cell family>: the mean number of nonzero entries
off the diagonal of the affinity M that build_affinity wrote for a pair in
the traced stretch (roman_tpu_torch.tracing's counters "affinity.nonzeros"
over "affinity.pairs"; pairs re-solved at the rescue budget are built, and
counted, again). None where the program counted no built pair in the
stretch (or has no such counter)."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    pairs = tracing.counter("affinity.pairs")
    if not pairs:
        return None
    return tracing.counter("affinity.nonzeros") / pairs
