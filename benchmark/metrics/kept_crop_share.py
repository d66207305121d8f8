"""kept_crop_share.<cell family>: the share of the crops the CLIP stage
encoded in the traced stretch whose masks the program kept
(roman_tpu_torch.tracing's counters "perception.clip_kept", the program's
`valid` flags, over "perception.clip_crops", the slots encoded), in %.
None where the program counted no crop in the stretch (or has no such
counter)."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    crops = tracing.counter("perception.clip_crops")
    if not crops:
        return None
    return 100.0 * tracing.counter("perception.clip_kept") / crops
