"""encoded_crop_share.<cell family>: the share of the slots given to the
CLIP stage in the traced stretch that its tower encoded (roman_tpu_torch.
tracing's counters "perception.clip_encoded", the crops the tower ran,
chunks' padding included, over "perception.clip_crops", the slots given),
in %. None where the program counted no crop in the stretch, or has no
counter of the crops encoded."""


def read(ctx, name):
    try:
        from roman_tpu_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None or not tracing.counted("perception.clip_encoded"):
        return None
    crops = tracing.counter("perception.clip_crops")
    if not crops:
        return None
    return 100.0 * tracing.counter("perception.clip_encoded") / crops
