"""The detector's share (%) of the card's bf16 peak: the FLOPs its forward
needs at the cell's input (counted from the published layer list) for the
stretch's frames, over the detector stage's device time (each of its
ranges from its first launched operation's start to its last one's end)."""

from benchmark.work import peaks


def read(ctx):
    span = ctx.stretch.stage_span("detector") if ctx.stretch is not None else None
    if not span:
        return None
    return 100.0 * ctx.detector_flops * ctx.stretch.frames / (span[0] * peaks.BF16_FLOPS)
