"""The appearance network's share (%) of the card's bf16 peak: the FLOPs
its forward needs for the crops of the stretch's frames (``reid_slots`` a
frame, counted from the published layer list: ``reid_flops``) over the
``reid`` stage's device time (each of its ranges from its first launched
operation's start to its last one's end).  None without an appearance
network or its stage in the stretch."""

from benchmark.work import peaks


def read(ctx):
    work = getattr(ctx, "reid_flops", None)
    span = ctx.stretch.stage_span("reid") if work and ctx.stretch is not None else None
    if not span:
        return None
    return 100.0 * work * ctx.stretch.frames / (span[0] * peaks.BF16_FLOPS)
