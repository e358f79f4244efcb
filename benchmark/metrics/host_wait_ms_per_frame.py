"""Milliseconds a frame the main thread waited on the card in the traced
stretch: its ``wait`` spans in the program's span log (each read-back that
blocks), placed on the trace's clock and cut to the stretch, over the
stretch's frames."""

from benchmark import common, spans


def read(ctx):
    got = spans.waits_in_stretch(ctx)
    if got is None:
        return None
    line = spans.describe(ctx)
    if line:
        common.diag(line)
    waits, _ = got
    return sum(b - a for a, b in waits) / 1e6 / ctx.stretch.frames
