"""Milliseconds a frame the card sat idle in the traced stretch while the
main thread waited on it: the device's idle gaps (no operation running)
that fall inside the main thread's ``wait`` spans of the program's span
log, placed on the trace's clock.  Gaps in work already queued, which the
host cannot cause; over the stretch's frames."""

from benchmark import common, spans


def read(ctx):
    got = spans.waits_in_stretch(ctx)
    if got is None:
        return None
    waits, offset = got
    common.diag(f"device idle s by the main thread's innermost span: {spans.idle_by_span(ctx)}")
    on_trace = [((a - offset) / 1e3, (b - offset) / 1e3) for a, b in waits]
    return spans.overlap_us(spans.device_idle(ctx.stretch), on_trace) / 1e3 / ctx.stretch.frames
