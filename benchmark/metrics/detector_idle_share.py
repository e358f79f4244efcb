"""Share (%) of the detector stage's device time (as in ``detector_mfu``)
in which no operation it launched ran on the card."""


def read(ctx):
    span = ctx.stretch.stage_span("detector") if ctx.stretch is not None else None
    if not span:
        return None
    return 100.0 * (1.0 - span[1] / span[0])
