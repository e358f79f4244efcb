"""Share (%) of the ``reid`` stage's device time (as in ``reid_mfu``) in
which no operation it launched ran on the card: the appearance network's
launches reaching the card more slowly than it runs them."""


def read(ctx):
    span = ctx.stretch.stage_span("reid") if ctx.stretch is not None else None
    if not span:
        return None
    return 100.0 * (1.0 - span[1] / span[0])
