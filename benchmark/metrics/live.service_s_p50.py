"""Median seconds of a segment from the start of its perception (the call
of ``get_coordinates`` that ``serve_clips`` makes) to its ``ClipResult``:
its service without its wait in the queue, over the window's segments."""

import statistics


def read(ctx):
    return statistics.median(ctx.service_s) if ctx.service_s else None
