"""Median seconds a segment's finished result was held by ``serve_clips``:
its ``serve:held`` span in the program's span log, from the end of its
Processor job to the moment it was yielded, over the segments of the last
``serve_clips`` call (the window's)."""

import statistics

from benchmark import spans


def read(ctx):
    call = spans.last_call(spans.records(), "serve_clips")
    got = [spans.seconds(r) for r in call or () if r.name == "serve:held"]
    return statistics.median(got) if got else None
