"""Median seconds a segment waited in ``serve_clips``' queue: its
``serve:queued`` span in the program's span log, from the segment leaving
the traffic's iterator to the start of its perception, over the segments
of the last ``serve_clips`` call (the window's)."""

import statistics

from benchmark import spans


def read(ctx):
    call = spans.last_call(spans.records(), "serve_clips")
    got = [spans.seconds(r) for r in call or () if r.name == "serve:queued"]
    return statistics.median(got) if got else None
