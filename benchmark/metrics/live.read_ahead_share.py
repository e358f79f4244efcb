"""Percent of segments over which ``serve_clips`` read ahead (asked for
the next segment before yielding this one's result): the
``serve:read_ahead`` counts in the program's span log (1 read ahead, 0
the reference's order) over the ``serve:perceive`` spans of the last
``serve_clips`` call (the window's).  None where the call has no such
count: a program whose ``serve_clips`` does not log its order."""

from benchmark import spans


def read(ctx):
    call = spans.last_call(spans.records(), "serve_clips")
    counts = [r.value for r in call or () if r.kind == "count" and r.name == "serve:read_ahead"]
    perceived = sum(1 for r in call or () if r.name == "serve:perceive")
    return 100.0 * sum(counts) / perceived if counts and perceived else None
