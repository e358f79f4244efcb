"""Median seconds of a segment's perception in ``serve_clips``: its
``serve:perceive`` span in the program's span log (its
``get_coordinates``), over the segments of the last ``serve_clips`` call
(the window's)."""

import statistics

from benchmark import common, spans


def read(ctx):
    call = spans.last_call(spans.records(), "serve_clips")
    got = [spans.seconds(r) for r in call or () if r.name == "serve:perceive"]
    if not got:
        return None
    common.diag(f"span log: {len(call)} records in the last serve_clips call, {len(call) / len(got):.1f} a segment")
    if getattr(ctx, "stretch", None) is not None:
        common.diag(f"device idle s by the main thread's innermost span: {spans.idle_by_span(ctx)}")
    return statistics.median(got)
