"""Milliseconds a frame of ``serve_clips``' Processor jobs: the
``serve:post`` spans of the last ``serve_clips`` call in the program's span
log (each segment's Processor, on its worker thread), over the frames
their ``serve:frames`` counts give."""

from benchmark import spans


def read(ctx):
    call = spans.last_call(spans.records(), "serve_clips")
    post = sum(spans.seconds(r) for r in call or () if r.name == "serve:post")
    frames = sum(r.value for r in call or () if r.kind == "count" and r.name == "serve:frames")
    return post * 1e3 / frames if frames else None
