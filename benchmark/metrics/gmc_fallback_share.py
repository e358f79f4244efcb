"""Percent of the window's frames whose features-GMC fit kept fewer than
``gmc_min_features`` inlier corners, so that the tracker took the
keypoint-flow affine in its place: the program's ``gmc:fallback`` counts
of the window's ``stream_coordinates`` call over its ``gmc:frames``
counts (both made a chunk at a time, from the tally the chunk's outputs
bring back).  None where the call has no such count (a configuration
without the features GMC, or a program that does not tally it)."""

from benchmark import spans


def read(ctx):
    call = spans.last_call(spans.records(), "stream_coordinates") or ()
    frames = sum(r.value for r in call if r.kind == "count" and r.name == "gmc:frames")
    fallback = sum(r.value for r in call if r.kind == "count" and r.name == "gmc:fallback")
    return 100.0 * fallback / frames if frames else None
