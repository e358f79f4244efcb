"""A whole match as data providers process it: ``stream_coordinates`` (the
CLI's ``--segment_frames`` path) in a closed loop over an endless stream.

The stream is one seeded shot (``shot_frames`` frames of a still camera)
played over and over, each repeat a cut back to the shot's start; frame
indices run on.  It is handed to the program ``segment_frames`` frames at
a time, and the window counts every frame whose coordinates the entry
yielded, over the time from the window's opening to the block that closes
it (the first yielded once ``--seconds`` have passed), so every frame of
the window and all of its time count.  With ``--trace 1`` one block (the
``trace_block``-th of the window) runs under the profiler.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from benchmark.common import Result, diag
from benchmark.trace import Stretch, Tracer


def run(r) -> Result:
    t = r.traffic
    scene = r.render(1)[0]
    r.build()
    model, inj, shot = r.model, r.inj, t["shot_frames"]

    def segments():
        start = 0
        while True:
            inj.feed(0, start, t["segment_frames"])
            yield scene.frames[start : start + t["segment_frames"]]
            start = (start + t["segment_frames"]) % shot

    def stream():
        return model.stream_coordinates(segments(), t["fps"], prefetch="auto", **r.cadence)

    # warm-up: the window's block shapes, then a fresh stream for the window
    t0 = time.monotonic()
    inj.check_finite = True
    gen = stream()
    for _ in range(t["warmup_blocks"]):
        next(gen)
    gen.close()
    inj.check_finite = False
    inj.clear()
    diag(f"warm-up: {t['warmup_blocks']} blocks in {time.monotonic() - t0:.3f} s")

    tracer = Tracer(r.tmp_dir) if r.trace else None
    stretch_frames = stretch_lo = None
    frames, blocks = 0, []
    inj.capturing = True
    gen = stream()
    t_open = time.perf_counter()
    r.setup_s = time.monotonic() - r.t_start
    while True:
        traced = tracer is not None and len(blocks) == t["trace_block"]
        if traced:
            tracer.start()
        block = next(gen)
        if traced:
            tracer.stop()
            stretch_frames, stretch_lo = len(block), min(block)
        t_last = time.perf_counter()
        frames += len(block)
        blocks.append(block)
        if t_last - t_open >= r.seconds:
            break
    inj.capturing = False
    gen.close()
    window = t_last - t_open
    diag(f"window: {frames} frames in {len(blocks)} blocks, {window:.3f} s")

    # every frame up to the last one yielded is judged; one missing from the
    # output is a failed request, its objects all missed
    printed = {g: fr for block in blocks for g, fr in block.items()}
    due = max(printed) + 1 if printed else 0
    judged = [(printed.get(g), 0, g % shot) for g in range(due)]
    ctx = SimpleNamespace(stretch=None, **r.work())
    if tracer is not None:
        ctx.stretch = Stretch(tracer.events(), stretch_frames)
        kp_every = max(1, int(t["fps"] / max(1, r.cadence["num_keypoint_detection"])))
        ctx.keypoint_frames = sum(1 for g in range(stretch_lo, stretch_lo + stretch_frames) if g % kp_every == 0)
        ctx.flow_least_s = r.flow_least_s(ctx.geometry)
    return Result({"frames_per_s": frames / window, "setup_s": r.setup_s}, due, due - len(printed), judged, ctx)
