"""A live tracking feed: ``serve_clips`` over one-second segments from
``matches`` concurrent live matches, in an open loop.

Each match is its own seeded shot (``shot_frames`` frames, a still camera,
played over and over); its segments are ``segment_frames`` consecutive
frames.  A segment is due when its last frame has arrived: one a second a
match, the matches' phases spread evenly over the second, so segment ``i``
(match ``i % matches``) is due ``i / matches`` seconds after the window
opens, whatever the program is doing.  Segments due before the window's
end are offered; a segment's latency is the time from its due time to its
``ClipResult``, or to the window's end if it has none by then.

The feed is a generator, with no length, so ``serve_clips`` takes it in
the reference's order: it perceives a segment as soon as it comes, yields
its result when the Processor's job ends, and only then asks for the next
one (it asks ahead, before perceiving the current one, only over clips
that have a length).  The generator then waits until that segment is due.
The generator's own lateness (a segment handed later than both its due
time and the program's request) is reported on standard error.  With
``--trace 1`` the window's last ``trace_segments`` segments run under the
profiler, until the last result.

Every segment due is judged once the window has closed: its coordinates,
and its Processor table as the long-format records and ``team_mapping``
(:func:`benchmark.reference.judge.table_miss_share`, ``team_error_share``).
A segment with no result, or whose coordinates or table lack one of its
frames, counts as failed.  Until then the driver keeps what the judge
reads of each result pickled (:func:`kept`): bytes, which the
interpreter's collector does not walk.  Kept as objects, a window's
results would double the heap that the program's own full collections
traverse inside the window.
"""

from __future__ import annotations

import math
import pickle
import threading
import time
from types import SimpleNamespace

from benchmark.common import Result, diag, percentile
from benchmark.load import OpenLoop, latencies
from benchmark.trace import Stretch, Tracer


def kept(res) -> bytes:
    """What the judge reads of a ``ClipResult``: (coordinates, the table's
    frame index, empty where the table is, the long-format records,
    ``team_mapping``), pickled."""
    index = [] if res.table.empty else list(res.table.index)
    return pickle.dumps((res.coordinates, index, res.formatted, res.team_mapping), protocol=pickle.HIGHEST_PROTOCOL)


def run(r) -> Result:
    from eagle_tpu_torch.pipeline.processor import Processor
    from eagle_tpu_torch.pipeline.serve import serve_clips

    t = r.traffic
    k, seg, shot = t["matches"], t["segment_frames"], t["shot_frames"]
    scenes = r.render(k)
    r.build()
    model, inj = r.model, r.inj

    def segment(i):
        m, j = i % k, i // k
        start = (j * seg) % shot
        return m, start, scenes[m].frames[start : start + seg]

    def serve(clips):
        return serve_clips(model, clips, t["fps"], **r.cadence)

    # the Processor's host time and each perception's start, by wrapping
    # the calls into those layers
    proc = {"s": 0.0, "frames": 0}
    lock = threading.Lock()
    originals = {name: getattr(Processor, name) for name in ("process_data", "format_data")}

    def timed(name):
        def call(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return originals[name](self, *a, **kw)
            finally:
                with lock:
                    proc["s"] += time.perf_counter() - t0
                    proc["frames"] += len(self.coords) if name == "process_data" else 0
        return call

    starts: list = []
    real_gc = model.get_coordinates

    def get_coordinates(*a, **kw):
        starts.append(time.perf_counter())
        return real_gc(*a, **kw)

    t0 = time.monotonic()
    inj.check_finite = True

    def warm():
        for i in range(t["warmup_rounds"] * k):
            m, start, frames = segment(i)
            inj.feed(m, start, seg)
            yield frames

    for _ in serve(warm()):
        pass
    inj.check_finite = False
    inj.clear()
    diag(f"warm-up: {t['warmup_rounds'] * k} segments in {time.monotonic() - t0:.3f} s")

    tracer = Tracer(r.tmp_dir) if r.trace else None
    n_due = math.ceil(r.seconds * k)
    # the window's last segments: stopping the profiler holds the host for
    # seconds, which must not build a queue inside the window
    first = max(0, n_due - t["trace_segments"])
    for name in originals:
        setattr(Processor, name, timed(name))
    model.get_coordinates = get_coordinates
    inj.capturing = True
    t_open = time.perf_counter()
    r.setup_s = time.monotonic() - r.t_start
    loop = OpenLoop(n_due, k, t_open)

    def clips():
        for i in loop:
            m, start, frames = segment(i)
            inj.feed(m, start, seg)
            if tracer is not None and i == first:
                tracer.start()
            yield frames

    finish, results = [], []
    keeping = 0.0
    try:
        for res in serve(clips()):
            finish.append(time.perf_counter())
            results.append(kept(res))
            del res  # now, not once the next segment is perceived
            keeping += time.perf_counter() - finish[-1]
            if tracer is not None and len(finish) == n_due:
                tracer.stop()
    finally:
        for name, fn in originals.items():
            setattr(Processor, name, fn)
        model.get_coordinates = real_gc
        inj.capturing = False
    t_close = t_open + r.seconds
    latency = latencies(loop.due, finish, t_close)
    done = sum(1 for f in finish if f <= t_close)
    diag(f"window: {n_due} segments due, {done} done by the window's end, generator late by at most {loop.late:.6f} s, "
         f"latency median {percentile(latency, 50):.4f} s, 90th percentile {percentile(latency, 90):.4f} s, "
         f"95th {percentile(latency, 95):.4f} s, largest {max(latency):.4f} s; the results kept in "
         f"{keeping:.4f} s")
    results = [pickle.loads(b) for b in results]

    # every frame of every segment due is judged, and a segment whose
    # result lacks a frame, in its coordinates or its table, has failed
    judged, segments, failed = [], [], 0
    for i in range(n_due):
        m, start, _ = segment(i)
        res = results[i] if i < len(results) else None
        coords, index, formatted, mapping = res if res is not None else ({}, [], [], {})
        rows = [(start + g) % shot for g in range(seg)]
        frames = [coords.get(g) for g in range(seg)]
        records = [None] * seg
        for g, rec in zip(index, formatted):
            if 0 <= int(g) < seg:
                records[int(g)] = rec
        failed += any(f is None for f in frames) or any(r is None for r in records)
        judged.extend((fr, m, row) for fr, row in zip(frames, rows))
        segments.append({"shot": m, "rows": rows, "frames": frames, "records": records,
                         "mapping": mapping})
    ctx = SimpleNamespace(stretch=None, **r.work())
    ctx.service_s = [finish[i] - starts[i] for i in range(min(len(finish), len(starts)))]
    ctx.processor_s, ctx.processor_frames = proc["s"], proc["frames"]
    ctx.latency, ctx.done, ctx.late = latency, done, loop.late
    if tracer is not None:
        ctx.stretch = Stretch(tracer.events(), (n_due - first) * seg)
    return Result({"segment_latency_p90_s": percentile(latency, 90), "setup_s": r.setup_s}, n_due, failed, judged, ctx,
                  segments)
