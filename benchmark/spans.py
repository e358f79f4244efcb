"""The program's span log, read for the per-layer metrics.

The program under test keeps one span log a process
(``eagle_tpu_torch.utils.profiling.LOG``): spans, counts and the calls of
its entry points, on every thread, stamped with ``time.time_ns()``.  A
reader takes it here once the window has closed; a program without the
log gives None, and so does every reader.

The log's clock is unix time in ns.  The profiler's trace gives its host
events ``ts`` in us after the trace's ``baseTimeNanoseconds``, which
:class:`benchmark.trace.Stretch` does not keep; so :func:`align` fits the
offset between the two from the pairs that are in both: the main thread's
stages that opened a profiler range (``ranged`` in the log, the stretch's
``stage:<name>`` ranges), matched in order.  Then a log time ``t`` (ns)
is trace time ``(t - offset) / 1e3`` (us), and the pairs' residuals are
the alignment's error.
"""

from __future__ import annotations

import bisect
import statistics
import threading

#: a pair's start and end within this of the fitted offset (ns) count as
#: matched when the offset is searched
MATCH_NS = 1_000_000


def records() -> list | None:
    """The program's span log, oldest first, or None where it has none."""
    try:
        from eagle_tpu_torch.utils import profiling

        return profiling.LOG.records()
    except (ImportError, AttributeError):
        return None


def dropped() -> int:
    """Records the log pushed out when it was full (0 without a log)."""
    try:
        from eagle_tpu_torch.utils import profiling

        return profiling.LOG.dropped
    except (ImportError, AttributeError):
        return 0


def seconds(r) -> float:
    return (r.end - r.start) / 1e9


def last_call(recs: list | None, entry: str) -> list | None:
    """The records of the last call of the entry point ``entry``, or None."""
    if not recs:
        return None
    calls = [r.id for r in recs if r.kind == "call" and r.name == entry]
    if not calls:
        return None
    return [r for r in recs if r.call == calls[-1] and r.kind != "call"]


def main_thread(recs: list) -> list:
    ident = threading.main_thread().ident
    return [r for r in recs if r.thread == ident]


def align(recs: list | None, stretch) -> tuple[int, list[int]] | None:
    """(offset ns, residuals ns) of the log against the stretch's trace:
    a log time ``t`` is trace time ``(t - offset) / 1e3``.  The stretch's
    ``stage:`` ranges, in order, are paired with a run of the log's ranged
    spans of the same names; the offset is the median of the pairs' start
    and end differences, and the run is the one whose offset lines up most
    pairs within :data:`MATCH_NS`, then the tightest.  None without a log,
    a stretch or a pair."""
    if not recs or stretch is None:
        return None
    trace = sorted((round(a * 1e3), round(b * 1e3), name)
                   for name, rs in stretch.ranges.items() for a, b in rs)
    log = sorted((r.start, r.end, r.name) for r in main_thread(recs) if r.kind == "span" and r.ranged)
    if not trace or not log:
        return None
    best = None
    for j, (start, _, name) in enumerate(log):
        if name != trace[0][2] or j + len(trace) > len(log):
            continue
        diffs = [d for t, g in zip(trace, log[j:]) if t[2] == g[2] for d in (g[0] - t[0], g[1] - t[1])]
        off = round(statistics.median(diffs))
        hits = sum(1 for d in diffs if abs(d - off) < MATCH_NS)
        score = (hits, -statistics.median(abs(d - off) for d in diffs))
        if best is None or score > best[0]:
            best = (score, off, diffs)
    if best is None:
        return None
    _, offset, diffs = best
    return offset, [d - offset for d in diffs]


def clipped(recs: list, lo: float, hi: float) -> list[tuple[float, float]]:
    """The spans of ``recs`` cut to [lo, hi] (log ns), those that meet it."""
    return [(max(r.start, lo), min(r.end, hi)) for r in recs if r.end > lo and r.start < hi]


def waits_in_stretch(ctx) -> tuple[list, float] | None:
    """(the main thread's ``wait`` spans in the traced stretch, cut to it,
    in log ns; the log's offset) or None."""
    st = getattr(ctx, "stretch", None)
    recs = records()
    fit = align(recs, st)
    if fit is None:
        return None
    offset = fit[0]
    lo, hi = round(st.t0 * 1e3) + offset, round(st.t1 * 1e3) + offset
    waits = [r for r in main_thread(recs) if r.kind == "span" and r.name == "wait"]
    return clipped(waits, lo, hi), offset


def device_idle(stretch) -> list[tuple[float, float]]:
    """The stretch's gaps with no device operation running (trace us)."""
    spans = sorted((max(o["start"], stretch.t0), min(o["end"], stretch.t1)) for o in stretch.ops)
    gaps, end = [], stretch.t0
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if stretch.t1 > end:
        gaps.append((end, stretch.t1))
    return gaps


def overlap_us(gaps: list, spans: list) -> float:
    """Length of the parts of ``gaps`` that fall inside ``spans`` (both
    sorted lists of intervals; ``spans`` may overlap one another)."""
    merged: list = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    total = 0.0
    for a, b in gaps:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(merged) and merged[i][0] < b:
            total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return total


def describe(ctx) -> str | None:
    """A line on the log in the stretch: its records, its waits and the
    alignment's residuals, for standard error."""
    st = getattr(ctx, "stretch", None)
    recs = records()
    fit = align(recs, st)
    if fit is None:
        return None
    offset, res = fit
    lo, hi = round(st.t0 * 1e3) + offset, round(st.t1 * 1e3) + offset
    inside = [r for r in recs if lo <= r.start and r.end <= hi]
    waits = [r for r in inside if r.name == "wait"]
    a = sorted(abs(x) / 1e3 for x in res)
    return (f"span log: {len(inside)} records in the traced stretch ({len(waits)} waits) of {len(recs)} in all, "
            f"{dropped()} dropped; the trace's clock from {len(res) // 2} stage pairs, residual median "
            f"{statistics.median(a):.3f} us, 90th percentile {a[int(0.9 * (len(a) - 1))]:.3f} us, "
            f"largest {a[-1]:.3f} us")


def idle_by_span(ctx) -> dict | None:
    """The stretch's device idle seconds by what the main thread was in:
    its innermost span in the log at the time (by latest start, as the
    names from the outermost down), largest first; None without a log or
    a stretch."""
    st = getattr(ctx, "stretch", None)
    recs = records()
    fit = align(recs, st)
    if fit is None:
        return None
    offset = fit[0]

    def us(t):
        return min(max((t - offset) / 1e3, st.t0), st.t1)

    main = [r for r in main_thread(recs) if r.kind == "span" and us(r.end) > st.t0 and us(r.start) < st.t1]
    by_id = {r.id: r for r in main}

    def path(r):
        names = []
        while r is not None:
            names.append(r.name)
            r = by_id.get(r.parent)
        return "/".join(reversed(names))

    bounds = sorted({st.t0, st.t1} | {us(r.start) for r in main} | {us(r.end) for r in main})
    segs = []
    for a, b in zip(bounds, bounds[1:]):
        mid = (a + b) / 2
        cover = [r for r in main if us(r.start) <= mid < us(r.end)]
        segs.append((a, b, path(max(cover, key=lambda r: r.start)) if cover else "outside the program's spans"))
    starts = [a for a, _, _ in segs]
    idle: dict = {}
    for a, b in device_idle(st):
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            s0, s1, name = segs[i]
            idle[name] = idle.get(name, 0.0) + max(0.0, min(b, s1) - max(a, s0)) / 1e6
            i += 1
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))
