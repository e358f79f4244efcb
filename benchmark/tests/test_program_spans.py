"""The seven readers of the program's span log (``benchmark/spans.py``)
on a hand-built log and traced stretch: the live cell's serving spans of
the last ``serve_clips`` call, the match cell's waits on the card placed
on the trace's clock, set-up's top-level spans, and None wherever there is
nothing to read (no log, as in a program without one; no call; no
stretch; a log that pushed records out).  Run from the repository's root::

    python -m pytest -q benchmark/tests/test_program_spans.py
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

from benchmark import run as bench_run
from benchmark import spans
from benchmark.trace import STRETCH, Stretch
from eagle_tpu_torch.utils.profiling import Record

MAIN = threading.main_thread().ident
OTHER = MAIN + 1
#: the log's clock at the trace's zero (ns)
BASE = 1_790_000_000_000_000_000
LIVE = ("live.queued_s_p50", "live.perceive_s_p50", "live.held_s_p50", "live.post_ms_per_frame")
MATCH = ("host_wait_ms_per_frame", "queued_idle_ms_per_frame")
ALL = (*LIVE, *MATCH, "setup.program_s")


class Log:
    def __init__(self):
        self.recs: list = []

    def add(self, kind, name, start, end, *, thread=MAIN, parent=None, call=None, request=None, value=0,
            ranged=False):
        rid = len(self.recs) + 1
        self.recs.append(Record(kind, name, int(start), int(end), thread, rid, parent, call, request, value, ranged))
        return rid


def live_log() -> Log:
    """A warm-up call, then the window's: three segments of 25 frames."""
    log = Log()
    for queued, perceive, held, post in (([5.0], [5.0], [5.0], [5.0]),
                                         ([0.30, 0.35, 0.40], [0.20, 0.25, 0.21], [0.30, 0.31, 0.29],
                                          [0.05, 0.06, 0.04])):
        call = log.add("call", "serve_clips", 0, 0)
        for k, (q, p, h, s) in enumerate(zip(queued, perceive, held, post)):
            t = 10 * k * 1e9
            log.add("span", "serve:queued", t, t + q * 1e9, call=call, request=k)
            pid = log.add("span", "serve:perceive", t + q * 1e9, t + (q + p) * 1e9, call=call, request=k)
            log.add("span", "temporal", t + q * 1e9, t + (q + p) * 1e9, parent=pid, call=call, request=k, ranged=True)
            post_id = log.add("span", "serve:post", t + 1e9, t + (1 + s) * 1e9, thread=OTHER, call=call, request=k)
            log.add("count", "serve:frames", t + 1e9, t + 1e9, thread=OTHER, parent=post_id, call=call, request=k,
                    value=25)
            log.add("span", "serve:held", t + (1 + s) * 1e9, t + (1 + s + h) * 1e9, call=call, request=k)
    return log


def match_log_and_stretch(jitter: bool = True) -> tuple[Log, Stretch]:
    """A traced stretch of 1000 us and 10 frames (the detector's range at
    100-300 us, the temporal one at 400-800 us; kernels at 120-250,
    420-500 and 600-700 us, so the card idles 0-120, 250-420, 500-600 and
    700-1000 us), and a log holding the same block's ranges a few us off
    the trace's clock beside a block 5 ms earlier, a wait at 450-650 us, a
    wait at 950-1050 us across the stretch's end, one after it and one on
    another thread."""
    def host(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "args": {"correlation": corr}}

    events = [host(STRETCH, 0, 1000), host("stage:detector", 100, 200), host("stage:temporal", 400, 400),
              launch(110, 1), kernel(120, 130, 1), launch(410, 2), kernel(420, 80, 2), launch(450, 3),
              kernel(600, 100, 3)]
    st = Stretch(events, 10)
    log = Log()
    us = 1_000
    j = (2, -2, 1, -1) if jitter else (0, 0, 0, 0)
    log.add("span", "detector", BASE - 5_000 * us, BASE - 4_900 * us, ranged=True)
    log.add("span", "temporal", BASE - 4_700 * us, BASE - 4_400 * us, ranged=True)
    det = log.add("span", "detector", BASE + (100 + j[0]) * us, BASE + (300 + j[1]) * us, ranged=True)
    log.add("span", "temporal", BASE + (400 + j[2]) * us, BASE + (800 + j[3]) * us, ranged=True)
    log.add("span", "wait", BASE + 450 * us, BASE + 650 * us)
    log.add("span", "wait", BASE + 950 * us, BASE + 1050 * us)
    log.add("span", "wait", BASE + 1200 * us, BASE + 1300 * us)
    log.add("span", "wait", BASE + 100 * us, BASE + 300 * us, thread=OTHER, parent=det)
    return log, st


def setup_log() -> Log:
    log = Log()
    convert = log.add("span", "setup:convert", 0, 2e9)
    log.add("span", "setup:read", 0, 1e9, parent=convert)  # inside another set-up span
    log.add("span", "setup:build", 2e9, 5e9)
    stage = log.add("span", "temporal", 6e9, 7e9, ranged=True)
    log.add("span", "setup:capture", 6e9, 6.5e9, parent=stage)
    return log


def read(name, ctx):
    return bench_run.reader(name)(ctx)


@pytest.fixture
def with_log(monkeypatch):
    def use(log, dropped=0):
        monkeypatch.setattr(spans, "records", lambda: None if log is None else list(log.recs))
        monkeypatch.setattr(spans, "dropped", lambda: dropped)

    return use


def test_the_live_readers_take_the_last_serve_clips_call(with_log):
    with_log(live_log())
    ctx = SimpleNamespace(stretch=None)
    assert read("live.queued_s_p50", ctx) == pytest.approx(0.35)
    assert read("live.perceive_s_p50", ctx) == pytest.approx(0.21)
    assert read("live.held_s_p50", ctx) == pytest.approx(0.30)
    assert read("live.post_ms_per_frame", ctx) == pytest.approx(150.0 / 75)


@pytest.mark.parametrize("jitter", [False, True])
def test_the_match_readers_place_the_waits_on_the_traces_clock(with_log, jitter):
    """The main thread's waits in the stretch: 200 us, and the 50 us of the
    second inside it; the card's idle inside them 100 us (500-600) and 50
    us (950-1000).  The offset is found whether or not the stamps are off
    the ranges by a few us (their median difference is 0 here)."""
    log, st = match_log_and_stretch(jitter)
    with_log(log)
    offset, res = spans.align(log.recs, st)
    assert offset == BASE and max(abs(r) for r in res) == (2_000 if jitter else 0)
    ctx = SimpleNamespace(stretch=st)
    assert read("host_wait_ms_per_frame", ctx) == pytest.approx(0.250 / 10)
    assert read("queued_idle_ms_per_frame", ctx) == pytest.approx(0.150 / 10)


def test_setup_sums_the_top_level_setup_spans(with_log):
    with_log(setup_log())
    assert read("setup.program_s", SimpleNamespace(stretch=None)) == pytest.approx(2.0 + 3.0 + 0.5)
    with_log(setup_log(), dropped=1)
    assert read("setup.program_s", SimpleNamespace(stretch=None)) is None


@pytest.mark.parametrize("name", ALL)
def test_each_reader_gives_none_with_nothing_to_read(with_log, name):
    """No log (a program without one); a log with no serve_clips call, no
    set-up span and no stretch; a stretch whose stages are not in the log."""
    _, st = match_log_and_stretch()
    for log, stretch in ((None, st), (Log(), None), (setup_log() if name != "setup.program_s" else Log(), st)):
        with_log(log)
        assert read(name, SimpleNamespace(stretch=stretch)) is None, (name, log)


def test_idle_by_the_innermost_span(with_log):
    """The card's idle gaps of the hand-built stretch (0-120, 250-420,
    500-600, 700-1000 us), by the main thread's innermost span: the
    detector's range 100-120 and 250-300, the temporal one 400-420 and
    700-800 (the wait inside it 500-600), the wait across the stretch's
    end 950-1000, the rest outside every span."""
    log, st = match_log_and_stretch(jitter=False)
    with_log(log)
    got = spans.idle_by_span(SimpleNamespace(stretch=st))
    assert got == pytest.approx({"outside the program's spans": 350e-6, "wait": 150e-6, "temporal": 120e-6,
                                 "detector": 70e-6})
    assert list(got) == ["outside the program's spans", "wait", "temporal", "detector"]
