"""The readers of the four per-layer metrics of Eagle's own tracker
(``benchmark/metrics/{reid_mfu,reid_idle_share,reid_crops_per_frame,
gmc_fallback_share}.py``), each on a hand-built traced stretch or span
log: the appearance network's stage on the trace, the program's
``reid:crops`` counts inside the stretch, the features GMC's tally of the
window's stream; and None wherever there is nothing to read (no stretch,
no appearance network, no log, no such count, as in a program that does
not make them).  Run from the repository's root::

    python -m pytest -q benchmark/tests/test_reid_features_readers.py
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

from benchmark import run as bench_run
from benchmark import spans
from benchmark.trace import STRETCH, Stretch
from benchmark.work import peaks
from eagle_tpu_torch.utils.profiling import Record

MAIN = threading.main_thread().ident
#: the log's clock at the trace's zero (ns)
BASE = 1_790_000_000_000_000_000
FRAMES = 8
REID_FLOPS = 10.5e9


def stretch(reid: bool = True) -> Stretch:
    """1000 us and 8 frames: the detector's range at 100-300 us, the
    appearance network's (``stage:reid``, left out with ``reid`` False) at
    300-600 us, whose kernels run at 350-400 and 450-550 us (a 200 us span,
    busy 150 us)."""
    def host(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def launched(ts, start, dur, corr):
        return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                 "args": {"correlation": corr}},
                {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start, "dur": dur, "args": {"correlation": corr}}]

    events = [host(STRETCH, 0, 1000), host("stage:detector", 100, 200), *launched(150, 160, 100, 1)]
    if reid:
        events += [host("stage:reid", 300, 300), *launched(310, 350, 50, 2), *launched(320, 450, 100, 3)]
    return Stretch(events, FRAMES)


def read(metric: str, ctx, monkeypatch, records=None):
    monkeypatch.setattr(spans, "records", lambda: records)
    return bench_run.reader(metric)(ctx)


def test_reid_mfu_and_idle_share_read_the_stage(monkeypatch):
    ctx = SimpleNamespace(stretch=stretch(), reid_flops=REID_FLOPS)
    want = 100.0 * REID_FLOPS * FRAMES / (200e-6 * peaks.BF16_FLOPS)
    assert read("reid_mfu", ctx, monkeypatch) == pytest.approx(want, rel=1e-9)
    assert read("reid_idle_share", ctx, monkeypatch) == pytest.approx(25.0, rel=1e-9)


def test_reid_mfu_and_idle_share_are_none_without_their_input(monkeypatch):
    for ctx in (SimpleNamespace(stretch=None, reid_flops=REID_FLOPS),
                SimpleNamespace(stretch=stretch(reid=False), reid_flops=REID_FLOPS)):
        assert read("reid_mfu", ctx, monkeypatch) is None
        assert read("reid_idle_share", ctx, monkeypatch) is None
    # a configuration without an appearance network has no reid_flops
    assert read("reid_mfu", SimpleNamespace(stretch=stretch()), monkeypatch) is None


def crops_log(counts: bool = True) -> list:
    """The stretch's two ranged stages in the log, 3 us off the trace's
    clock; ``reid:crops`` counts of 4 and 4 frames x 64 slots inside the
    stretch and one of 16 x 64 before it (the previous block's)."""
    recs = []

    def add(kind, name, start_us, end_us, value=0, ranged=False):
        recs.append(Record(kind, name, BASE + int(start_us * 1e3) + 3000, BASE + int(end_us * 1e3) + 3000, MAIN,
                           len(recs) + 1, None, 1, 0, value, ranged))

    add("span", "detector", 100, 300, ranged=True)
    add("span", "reid", 300, 600, ranged=True)
    if counts:
        add("count", "reid:crops", -5000, -5000, value=16 * 64)
        add("count", "reid:crops", 400, 400, value=4 * 64)
        add("count", "reid:crops", 500, 500, value=4 * 64)
    return recs


def test_reid_crops_per_frame_counts_the_stretch(monkeypatch):
    ctx = SimpleNamespace(stretch=stretch())
    assert read("reid_crops_per_frame", ctx, monkeypatch, crops_log()) == 64.0


@pytest.mark.parametrize("case", ["no log", "no count", "no stretch"])
def test_reid_crops_per_frame_is_none_without_its_input(monkeypatch, case):
    ctx = SimpleNamespace(stretch=None if case == "no stretch" else stretch())
    records = {"no log": None, "no count": crops_log(counts=False), "no stretch": crops_log()}[case]
    assert read("reid_crops_per_frame", ctx, monkeypatch, records) is None


def gmc_log(window) -> list:
    """A warm-up stream call whose every frame fell back, then the window's
    call with ``window``'s (frames, fallback) a chunk (None: no tally)."""
    recs = []
    for call, chunks in ((1, [(96, 96)]), (2, window)):
        recs.append(Record("call", "stream_coordinates", 0, 0, MAIN, call, None, call, None))
        for k, (frames, fallback) in enumerate(chunks or ()):
            for name, value in (("gmc:frames", frames), ("gmc:fallback", fallback), ("gmc:inliers", 20 * frames)):
                recs.append(Record("count", name, k, k, MAIN, len(recs) + 10, None, call, 96 * k, value))
    return recs


@pytest.mark.parametrize("window,want", [([(96, 3), (96, 0), (56, 1)], 1.6129032258064515), ([(96, 0)], 0.0),
                                         (None, None)])
def test_gmc_fallback_share_of_the_window(monkeypatch, window, want):
    """4 of 248 frames fell back: 1.61%; none: 0.0 (not the warm-up's
    100); a window without the tally: None."""
    got = read("gmc_fallback_share", SimpleNamespace(stretch=stretch()), monkeypatch, gmc_log(window))
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


def test_gmc_fallback_share_is_none_without_a_log(monkeypatch):
    assert read("gmc_fallback_share", SimpleNamespace(stretch=None), monkeypatch, None) is None
