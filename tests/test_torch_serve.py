"""PyTorch port, clip-pipelined serving (``eagle_tpu_torch/pipeline/
serve.py::serve_clips``): the results equal the reference's sequential
order -- ``get_coordinates``, then the ``Processor`` and ``format_data``,
one clip at a time -- with the Processor of clip k on a worker thread
while clip k+1 is perceived, and clip k+1's host prescale prefetched; its
four spans a clip in the span log, and the log against the profiler's
trace.

Tolerance: none (coordinates, the table with NaN equal to NaN, the team
mapping and the formatted records are equal)."""

import math
import threading

import pytest
import torch

from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.pipeline import serve as serve_mod
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.processor import Processor
from eagle_tpu_torch.pipeline.serve import ClipResult, serve_clips
from eagle_tpu_torch.utils.profiling import LOG

from .oracles import oracle_detector_fn, oracle_keypoint_fn

torch.set_num_threads(2)

FPS = 10


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=10, width=320, height=192, num_players=4, fps=FPS, seed=31)


def _clips(scene):
    return [scene.frames, scene.frames[:8], scene.frames[2:]]


def _model(scene):
    """A fresh model a pass: the oracle detector carries a call cursor, so
    a model used twice would see other detections the second time."""
    return TModel(keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene), device="cpu")


def assert_tables_equal(a, b):
    def same(x, y):
        if isinstance(x, float) and math.isnan(x):
            return isinstance(y, float) and math.isnan(y)
        return type(x) is type(y) and x == y

    assert a.index == b.index and list(a.columns) == list(b.columns)
    for c in a.columns:
        assert len(a[c]) == len(b[c]) and all(map(same, a[c], b[c])), c


@pytest.fixture(scope="module")
def sequential(scene):
    """The reference's order, by hand."""
    model = _model(scene)
    out = []
    for clip in _clips(scene):
        coords = model.get_coordinates(clip, FPS, num_keypoint_detection=2)
        proc = Processor(coords, clip, FPS, device="cpu")
        table, mapping = proc.process_data()
        out.append(ClipResult(coords, table, mapping, proc.format_data(table)))
    return out


@pytest.mark.parametrize("overlap", [False, True])
def test_serve_matches_sequential_exactly(scene, sequential, overlap):
    """Three clips from a generator, in order, each equal to its sequential
    run."""
    served = list(serve_clips(_model(scene), iter(_clips(scene)), FPS, num_keypoint_detection=2, overlap=overlap))
    assert len(served) == 3
    for got, exp in zip(served, sequential):
        assert got.coordinates == exp.coordinates
        assert_tables_equal(got.table, exp.table)
        assert got.team_mapping == exp.team_mapping and len(set(exp.team_mapping.values())) == 2
        assert got.formatted == exp.formatted


def test_serve_empty_iterable(scene):
    assert list(serve_clips(_model(scene), [], FPS)) == []
    assert list(serve_clips(_model(scene), iter([]), FPS, overlap=True)) == []


def test_overlap_auto_follows_available_cpus(scene, monkeypatch):
    """``overlap="auto"`` starts the two worker pools exactly when a spare
    core exists; the results are the same either way."""
    import eagle_tpu_torch.utils as utils_mod

    built = []
    real = serve_mod.ThreadPoolExecutor

    class Recording(real):
        def __init__(self, *a, **kw):
            built.append(True)
            super().__init__(*a, **kw)

    monkeypatch.setattr(serve_mod, "ThreadPoolExecutor", Recording)
    monkeypatch.setattr(utils_mod, "available_cpus", lambda: 1)
    (one,) = serve_clips(_model(scene), [scene.frames[:6]], FPS)
    assert built == []
    monkeypatch.setattr(utils_mod, "available_cpus", lambda: 8)
    (many,) = serve_clips(_model(scene), [scene.frames[:6]], FPS)
    assert len(built) == 2
    assert one.coordinates == many.coordinates and one.formatted == many.formatted


SERVE = ("serve:queued", "serve:perceive", "serve:post", "serve:held")


@pytest.mark.parametrize("overlap", [False, True])
def test_serve_logs_four_spans_a_clip(scene, overlap):
    """One ``serve_clips`` call in the span log: each clip, its request id,
    has one ``serve:queued``, ``serve:perceive``, ``serve:post`` and
    ``serve:held``, in that order, held from the end of its Processor job;
    the perception's stages inside ``serve:perceive`` on the main thread;
    the Processor's stages and its frame count inside ``serve:post``, on
    the worker's thread with ``overlap``; ``serve:held`` 0 long in the
    reference's order.  The model's timer took both's stages."""
    model = _model(scene)
    clips = _clips(scene)
    list(serve_clips(model, iter(clips), FPS, num_keypoint_detection=2, overlap=overlap))
    recs = LOG.records()
    call = max(r.id for r in recs if r.kind == "call" and r.name == "serve_clips")
    mine = [r for r in recs if r.call == call]
    main = threading.main_thread().ident
    for k, clip in enumerate(clips):
        spans = [[r for r in mine if r.request == k and r.name == n] for n in SERVE]
        assert [len(s) for s in spans] == [1, 1, 1, 1], k
        queued, perceive, post, held = (s[0] for s in spans)
        assert queued.end <= perceive.start <= perceive.end <= post.start <= post.end == held.start <= held.end
        assert (queued.thread, perceive.thread, held.thread) == (main, main, main)
        assert (post.thread != main) == overlap
        inner = [r for r in mine if r.parent == perceive.id]
        assert {"prescale", "detector", "keypoints", "temporal", "assembly"} <= {r.name for r in inner}
        assert all(r.thread == main for r in inner)
        job = [r for r in mine if r.parent == post.id]
        assert {"crops", "votes", "table", "merge", "format"} <= {r.name for r in job}
        assert all(r.thread == post.thread and r.request == k for r in job)
        assert [r.value for r in job if r.name == "serve:frames"] == [len(clip)]
        assert (held.end == held.start) == (not overlap)
    assert {"prescale", "temporal", "crops", "votes", "table", "merge", "format"} <= set(model.timer.seconds)


#: the ``stage:`` ranges a clip opens in the trace: the perception's; in
#: the reference's order also the Processor's, on the main thread then
PERCEPTION_RANGES = {"prescale": 1, "detector": 1, "keypoints": 1, "temporal": 2, "assembly": 1}
PROCESSOR_RANGES = {"crops": 2, "votes": 3, "table": 1, "merge": 2, "format": 1}


@pytest.mark.parametrize("overlap", [False, True])
def test_the_log_sits_on_the_trace_clock(scene, tmp_path, overlap):
    """Two clips served under the CPU profiler: the trace's ``stage:``
    ranges are the stages the main thread opens outside another stage, a
    clip the perception's and, in the reference's order, the Processor's
    (none of the worker's, the serving spans or the waits); each is a
    ranged span of the log, in order, at ``ts * 1e3 +
    baseTimeNanoseconds``.  The profiler stamps a range halfway through
    opening it, tens of microseconds on this CPU, and a thread switch can
    hold one stamp back: the median start or end within 20 us of the
    range's, nine in ten within 50 us."""
    import collections
    import json
    import statistics

    from torch.profiler import ProfilerActivity, profile, record_function

    model = _model(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the profiler's first range is slow to open
            pass
        list(serve_clips(model, iter(_clips(scene)[:2]), FPS, num_keypoint_detection=2, overlap=overlap))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = sorted((e["ts"], e["dur"], e["name"][len("stage:"):]) for e in trace["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("stage:"))
    call = max(r.id for r in LOG.records() if r.kind == "call" and r.name == "serve_clips")
    logged = sorted((r for r in LOG.records() if r.call == call and r.ranged), key=lambda r: r.start)
    want = collections.Counter({**PERCEPTION_RANGES, **({} if overlap else PROCESSOR_RANGES)})
    assert collections.Counter(name for _, _, name in ranges) == want + want
    assert [name for _, _, name in ranges] == [r.name for r in logged]
    gaps = sorted(abs(x - y) for (ts, dur, _), r in zip(ranges, logged)
                  for x, y in ((base + round(ts * 1e3), r.start), (base + round((ts + dur) * 1e3), r.end)))
    assert statistics.median(gaps) <= 20_000 and gaps[int(0.9 * len(gaps))] <= 50_000
