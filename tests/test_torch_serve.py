"""PyTorch port, clip-pipelined serving (``eagle_tpu_torch/pipeline/
serve.py::serve_clips``): the results equal the reference's sequential
order -- ``get_coordinates``, then the ``Processor`` and ``format_data``,
one clip at a time -- over a backlog (clips with a length: the Processor
of clip k on a worker thread while clip k+1 is perceived, and clip k+1's
host prescale prefetched) and over a generator (a feed, instant or paced:
the reference's order, each result out before the next clip is asked
for); the clips iterated on the consumer's thread only; four spans and
the order's count a clip in the span log, and the log against the
profiler's trace.

Tolerance: none (coordinates, the table with NaN equal to NaN, the team
mapping and the formatted records are equal)."""

import math
import threading
import time

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


#: seconds a paced source sleeps before each clip: ten times a Processor
#: job at the tests' size on a CPU
PACE = 0.5


def _source(clips, pace, asks):
    """The clips from a generator that sleeps ``pace`` s before each and
    appends ("ask", i, its thread) to ``asks`` each time it is asked for
    clip i (i = len(clips) at the end)."""
    for i, clip in enumerate(clips):
        asks.append(("ask", i, threading.get_ident()))
        time.sleep(pace)
        yield clip
    asks.append(("ask", len(clips), threading.get_ident()))


class _Backlog:
    """Clips with a length, as a dataset holds them: each read (a sleep of
    ``read_s``) when asked for, the asks logged as by :func:`_source`."""

    def __init__(self, clips, asks, read_s=0.0):
        self.clips, self.asks, self.read_s = clips, asks, read_s

    def __len__(self):
        return len(self.clips)

    def __iter__(self):
        return _source(self.clips, self.read_s, self.asks)


class Served:
    """One ``serve_clips(overlap=True)`` run over the scene's clips as a
    backlog or as a paced feed: its results, the source's requests and the
    consumer's receipts in the order they happened ("got", k, thread), its
    call's records of the span log and its model."""

    def __init__(self, scene, source):
        self.model = _model(scene)
        self.events: list = []
        clips = _clips(scene)
        src = _Backlog(clips, self.events) if source == "backlog" else _source(clips, PACE, self.events)
        self.results = []
        for k, res in enumerate(serve_clips(self.model, src, FPS, num_keypoint_detection=2, overlap=True)):
            self.events.append(("got", k, threading.get_ident()))
            self.results.append(res)
        recs = LOG.records()
        call = max(r.id for r in recs if r.kind == "call" and r.name == "serve_clips")
        self.records = [r for r in recs if r.call == call]


@pytest.fixture(scope="module")
def served(scene):
    """``served(source)``: one run a source, shared by the tests."""
    runs = {}

    def get(source):
        if source not in runs:
            runs[source] = Served(scene, source)
        return runs[source]

    return get


def _order(records):
    """Each clip's ``serve:read_ahead`` count, by request."""
    counts = {r.request: r.value for r in records if r.kind == "count" and r.name == "serve:read_ahead"}
    return [counts[k] for k in sorted(counts)]


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


@pytest.mark.parametrize("source", ["backlog", "paced"])
def test_served_sources_match_sequential_exactly(served, sequential, source):
    """``overlap=True`` over a backlog (read ahead) and over a paced feed
    (the reference's order): three clips, in order, each equal to its
    sequential run."""
    results = served(source).results
    assert len(results) == 3
    for got, exp in zip(results, sequential):
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
    the worker's thread with ``overlap`` (the clips are a list: a
    backlog); ``serve:held`` 0 long in the reference's order; the
    ``serve:read_ahead`` count 1 a clip with ``overlap``, else 0.  The
    model's timer took both's stages."""
    model = _model(scene)
    clips = _clips(scene)
    list(serve_clips(model, clips, FPS, num_keypoint_detection=2, overlap=overlap))
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
    assert _order(mine) == [int(overlap)] * len(clips)
    assert {"prescale", "temporal", "crops", "votes", "table", "merge", "format"} <= set(model.timer.seconds)


def test_a_paced_feed_is_served_in_the_reference_order(served):
    """``overlap=True`` over a generator that sleeps before each clip:
    each clip's four spans, its Processor job on the consumer's thread,
    ``serve:held`` 0 long and ended before the next clip is asked for, the
    ``serve:read_ahead`` count 0 a clip, and result k in the consumer's
    hands before clip k+1 is asked for."""
    run = served("paced")
    main = threading.main_thread().ident
    for k in range(3):
        queued, perceive, post, held = (next(r for r in run.records if r.request == k and r.name == n) for n in SERVE)
        assert queued.end <= perceive.start <= perceive.end <= post.start <= post.end == held.start == held.end
        assert {queued.thread, perceive.thread, post.thread, held.thread} == {main}
    assert _order(run.records) == [0, 0, 0]
    at = {e[:2]: i for i, e in enumerate(run.events)}
    assert all(at["got", k] < at["ask", k + 1] for k in range(3))


def test_a_backlog_is_read_ahead(served):
    """``overlap=True`` over clips with a length: clip k+1 asked for
    before result k is out, for every clip, and the ``serve:read_ahead``
    count 1 a clip."""
    run = served("backlog")
    at = {e[:2]: i for i, e in enumerate(run.events)}
    assert all(at["ask", k + 1] < at["got", k] for k in range(3))
    assert _order(run.records) == [1, 1, 1]


@pytest.mark.parametrize("source", ["backlog", "paced"])
def test_clips_are_iterated_on_the_consumers_thread(served, source):
    """Every ``next()`` on ``clips`` runs on the thread that iterates
    ``serve_clips`` (a source may hold thread-local state, such as a
    profiler it started): no feeder thread, in either order."""
    run = served(source)
    asks = [e for e in run.events if e[0] == "ask"]
    assert len(asks) == 4
    assert {e[2] for e in run.events} == {threading.get_ident()}


class _FakeModel:
    """A model whose perception of a clip returns it at once."""

    def __init__(self):
        from eagle_tpu_torch.utils.profiling import StageTimer

        self.timer, self.device = StageTimer(), "cpu"

    def prescale_clip(self, clip):
        return clip

    def get_coordinates(self, clip, fps, prescaled=None, **kw):
        return {0: clip}


class _FakeProcessor:
    """A Processor whose table is its clip."""

    def __init__(self, coords, clip, fps, **kw):
        self.clip = clip

    def process_data(self, smooth=False):
        return self.clip, {}

    def format_data(self, table):
        return [table]


@pytest.mark.parametrize("kind,read_s,overlap,ahead", [
    ("list", 0.0, True, 1),
    ("backlog", 0.01, True, 1),  # a dataset reading each clip in 10 ms
    ("list", 0.0, False, 0),
    ("generator", 0.0, True, 0),
    ("generator", 0.01, True, 0),  # a generator decoding each clip in 10 ms
])
def test_the_order_follows_whether_the_clips_have_a_length(monkeypatch, kind, read_s, overlap, ahead):
    """With ``overlap``, clips with a length are read ahead, however long
    each takes to read; a generator is served in the reference's order,
    however fast it hands its clips (a decoder 10 ms behind and a feed 10
    ms ahead look alike); ``overlap=False`` keeps the reference's order.
    The ``serve:read_ahead`` count says which, and results come in order
    either way."""
    monkeypatch.setattr(serve_mod, "Processor", _FakeProcessor)
    events: list = []
    clips = list(range(5))
    src = {"list": clips, "backlog": _Backlog(clips, events, read_s),
           "generator": _source(clips, read_s, events)}[kind]
    got = []
    for k, res in enumerate(serve_clips(_FakeModel(), src, FPS, overlap=overlap)):
        events.append(("got", k, threading.get_ident()))
        got.append(res.table)
    assert got == clips
    recs = LOG.records()
    call = max(r.id for r in recs if r.kind == "call" and r.name == "serve_clips")
    assert _order([r for r in recs if r.call == call]) == [ahead] * 5
    if kind != "list":
        at = {e[:2]: i for i, e in enumerate(events)}
        assert all((at["ask", k + 1] < at["got", k]) == bool(ahead) for k in range(5))


#: the ``stage:`` ranges a clip opens in the trace: the perception's; in
#: the reference's order also the Processor's, on the main thread then
PERCEPTION_RANGES = {"prescale": 1, "detector": 1, "keypoints": 1, "temporal": 2, "assembly": 1}
PROCESSOR_RANGES = {"crops": 2, "votes": 3, "table": 1, "merge": 2, "format": 1}


@pytest.mark.parametrize("overlap", [False, True])
def test_the_log_sits_on_the_trace_clock(scene, tmp_path, overlap):
    """Two clips served under the CPU profiler: the trace's ``stage:``
    ranges are the stages the main thread opens outside another stage, a
    clip the perception's and, in the reference's order, the Processor's
    (none of the worker's, the serving spans or the waits; the clips are
    a list, read ahead with ``overlap``); each is a
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
        list(serve_clips(model, _clips(scene)[:2], FPS, num_keypoint_detection=2, overlap=overlap))
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
