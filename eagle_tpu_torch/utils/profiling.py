"""Tracing and timing (PyTorch counterpart of
``eagle_tpu/utils/profiling.py``).

- :class:`StageTimer`: the port's one recorder of spans and counts.  A
  stage (``timer(name)``) adds its wall seconds to the instance's
  ``seconds`` and ``counts``; every span and count goes to the span log.
- :data:`LOG`: the span log, one a process, in memory and bounded.
- :func:`device_trace`: a ``torch.profiler`` scope over the host and the
  card that writes a Chrome trace (the JAX package's ``jax.profiler``
  trace scope).
- :func:`block`: wait for the device work behind the tensors of a nested
  structure (the JAX package's ``block_until_ready`` helper).
- :func:`profile_stages`: one ``get_coordinates`` run under
  ``torch.profiler``, summarised per stage (wall, device busy and idle
  share, the host's blocking calls) and per device kernel; the bench
  (``python -m eagle_tpu_torch.bench``) and ``chip_smoke.py --profile``
  read it.

The span log
------------

A :class:`Record` is a span (``kind`` "span": a name, a start and an end),
a count (``kind`` "count": a name and ``value``) or the start of a call
(``kind`` "call"), each with:

- ``thread``: ``threading.get_ident()`` of the thread that made it, on any
  thread: the main thread's stages, the ``Processor``'s on the worker
  thread of ``serve_clips``;
- ``id``, and ``parent``: the id of the span open around it on its thread
  (None at the top);
- ``call``: the id of the entry point's call it belongs to
  (``get_coordinates``, ``stream_coordinates``, ``serve_clips``; its
  "call" record names the entry point), and ``request``: its unit of work
  in that call (the clip's index in ``serve_clips``, the block's first
  global frame in a stream, None in a lone ``get_coordinates``).  Both are
  the thread's :func:`scope` when the record is made.

Clock: ``time.time_ns()``, unix nanoseconds, the clock of the host
timestamps of ``torch.profiler``: an event at ``ts`` (us) in an exported
Chrome trace happened at ``ts * 1e3 + baseTimeNanoseconds`` on it.  Where
the base is not at hand, the main thread's ranged stages (``ranged``) are
in the log and in the trace (``stage:<name>``) both, and their pairs give
the offset.

Bound: :data:`LOG_BOUND` records.  When the log is full, each new record
pushes out the oldest; ``LOG.dropped`` counts those pushed out.  Spans are
made a stage, batch, chunk or clip, never a frame or a kernel: a 51 s run
of the benchmark's cells makes a few thousand.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["LOG", "LOG_BOUND", "Record", "SpanLog", "StageProfile", "StageTimer", "block", "device_trace",
           "entry_point", "new_call", "profile_stages", "scope", "trace_events"]

#: the most records the span log holds
LOG_BOUND = 1 << 16


class Record(NamedTuple):
    """One entry of the span log (see the module's docstring); times in
    unix ns."""

    kind: str
    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: int | None
    call: int | None
    request: int | None
    value: int = 0
    #: the span also opened the profiler range ``stage:<name>``
    ranged: bool = False


class SpanLog:
    """The newest ``bound`` records, in the order they were closed."""

    def __init__(self, bound: int):
        self._records: collections.deque = collections.deque(maxlen=bound)
        self._lock = threading.Lock()
        self.appended = 0

    def append(self, rec: Record) -> None:
        with self._lock:
            self._records.append(rec)
            self.appended += 1

    def records(self) -> list[Record]:
        with self._lock:
            return list(self._records)

    @property
    def dropped(self) -> int:
        """Records pushed out by newer ones."""
        with self._lock:
            return self.appended - len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.appended = 0


#: the process's span log
LOG = SpanLog(LOG_BOUND)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """The ids of the spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(kind: str, name: str, start: int, end: int, rid: int, parent, value: int = 0, ranged: bool = False):
    LOG.append(Record(kind, name, start, end, threading.get_ident(), rid, parent, getattr(_local, "call", None),
                      getattr(_local, "request", None), value, ranged))


@contextlib.contextmanager
def scope(call: int | None, request: int | None):
    """Records made on this thread inside the block carry ``call`` and
    ``request``; the thread's previous scope comes back after it.  A
    generator opens its scope around each piece of work, never across a
    ``yield``."""
    was = getattr(_local, "call", None), getattr(_local, "request", None)
    _local.call, _local.request = call, request
    try:
        yield
    finally:
        _local.call, _local.request = was


def new_call(name: str) -> int:
    """A new call of the entry point ``name``: its id, logged."""
    cid = next(_ids)
    t = time.time_ns()
    LOG.append(Record("call", name, t, t, threading.get_ident(), cid, None, cid, None))
    return cid


def entry_point(name: str):
    """Decorator of a (non-generator) entry point: a call of it on a
    thread with no scope starts a new call (its request None); inside
    another call's scope it belongs to that one."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if getattr(_local, "call", None) is not None:
                return fn(*args, **kwargs)
            with scope(new_call(name), None):
                return fn(*args, **kwargs)

        return run

    return wrap


class _Span:
    """An open span (a context manager); ``start``, ``end`` (unix ns) and
    ``seconds`` once closed."""

    __slots__ = ("timer", "name", "stage", "range", "start", "end", "id", "parent")

    def __init__(self, timer, name: str, stage: bool):
        self.timer, self.name, self.stage, self.range = timer, name, stage, None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        opens = False
        if self.stage:
            depth = getattr(_local, "stages", 0)
            _local.stages = depth + 1
            opens = depth == 0 and threading.current_thread() is threading.main_thread()
        self.start = time.time_ns()
        if opens:
            # the profiler stamps a range about halfway through opening it
            # (tens of us while it records), and near the end of closing it
            self.range = record_function(f"stage:{self.name}")
            self.range.__enter__()
            self.start = (self.start + time.time_ns()) // 2
        return self

    def __exit__(self, *exc):
        timer = self.timer
        if self.stage and timer.sync and timer.device is not None and timer.device.type == "cuda":
            torch.cuda.synchronize(timer.device)
        if self.range is not None:
            self.range.__exit__(*exc)
        self.end = time.time_ns()
        _stack().pop()
        if self.stage:
            _local.stages -= 1
            timer._add(self.name, self.seconds)
        _record("span", self.name, self.start, self.end, self.id, self.parent, ranged=self.range is not None)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class StageTimer:
    """Wall-clock seconds per stage, and the recorder of the span log.

    ``timer(name)`` opens a stage: on closing, its wall seconds add to the
    instance's ``seconds[name]`` and its closes to ``counts[name]``, under
    a lock (a model's timer takes the main thread's stages and a served
    clip's Processor's at once), and it goes to the log as a span.  A stage
    opened on the main thread while no other stage is open there is also a
    ``torch.profiler`` range ``stage:<name>``, so a trace can attribute
    device time to the stages; a stage on another thread, or inside a
    stage, is in the log only (a range opened on a worker thread never
    reaches the exported trace).  ``sync``: each stage ends with a device
    synchronisation, so the time lands where the work is.

    :meth:`span` (a span in the log only: a wait on the card inside a
    stage, the serving spans, set-up), :meth:`record` (a span of given
    times) and :meth:`count` (a count in the log) need no instance, and
    touch no instance's ``seconds``."""

    def __init__(self, device: torch.device | None = None, sync: bool = False):
        self.device = device
        self.sync = sync
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, name: str):
        return _Span(self, name, True)

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def totals(self) -> dict[str, float]:
        """A copy of ``seconds`` (another thread may be adding to it)."""
        with self._lock:
            return dict(self.seconds)

    @staticmethod
    def span(name: str) -> _Span:
        """A span in the log only: no profiler range, no instance's
        ``seconds``."""
        return _Span(None, name, False)

    @staticmethod
    def record(name: str, start: int, end: int) -> None:
        """A span from ``start`` to ``end`` (unix ns, :func:`time.time_ns`)
        made on this thread, in the log only; its parent is the span open
        now."""
        stack = _stack()
        _record("span", name, start, end, next(_ids), stack[-1] if stack else None)

    @staticmethod
    def count(name: str, n: int = 1) -> None:
        """A count of ``n`` under ``name`` in the log, now."""
        stack = _stack()
        t = time.time_ns()
        _record("count", name, t, t, next(_ids), stack[-1] if stack else None, value=int(n))

    def summary(self) -> dict:
        """{stage: {"total_s", "calls", "mean_ms"}}, largest total first
        (the JAX package's ``StageTimer.summary``)."""
        return {
            name: {
                "total_s": round(self.seconds[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.seconds[name] / max(1, self.counts[name]), 3),
            }
            for name in sorted(self.seconds, key=self.seconds.get, reverse=True)
        }

    def report(self) -> str:
        """JSON of the stages' milliseconds, in the order they first ran."""
        return json.dumps({k: round(v * 1e3, 3) for k, v in self.seconds.items()}, indent=2)


#: the trace's event categories that are device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: host calls that may wait for the device (:func:`profile_stages` counts
#: them all, and apart those that do wait: every one but a copy from the
#: card to the card)
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block (host operations, and the card's kernels
    and copies when CUDA is available) and write its Chrome trace to
    ``log_dir/trace_<time>.json`` on exit (open it in chrome://tracing or
    Perfetto).  Yields the ``torch.profiler.profile`` object."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Synchronise every CUDA device that holds a tensor of ``tree`` (nested
    dicts, lists, tuples and named tuples of tensors and other leaves) and
    return ``tree``: in a timed region, the device work is then done."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


def _union_ms(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_events(prof) -> list[dict]:
    """The complete ("X") events of a finished ``torch.profiler`` run, read
    back from its Chrome trace (written to and removed from the build
    directory)."""
    from eagle_tpu_torch.ops.optical_flow import BUILD_DIR

    trace = os.path.join(BUILD_DIR, f"trace_{os.getpid()}.json")
    os.makedirs(BUILD_DIR, exist_ok=True)
    prof.export_chrome_trace(trace)
    try:
        with open(trace) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(trace)


class StageProfile(NamedTuple):
    """:func:`profile_stages`' summary.  ``stages``: per stage, the wall
    ms, the device's busy ms (the union of the kernels and copies inside
    the stage's ranges) and idle share, the host's ms blocked in
    synchronising calls and their count (``blocking_calls``: every call
    of :data:`BLOCKING_CALLS`; ``waiting_calls``: those but the copies from
    the card to the card, which do not wait).  ``kernels``: every device
    operation's name -> (count, ms).  ``stage_kernels``: per stage, the
    names of the device kernels that ran inside it -> count."""

    stages: dict
    kernels: dict
    stage_kernels: dict


def profile_stages(model, frames, fps: int, **kw) -> StageProfile:
    """One run of ``model.get_coordinates(frames, fps, **kw)`` under
    ``torch.profiler`` on the card, each stage ending in a synchronize
    (``StageTimer(sync=True)``), summarised as :class:`StageProfile`."""
    timer = StageTimer(model.device, sync=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.get_coordinates(frames, fps, timer=timer, **kw)
        torch.cuda.synchronize()
    ranges, device, blocking, waiting = {}, [], [], []
    events = trace_events(prof)
    # a copy from the card to the card does not wait for it (the captured
    # temporal step's frame slots are filled that way)
    on_card = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "gpu_memcpy" and "DtoD" in e["name"]} - {None}
    for e in events:
        span = (e["ts"], e["ts"] + e["dur"])
        if e.get("cat") == "user_annotation" and e["name"].startswith("stage:"):
            ranges.setdefault(e["name"][len("stage:"):], []).append(span)
        elif e.get("cat") in DEVICE_CATEGORIES:
            device.append((span, e["name"], e["cat"]))
        elif e.get("cat") == "cuda_runtime" and e["name"] in BLOCKING_CALLS:
            blocking.append(span)
            if e.get("args", {}).get("correlation") not in on_card:
                waiting.append(span)

    def inside(spans, rs):
        return [(max(a, r0), min(b, r1)) for a, b in spans for r0, r1 in rs if a < r1 and b > r0]

    stages, stage_kernels = {}, {}
    for name, rs in ranges.items():
        wall = sum(b - a for a, b in rs) / 1e3
        busy = _union_ms(inside([sp for sp, _, _ in device], rs))
        stages[name] = {
            "wall_ms": wall,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall > 0 else None,
            "host_blocked_ms": _union_ms(inside(blocking, rs)),
            "blocking_calls": len(inside(blocking, rs)),
            "waiting_calls": len(inside(waiting, rs)),
        }
        counts: dict = {}
        for sp, kname, cat in device:
            if cat == "kernel" and inside([sp], rs):
                counts[kname] = counts.get(kname, 0) + 1
        stage_kernels[name] = counts
    by_kernel: dict = {}
    for (a, b), name, _ in device:
        n, ms = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (n + 1, ms + (b - a) / 1e3)
    return StageProfile(stages, by_kernel, stage_kernels)
