"""Tracing and timing helpers (PyTorch counterpart of
``eagle_tpu/utils/profiling.py``).

- :class:`StageTimer` (defined in ``pipeline/coordinate_model.py``, where
  ``get_coordinates`` takes it): wall seconds per pipeline stage, each span
  also a ``torch.profiler`` range ``stage:<name>``.
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
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile

from eagle_tpu_torch.ops.optical_flow import BUILD_DIR
from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

__all__ = ["StageProfile", "StageTimer", "block", "device_trace", "profile_stages", "trace_events"]

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
