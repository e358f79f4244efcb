"""The device trace of one steady stretch of a run, reduced to what the
per-layer metrics read.

The union arithmetic and the event selection are a frozen copy of
``eagle_tpu_torch/utils/profiling.py`` (``_union_ms``, ``trace_events``:
the complete events of the profiler's Chrome trace).  Unlike
``profile_stages`` the stages are not synchronised: each device operation
belongs to the program stage (``stage:<name>``, the ranges the program's
``StageTimer`` opens) in which the host launched it, found through the
launch's correlation id.  So the run is traced as it runs untraced.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: the trace's event categories that are device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host's range around the traced stretch
STRETCH = "bench:stretch"
#: the host's range around the benchmark's own device work (the judge's
#: samples), and the stage its operations are given
OWN = "bench:inject"
BENCHMARK = "(benchmark)"


def union_s(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in s."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


class Tracer:
    """Profiles the stretch opened by :meth:`start` and closed by
    :meth:`stop`; :meth:`stretch` reads it back."""

    def __init__(self, tmp_dir: str):
        fd, self.path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json", dir=tmp_dir)
        os.close(fd)
        self.prof = None
        self._range = None

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._range = record_function(STRETCH)
        self._range.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def events(self) -> list[dict]:
        """The complete ("X") events, read back from the Chrome trace, which
        is then deleted."""
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        finally:
            os.remove(self.path)


class Stretch:
    """The traced stretch: ``t0``/``t1`` (us, trace clock), the program's
    stage ranges on the host, and every device operation with the stage
    whose range holds its launch (None outside every stage)."""

    def __init__(self, events: list[dict], frames: int):
        self.frames = frames
        span = [e for e in events if e.get("name") == STRETCH]
        if not span:
            raise RuntimeError(f"the trace holds no {STRETCH!r} range")
        self.t0 = span[0]["ts"]
        self.t1 = self.t0 + span[0]["dur"]
        self.ranges: dict[str, list] = {}
        own = []
        launch = {}
        for e in events:
            cat = e.get("cat", "")
            if cat == "user_annotation" and e["name"].startswith("stage:"):
                self.ranges.setdefault(e["name"][len("stage:"):], []).append((e["ts"], e["ts"] + e["dur"]))
            elif cat == "user_annotation" and e["name"] == OWN:
                own.append((e["ts"], e["ts"] + e["dur"]))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        own.sort()
        own_starts = [a for a, _ in own]
        self._flat = sorted((a, b, name) for name, rs in self.ranges.items() for a, b in rs)
        self._starts = [a for a, _, _ in self._flat]
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATEGORIES:
                continue
            a, b = e["ts"], e["ts"] + e["dur"]
            if b < self.t0 or a > self.t1:
                continue
            ts = launch.get(e.get("args", {}).get("correlation"))
            k = bisect.bisect_right(own_starts, ts) - 1 if ts is not None else -1
            if k >= 0 and ts <= own[k][1]:
                stage, rng = BENCHMARK, None
            else:
                stage, rng = self.stage_at(ts)
            self.ops.append({"start": a, "end": b, "name": e["name"], "cat": e["cat"], "stage": stage, "range": rng})

    def stage_at(self, ts) -> tuple[str | None, tuple | None]:
        """(stage, its range) of the host at trace time ``ts``: the
        program's stage ranges do not overlap one another."""
        if ts is None:
            return None, None
        i = bisect.bisect_right(self._starts, ts) - 1
        if i >= 0 and ts <= self._flat[i][1]:
            a, b, name = self._flat[i]
            return name, (a, b)
        return None, None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self, stage: str | None = "*") -> float:
        """Seconds with a device operation running (of ``stage``'s
        launches, or of all with ``"*"``), inside the stretch."""
        return union_s((max(o["start"], self.t0), min(o["end"], self.t1)) for o in self.ops
                       if stage == "*" or o["stage"] == stage)

    def stage_span(self, stage: str) -> tuple[float, float] | None:
        """(device span s, device busy s) of ``stage``: summed over the
        stage's ranges, each from its first launched operation's start to
        its last one's end, and the busy time inside those spans."""
        per_range: dict = {}
        for o in self.ops:
            if o["stage"] == stage:
                per_range.setdefault(o["range"], []).append(o)
        if not per_range:
            return None
        span = busy = 0.0
        for ops in per_range.values():
            a, b = min(o["start"] for o in ops), max(o["end"] for o in ops)
            span += (b - a) / 1e6
            busy += union_s((o["start"], o["end"]) for o in ops)
        return span, busy

    def kernels(self, stage: str | None = "*") -> list[dict]:
        return [o for o in self.ops if o["cat"] == "kernel" and (stage == "*" or o["stage"] == stage)]

    def host_s(self, stage: str) -> float:
        """Host seconds inside ``stage``'s ranges within the stretch."""
        return sum(max(0.0, min(b, self.t1) - max(a, self.t0)) for a, b in self.ranges.get(stage, ())) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the device summed by the program stage the host was in."""
        by_name: dict = {}
        for o in self.ops:
            by_name[o["name"]] = by_name.get(o["name"], 0.0) + (o["end"] - o["start"]) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((max(o["start"], self.t0), min(o["end"], self.t1)) for o in self.ops)
        gaps, end = [], self.t0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        idle: dict = {}
        for a, b in gaps:
            key = self.stage_at((a + b) / 2)[0] or "outside the program's stages"
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}
