"""The benchmark's harness on the CPU: its files found by name, the FLOP
counts against hand counts, the open loop and the window arithmetic, the
imports of a run and of the reference, and the injection on both upload
paths at a small size.  Run from the repository's root::

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.load import OpenLoop, latencies
from benchmark.reference import hrnet, yolov8
from benchmark.reference.ops import FlopCounter
from benchmark.tests import tiny
from benchmark.work import flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.setattr(bench_run, "ROOT", ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    bench, entry, config, traffic = bench_run.spec_of(cell)
    assert config["name"] == entry["config"] and config["reduced"] == []
    assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers", f"{traffic['driver']}.py"))
    assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", f"{cell}.json"))
    for m in bench_run.metrics_of(bench, entry, trace=True):
        assert callable(bench_run.reader(m["name"]))
    assert {m["name"] for m in bench_run.metrics_of(bench, entry, trace=False)} >= {"setup_s"}


def _meta(layout):
    return {k: torch.empty(s, device="meta") for k, s in layout.items()}


def test_flop_counts_match_a_hand_count_of_one_block():
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "yolov8l-960_hrnet-w48.json")))
    ops = FlopCounter()
    net = yolov8.YOLOv8(_meta(yolov8.layout(cfg["detector"])), cfg["detector"], ops)
    hw = 136 * 240
    net.c2f(torch.empty(1, 128, 136, 240, device="meta"), "model.2", 3, True)
    # cv1 1x1 128->128, three bottlenecks of two 3x3 64->64, cv2 1x1 320->128
    assert ops.flops == 2 * hw * (128 * 128 + 3 * 2 * 64 * 64 * 9 + 320 * 128)
    ops = FlopCounter()
    hr = hrnet.HRNet(_meta(hrnet.layout(cfg["keypoints"])), cfg["keypoints"], ops)
    p = "unnormalized_model.0.stage2.0.branches.0.0"
    hr.unit(hr.unit(torch.empty(1, 48, 135, 240, device="meta"), f"{p}.conv1", f"{p}.bn1"), f"{p}.conv2", f"{p}.bn2")
    assert ops.flops == 2 * 135 * 240 * 2 * 48 * 48 * 9
    # the published totals at 640 (ultralytics: 165.2 and 78.9 GFLOPs with 80 classes)
    m = json.load(open(os.path.join(ROOT, "benchmark", "configs", "yolov8m-640_hrnet-w48.json")))
    assert abs(flops.detector(cfg["detector"], (640, 640)) / 165.2e9 - 1) < 0.01
    assert abs(flops.detector(m["detector"], (640, 640)) / 78.9e9 - 1) < 0.01


def test_open_loop_keeps_its_schedule_and_reports_its_own_lateness():
    now = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        now[0] += s + 0.001  # the sleep overshoots by a millisecond

    loop = OpenLoop(8, 4.0, 0.0, clock=lambda: now[0], sleep=sleep)
    got = []
    for i in loop:
        got.append(i)
        if i == 2:
            now[0] += 1.0  # the consumer stalls: the next ones are already due
    assert got == list(range(8))
    assert loop.due == [i / 4 for i in range(8)]
    assert loop.late == pytest.approx(0.001)
    # after the stall nothing waits until the schedule is caught up
    assert all(h >= d for h, d in zip(loop.handed, loop.due))
    assert loop.handed[3] == pytest.approx(1.501)


def test_the_window_counts_a_stall_that_one_repetition_would_hide():
    due = [i * 0.25 for i in range(100)]
    finish = [d + 0.1 for d in due]
    for i in range(40, 52):  # a 2 s stall: these finish late
        finish[i] = due[51] + 2.0
    lat = latencies(due, finish, t_close=25.0)
    assert np.percentile(lat, 90) > 1.0
    # a median of repetitions (four of 25 segments each) sees one slow repetition only
    reps = [np.percentile(lat[k : k + 25], 50) for k in range(0, 100, 25)]
    assert np.median(reps) < 0.2
    # a request with no result by the window's end counts at its age then
    assert latencies([0.0, 1.0], [0.5], t_close=3.0) == [0.5, 2.0]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.judge, benchmark.work.flops, benchmark.work.lk_flow; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    mods = set(eval(out))
    assert not mods & {"eagle_tpu_torch", "eagle_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_and_no_jax_package():
    code = ("import sys; from benchmark.tests import tiny; from benchmark import run; "
            "tiny.run_and_judge('l960.match1080', 7, 1.0); print(run.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_injection_on_both_upload_paths(cell):
    result, checks = tiny.run_and_judge(cell, 2**31 + 11, 2.0)
    assert result.attempted > 0 and result.frames
    # the judge found every sampled keypoint call's frames and its gaps are bf16's
    assert checks["detector_gap"]["value"] < 0.5 and checks["keypoint_gap"]["value"] < 0.5
    assert checks["track_miss_share"]["value"] < 0.05
    # every true object of every frame handed in is found, in the coordinates
    # and (the live cell) in the Processor's records, and no segment failed
    assert checks["object_miss_share"]["value"] < 0.05 and result.failed == 0
    assert len(result.frames) == result.attempted * (1 if result.segments is None else len(result.segments[0]["rows"]))
    if result.segments is not None:
        assert checks["table_miss_share"]["value"] < 0.05 and checks["team_error_share"]["value"] < 0.1


def test_the_benchmarks_own_device_work_belongs_to_no_program_stage():
    from benchmark.trace import BENCHMARK, OWN, STRETCH, Stretch

    def host(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "args": {"correlation": corr}}

    events = [host(STRETCH, 0, 1000), host("stage:detector", 10, 200), host(OWN, 20, 10),
              launch(25, 1), kernel(100, 50, 1),  # the fingerprint, inside the detector's range
              launch(40, 2), kernel(150, 400, 2),  # the detector's own kernel
              host("stage:temporal", 300, 100), launch(310, 3), kernel(600, 100, 3)]
    st = Stretch(events, 10)
    assert [o["stage"] for o in st.ops] == [BENCHMARK, "detector", "temporal"]
    # the detector's span starts at its own first kernel, not the fingerprint's
    assert st.stage_span("detector") == (0.0004, 0.0004)
    assert st.busy_s(BENCHMARK) == 0.00005
