"""End-to-end throughput bench of the port on the card (the counterpart of
the JAX package's ``bench.py``)::

    python -m eagle_tpu_torch.bench [--frames 96] [--reps 5] [--budget-s 900] [--seed 0]

It drives the system's four paths at full width under ``DEFAULT_CONFIG``
(YOLOv8-l ``large_hd`` at 960, HRNet-W48 at 540x960, bf16, seeded weights)
on the synthetic 1280x720 broadcast clip of
:func:`eagle_tpu_torch.utils.synthetic.make_scene` (10 players, 24 fps, a
still camera):

- ``end_to_end_720p_frames_per_sec``: ``get_coordinates`` on the clip;
- ``multi_clip_fps``: :class:`MultiClipRunner` on its two halves;
- ``serving_fps``: :func:`serve_clips` over the clip twice (perception and
  the ``Processor``, overlapped), frames over the wall;
- ``with_processing_fps``: the first path's coordinates through the
  ``Processor`` (``process_data`` and ``format_data``), frames over the sum.

Seeded weights see no pitch and no players, which would drive the tracker
and the ``Processor`` into a degenerate path.  So every forward still runs
on the card and only the values it returns are replaced by the scene's
truth (:class:`OracleInjection`).  The four paths run in turns inside each
rep; each metric is the median over the reps, with ``<name>_spread`` = [min,
max] beside it.

Output: one JSON line on stdout, emitted again after every rep, on
SIGTERM and at exit; diagnostics go to stderr with a ``# `` prefix.  A
wall budget cuts the rep count, not the output.  The gates -- at least 8
tracked players a frame on every path, each served clip equal to its
sequential run, and on the card the flow, auction and NMS kernels launched
on every path and the exact solver's never -- make ``status``
``"invalid: ..."`` and the exit code 1 when one fails.  The bench runs on
the card; with ``--device cpu`` (and no number under a device metric's
name) where it is asked to, and with no card and no ``--device cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from eagle_tpu_torch.ops import launch_counts as counts
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel, StageTimer, resolve_device
from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner
from eagle_tpu_torch.pipeline.processor import Processor
from eagle_tpu_torch.pipeline.serve import serve_clips
from eagle_tpu_torch.utils.oracles import oracle_detections_at, oracle_keypoint_fn
from eagle_tpu_torch.utils.profiling import profile_stages
from eagle_tpu_torch.utils.synthetic import make_scene

#: the JAX bench's scene (``bench.py:174``); ``pan_speed`` stays 0: the
#: keypoint oracle is a still camera's
WIDTH, HEIGHT, PLAYERS, FPS = 1280, 720, 10, 24
#: the cadences of the JAX bench's runs: a homography a second, keypoints
#: three times a second
CADENCE = dict(num_homography=1, num_keypoint_detection=3)
#: the production-load gate: tracked players a frame, on every path
MIN_PLAYERS = 8
#: the end-to-end metrics, in the order the paths run in a rep
METRICS = ("end_to_end_720p_frames_per_sec", "multi_clip_fps", "serving_fps", "with_processing_fps")
#: the paths whose launches are counted ("with_processing": the first
#: path's run and its Processor)
PATHS = ("end_to_end", "with_processing", "multi_clip", "serving")
#: the headline's keys once the bench has run (a device metric is None
#: on the CPU, and an untimed run's when the budget left it out)
KEYS = (
    "metric", "value", "unit", "status", "frames", "device", "reps", *METRICS, *(f"{m}_spread" for m in METRICS),
    "players_per_frame", "players_pitch_error_m_median", "prescale_ms_per_frame", "dispatch_ms", "rtt_ms",
    "peak_device_memory_GiB", "launches", "temporal_ms_per_frame", "temporal_blocking_calls_per_frame",
    "temporal_waiting_calls_per_frame",
    "temporal_device_idle_share", "detector_device_idle_share", "traced_kernels", "traced_run_launches",
)
#: the kernels the bench's path launches, and the exact solver's, which it
#: must not (the default tracker runs the auction)
LAUNCHED, NOT_LAUNCHED = ("lk_flow", "auction", "nms", "ransac_keys", "eigh9"), ("lap_jv",)
#: the hand-written kernels' device kernels in a trace, by name pattern: one
#: a launch (an NMS launch runs its overlap kernel, then the fixed point)
TRACED = {"lk_flow": r"lk_flow_fused", "auction": r"auction_(onchip|global)", "nms": r"nms_suppress_fixed_point",
          "ransac_keys": r"ransac_keys", "eigh9": r"eigh9_smallest", "lap_jv": r"\blap_jv"}
#: device kernels of a convolution (cuDNN's implicit-GEMM, Winograd and
#: direct kernels, CUTLASS's fprop), by name
CONV_KERNEL = re.compile(r"conv|fprop|winograd|implicit", re.IGNORECASE)


def diag(obj) -> None:
    """A diagnostic on stderr, each line prefixed ``# ``, so that none can
    parse as the headline."""
    text = obj if isinstance(obj, str) else json.dumps(obj)
    for line in text.splitlines() or [""]:
        print(f"# {line}", file=sys.stderr, flush=True)


class OracleInjection:
    """The scene's truth behind the model's real forwards, on this model
    instance: its ``run_detector`` (YOLOv8, the NMS kernel and the box map)
    and ``run_keypoints`` (HRNet and ``decode_heatmaps``) are wrapped.  Each
    wrapper calls the real method and returns ``oracle + 0.0 * real`` on the
    device: the result cannot exist before the real forward has finished,
    so the wait for it stays where the model's own result would have it.

    The detector's rows are frame ``cursor`` onward, the cursor advanced by
    the batch's real size and taken modulo the clip's length (a flattened
    multi-clip run or a served pair of the clip runs the frames in order);
    :meth:`reset` before every run.  The keypoint rows are the still
    camera's 57 landmarks, tiled to the batch.  The oracle tables go to the
    device once, on first use (the warm-up).  With ``check_finite`` the real
    rows are checked finite (``0.0 * nan`` is nan): a host sync, so only
    in the warm-up."""

    def __init__(self, model: CoordinateModel, scene):
        if model._custom_det or model._custom_kp:
            raise ValueError("the oracle injection wraps the built-in models; this model has custom callables")
        if model.config.tracker.use_appearance:
            raise ValueError("the oracle injection replaces detector rows without appearance embeddings")
        self.n = len(scene.frames)
        d = model.config.detector.max_detections
        rows = []
        for t in range(self.n):
            b, s, c, v = oracle_detections_at(scene, t, d)
            rows.append(np.concatenate([b, s[:, None], c[:, None], v[:, None]], -1, dtype=np.float32))
        #: (N, D, 7) [x1, y1, x2, y2, conf, cls, valid] a frame
        self.det_rows = np.stack(rows)
        kp, valid = oracle_keypoint_fn(scene)(scene.frames[:1])
        #: (57, 4) [x, y, score, valid]
        self.kp_row = np.concatenate([kp[0], valid[0].astype(np.float32)[:, None]], -1)
        self.cursor = 0
        self.check_finite = False
        self._tables: dict = {}
        self._real_det, self._real_kp = model.run_detector, model.run_keypoints
        model.run_detector, model.run_keypoints = self.run_detector, self.run_keypoints

    def reset(self) -> None:
        self.cursor = 0

    def _table(self, key, make, device) -> torch.Tensor:
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        return self._tables[key]

    def _mix(self, oracle: torch.Tensor, real: torch.Tensor, what: str) -> torch.Tensor:
        if self.check_finite and not bool(torch.isfinite(real).all()):
            raise RuntimeError(f"the real {what} rows hold non-finite values: 0.0 * nan would leak into the oracle's")
        return oracle + 0.0 * real

    def run_detector(self, x, geom, img_hw, timer: StageTimer | None = None) -> torch.Tensor:
        real = self._real_det(x, geom, img_hw, timer)
        b = int(x.shape[0])
        start = self.cursor % self.n
        self.cursor += b
        oracle = self._table(("det", start, b), lambda: self.det_rows[(start + np.arange(b)) % self.n], real.device)
        return self._mix(oracle, real[..., :7], "detector")

    def run_keypoints(self, x, geom, img_hw) -> torch.Tensor:
        real = self._real_kp(x, geom, img_hw)
        b = int(x.shape[0])
        oracle = self._table(("kp", b), lambda: np.broadcast_to(self.kp_row, (b, *self.kp_row.shape)), real.device)
        return self._mix(oracle, real[..., :4], "keypoint")


def launch_counts() -> dict:
    """The kernels' launch counts (each wrapper's count of its launches,
    :mod:`eagle_tpu_torch.ops.launch_counts`)."""
    return {k: counts.get(k) for k in LAUNCHED + NOT_LAUNCHED}


def device_info(device: torch.device):
    """"cpu", or the card: its name, its power limit as ``nvidia-smi``
    reads it, and the device count."""
    if device.type != "cuda":
        return "cpu"
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[device.index or 0]
    return {
        "kind": torch.cuda.get_device_name(device),
        "power_limit": line.rsplit(",", 1)[1].strip(),
        "count": torch.cuda.device_count(),
        "nvidia_smi": line,
    }


def launch_latency_ms(device: torch.device) -> tuple[float, float]:
    """(dispatch_ms, rtt_ms) on the card, by the JAX bench's method: the
    slope between chains of 10 and 40 tiny launches each ending in a
    synchronize, and one launch plus ``torch.cuda.synchronize()``."""
    x = torch.ones((8, 8), device=device)

    def chain(k: int) -> float:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        y = x
        for _ in range(k):
            y = y + 1.0
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    chain(5)
    return max((chain(40) - chain(10)) * 1e3 / 30, 0.0), min(chain(1), chain(1)) * 1e3


def players_per_frame(coords: dict) -> float:
    return float(np.mean([len(fr["Coordinates"].get("Player", {})) for fr in coords.values()]))


def pitch_error_m(coords: dict, scene) -> float | None:
    """Median distance (metres) from each tracked player's or goalkeeper's
    pitch position to the nearest true player of its frame."""
    d = []
    for t, fr in coords.items():
        truth = scene.player_world[t]
        for cls in ("Player", "Goalkeeper"):
            for obj in fr["Coordinates"].get(cls, {}).values():
                xy = obj.get("Transformed_Coordinates")
                if xy is not None:
                    d.append(float(np.linalg.norm(truth - np.asarray(xy, np.float64), axis=1).min()))
    return float(np.median(d)) if d else None


def run(model: CoordinateModel, scene, *, reps: int = 5, budget_s: float = 900.0, emit=None) -> dict:
    """The bench on ``model`` (built-in models; wrapped here by
    :class:`OracleInjection`) and ``scene`` (an even number of frames):
    a warm-up run of each path, then ``reps`` timed reps of the four paths
    in turns (fewer when ``budget_s`` seconds run short), then one untimed
    run under a synchronising :class:`StageTimer` and, on the card, one
    traced run.  ``emit(headline)`` is called with the headline dict at the
    start and after every step that changes it; returns the last one."""
    emit = emit or (lambda h: print(json.dumps(h), flush=True))
    t_start = time.monotonic()

    def remaining() -> float:
        return budget_s - (time.monotonic() - t_start)

    if reps < 1:
        raise ValueError(f"the bench needs at least one rep, not {reps}")
    frames, fps = scene.frames, scene.fps
    n = len(frames)
    if n % 2:
        raise ValueError(f"the multi-clip path splits the clip in two halves: give an even frame count, not {n}")
    hw = (int(frames.shape[1]), int(frames.shape[2]))
    if not model._geometry(hw).enabled:
        raise ValueError(f"{hw[1]}x{hw[0]} frames must take the working-resolution path of the built-in models")
    dev = model.device
    cuda = dev.type == "cuda"
    inj = OracleInjection(model, scene)
    runner = MultiClipRunner(model)
    clips = [frames[: n // 2], frames[n // 2 :]]
    head = {
        "metric": METRICS[0],
        "value": None,
        "unit": "frames/sec, median over the reps",
        "status": "starting",
        "frames": n,
        "device": device_info(dev),
    }
    emit(head)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(call):
        """(what ``call()`` returns, its wall seconds, the launches it made)"""
        inj.reset()
        sync()
        c0 = launch_counts()
        t0 = time.perf_counter()
        out = call()
        dt = time.perf_counter() - t0
        return out, dt, {k: v - c0[k] for k, v in launch_counts().items()}

    def perceive(timer=None):
        return model.get_coordinates(frames, fps, profile=timer, **CADENCE)

    def multi():
        return runner.run(clips, fps, **CADENCE)

    def serve():
        return list(serve_clips(model, [frames, frames], fps, **CADENCE))

    def process(coords):
        proc = Processor(coords, frames, fps, device=dev)
        table, mapping = proc.process_data()
        return mapping, proc.format_data(table)

    diag(f"TF32 (PyTorch's defaults, as the CLI runs): cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
         f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    inj.check_finite = True
    for call in (lambda: process(perceive()), multi, serve):
        timed(call)
    inj.check_finite = False
    diag(f"warm-up: one run of each path in {time.perf_counter() - t0:.3f} s")

    samples = {m: [] for m in METRICS}
    prescale, latency, peak = [], [], 0.0
    failures: list[str] = []
    rep_cost = 0.0
    for rep in range(reps):
        rep_t0 = time.monotonic()
        timer = StageTimer(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        coords, t_coords, l_coords = timed(lambda: perceive(timer))
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(dev) / 2**30)
        (mapping, records), t_proc, l_proc = timed(lambda: process(coords))
        results, t_multi, l_multi = timed(multi)
        served, t_serve, l_serve = timed(serve)
        l_with = {k: l_coords[k] + l_proc[k] for k in l_coords}
        launches = dict(zip(PATHS, (l_coords, l_with, l_multi, l_serve)))
        for m, v in zip(METRICS, (n / t_coords, n / t_multi, 2 * n / t_serve, n / (t_coords + t_proc))):
            samples[m].append(v)
        prescale.append(timer.seconds["prescale"] * 1e3 / n)

        # the gates, outside the timed windows
        per_path = {
            "end_to_end": players_per_frame(coords),
            "multi_clip": min(players_per_frame(r) for r in results),
            "serving": min(players_per_frame(r.coordinates) for r in served),
        }
        low = {p: round(v, 3) for p, v in per_path.items() if v < MIN_PLAYERS}
        if low:
            failures.append(f"rep {rep + 1}: players a frame below {MIN_PLAYERS} on {low}")
        if [len(r) for r in results] != [len(c) for c in clips] or len(served) != 2:
            failures.append(f"rep {rep + 1}: multi-clip results {[len(r) for r in results]}, {len(served)} served clips")
        for k, r in enumerate(served):
            if r.coordinates != coords or json.dumps(r.formatted) != json.dumps(records) or r.team_mapping != mapping:
                failures.append(f"rep {rep + 1}: served clip {k} differs from its sequential run")
        if not records or not mapping:
            failures.append(f"rep {rep + 1}: the Processor gave {len(records)} records, {len(mapping)} teams")
        if cuda:
            for p, c in launches.items():
                if any(c[k] == 0 for k in LAUNCHED) or any(c[k] != 0 for k in NOT_LAUNCHED):
                    failures.append(f"rep {rep + 1}: {p} launched {c}")
            latency.append(launch_latency_ms(dev))
        diag({"rep": rep + 1, "stages_ms": json.loads(timer.report()), "players_per_frame": per_path})

        head.update({m: statistics.median(samples[m]) for m in METRICS})
        head.update({f"{m}_spread": [min(samples[m]), max(samples[m])] for m in METRICS})
        head.update({
            "value": head[METRICS[0]],
            "reps": rep + 1,
            "players_per_frame": per_path["end_to_end"],
            "prescale_ms_per_frame": statistics.median(prescale),
            "dispatch_ms": statistics.median(d for d, _ in latency) if latency else None,
            "rtt_ms": statistics.median(r for _, r in latency) if latency else None,
            "peak_device_memory_GiB": peak if cuda else None,
            "launches": launches,
            "status": "ok" if not failures else "invalid: " + "; ".join(failures),
        })
        emit(head)
        rep_cost = max(rep_cost, time.monotonic() - rep_t0)
        if rep + 1 < reps and remaining() < 1.5 * rep_cost + 30:
            diag(f"budget: {remaining():.0f} s left, a rep costs {rep_cost:.0f} s; stopping at {rep + 1} rep(s)")
            break

    head["players_pitch_error_m_median"] = pitch_error_m(coords, scene)
    diag(f"tracked players' pitch positions against the scene's truth: median "
         f"{head['players_pitch_error_m_median']} m (information, not a gate)")

    # the untimed window: the temporal step's ms a frame with every stage
    # ending in a synchronize, then (on the card) one traced run
    head.update({"temporal_ms_per_frame": None, "temporal_blocking_calls_per_frame": None,
                 "temporal_waiting_calls_per_frame": None,
                 "temporal_device_idle_share": None, "detector_device_idle_share": None, "traced_kernels": None,
                 "traced_run_launches": None})
    if remaining() > 2 * n / min(samples[METRICS[0]]) + 30:
        inj.reset()
        timer = StageTimer(dev, sync=True)
        perceive(timer)
        head["temporal_ms_per_frame"] = timer.seconds["temporal"] * 1e3 / n
        diag({"synchronised_stages": timer.summary()})
    else:
        diag(f"budget: {remaining():.0f} s left; no synchronised run")
    if cuda and remaining() > 4 * n / min(samples[METRICS[0]]) + 30:
        inj.reset()
        sync()
        c0 = launch_counts()
        prof = profile_stages(model, frames, fps, **CADENCE)
        launched = {k: v - c0[k] for k, v in launch_counts().items()}
        tmp, det = prof.stages["temporal"], prof.stages["detector"]
        every = {k: c for k, (c, _) in prof.kernels.items()}

        def count(pattern, kernels=every):
            """Device kernels traced whose name matches ``pattern``."""
            return sum(c for k, c in kernels.items() if re.search(pattern, k))

        head.update({
            "temporal_blocking_calls_per_frame": tmp["blocking_calls"] / n,
            "temporal_waiting_calls_per_frame": tmp["waiting_calls"] / n,
            "temporal_device_idle_share": tmp["device_idle_share"],
            "detector_device_idle_share": det["device_idle_share"],
            "traced_kernels": {
                "detector_convolutions": count(CONV_KERNEL, prof.stage_kernels["detector"]),
                "keypoint_convolutions": count(CONV_KERNEL, prof.stage_kernels["keypoints"]),
                **{k: count(pattern) for k, pattern in TRACED.items()},
            },
            "traced_run_launches": launched,
        })
        diag({"traced_stages": prof.stages})
        top = sorted(prof.kernels.items(), key=lambda kv: -kv[1][1])[:12]
        diag({"traced_top_device_ops": [[k[:100], c, ms] for k, (c, ms) in top]})
    elif cuda:
        diag(f"budget: {remaining():.0f} s left; no traced run")
    emit(head)
    return head


class Headline:
    """The last headline line: printed on every :meth:`emit`, and again on
    SIGTERM, SIGINT or SIGHUP (then exit 1) and at exit, so the last JSON
    line of the output is always the most complete headline measured."""

    def __init__(self):
        self.last: dict | None = None

    def emit(self, head: dict) -> None:
        self.last = dict(head)
        print(json.dumps(self.last), flush=True)

    def reemit(self, signum=None, frame=None) -> None:
        if self.last is not None:
            print(json.dumps(self.last), flush=True)
        if signum is not None:
            os._exit(1)

    def install(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            signal.signal(sig, self.reemit)
        atexit.register(self.reemit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m eagle_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=96, help="frames of the 1280x720 scene (even; default 96)")
    ap.add_argument("--reps", type=int, default=5, help="timed reps of the four paths (default 5)")
    ap.add_argument("--budget-s", type=float, default=900.0,
                    help="wall budget in seconds: fewer reps, then no untimed runs, when it runs short (default 900)")
    ap.add_argument("--seed", type=int, default=0, help="the scene's and the weights' seed (default 0)")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; by default the CUDA card, and with none the bench raises')
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    device = resolve_device(args.device)
    out = Headline()
    out.install()
    scene = make_scene(num_frames=args.frames, width=WIDTH, height=HEIGHT, num_players=PLAYERS, fps=FPS,
                       seed=args.seed)
    model = CoordinateModel(seed=args.seed, device=device)
    try:
        head = run(model, scene, reps=args.reps, budget_s=args.budget_s - (time.monotonic() - t0), emit=out.emit)
    except Exception as e:  # the run's boundary: report it in the headline, then fail
        traceback.print_exc()
        out.emit({**(out.last or {}), "status": f"invalid: {type(e).__name__}: {e}"})
        return 1
    return 0 if head["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
