"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set from,
on the card at the cell's own size::

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--seconds 5]

Each seed is one run of the cell as ``benchmark.run`` makes it (its driver,
a short window at the cell's own load), judged as a run is judged: the
program's readings.  For a seed of ``--control-seeds`` the same run's
samples are judged once more with the reference computed in float8 e4m3 in
the program's place (the precision below the configurations' bfloat16):
the control's readings of the two network gaps, which the limits must lie
below, and of the pitch gap with the projection computed in bfloat16 (the
precision below the float32 of the program's geometry).  One JSON line a seed on standard output.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import common, run as bench_run, weights  # noqa: E402
from benchmark.reference import judge  # noqa: E402


#: every how many frames the bfloat16 geometry control reads (it projects
#: each object with scalar tensor arithmetic)
CONTROL_STRIDE = 10


def control_gaps(r: common.Run, result: common.Result) -> dict:
    """The two network gaps of the float8 reference in the program's place,
    on the run's own samples, and the pitch gap of the reference's
    projection computed in bfloat16 on the run's own objects."""
    det_samples, kp_samples = r.inj.samples()
    hw = (r.traffic["height"], r.traffic["width"])
    det, kp = weights.as_loaded(r.det_sd, r.device), weights.as_loaded(r.kp_sd, r.device)
    ref = judge.Networks(r.config, det, kp, hw, r.device)
    low = judge.Networks(r.config, det, kp, hw, r.device, "fp8")
    frames_of = lambda fr: np.stack([r.scenes[tb].frames[i] for tb, i in fr])  # noqa: E731
    d = max(judge.detector_gap(ref, *low.detect(frames_of(s["frames"])), frames_of(s["frames"])) for s in det_samples)
    k = max(judge.keypoint_gap(ref, low.heatmaps(frames_of(s["frames"])), frames_of(s["frames"])) for s in kp_samples)
    frames = [(fr, r.H_ref) for fr, _, _ in result.frames[:: CONTROL_STRIDE] if fr is not None]
    return {"detector_gap": d, "keypoint_gap": k, "pitch_gap_mean_m": judge.pitch_gaps_m(frames, control=True)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for k, v in bench_run.CACHES.items():
        os.environ[k] = v
    bench, cell, config, traffic = bench_run.spec_of(args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.monotonic()
        ns = types.SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
        r = common.Run(ns, cell, config, traffic, torch.device("cuda", 0), t0)
        result = driver.run(r)
        r.free_program()
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "program": {k: c["value"] for k, c in r.judge(result).items()}, "e2e": result.e2e}
        if seed in controls:
            line["control"] = control_gaps(r, result)
        line["seconds"] = time.monotonic() - t0
        print(json.dumps(line), flush=True)
        del r, result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
