"""The sweep that fixed the live cell's offered load, on the card::

    python3 -m benchmark.sweep --workload m640.live1080 --matches 2,3,4,6 [--seconds 20] [--seed 1]

One run of the cell's driver a match count, each with ``matches`` set to
it: the segments done by the window's end, the latency's median and 90th
percentile, the median of the window's first and last thirds (a growing
backlog shows as a rising latency) and the generator's lateness, one JSON
line each.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import time
import types

import numpy as np
import torch

from benchmark import common, run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="m640.live1080")
    ap.add_argument("--matches", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    for k, v in bench_run.CACHES.items():
        os.environ[k] = v
    _, cell, config, traffic = bench_run.spec_of(args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    for k in [int(x) for x in args.matches.split(",")]:
        ns = types.SimpleNamespace(seed=args.seed, seconds=args.seconds, trace=0)
        r = common.Run(ns, cell, config, dict(traffic, matches=k), torch.device("cuda", 0), time.monotonic())
        result = driver.run(r)
        ctx = result.context
        lat = np.asarray(ctx.latency)
        third = len(lat) // 3
        print(json.dumps({"matches": k, "offered_fps": k * traffic["segment_frames"], "due": len(lat),
                          "done_in_window": ctx.done, "p50_s": float(np.median(lat)),
                          "p90_s": float(np.percentile(lat, 90)), "first_third_p50_s": float(np.median(lat[:third])),
                          "last_third_p50_s": float(np.median(lat[-third:])), "generator_late_s": ctx.late,
                          "service_p50_s": float(np.median(ctx.service_s))}), flush=True)
        r.free_program()
        del r, result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
