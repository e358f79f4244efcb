"""Faults planted in the program, each breaking one guarantee a cell's run
must keep, for the judge to catch::

    python3 -m benchmark.faults --workload <cell> --seeds 1,2,3 [--seconds 5]

runs the cell once a seed and fault with the fault planted and prints the
judge's readings, one JSON line each: the upper readings that a number the
float8 control cannot move (the tracker's) is held against.  The
benchmark's own runs never run this; ``benchmark/tests/test_faults.py``
plants the same faults at a small size on the CPU.

- ``state_unchanged``: the temporal step returns the state it was given;
- ``half_batch``: the detector computes half of its batch and leaves the
  rest at zero (consecutive frames are near alike, so a repeated half
  would pass unseen);
- ``answer_altered``: each object's pitch position moved 2 m where the
  entry assembles it;
- ``boxes_altered``: each tracked player's box moved 40 px where the
  entry assembles it;
- ``heatmaps_altered``: the keypoint network's heatmaps mirrored where it
  produces them;
- ``objects_dropped``: every second tracked player of each frame left out
  where the entry assembles it;
- ``frames_dropped``: every second frame left out of what the entry
  assembles (the stream only: the Processor refuses a clip whose
  coordinates lack frames);
- ``processor_half``: the Processor builds its table from the first half
  of a segment's frames only;
- ``teams_swapped``: every second player id of the Processor's
  ``team_mapping`` put on the other team;
- ``crops_shifted`` (configurations with an appearance network): each
  slot's ReID crop taken from the next slot's box, where the program
  crops.

The cells run on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import time
import types

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def state_unchanged():
    from eagle_tpu_torch.pipeline import step_graph, temporal

    def make(real):
        return lambda carry, *a, **kw: (carry, real(carry, *a, **kw)[1])

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(temporal, "temporal_step", make))
    # the captured chunks run this step on the card
    stack.enter_context(_patched(step_graph.temporal, "temporal_step_static", make))
    return stack


def half_batch():
    from eagle_tpu_torch.models.yolov8 import YOLOv8

    def make(real):
        def forward(self, x):
            half = max(1, x.shape[0] // 2)
            boxes, scores = real(self, x[:half])
            rest = x.shape[0] - half
            return (torch.cat([boxes, boxes.new_zeros(rest, *boxes.shape[1:])]),
                    torch.cat([scores, scores.new_zeros(rest, *scores.shape[1:])]))
        return forward

    return _patched(YOLOv8, "forward", make)


def _altered_objects(alter):
    """``alter(obj)`` applied to every object the entry assembles."""
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    def make(real):
        def assemble(self, *a, **kw):
            res = real(self, *a, **kw)
            for fr in res.values():
                for objs in fr["Coordinates"].values():
                    for obj in objs.values():
                        alter(obj)
            return res
        return assemble

    return _patched(CoordinateModel, "_assemble", make)


def answer_altered():
    def alter(obj):
        xy = obj.get("Transformed_Coordinates")
        if xy is not None:
            obj["Transformed_Coordinates"] = [xy[0] + 2, xy[1]]

    return _altered_objects(alter)


def boxes_altered():
    def alter(obj):
        x1, y1, x2, y2 = obj["BBox"]
        obj["BBox"] = [x1 + 40, y1, x2 + 40, y2]

    return _altered_objects(alter)


def heatmaps_altered():
    from eagle_tpu_torch.models.hrnet import HRNet

    return _patched(HRNet, "forward", lambda real: (lambda self, x: real(self, x).flip(-1)))


def objects_dropped():
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    def make(real):
        def assemble(self, *a, **kw):
            res = real(self, *a, **kw)
            for fr in res.values():
                players = fr["Coordinates"].get("Player", {})
                for oid in sorted(players)[1::2]:
                    del players[oid]
            return res
        return assemble

    return _patched(CoordinateModel, "_assemble", make)


def frames_dropped():
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    def make(real):
        def assemble(self, *a, **kw):
            res = real(self, *a, **kw)
            return {g: fr for k, (g, fr) in enumerate(res.items()) if k % 2 == 0}
        return assemble

    return _patched(CoordinateModel, "_assemble", make)


def processor_half():
    from eagle_tpu_torch.pipeline.processor import Processor

    def make(real):
        def process_data(self, *a, **kw):
            keys = list(self.coords)
            self.coords = {g: self.coords[g] for g in keys[: (len(keys) + 1) // 2]}
            return real(self, *a, **kw)
        return process_data

    return _patched(Processor, "process_data", make)


def teams_swapped():
    from eagle_tpu_torch.pipeline.processor import Processor

    def make(real):
        def finish(self, *a, **kw):
            mapping = real(self, *a, **kw)
            for pid in sorted(mapping)[1::2]:
                mapping[pid] = 1 - mapping[pid]
            return mapping
        return finish

    return _patched(Processor, "_finish_team_mapping", make)


def crops_shifted():
    from eagle_tpu_torch.pipeline import coordinate_model

    def make(real):
        return lambda model, frames, boxes: real(model, frames, boxes.roll(-1, dims=1))

    return _patched(coordinate_model, "embed_boxes", make)


#: fault -> the number it must break
FAULTS = {"state_unchanged": "pitch_gap_mean_m", "half_batch": "detector_gap", "answer_altered": "pitch_gap_mean_m",
          "boxes_altered": "track_miss_share", "heatmaps_altered": "keypoint_gap",
          "objects_dropped": "object_miss_share", "frames_dropped": "object_miss_share",
          "processor_half": "table_miss_share", "teams_swapped": "team_error_share", "crops_shifted": "reid_gap"}
#: faults that only some drivers can have, by driver
ONLY = {"frames_dropped": ("stream",), "processor_half": ("live",), "teams_swapped": ("live",)}
#: faults that only a configuration with an appearance network can have
REID_ONLY = ("crops_shifted",)


def applies(fault: str, driver: str, config: dict) -> bool:
    return driver in ONLY.get(fault, (driver,)) and ("reid" in config or fault not in REID_ONLY)


def main(argv=None) -> int:
    from benchmark import common, run as bench_run

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.faults", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for k, v in bench_run.CACHES.items():
        os.environ[k] = v
    _, cell, config, traffic = bench_run.spec_of(args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    for fault in [f for f in args.faults.split(",") if applies(f, traffic["driver"], config)]:
        for seed in [int(s) for s in args.seeds.split(",")]:
            ns = types.SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
            r = common.Run(ns, cell, config, traffic, torch.device("cuda", 0), time.monotonic())
            with globals()[fault]():
                result = driver.run(r)
            r.free_program()
            gc.collect()
            torch.cuda.empty_cache()
            checks = r.judge(result)
            print(json.dumps({"fault": fault, "seed": seed, "readings": {k: c["value"] for k, c in checks.items()},
                              "correct": all(c["value"] <= c["limit"] for c in checks.values())}), flush=True)
            del r, result
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
