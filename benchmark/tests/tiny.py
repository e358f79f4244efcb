"""A cell's run at a size the CPU can hold: the same drivers, injection and
judge, on smaller frames and networks of the same architecture."""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import time
import types

import torch

from benchmark import common

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


#: (cell, config, traffic, detector size, frames W x H); the match cell keeps
#: the working-canvas path (a frame twice its 4:2:0 canvas), the live cell the
#: raw path (a letterbox smaller than the keypoint input)
CELLS = {
    "l960.match1080": ("yolov8l-960_hrnet-w48", "match1080", 320, (640, 384)),
    "m640.live1080": ("yolov8m-640_hrnet-w48", "live1080", 128, (640, 384)),
}
KEYPOINT_HW = (96, 160)
THREADS = 2
#: test-only cells with the tracker's appearance network: {cell: (the cell
#: whose configuration, traffic and limits it extends, the appearance
#: network)}; OSNet-x0.25, Eagle's shipped ReID, on ``REID_SLOTS`` slots
#: and 16-frame blocks, so that a run stays short on the CPU
REID_CELLS = {"l960.reid": ("l960.match1080", {"family": "osnet", "stage_widths": [16, 64, 96, 128],
                                               "feature_dim": 512, "input_hw": [256, 128]})}
REID_SLOTS = 3
#: ``reid_gap``'s limit at this size, between what 5 seeds read on the
#: CPU: sound runs 0.135-0.218, the float8 control 0.753-1.073, the crops
#: shifted a slot 1.285-1.399
REID_GAP_LIMIT = 0.5


def driver_of(cell: str) -> str:
    return load("traffic", CELLS[cell][1])["driver"]


def tiny(cell: str, seed: int, seconds: float, device="cpu"):
    """(Run, driver module) of ``cell`` at the small size."""
    from benchmark.drivers import live, stream

    if torch.device(device).type == "cpu":
        # a few threads a run: runs side by side (pytest -n) otherwise
        # oversubscribe the cores and the serving threads crawl
        torch.set_num_threads(THREADS)
    base, reid = REID_CELLS.get(cell, (cell, None))
    conf, traffic, size, (w, h) = CELLS[base]
    cfg = copy.deepcopy(load("configs", conf))
    cfg["detector"].update(depth_multiple=0.33, width_multiple=0.25, max_channels=1024)
    cfg["program"]["detector"] = {"variant": "medium", "image_size": size}
    cfg["program"]["keypoint"] = {"input_hw": KEYPOINT_HW}
    cfg["keypoints"]["input_hw"] = list(KEYPOINT_HW)
    if reid is not None:
        cfg["reid"] = reid
        cfg["program"]["tracker"] = {"use_appearance": True, "embedder": "osnet", "reid_slots": REID_SLOTS}
    tr = dict(load("traffic", traffic), width=w, height=h, players=8)
    if reid is not None:
        tr.update(shot_frames=16, segment_frames=16, warmup_blocks=1)
    elif tr["driver"] == "stream":
        tr.update(shot_frames=48, segment_frames=48, warmup_blocks=1)
    else:
        tr.update(matches=2, shot_frames=10, segment_frames=5, warmup_rounds=1)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    r = common.Run(args, {"name": base, "chips": 1}, cfg, tr, torch.device(device), time.monotonic())
    if reid is not None:
        r.limits = dict(r.limits, reid_gap=REID_GAP_LIMIT)
        # 16-frame chunks, so that the stream's blocks are 16 frames
        program_config = r.program_config
        r.program_config = lambda: dataclasses.replace(program_config(), chunk_frames=16)
    return r, (stream if tr["driver"] == "stream" else live)


def run_and_judge(cell: str, seed: int, seconds: float, device="cpu"):
    """(Result, checks) of one tiny run."""
    r, driver = tiny(cell, seed, seconds, device)
    result = driver.run(r)
    r.free_program()
    gc.collect()
    return result, r.judge(result)


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
