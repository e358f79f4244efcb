"""What every cell's run shares: seeds, scenes, weights, the program under
test, the injection, and the judge that decides ``correct``.

A driver (``benchmark/drivers/<name>.py``) offers the traffic to the
program and returns a :class:`Result`; everything else is here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import weights
from benchmark.frozen import pitch
from benchmark.frozen.oracles import oracle_detections_at, oracle_keypoint_fn
from benchmark.frozen.synthetic import make_scene
from benchmark.inject import Injection
from benchmark.reference import hrnet, judge, preprocess, yolov8
from benchmark.work import flops, lk_flow

HERE = os.path.dirname(os.path.abspath(__file__))


def diag(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Result:
    """What a driver's window gives the run: the end-to-end metrics by
    name, the requests attempted and failed, the frames the judge reads
    ((frame dict, or None where the output lacks a frame handed in; shot;
    shot row) each), ``context`` for the per-layer metrics' readers, and
    for a driver that runs the Processor ``segments``: per segment {"shot",
    "rows": its shot rows, "frames": its frame dicts (None where missing),
    "records": its Processor records by frame (None where the table has no
    row), "mapping": its ``team_mapping``}."""

    e2e: dict
    attempted: int
    failed: int
    frames: list
    context: SimpleNamespace
    segments: list | None = None


class Run:
    def __init__(self, args, cell: dict, config: dict, traffic: dict, device: torch.device, t_start: float):
        self.args, self.cell, self.config, self.traffic = args, cell, config, traffic
        self.device, self.t_start = device, t_start
        self.seed, self.seconds, self.trace = int(args.seed), float(args.seconds), bool(args.trace)
        with open(os.path.join(HERE, "limits", f"{cell['name']}.json")) as f:
            self.limits = json.load(f)
        self.cadence = dict(config["cadence"])
        #: the run's scratch folder (``TMPDIR``): weights and traces, deleted after use
        self.tmp_dir = tempfile.gettempdir()
        self.scenes: list = []
        self.model = self.inj = None

    def sub_seed(self, *key: int) -> int:
        """A 63-bit seed for ``key`` under the run's seed (any integer)."""
        ss = np.random.SeedSequence([self.seed % (1 << 64), *key])
        return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))

    # -- traffic ---------------------------------------------------------

    def render(self, count: int) -> list:
        """``count`` seeded shots of the traffic's size (one a match)."""
        t = self.traffic
        self.scenes = [make_scene(num_frames=t["shot_frames"], width=t["width"], height=t["height"],
                                  num_players=t["players"], fps=t["fps"], seed=self.sub_seed(1, i) % (1 << 32))
                       for i in range(count)]
        return self.scenes

    # -- the program -------------------------------------------------------

    def program_config(self):
        from eagle_tpu_torch.config import DEFAULT_CONFIG

        groups = {k: dataclasses.replace(getattr(DEFAULT_CONFIG, k), **v) for k, v in self.config["program"].items()}
        return dataclasses.replace(DEFAULT_CONFIG, **groups)

    def build(self) -> None:
        """Weights from the seed in the published layouts (their BatchNorm
        statistics set on the first scene's first frame by the float32
        reference), saved as checkpoints, loaded by the program's own
        loaders; then the injection of the scenes' truth."""
        from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

        dev, cfg = self.device, self.config
        frame = self.scenes[0].frames[:1]
        hw = frame.shape[1:3]
        geom = preprocess.geometry(hw, cfg["program"]["detector"]["image_size"], cfg["keypoints"]["input_hw"])
        with judge.float32_exact():
            det = weights.draw(yolov8.layout(cfg["detector"]), self.sub_seed(2), dev)
            x = preprocess.detector_input(torch.from_numpy(frame).to(dev), cfg["program"]["detector"]["image_size"], geom)
            yolov8.calibrate(yolov8.YOLOv8(det, cfg["detector"]), x)
            kp = weights.draw(hrnet.layout(cfg["keypoints"]), self.sub_seed(3), dev)
            x = preprocess.keypoint_input(torch.from_numpy(frame).to(dev), cfg["keypoints"]["input_hw"], geom)
            yolov8.calibrate(hrnet.HRNet(kp, cfg["keypoints"]), x)
        self.det_sd, self.kp_sd = weights.for_saving(det, weights.dfl_projection()), weights.for_saving(kp)
        del det, kp, x
        # a folder of its own under TMPDIR (weights, not a cache: nothing
        # reads them again), so that runs side by side do not share it
        folder = tempfile.mkdtemp(prefix="eagle_benchmark_", dir=self.tmp_dir)
        paths = {"detector": os.path.join(folder, "detector.pt"), "keypoints": os.path.join(folder, "keypoints.pth")}
        torch.save(self.det_sd, paths["detector"])
        torch.save(self.kp_sd, paths["keypoints"])
        try:
            self.model = CoordinateModel(config=self.program_config(), detector_checkpoint=paths["detector"],
                                         keypoint_checkpoint=paths["keypoints"], seed=self.sub_seed(4) % (1 << 31),
                                         device=dev)
        finally:
            for p in paths.values():
                os.remove(p)
            os.rmdir(folder)
        d = self.model.config.detector.max_detections
        tables = []
        for scene in self.scenes:
            rows = []
            for t in range(len(scene.frames)):
                b, s, c, v = oracle_detections_at(scene, t, d)
                rows.append(np.concatenate([b, s[:, None], c[:, None], v[:, None]], -1, dtype=np.float32))
            tables.append(np.stack(rows))
        kp, valid = oracle_keypoint_fn(self.scenes[0])(self.scenes[0].frames[:1])
        kp_row = np.concatenate([kp[0], valid[0].astype(np.float32)[:, None]], -1)
        self.inj = Injection(self.model, tables, kp_row, self.traffic["judge_calls"], self.sub_seed(5) % (1 << 31))
        self.kp_pts = kp[0][valid[0], :2].astype(np.float64)
        #: the image -> pitch homography the injected keypoints determine
        self.H_ref = judge.fit_homography(self.kp_pts, pitch.WORLD_XY[valid[0]])

    def work(self) -> dict:
        """FLOPs a frame of each network at the cell's inputs, counted from
        the published layer lists."""
        cfg, t = self.config, self.traffic
        size = cfg["program"]["detector"]["image_size"]
        geom = preprocess.geometry((t["height"], t["width"]), size, cfg["keypoints"]["input_hw"])
        det_hw = (geom["canvas_h"], geom["canvas_w"]) if geom else (size, size)
        return {"detector_flops": flops.detector(cfg["detector"], det_hw),
                "keypoint_flops": flops.keypoints(cfg["keypoints"], cfg["keypoints"]["input_hw"]),
                "geometry": geom}

    def flow_least_s(self, geom) -> float:
        """The least time of one flow launch at the published peaks: the
        still camera's visible landmarks, in the frames the kernel reads
        (the working canvas when there is one)."""
        if geom is None:
            return lk_flow.least_seconds(self.kp_pts, (self.traffic["height"], self.traffic["width"]))
        pts = self.kp_pts * geom["gain"] + [geom["pad_x"], geom["pad_y"]]
        return lk_flow.least_seconds(pts, (geom["canvas_h"], geom["canvas_w"]))

    def free_program(self) -> None:
        if self.inj is not None:
            self.inj.close()
        self.model = None

    # -- the judge -------------------------------------------------------

    def judge(self, result: Result) -> dict:
        """The numbers compared, each with its limit (``benchmark/limits``)."""
        t0 = time.monotonic()
        det_samples, kp_samples = self.inj.samples()
        hw = (self.traffic["height"], self.traffic["width"])
        nets = judge.Networks(self.config, weights.as_loaded(self.det_sd, self.device),
                              weights.as_loaded(self.kp_sd, self.device), hw, self.device)
        frames_of = lambda fr: np.stack([self.scenes[tb].frames[r] for tb, r in fr])  # noqa: E731
        det_gap = max(judge.detector_gap(nets, *s["out"], frames_of(s["frames"])) for s in det_samples)
        kp_gap = max(judge.keypoint_gap(nets, s["out"], frames_of(s["frames"])) for s in kp_samples)
        printed = [(fr, tb, r) for fr, tb, r in result.frames if fr is not None]
        pitch_mean, pitch_max, n_obj = judge.pitch_gaps_m([(fr, self.H_ref) for fr, _, _ in printed])
        miss, n_players = judge.track_miss_share([(fr, self.scenes[tb].player_boxes[r]) for fr, tb, r in printed], hw)
        lost, n_true = judge.object_miss_share(
            [(fr, self.scenes[tb].player_boxes[r], self.scenes[tb].ball_image[r]) for fr, tb, r in result.frames], hw)
        values = {"detector_gap": det_gap, "keypoint_gap": kp_gap, "pitch_gap_mean_m": pitch_mean,
                  "track_miss_share": miss, "object_miss_share": lost}
        said = (f"{len(det_samples)} detector calls ({sum(len(s['frames']) for s in det_samples)} frames), "
                f"{len(kp_samples)} keypoint calls ({sum(len(s['frames']) for s in kp_samples)} frames), "
                f"{len(printed)} of {len(result.frames)} frames printed, {n_obj} objects ({pitch_max} m the largest "
                f"pitch gap), {n_players} tracked players, {n_true} true objects")
        if result.segments is not None:
            values["table_miss_share"], n_rec = judge.table_miss_share(
                [(s["records"], [self.truth_at(s["shot"], r) for r in s["rows"]]) for s in result.segments], hw)
            values["team_error_share"], n_ids = judge.team_error_share(
                [(s["frames"], self.scenes[s["shot"]].player_boxes[s["rows"]], self.scenes[s["shot"]].player_team,
                  s["mapping"]) for s in result.segments], hw)
            said += f", {len(result.segments)} segments' tables ({n_rec} true objects, {n_ids} tracked ids)"
        diag(f"judge: {said}, {time.monotonic() - t0:.3f} s")
        return {k: {"value": v, "limit": self.limits[k]} for k, v in values.items()}

    def truth_at(self, shot: int, row: int) -> tuple:
        """(true feet (P, 2), true pitch positions (P, 2), ball image (2,),
        ball pitch position (2,)) of one frame of a shot."""
        s = self.scenes[shot]
        return s.player_feet_image[row], s.player_world[row], s.ball_image[row], s.ball_world[row]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
