"""PyTorch port, structured logging: ``eagle_tpu_torch.utils.logging``
against ``eagle_tpu.utils.logging``, and the ``get_coordinates`` event
both packages emit at the end of a call (one JSON line at INFO,
``{"ts", "event", "frames", <stage>: total seconds, ...}``, the stages
largest first).

Tolerances: with ``ts`` removed, the event and the frame count are equal;
the stage totals are wall-clock seconds of each package's own stages
(the JAX package's ``upload``/``scan``, the port's ``prescale``/
``temporal``), so only their form is compared: non-negative floats of 4
decimals, in descending order."""

import json
import logging

import numpy as np
import pytest
import torch

from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils import logging as jlog
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.utils import logging as tlog

from .oracles import oracle_detector_fn, oracle_keypoint_fn

torch.set_num_threads(2)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def captured():
    """Each package's logger at INFO with a capturing handler:
    {"jax": handler, "torch": handler}."""
    out, saved = {}, []
    for name, mod in (("jax", jlog), ("torch", tlog)):
        logger = mod.get_logger()
        saved.append((logger, logger.level))
        logger.setLevel(logging.INFO)
        out[name] = _Lines()
        logger.addHandler(out[name])
    yield out
    for (logger, level), h in zip(saved, out.values()):
        logger.removeHandler(h)
        logger.setLevel(level)


def _without_ts(line: str) -> dict:
    rec = json.loads(line)
    assert isinstance(rec.pop("ts"), float)
    return rec


def test_log_event_writes_the_same_line(captured):
    jlog.log_event("probe", frames=3, detector=0.25)
    tlog.log_event("probe", frames=3, detector=0.25)
    (j,), (t,) = captured["jax"].lines, captured["torch"].lines
    assert _without_ts(j) == _without_ts(t) == {"event": "probe", "frames": 3, "detector": 0.25}
    assert tlog.get_logger().name == "eagle_tpu_torch" and not tlog.get_logger().propagate


def test_get_coordinates_event_matches_jax(captured):
    scene = make_scene(num_frames=6, width=480, height=270, num_players=4, fps=6, seed=5)
    kw = dict(num_homography=1, num_keypoint_detection=2)
    JModel(keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene),
           verbose_init=False).get_coordinates(scene.frames, scene.fps, verbose=False, **kw)
    TModel(keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene),
           device="cpu").get_coordinates(scene.frames, scene.fps, **kw)
    recs = {}
    for name, h in captured.items():
        events = [_without_ts(line) for line in h.lines if json.loads(line)["event"] == "get_coordinates"]
        assert len(events) == 1, name
        recs[name] = events[0]
    for rec in recs.values():
        stages = [v for k, v in rec.items() if k not in ("event", "frames")]
        assert stages and all(isinstance(v, float) and v >= 0 and v == round(v, 4) for v in stages)
        assert stages == sorted(stages, reverse=True)
    assert {k: recs["jax"][k] for k in ("event", "frames")} == {k: recs["torch"][k] for k in ("event", "frames")}
    assert recs["torch"]["frames"] == len(scene.frames)
    assert {"detector", "keypoints", "assembly"} <= set(recs["jax"]) & set(recs["torch"])
    assert np.isfinite(sum(v for k, v in recs["torch"].items() if k not in ("event", "frames")))
