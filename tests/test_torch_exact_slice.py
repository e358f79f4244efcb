"""PyTorch port, the slice as a whole with ``TrackerConfig(assignment=
"exact")``: ``get_coordinates`` on an oracle clip against the JAX package,
the tracker's three stages a frame solved by the JV solver (its plain
version here, on the CPU).

Tolerances: ``tests/test_torch_coordinate_model.py``'s (track ids,
keypoints and classes equal, boundaries within 5 mm, boxes and pitch
positions within 1 px or 1 m)."""

import dataclasses

import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .test_torch_coordinate_model import assert_coords_match

torch.set_num_threads(2)


def test_exact_slice_matches_jax():
    """``get_coordinates`` with the exact solver on a 12-frame 640x360
    oracle clip, 24 track slots and 32 detection slots (n = 56)."""
    scene = make_scene(num_frames=12, width=640, height=360, num_players=6, fps=12, seed=3)

    def cfg(base):
        return base.replace(tracker=dataclasses.replace(base.tracker, assignment="exact", max_tracks=24))

    kw = dict(num_homography=1, num_keypoint_detection=3)
    want = JModel(
        config=cfg(JCFG), keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene, max_det=32),
        verbose_init=False,
    ).get_coordinates(scene.frames, scene.fps, verbose=False, **kw)
    got = TModel(
        config=cfg(TCFG), keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene, max_det=32),
        device="cpu",
    ).get_coordinates(scene.frames, scene.fps, **kw)
    assert assert_coords_match(got, want, boundary_atol=5e-3) > 50
    assert all(len(fr["Coordinates"].get("Player", {})) == 6 for fr in got.values())
