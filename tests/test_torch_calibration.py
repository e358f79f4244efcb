"""PyTorch port, brightness-snap calibration: ``temporal.calibrate_keypoints``
against the JAX package's on the same numpy inputs, and
``get_coordinates(calibration=True)`` of both packages on the identity
geometry (oracle models) and on the working geometry (the built-in models
with bridged weights, where the snap runs on the letterboxed canvas).

Tolerances: calibrated keypoints are integers and bit-equal; the slices
are compared as in tests/test_torch_coordinate_model.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline import temporal as tt
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .test_torch_coordinate_model import _bridged_params, _reduced_cfg, _small_scene, assert_coords_match

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(48, 64), (540, 960)])
def test_calibrate_keypoints_matches_jax(hw):
    """Dim and bright frames, points inside, on the borders and outside the
    frame, valid and not: the same integer points."""
    h, w = hw
    rng = np.random.default_rng(h)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    frame[: h // 2] //= 2  # the top half dim: more points snap
    pts = np.concatenate([
        rng.uniform([-5, -5], [w + 5, h + 5], (50, 2)),
        [[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1], [2.9, 1.2], [w - 2.5, h - 3.7], [-0.5, 3], [w, h]],
    ]).astype(np.float32)
    valid = rng.random(len(pts)) < 0.8
    want = np.asarray(jt.calibrate_keypoints(jnp.asarray(frame), jnp.asarray(pts), jnp.asarray(valid)))
    got = tt.calibrate_keypoints(torch.from_numpy(frame), torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != np.trunc(pts)).any(), "some points must snap"


def _off_line_keypoints(scene, dx: float = 2.0):
    """The oracle keypoints moved ``dx`` px off the pitch lines, onto dim
    grass, so that calibration snaps them back toward the bright line."""
    inner = oracle_keypoint_fn(scene)

    def fn(batch):
        kp, valid = inner(batch)
        kp = kp.copy()
        kp[..., 0] += dx
        return kp, valid

    return fn


def test_oracle_slice_with_calibration_matches_jax():
    """Identity geometry: calibration snaps the model keypoints of every
    frame before the homography."""
    sc = make_scene(num_frames=12, width=640, height=360, num_players=4, fps=12, seed=7)
    kw = dict(num_homography=1, num_keypoint_detection=3)
    want = JModel(
        keypoint_fn=_off_line_keypoints(sc), detector_fn=oracle_detector_fn(sc), verbose_init=False
    ).get_coordinates(sc.frames, sc.fps, verbose=False, calibration=True, **kw)
    runs = {}
    for calibration in (True, False):
        runs[calibration] = TModel(
            keypoint_fn=_off_line_keypoints(sc), detector_fn=oracle_detector_fn(sc), device="cpu"
        ).get_coordinates(sc.frames, sc.fps, calibration=calibration, **kw)
    assert_coords_match(runs[True], want, boundary_atol=5e-3)
    moved = sum(runs[True][i]["Keypoints"] != runs[False][i]["Keypoints"] for i in runs[True])
    assert moved >= len(sc.frames) // 2, "calibration must move keypoints on most frames"


def test_config_calibration_follows_the_argument_as_in_jax():
    """The JAX package's rule: ``get_coordinates``' ``calibration``
    argument (default False) replaces the configuration's.  A model built
    with ``calibration=True`` in its config and called without the
    argument runs uncalibrated in both packages (the port calibrated
    before: its keypoints differed from the JAX package's on 12 of 12
    frames); with the argument both calibrate."""
    sc = make_scene(num_frames=12, width=640, height=360, num_players=4, fps=12, seed=7)
    kw = dict(num_homography=1, num_keypoint_detection=3)

    def run(model_cls, cfg, **extra):
        return model_cls(
            config=cfg.replace(calibration=True), keypoint_fn=_off_line_keypoints(sc),
            detector_fn=oracle_detector_fn(sc), **extra,
        ).get_coordinates(sc.frames, sc.fps, **kw)

    want = run(JModel, JCFG, verbose_init=False)
    got = run(TModel, TCFG, device="cpu")
    assert_coords_match(got, want, boundary_atol=5e-3)
    calibrated = TModel(
        keypoint_fn=_off_line_keypoints(sc), detector_fn=oracle_detector_fn(sc), device="cpu"
    ).get_coordinates(sc.frames, sc.fps, calibration=True, **kw)
    assert sum(got[i]["Keypoints"] != calibrated[i]["Keypoints"] for i in got) >= len(sc.frames) // 2


def test_builtin_slice_with_calibration_matches_jax():
    """Working geometry (4:2:0 letterbox to a 160x96 canvas): the snap runs
    in canvas pixels and only moved points map back."""
    sc = _small_scene()
    kp_params, det_params = _bridged_params()
    kw = dict(num_keypoint_detection=2, calibration=True)
    want = JModel(
        config=_reduced_cfg(JCFG), keypoint_params=kp_params, detector_params=det_params, verbose_init=False
    ).get_coordinates(sc.frames, sc.fps, verbose=False, **kw)
    model = TModel(config=_reduced_cfg(TCFG), keypoint_params=kp_params, detector_params=det_params, device="cpu")
    assert model._geometry((192, 320)).enabled
    got = model.get_coordinates(sc.frames, sc.fps, **kw)
    assert_coords_match(got, want, boundary_atol=5e-2)
    plain = model.get_coordinates(sc.frames, sc.fps, num_keypoint_detection=2)
    assert any(got[i]["Keypoints"] != plain[i]["Keypoints"] for i in got), "calibration must move keypoints"


def test_check_config_accepts_calibration_not_the_features_gmc():
    """Calibration and, since the features GMC is ported, ``gmc="features"``
    pass the check; an unknown flow backend still raises."""
    tt.check_config(TCFG.replace(calibration=True))
    tt.check_config(TCFG.replace(tracker=dataclasses.replace(TCFG.tracker, gmc="features")))
    with pytest.raises(ValueError, match="flow backend"):
        tt.check_config(TCFG.replace(flow=dataclasses.replace(TCFG.flow, backend="pallas")))
