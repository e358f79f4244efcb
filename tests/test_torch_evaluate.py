"""PyTorch port: the eval CLI (``python -m eagle_tpu_torch.evaluate``)
against the JAX package's ``scripts/evaluate.py``, and the model's default
runner entries (``_default_keypoint_fn`` / ``_default_detector_fn``)
against the JAX package's.

Tolerances:
- (a), (b) the same injected runners (the scene's truth with seeded numpy
  noise, points dropped, false and non-person detections) through both
  CLIs: the ``results.json`` key trees equal and every metric within 1e-12
  (``time`` is not compared: the JAX script's keypoint clock stops before
  its device arrays are ready);
- (c) the built-in HRNet-W48 and YOLOv8-m with the same (bridged) weights
  at the reduced size of ``tests/test_torch_coordinate_model.py``, under
  that file's bars: masks, classes equal; keypoints and boxes within 1 px;
  scores within 1e-4.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu_torch import evaluate
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.io.video import write_video
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.utils.synthetic import make_scene

from .test_torch_coordinate_model import _bridged_params, _reduced_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 2


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_evaluate", os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noisy_runners(scene):
    """Keypoint and detector runners that return the scene's truth with
    seeded noise: every call with B frames returns the same arrays."""
    kp_image, boxes_true = scene.keypoints_image, scene.player_boxes

    def keypoints(frames):
        b = len(frames)
        rng = np.random.default_rng(1)
        kp = np.zeros((b, 57, 3), np.float32)
        kp[..., :2] = kp_image + rng.normal(0.0, 4.0, (b, 57, 2))
        kp[..., 2] = rng.uniform(0.3, 1.0, (b, 57))
        return kp, rng.random((b, 57)) > 0.25

    def detections(frames):
        b, p, d = len(frames), boxes_true.shape[1], 16
        rng = np.random.default_rng(2)
        boxes = np.zeros((b, d, 4), np.float32)
        boxes[:, :p] = boxes_true[:b] + rng.normal(0.0, 2.5, (b, p, 4))
        corner = rng.uniform(0, 1100, (b, d - p, 2))
        boxes[:, p:] = np.concatenate([corner, corner + rng.uniform(10, 60, (b, d - p, 2))], -1)
        conf = rng.uniform(0.2, 1.0, (b, d)).astype(np.float32)
        cls = rng.integers(0, 4, (b, d)).astype(np.int32)
        return boxes, conf, cls, rng.random((b, d)) > 0.15

    return keypoints, detections


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_results_equal(got: dict, want: dict):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if k.endswith("/time"):
            continue
        assert abs(g[k] - w[k]) <= 1e-12, (k, g[k], w[k])
    assert w["YOLO/classification/true_positives_12"] > 0 and w["HRNet/classification/true_positives_12"] > 0
    assert w["YOLO/classification/false_positives_2"] > 0 and w["YOLO/boxes/num_pred"] > 0


def _run_both(monkeypatch, tmp_path, scene, extra):
    keypoints, detections = _noisy_runners(scene)
    import eagle_tpu.pipeline.coordinate_model as jcm

    monkeypatch.setattr(
        jcm, "CoordinateModel", lambda **kw: JModel(keypoint_fn=keypoints, detector_fn=detections, verbose_init=False)
    )
    monkeypatch.setattr(
        evaluate, "CoordinateModel",
        lambda device=None, **kw: TModel(keypoint_fn=keypoints, detector_fn=detections, device=device),
    )
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--frames", str(FRAMES), "--out", str(jax_out), *extra])
    _jax_cli().main()
    returned = evaluate.main(["--device", "cpu", "--frames", str(FRAMES), "--out", str(port_out), *extra])
    got = json.loads(port_out.read_text())
    assert _flat(got).keys() == _flat(returned).keys()
    _assert_results_equal(got, json.loads(jax_out.read_text()))


def test_synthetic_cli_matches_jax(monkeypatch, tmp_path):
    """(a) The default (synthetic) mode: the port's scene against the JAX
    package's, the same truth built from it."""
    _run_both(monkeypatch, tmp_path, make_scene(num_frames=FRAMES, width=1280, height=720, num_players=10), [])


def test_video_and_labels_cli_matches_jax(monkeypatch, tmp_path):
    """(b) ``--video`` / ``--labels``: an mp4 of the scene written by the
    port's ``write_video`` (25 fps: every frame is kept) and labels built
    from its truth, three frames of which ``--frames`` keeps two."""
    scene = make_scene(num_frames=3, width=640, height=360, num_players=6, seed=4)
    video = str(tmp_path / "clip.mp4")
    write_video(scene.frames, video, 25)
    kp = scene.keypoints_image
    labels = {}
    for t in range(3):
        inb = (kp[:, 0] >= 0) & (kp[:, 0] < 640) & (kp[:, 1] >= 0) & (kp[:, 1] < 360)
        labels[str(t)] = {
            "keypoints": [[float(kp[i, 0]), float(kp[i, 1]), int(i)] for i in np.nonzero(inb)[0] if i % 3],
            "boxes": [[*map(float, b), 0] for b in scene.player_boxes[t]],
        }
    labels_path = tmp_path / "labels.json"
    labels_path.write_text(json.dumps(labels))
    _run_both(monkeypatch, tmp_path, scene, ["--video", video, "--labels", str(labels_path)])


def test_cli_needs_labels_with_a_video(tmp_path):
    with pytest.raises(SystemExit):
        evaluate.main(["--device", "cpu", "--video", str(tmp_path / "clip.mp4")])


@pytest.fixture(scope="module")
def models():
    kp_params, det_params = _bridged_params()
    jm = JModel(config=_reduced_cfg(JCFG), keypoint_params=kp_params, detector_params=det_params, verbose_init=False)
    tm = TModel(config=_reduced_cfg(TCFG), keypoint_params=kp_params, detector_params=det_params, device="cpu")
    return jm, tm, make_scene(num_frames=3, width=320, height=192, num_players=4, seed=5).frames


def test_default_keypoint_fn_matches_jax(models):
    """(c) HRNet-W48 at the original resolution (the identity geometry):
    (B, 57, 3) keypoints and their mask."""
    jm, tm, frames = models
    assert tm._keypoint_fn == tm._default_keypoint_fn and not tm._custom_kp
    want_kp, want_valid = (np.asarray(a) for a in jm._default_keypoint_fn(frames))
    got_kp, got_valid = tm._default_keypoint_fn(frames)
    assert isinstance(got_kp, torch.Tensor) and got_kp.shape == (3, 57, 3) and got_valid.dtype == torch.bool
    got_kp, got_valid = got_kp.numpy(), got_valid.numpy()
    np.testing.assert_array_equal(got_valid, want_valid)
    assert want_valid.sum() > 20
    np.testing.assert_allclose(got_kp[..., :2], want_kp[..., :2], atol=1)
    np.testing.assert_allclose(got_kp[..., 2], want_kp[..., 2], atol=1e-4)


def test_default_detector_fn_matches_jax(models):
    """(c) YOLOv8-m + NMS at the original resolution: numpy boxes, scores,
    int32 classes and the bool mask."""
    jm, tm, frames = models
    assert tm._detector_fn == tm._default_detector_fn and not tm._custom_det
    want = jm._default_detector_fn(frames)
    got = tm._default_detector_fn(frames)
    assert [a.dtype for a in got] == [np.float32, np.float32, np.int32, np.bool_]
    np.testing.assert_array_equal(got[3], want[3])
    v = want[3]
    assert v.sum() > 10
    np.testing.assert_array_equal(got[2][v], want[2][v])
    np.testing.assert_allclose(got[0][v], want[0][v], atol=1)
    np.testing.assert_allclose(got[1][v], want[1][v], atol=1e-4)
