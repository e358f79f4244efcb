"""PyTorch port, the eval harness (``eagle_tpu_torch/eval.py``) against the
JAX package's ``eagle_tpu/eval.py`` on synthetic predictions and labels with
exact ties, empty frames and masked slots, given as numpy arrays and as
tensors.  Tolerance: every number within 1e-12 (both compute in numpy on
the host)."""

import math

import numpy as np
import pytest
import torch

from eagle_tpu import eval as jeval
from eagle_tpu_torch import eval as teval

from .torch_parity import t

torch.set_num_threads(2)


def _assert_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_close(got[k], want[k])
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert type(got) is type(want), (got, want)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def _points(seed, n=6, k=20, scale=40.0):
    """Predicted and true points on an integer grid (exact distance ties),
    empty frames (no valid prediction, no valid label) and masked slots."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 60, (n, k, 2)).astype(np.float32)
    pred = gt + rng.choice([-6.0, -2.0, 0.0, 2.0, 4.0, 12.0], (n, k, 2)).astype(np.float32)
    pred[:, ::5] = pred[:, 1::5]  # duplicated predictions: tied greedy candidates
    gt_valid = rng.uniform(size=(n, k)) < 0.8
    pred_valid = rng.uniform(size=(n, k)) < 0.8
    gt_valid[1] = False  # a frame without labels
    pred_valid[2] = False  # a frame without predictions
    return pred * scale / 40.0, pred_valid, gt * scale / 40.0, gt_valid


@pytest.mark.parametrize("labeled", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_point_metrics_match_jax(labeled, as_tensor):
    pred, pv, gt, gv = _points(0)
    want = jeval.point_metrics(pred, pv, gt, gv, labeled=labeled)
    args = (t(pred), t(pv), t(gt), t(gv)) if as_tensor else (pred, pv, gt, gv)
    _assert_close(teval.point_metrics(*args, labeled=labeled), want)


def test_point_metrics_other_thresholds_and_empty_input():
    pred, pv, gt, gv = _points(1)
    _assert_close(teval.point_metrics(pred, pv, gt, gv, thresholds=(1, 3)),
                  jeval.point_metrics(pred, pv, gt, gv, thresholds=(1, 3)))
    none = np.zeros_like(pv)
    _assert_close(teval.point_metrics(pred, none, gt, none, labeled=False),
                  jeval.point_metrics(pred, none, gt, none, labeled=False))


def _boxes(seed, n=5, d=12):
    """xyxy boxes: the labels, predictions that shift some of them by whole
    pixels (IoU ties), exact duplicates, empty frames and masked slots."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 200, (n, d, 2)).astype(np.float64)
    wh = rng.integers(10, 40, (n, d, 2)).astype(np.float64)
    gt = np.concatenate([xy, xy + wh], -1)
    shift = rng.choice([0.0, 2.0, 5.0, 30.0], (n, d, 1))
    pred = gt + np.concatenate([shift, shift * 0.0, shift, shift * 0.0], -1)
    pred[:, 3] = pred[:, 4]
    gv = rng.uniform(size=(n, d)) < 0.85
    pv = rng.uniform(size=(n, d)) < 0.85
    gv[0] = False
    pv[3] = False
    return pred, pv, gt, gv


@pytest.mark.parametrize("iou_threshold", [0.5, 0.75])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_detection_metrics_match_jax(iou_threshold, as_tensor):
    pred, pv, gt, gv = _boxes(2)
    want = jeval.detection_metrics(pred, pv, gt, gv, iou_threshold=iou_threshold)
    args = (t(pred), t(pv), t(gt), t(gv)) if as_tensor else (pred, pv, gt, gv)
    got = teval.detection_metrics(*args, iou_threshold=iou_threshold)
    _assert_close(got, want)
    assert want["num_pred"] > 0 and 0 < want["precision"] < 1


def test_box_iou_matches_jax():
    pred, _, gt, _ = _boxes(3)
    want = jeval.box_iou(pred[0], gt[0])
    np.testing.assert_allclose(teval.box_iou(pred[0], gt[0]), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(teval.box_iou(t(pred[0]), t(gt[0])), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pitch_rmse_matches_jax(as_tensor):
    pred, pv, gt, gv = _points(4, scale=1.0)  # metres, float32 as the pipeline reports them
    want = jeval.pitch_rmse(pred, pv, gt, gv)
    args = (t(pred), t(pv), t(gt), t(gv)) if as_tensor else (pred, pv, gt, gv)
    _assert_close(teval.pitch_rmse(*args), want)
    none = np.zeros_like(pv)
    _assert_close(teval.pitch_rmse(pred, none, gt, none), jeval.pitch_rmse(pred, none, gt, none))
    assert teval.THRESHOLDS == jeval.THRESHOLDS
