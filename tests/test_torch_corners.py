"""PyTorch port, the features GMC: corner response, grid corners, the
robust 4-DOF fit and the whole ``_features_gmc_warp`` against the JAX
package.

Tolerances:
- the corner response within 1e-5 of the map's peak (float32 sums in
  another order);
- grid corner positions and valid masks equal (each is an argmax over a
  cell, the first on ties in both packages);
- the robust fit's 2x2 part within 1e-4 and its translation within 1e-3 px,
  inlier counts equal (the scenes keep every residual well away from the
  trimming thresholds);
- the whole warp within 1e-4 (2x2) and 2e-2 px (translation): the corners
  are tracked by each package's own LK flow, whose positions agree to ~1e-3
  px, and on the working path the translation is divided by the gain.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.ops import corners as jc
from eagle_tpu.ops.preprocess import compute_work_geometry, host_letterbox
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.config import WorkGeometry
from eagle_tpu_torch.ops import corners as tc
from eagle_tpu_torch.pipeline import temporal as tt

from .torch_parity import n, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pan():
    """A panning pair at 640x360 (3 px a frame)."""
    return make_scene(num_frames=2, width=640, height=360, num_players=6, fps=8, seed=9, pan_speed=3.0).frames


@pytest.fixture(scope="module")
def canvas():
    """A panning 1280x720 pair letterboxed to the detector's 544x960 canvas,
    and its geometry."""
    frames = make_scene(num_frames=2, width=1280, height=720, num_players=8, fps=8, seed=10, pan_speed=4.0).frames
    g = compute_work_geometry((720, 1280), 960)
    assert (g.canvas_h, g.canvas_w) == (544, 960)
    return host_letterbox(frames, g), g


def test_corner_response_matches_jax(pan):
    want = np.asarray(jc.corner_response(jc._gray(jnp.asarray(pan[0]))))
    got = n(tc.corner_response(tc._gray(t(pan[0]))))
    assert want.max() > 10.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("which", ["pan", "canvas"])
def test_grid_corners_match_jax(pan, canvas, which):
    frames = pan if which == "pan" else canvas[0]
    for f in frames:
        want_pts, want_ok = (np.asarray(a) for a in jc.grid_corners(jnp.asarray(f)))
        got_pts, got_ok = tc.grid_corners(t(f))
        np.testing.assert_array_equal(n(got_ok), want_ok)
        np.testing.assert_array_equal(n(got_pts), want_pts)
        assert want_pts.shape == (240, 2) and want_ok.sum() >= 40


def _correspondences(seed: int, outliers: float):
    """240 points under a similarity (rotation 2 deg, scale 1.01, a shift)
    plus 0.3 px noise, with a share of them moved 20-60 px."""
    rng = np.random.default_rng(seed)
    src = rng.uniform([20, 20], [940, 520], (240, 2)).astype(np.float32)
    th, sc = np.deg2rad(2.0), 1.01
    R = sc * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    dst = src @ R.T + [6.5, -3.25] + rng.normal(0, 0.3, src.shape)
    bad = rng.uniform(size=240) < outliers
    dst[bad] += rng.uniform(20, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    valid = rng.uniform(size=240) < 0.9
    return src, dst.astype(np.float32), valid


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.3), (2, 0.3)])
def test_fit_similarity_robust_matches_jax(seed, outliers):
    src, dst, valid = _correspondences(seed, outliers)
    want_w, want_n = (np.asarray(a) for a in jc.fit_similarity_robust(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid)))
    got_w, got_n = tc.fit_similarity_robust(t(src), t(dst), t(valid))
    got_w = n(got_w)
    assert int(got_n) == int(want_n)
    np.testing.assert_allclose(got_w[:, :2], want_w[:, :2], atol=1e-4)
    np.testing.assert_allclose(got_w[:, 2], want_w[:, 2], atol=1e-3)
    # the fit finds the drawn motion and keeps the inliers
    np.testing.assert_allclose(want_w[0, 0], 1.01 * np.cos(np.deg2rad(2.0)), atol=1e-3)
    assert int(want_n) >= 0.9 * (1 - outliers) * valid.sum() - 5


def _gmc_inputs(prev, curr, seed: int = 0):
    """Keypoint carry and keypoint flow for the fallback warp: 57 points
    moved by a small affine, 30 of them valid."""
    rng = np.random.default_rng(seed)
    kp = rng.uniform(50, 300, (57, 2)).astype(np.float32)
    flow = (kp @ np.array([[1.0, 0.01], [-0.01, 1.0]], np.float32).T + [2.0, -1.0]).astype(np.float32)
    ok = np.zeros(57, bool)
    ok[:30] = True
    return prev, curr, kp, flow, ok


def _both_warps(prev, curr, kp, flow, ok, jcfg, tcfg):
    want = np.asarray(
        jt._features_gmc_warp(
            types.SimpleNamespace(kp_xy=jnp.asarray(kp)),
            types.SimpleNamespace(prev_frame_bgr=jnp.asarray(prev), frame_bgr=jnp.asarray(curr)),
            jcfg, jnp.asarray(flow), jnp.asarray(ok),
        )
    )
    carry = types.SimpleNamespace(kp_xy=t(kp))
    xs = types.SimpleNamespace(prev_frame_bgr=t(prev), frame_bgr=t(curr))
    got = n(tt._features_gmc_warp(carry, xs, tcfg, t(flow), t(ok)))
    return got, want


def _assert_warp(got, want):
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=2e-2)


def test_features_gmc_warp_matches_jax_identity(pan):
    args = _gmc_inputs(pan[0], pan[1])
    got, want = _both_warps(*args, JCFG, TCFG)
    _assert_warp(got, want)
    fallback = np.asarray(jt.estimate_gmc_warp(*(jnp.asarray(a) for a in args[2:])))
    assert np.abs(want - fallback).max() > 0.1, "enough corners: the features warp, not the fallback"
    assert abs(want[0, 2] - 3.0) < 0.5, "the camera pans 3 px a frame"


def test_features_gmc_warp_matches_jax_working_geometry(canvas):
    frames, g = canvas
    jcfg = JCFG.replace(work=g)
    tcfg = TCFG.replace(work=WorkGeometry(**g.__dict__))
    got, want = _both_warps(*_gmc_inputs(frames[0], frames[1]), jcfg, tcfg)
    _assert_warp(got, want)
    assert abs(want[0, 2] - 4.0) < 0.5, "the camera pans 4 original px a frame"


def test_features_gmc_warp_falls_back_without_corners():
    """A flat frame has no corners: the keypoint-flow affine is used."""
    flat = np.full((360, 640, 3), 127, np.uint8)
    args = _gmc_inputs(flat, flat)
    got, want = _both_warps(*args, JCFG, TCFG)
    fallback = np.asarray(jt.estimate_gmc_warp(*(jnp.asarray(a) for a in args[2:])))
    np.testing.assert_allclose(want, fallback, atol=1e-6)
    _assert_warp(got, want)
