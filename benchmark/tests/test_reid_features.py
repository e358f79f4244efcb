"""Eagle's own tracker (the configuration ``yolov8l-960_hrnet-w48_osnet-
x0.25``: OSNet-x0.25 ReID and the features GMC) on the CPU: the program's
features-GMC warp against the plain reference (``benchmark/reference/
gmc.py``) and against the known motion of a seeded frame pair, the
reference's imports, and a run at a small size of the test-only OSNet cell
(``tiny.REID_CELLS``) with the features GMC, correct, its span log holding
the crops and the GMC's tally.  Run from the repository's root::

    python -m pytest -q benchmark/tests/test_reid_features.py
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import spans
from benchmark.reference import gmc
from benchmark.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the warp's 2x2 part and translation (px) against the known motion: the
#: 240 corners' LK tracks on a texture rounded to 8 bits are each off by a
#: few hundredths of a pixel, and the fit over them by under 3e-3 px and
#: 2e-5 (measured 1.3e-3-2.6e-3 px and 4.9e-6-1.4e-5 over 4 seeds)
MOTION_PX, MOTION_2X2 = 6e-3, 5e-5
#: the program's warp against the reference's: the same corners (equal),
#: the same LK and fit in float32, summed in other orders and sampled
#: through other arithmetic (measured under 5e-5 px and 1.3e-7)
REF_PX, REF_2X2 = 1e-3, 1e-5


def texture(seed: int, hw: tuple[int, int], motion=None) -> np.ndarray:
    """A (H, W, 3) uint8 gray frame of 48 seeded plane waves (wavelengths
    6-30 px: corners in every grid cell), or that frame moved by ``motion``
    = (A (2, 2), t (2,)): the pixel at p shows what the first frame shows at
    A^-1 (p - t), computed exactly and rounded once."""
    rng = np.random.default_rng(seed)
    n = 48
    ang, lam = rng.uniform(0, np.pi, n), rng.uniform(6, 30, n)
    phase, amp = rng.uniform(0, 2 * np.pi, n), rng.uniform(0.5, 1.0, n)
    y, x = np.mgrid[0 : hw[0], 0 : hw[1]].astype(np.float64)
    if motion is not None:
        a, t = motion
        q = np.stack([x - t[0], y - t[1]], -1) @ np.linalg.inv(a).T
        x, y = q[..., 0], q[..., 1]
    v = sum(m * np.cos(2 * np.pi * (np.cos(d) * x + np.sin(d) * y) / w + p) for m, d, w, p in zip(amp, ang, lam, phase))
    g = np.clip(np.round(128 + 40 * v / np.sqrt((amp**2).sum() / 2)), 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, -1)


@pytest.mark.parametrize("seed", [0, 3])
def test_the_programs_features_gmc_warp_agrees_with_the_plain_reference(seed):
    """A 240x400 pair moved by a known sub-pixel rotation, scale and
    translation: the program's ``_features_gmc_warp`` (its grid corners,
    flow at K = 240 and robust fit; identity geometry) and the plain
    reference both recover the motion, from the same corners, and agree
    with each other more closely still; the program's tally counts the
    fit's inliers and no fallback."""
    from eagle_tpu_torch.config import DEFAULT_CONFIG
    from eagle_tpu_torch.ops.corners import grid_corners
    from eagle_tpu_torch.pipeline import temporal

    torch.set_num_threads(tiny.THREADS)
    theta, scale = 0.004 + 0.002 * seed, 1.0 + 0.001 * seed
    a = scale * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    t = np.array([1.37 - 0.5 * seed, -0.62 + 0.3 * seed])
    want = np.concatenate([a, t[:, None]], 1)
    prev = torch.from_numpy(texture(seed, (240, 400)))
    curr = torch.from_numpy(texture(seed, (240, 400), (a, t)))

    tally = torch.zeros(2, dtype=torch.int64)
    carry = types.SimpleNamespace(kp_xy=torch.zeros(57, 2))
    xs = types.SimpleNamespace(prev_frame_bgr=prev, frame_bgr=curr)
    got = temporal._features_gmc_warp(carry, xs, DEFAULT_CONFIG, torch.zeros(57, 2), torch.zeros(57, dtype=torch.bool),
                                      gmc_stats=tally).numpy()
    flow = DEFAULT_CONFIG.flow
    ref, inliers = gmc.gmc_warp(prev, curr, flow.window, flow.pyramid_levels, flow.iterations, flow.epsilon)
    ref = ref.numpy()

    pts, valid = gmc.grid_corners(prev)
    mine, mine_valid = grid_corners(prev)
    assert torch.equal(pts, mine) and torch.equal(valid, mine_valid) and int(valid.sum()) == 240
    for warp in (got, ref):
        assert np.abs(warp[:, :2] - want[:, :2]).max() < MOTION_2X2
        assert np.abs(warp[:, 2] - want[:, 2]).max() < MOTION_PX
    assert np.abs(got[:, :2] - ref[:, :2]).max() < REF_2X2
    assert np.abs(got[:, 2] - ref[:, 2]).max() < REF_PX
    assert tally.tolist() == [0, int(inliers)] and int(inliers) >= 200


def test_the_plain_gmc_imports_nothing_of_the_program():
    code = "import sys, benchmark.reference.gmc; print(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & {"eagle_tpu_torch", "eagle_tpu", "jax", "jaxlib", "flax"}


def test_a_small_run_of_the_osnet_cell_with_the_features_gmc_is_correct():
    """The test-only OSNet cell (``tiny.REID_CELLS``) with the tracker's
    GMC set to "features", as the configuration sets it: correct with
    ``reid_gap`` among its checks; the window's stream logs the crops
    (``reid_slots`` a frame) and the GMC's tally a chunk."""
    r, driver = tiny.tiny("l960.reid", 2**31 + 41, 2.0)
    program_config = r.program_config

    def features():
        cfg = program_config()
        return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, gmc="features"))

    r.program_config = features
    result = driver.run(r)
    assert r.model.config.tracker.gmc == "features"
    r.free_program()
    gc.collect()
    checks = r.judge(result)
    assert tiny.correct(checks), checks
    assert "reid_gap" in checks and result.failed == 0
    call = spans.last_call(spans.records(), "stream_coordinates")
    counts = {}
    for rec in call:
        if rec.kind == "count":
            counts[rec.name] = counts.get(rec.name, 0) + rec.value
    assert counts["gmc:frames"] >= 16 and counts["gmc:frames"] % 16 == 0
    assert counts["reid:crops"] == tiny.REID_SLOTS * counts["gmc:frames"]
    assert counts["gmc:inliers"] > 0 and 0 <= counts["gmc:fallback"] <= counts["gmc:frames"]
