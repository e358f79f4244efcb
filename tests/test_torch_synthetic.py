"""PyTorch port: ``eagle_tpu_torch/utils/synthetic.py`` against the JAX
package's ``eagle_tpu/utils/synthetic.py``, which draws with OpenCV.

Tolerances:
- the homographies within 1e-12 relative, every truth array within 1e-9 px
  (both are float64 from the same draws), the teams and the fps equal;
- each frame at least 99% bit-equal pixels, and every pixel that differs
  within 2 px of a colour edge of the JAX frame (the port's rasterizer
  follows OpenCV's integer rules; a vertex that rounds the other way moves
  an edge by a pixel, nothing else);
- the rasterizer's primitives against OpenCV's on random shapes, clipped
  ones included: bit-equal;
- importing the module and drawing loads neither OpenCV nor JAX.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from eagle_tpu.utils import synthetic as J
from eagle_tpu_torch.utils import synthetic as T

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRUTH = ("player_world", "player_feet_image", "player_boxes", "ball_world", "ball_image", "keypoints_image")


def _edges(img: np.ndarray) -> np.ndarray:
    """Pixels with an 8-neighbour of another colour."""
    h, w = img.shape[:2]
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    edge = np.zeros((h, w), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= (pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] != img).any(-1)
    return edge


@pytest.mark.parametrize(
    "seed,width,height,players,pan",
    [(0, 1280, 720, 10, 0.0), (3, 960, 540, 6, 1.5), (5, 256, 128, 8, 0.0)],
)
def test_make_scene_matches_jax(seed, width, height, players, pan):
    kw = dict(num_frames=4, width=width, height=height, num_players=players, fps=12, seed=seed, pan_speed=pan)
    want, got = J.make_scene(**kw), T.make_scene(**kw)
    for name in ("H_world_to_image", "H_image_to_world"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name
    for name in TRUTH:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got.player_team, want.player_team)
    assert got.fps == want.fps
    assert got.frames.shape == want.frames.shape and got.frames.dtype == np.uint8
    for t in range(len(want.frames)):
        differ = (got.frames[t] != want.frames[t]).any(-1)
        assert differ.mean() <= 0.01, f"frame {t}: {differ.mean():.4%} of pixels differ"
        near_edge = binary_dilation(_edges(want.frames[t]), np.ones((5, 5), bool))
        assert not (differ & ~near_edge).any(), f"frame {t}: a pixel away from any edge differs"


def _shapes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield rng.integers(-40, 110, (int(rng.integers(2, 7)), 2)).astype(np.int32), bool(rng.integers(0, 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_primitives_bit_equal_to_opencv(seed):
    """Thick lines and polylines (thickness 3), filled polygons, filled
    rectangles and discs on a 64x80 canvas, vertices up to 40 px outside."""
    for pts, closed in _shapes(seed, 150):
        p = [tuple(int(v) for v in q) for q in pts]
        want = np.zeros((64, 80, 3), np.uint8)
        got = np.zeros_like(want)
        cv2.line(want, p[0], p[1], (255, 255, 255), 3)
        T._thick_segment(got, p[0], p[1], (255, 255, 255), 3)
        cv2.polylines(want, [pts], closed, (1, 2, 3), 3)
        T._polyline(got, pts, closed, (1, 2, 3))
        if len(p) >= 3:
            cv2.fillPoly(want, [pts], (9, 8, 7))
            T._fill_poly(got, p, (9, 8, 7))
        cv2.rectangle(want, p[0], p[1], (4, 5, 6), -1)
        T._fill_rect(got, p[0], p[1], (4, 5, 6))
        r = abs(p[-1][0]) % 9
        cv2.circle(want, p[-1], r, (7, 7, 7), -1)
        T._fill_disc(got, p[-1], r, (7, 7, 7))
        np.testing.assert_array_equal(got, want, err_msg=str(p))


def test_module_loads_neither_opencv_nor_jax():
    probe = (
        "import sys\n"
        "from eagle_tpu_torch.utils.synthetic import make_scene\n"
        "s = make_scene(num_frames=2, width=160, height=96, num_players=3, pan_speed=1.5)\n"
        "assert s.frames.shape == (2, 96, 160, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'jax', 'eagle_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout
