"""PyTorch port, optical flow: the plain LK flow against the JAX
package's ``lk_flow`` and its Pallas kernel ``lk_flow_pallas2`` (run in
interpret mode, as tests/test_pallas_flow.py runs it) and the ROI
pyramid.  The CUDA kernel against the plain version, on the card, is
tests/test_torch_cuda.py.

Tolerances: status bit-equal; positions within 1e-2 px on tracked points
(the bar tests/test_pallas_flow.py sets between the JAX engines); ROI
pyramids bit-equal (their values are exact in float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops.optical_flow import lk_flow as jlk
from eagle_tpu.ops.optical_flow import pyr_down as jpyr
from eagle_tpu.ops.pallas_flow2 import lk_flow_pallas2
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import FlowConfig, PipelineConfig
from eagle_tpu_torch.ops import optical_flow as of
from eagle_tpu_torch.pipeline.temporal import flow_with_filters

from .torch_parity import n, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    scene = make_scene(num_frames=2, width=640, height=360, num_players=3, seed=9, pan_speed=2.0)
    rng = np.random.default_rng(0)
    vis = scene.keypoints_image
    inb = (vis[:, 0] > 0) & (vis[:, 0] < 639) & (vis[:, 1] > 0) & (vis[:, 1] < 359)
    pts = np.concatenate(
        [
            vis[inb],
            rng.uniform([0, 0], [639, 359], (20, 2)),
            [[0.0, 0.0], [639.0, 359.0], [3.0, 200.0], [636.5, 5.25], [320.5, 358.9]],
        ]
    ).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[2] = False
    return scene.frames[0], scene.frames[1], pts, valid


def test_plain_matches_jax_lk_flow(case):
    prev, curr, pts, valid = case
    want_p, want_s = (np.asarray(a) for a in jlk(jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(pts), jnp.asarray(valid)))
    got_p, got_s = (n(a) for a in of.lk_flow(t(prev), t(curr), t(pts), t(valid)))
    np.testing.assert_array_equal(got_s, want_s)
    assert want_s.sum() > 20
    np.testing.assert_allclose(got_p[want_s], want_p[want_s], atol=1e-2)


def test_plain_matches_pallas2_interpret(case):
    prev, curr, pts, valid = case
    # the Pallas kernel clamps samples to its VMEM window; inside the window
    # slack (interior points with small drift) it matches lk_flow
    inner = (pts[:, 0] > 40) & (pts[:, 0] < 600) & (pts[:, 1] > 40) & (pts[:, 1] < 320)
    p, v = pts[inner][:16], valid[inner][:16]
    want_p, want_s = (
        np.asarray(a)
        for a in lk_flow_pallas2(jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(p), jnp.asarray(v), interpret=True)
    )
    got_p, got_s = (n(a) for a in of.lk_flow_plain(t(prev), t(curr), t(p), t(v)))
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_allclose(got_p[want_s], want_p[want_s], atol=1e-2)


@pytest.mark.parametrize("shape", [(3, 192, 192), (2, 37, 53)])
def test_pyr_down_bit_equal(shape):
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    a, b = np.asarray(jpyr(jnp.asarray(x))), n(of.pyr_down(t(x)))
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(n(of.pyr_down(t(b))), np.asarray(jpyr(jnp.asarray(a))))


def test_roi_pyramid_layout(case):
    """The packed pyramid holds, level by level, the K previous and then the
    K current gray ROIs, each level the pyrDown of the one before."""
    prev, curr, pts, _ = case
    h, w = prev.shape[:2]
    side = of.roi_side(h, w)
    origin = of.roi_origins(t(pts), h, w, side, 2)
    pyr = of.roi_pyramids(t(prev), t(curr), origin, side, 2)
    views = of.pyramid_levels(pyr, len(pts), side, 2)
    assert [v.shape[-1] for v in views] == of.level_sizes(side, 2) == [side, side // 2, side // 4]
    assert pyr.numel() == sum(v.numel() for v in views)
    for frame, half in ((prev, 0), (curr, 1)):
        gray = of.bgr_to_gray(t(frame))
        for i, (x0, y0) in enumerate(n(origin).tolist()):
            np.testing.assert_array_equal(n(views[0][half, i]), n(gray[y0 : y0 + side, x0 : x0 + side]))
    for lvl in (1, 2):
        np.testing.assert_array_equal(n(views[lvl]), n(of.pyr_down(views[lvl - 1].reshape(-1, *views[lvl - 1].shape[2:]))).reshape(views[lvl].shape))


def test_cpu_tensors_take_the_plain_version(case):
    prev, curr, pts, valid = case
    before = of.launches
    a = of.lk_flow(t(prev), t(curr), t(pts), t(valid))
    b = of.lk_flow_plain(t(prev), t(curr), t(pts), t(valid))
    assert of.launches == before
    np.testing.assert_array_equal(n(a[0]), n(b[0]))


def test_flow_backend_names():
    frame = torch.zeros(32, 32, 3, dtype=torch.uint8)
    pts = torch.full((4, 2), 16.0)
    valid = torch.ones(4, dtype=torch.bool)
    for name in ("xla", "pallas2"):  # synonyms: "the flow step"
        flow_with_filters(frame, frame, pts, valid, PipelineConfig(flow=FlowConfig(backend=name)))
    with pytest.raises(ValueError, match="unknown flow backend"):
        flow_with_filters(frame, frame, pts, valid, PipelineConfig(flow=FlowConfig(backend="pallas")))

