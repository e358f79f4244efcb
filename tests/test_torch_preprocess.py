"""PyTorch port, preprocessing: the 4:2:0 host prescale, the BT.601
inverse, the gray conversion and the keypoint/detector resizes against the
JAX package on the same seeded inputs; OpenCV's exact 4:2:0 decode against
cv2 itself.

Tolerances: the prescale bytes, the I420 -> BGR bytes (both decodes) and
the flow gray are bit-equal; the float resizes agree to 1e-5 (the same
interpolation matrices, summed in another order)."""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops import preprocess as jp
from eagle_tpu.ops.optical_flow import _GRAY_W
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import WorkGeometry
from eagle_tpu_torch.ops import preprocess as tp
from eagle_tpu_torch.ops.optical_flow import bgr_to_gray

from .torch_parity import n, t

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(2, 96 * 3 // 2, 128), (2, 544 * 3 // 2, 960)])
def test_i420_to_bgr_bit_equal(shape):
    planes = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(n(tp.i420_to_bgr(t(planes))), n(jp.i420_to_bgr(jnp.asarray(planes))))


def _cv2_i420(planes: np.ndarray) -> np.ndarray:
    return np.stack([cv2.cvtColor(p, cv2.COLOR_YUV2BGR_I420) for p in planes])


@pytest.mark.parametrize("shape", [(2, 96 * 3 // 2, 128), (2, 544 * 3 // 2, 960)])
def test_i420_to_bgr_exact_matches_cv2_on_random_planes(shape):
    """Random planes put the chroma far outside video range, where the
    float BT.601 inverse is up to 19 off cv2."""
    planes = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(n(tp.i420_to_bgr_exact(t(planes))), _cv2_i420(planes))


def test_i420_to_bgr_exact_matches_cv2_on_canvases():
    """The working canvases the slice uploads: 720p broadcast-like frames
    through the native 4:2:0 letterbox to 544x960."""
    frames = make_scene(num_frames=4, width=1280, height=720, num_players=6, seed=3).frames
    planes = tp.host_letterbox_i420(frames, tp.compute_work_geometry((720, 1280), 960))
    np.testing.assert_array_equal(n(tp.i420_to_bgr_exact(t(planes))), _cv2_i420(planes))


def test_gray_bit_equal():
    img = np.random.default_rng(1).integers(0, 256, (200, 300, 3), np.uint8)
    want = np.round(np.asarray(jnp.asarray(img).astype(jnp.float32) @ jnp.asarray(_GRAY_W)))
    np.testing.assert_array_equal(n(bgr_to_gray(t(img))), want)


@pytest.mark.parametrize("hw,size", [((720, 1280), 960), ((360, 640), 320), ((1080, 1920), 960)])
def test_work_geometry_and_native_letterbox(hw, size):
    gj = jp.compute_work_geometry(hw, size)
    gt = tp.compute_work_geometry(hw, size)
    assert dataclass_tuple(gt) == dataclass_tuple(gj)
    frames = np.random.default_rng(2).integers(0, 256, (2, *hw, 3), np.uint8)
    np.testing.assert_array_equal(tp.host_letterbox_i420(frames, gt), jp.host_letterbox_i420(frames, gj))


def dataclass_tuple(g):
    return tuple(getattr(g, f) for f in WorkGeometry.__dataclass_fields__)


def test_letterbox_outside_native_envelope_raises():
    """Outside the fused kernel's envelope (an upscale) the 4:2:0 letterbox
    runs the unfused native path, byte-equal to the JAX package's cv2 one;
    only a geometry without the 4:2:0 placement parity raises."""
    g = tp.compute_work_geometry((192, 320), 960)  # an upscale
    frames = np.random.default_rng(4).integers(0, 256, (2, 192, 320, 3), np.uint8)
    np.testing.assert_array_equal(
        tp.host_letterbox_i420(frames, g), jp.host_letterbox_i420(frames, jp.compute_work_geometry((192, 320), 960))
    )
    odd = dataclasses.replace(g, pad_y=g.pad_y + 1)
    with pytest.raises(ValueError, match="even placement"):
        tp.host_letterbox_i420(frames, odd)


def test_resizes_match():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 72, 128, 3), np.uint8)
    np.testing.assert_allclose(
        n(tp.preprocess_keypoint(t(x), (54, 96))),
        np.asarray(jp.preprocess_keypoint(jnp.asarray(x), out_hw=(54, 96))),
        atol=1e-5,
    )
    img_t, gain_t, pad_t = tp.letterbox(t(x), size=160)
    img_j, gain_j, pad_j = jp.letterbox(jnp.asarray(x), size=160)
    np.testing.assert_allclose(n(img_t), np.asarray(img_j), atol=1e-6)
    assert gain_t == pytest.approx(float(gain_j))
    assert list(pad_t) == np.asarray(pad_j).tolist()


def test_upload_format_resolution():
    assert tp.resolve_upload_format("auto", True) == "yuv420"
    assert tp.resolve_upload_format("auto", False) == "bgr"
    with pytest.raises(ValueError):
        tp.resolve_upload_format("nv12", True)
