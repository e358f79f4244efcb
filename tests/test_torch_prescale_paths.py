"""PyTorch port, the prescale paths of the JAX package's
``_DevicePieces._host_plan`` that the port gained beside the native 4:2:0
letterbox: the 4:2:0 letterbox outside the fused kernel's envelope
(upscaling: 640x360 and 854x480 -> 540x960 in a 544x960 canvas), the BGR
letterbox ("canvas_bgr", with and without the 4:2:0 transport), the
device letterbox of raw planes (``prescale="device"``, "raw_planes") and
the 4:2:0 transport of raw frames on the identity geometry.

Tolerances: every host prescale and every decode byte-equal to the JAX
package's; the device letterbox within 4 LSB of the JAX package's
``device_letterbox_i420`` on the same planes and within 4 LSB of the host
canvas (both measured here: at most 4 on noise frames, 2-3 on make_scene
frames; a plane value rounded the other way moves B, G, R by up to ~2
each through the BT.601 inverse), with over 99% of the bytes equal to
the JAX package's; ``get_coordinates`` as in
tests/test_torch_coordinate_model.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.config import WorkGeometry as JGeometry
from eagle_tpu.ops import preprocess as jp
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.pipeline.coordinate_model import _DevicePieces
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.ops import preprocess as tp
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_keypoint_fn
from .test_torch_coordinate_model import assert_coords_match

torch.set_num_threads(2)

#: the device letterbox's measured bound, against the JAX package's and
#: against the host canvas
LSB = 4


def _frames(hw, n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _model(**cfg):
    return TModel(config=TCFG.replace(**cfg), device="cpu")


def _jgeom(g):
    return JGeometry(**dataclasses.asdict(g))


@pytest.mark.parametrize("hw", [(360, 640), (480, 854)])
def test_canvas_planes_outside_the_native_envelope_match_jax(hw):
    model = _model()
    g = model._geometry(hw)
    assert (g.img_h, g.img_w, g.canvas_h) == (540, 960, 544) and not tp.native_prescale_ok(g, hw)
    assert model._prescale_plan(g, hw) == ("canvas_planes", True)
    f = _frames(hw)
    host = tp.host_letterbox_i420(f, g)
    np.testing.assert_array_equal(host, jp.host_letterbox_i420(f, _jgeom(g)))
    np.testing.assert_array_equal(model.upload(f, g).numpy(), np.asarray(jp.i420_to_bgr(jnp.asarray(host))))


@pytest.mark.parametrize("hw,fmt", [((1082, 1920), "auto"), ((720, 1280), "bgr")])
def test_canvas_bgr_matches_jax(hw, fmt):
    """An odd-parity geometry (1082x1920: image 541x960 at pad_y 1) takes
    the BGR letterbox and, its canvas being 544x960, the 4:2:0 transport;
    ``upload_format="bgr"`` takes the BGR letterbox as it is."""
    model = _model(upload_format=fmt)
    g = model._geometry(hw)
    mode, yuv = model._prescale_plan(g, hw)
    assert (mode, yuv) == ("canvas_bgr", fmt == "auto")
    f = _frames(hw, seed=1)
    host = tp.host_letterbox(f, g)
    np.testing.assert_array_equal(host, jp.host_letterbox(f, _jgeom(g)))
    want = np.asarray(jp.i420_to_bgr(jnp.asarray(jp.host_to_i420(host)))) if yuv else host
    np.testing.assert_array_equal(model.upload(f, g).numpy(), want)


@pytest.mark.parametrize("content", ["scene", "noise"])
def test_raw_planes_within_the_measured_lsb_bound(content):
    hw = (720, 1280)
    model = _model(prescale="device")
    g = model._geometry(hw)
    assert model._prescale_plan(g, hw) == ("raw_planes", True)
    f = make_scene(num_frames=2, width=1280, height=720, seed=3).frames if content == "scene" else _frames(hw, seed=2)
    planes = tp.host_to_i420(f)
    np.testing.assert_array_equal(planes, jp.host_to_i420(f))
    got = model.upload(f, g).numpy().astype(int)
    want = np.asarray(jp.device_letterbox_i420(jnp.asarray(planes), _jgeom(g)))
    host = tp.i420_to_bgr(torch.from_numpy(tp.host_letterbox_i420(f, g))).numpy()
    assert np.abs(got - want).max() <= LSB
    assert np.abs(got - host).max() <= LSB
    assert (got == want).mean() > 0.99  # measured: 99.54% of the bytes equal on noise, 99.997% on the scene


def test_yuv420_on_the_identity_geometry_matches_jax():
    hw = (96, 128)
    model = TModel(config=TCFG.replace(upload_format="yuv420"), keypoint_fn=lambda b: None,
                   detector_fn=lambda b: None, device="cpu")
    g = model._geometry(hw)
    assert not g.enabled and model._prescale_plan(g, hw) == ("raw_bgr", True)
    f = _frames(hw, n=3, seed=4)
    np.testing.assert_array_equal(model.upload(f, g).numpy(), np.asarray(jp.i420_to_bgr(jnp.asarray(jp.host_to_i420(f)))))


@pytest.mark.parametrize("fmt", ["auto", "bgr", "yuv420"])
@pytest.mark.parametrize("prescale", ["host", "device"])
def test_prescale_plans_match_jax(fmt, prescale):
    model = _model(upload_format=fmt, prescale=prescale)
    for hw in [(720, 1280), (360, 640), (480, 854), (1082, 1920), (1080, 1920), (96, 128), (98, 130)]:
        g = model._geometry(hw)
        want = _DevicePieces._host_plan(hw, _jgeom(g) if g.enabled else None, tp.resolve_upload_format(fmt, g.enabled),
                                        prescale)[:2]
        assert model._prescale_plan(g, hw) == want, (hw, fmt, prescale)


def _fid(x, xp):
    """The frame id stamped as a flat 32x32 block of 640x360 frames (48x48
    at (2, 0) on the 544x960 canvas)."""
    return xp.round((x[:, 12:40, 8:40].astype(xp.float32).mean(axis=(1, 2, 3)) - 40.0) / 8.0)


def _det_rows(fid, xp):
    b = fid.shape[0]
    row = xp.stack([200 + 5 * fid, xp.full(b, 150.0), 240 + 5 * fid, xp.full(b, 260.0), xp.full(b, 0.9),
                    xp.zeros(b), xp.ones(b)], -1).astype(xp.float32)
    return xp.concatenate([row[:, None], xp.zeros((b, 127, 7), xp.float32)], 1)


def test_get_coordinates_on_640x360_frames_matches_jax():
    """The built-in models' path on 640x360 frames (the upscaling 4:2:0
    letterbox), with fake model runners that read a stamped frame id from
    the canvas; a prescale made beforehand (``prescale_clip``, the stream's
    prefetch) gives the same result, and so does ``prescale="device"`` run
    to its end."""
    scene = make_scene(num_frames=8, width=640, height=360, num_players=0, fps=8, seed=12)
    frames = scene.frames.copy()
    for i in range(len(frames)):
        frames[i, :32, :32] = 40 + 8 * i
    kp, valid = oracle_keypoint_fn(scene)(scene.frames[:1])
    kp_packed = np.concatenate([kp[0], valid[0].astype(np.float32)[:, None]], -1)
    cfg = dict(chunk_frames=32)
    kw = dict(num_homography=1, num_keypoint_detection=2)

    jm = JModel(config=JCFG.replace(**cfg), keypoint_params={}, detector_params={}, verbose_init=False)
    jm._det_runner = lambda g, hw: jax.jit(lambda x: _det_rows(_fid(x, jnp), jnp))
    jm._kp_runner = lambda g, hw: (lambda x: jnp.tile(jnp.asarray(kp_packed)[None], (x.shape[0], 1, 1)))
    want = jm.get_coordinates(frames, 8, verbose=False, **kw)

    def model(**extra):
        m = _model(**cfg, **extra)
        m.run_detector = lambda x, g, hw, timer=None: torch.from_numpy(_det_rows(_fid(x.numpy(), np), np))
        m.run_keypoints = lambda x, g, hw: torch.from_numpy(np.tile(kp_packed, (len(x), 1, 1)))
        return m

    m = model()
    assert m._prescale_plan(m._geometry((360, 640)), (360, 640)) == ("canvas_planes", True)
    got = m.get_coordinates(frames, 8, **kw)
    assert_coords_match(got, want, boundary_atol=5e-3)
    assert all(len(fr["Keypoints"]) >= 4 for fr in got.values())
    assert m.get_coordinates(frames, 8, prescaled=m.prescale_clip(frames), **kw) == got
    dev = model(prescale="device").get_coordinates(frames, 8, **kw)
    assert sorted(dev) == sorted(got) and all(len(fr["Keypoints"]) >= 4 for fr in dev.values())
