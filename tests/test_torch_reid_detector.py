"""PyTorch port, ReID on the working-resolution path: the built-in
detector's rows with their appearance embeddings, ``run_detector``'s
(B, D, 7 + E), against the JAX package's detector program on the same
uploaded canvas.  The boxes are clipped in original pixels, then mapped to
canvas pixels (``b * gain + pad``) and cropped from the canvas; only the
first ``reid_slots`` slots are embedded.

Reduced models as in tests/test_torch_coordinate_model.py (YOLOv8-m at a
160-px canvas, float32), OSNet-x0.25 with 32-d embeddings.  Tolerances:
valid masks and classes equal; boxes within 1e-2 px and scores within 1e-4
(the detector's float32 bars); embeddings within 1e-3 (the JAX package's
crops are one-hot matmuls, the port's a gather)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .test_torch_coordinate_model import _bridged_params, _reduced_cfg
from .torch_parity import n, osnet_params

torch.set_num_threads(2)


def _cfg(base):
    """The reduced models; a keypoint input that fits the letterboxed image
    (the keypoint model does not run here)."""
    cfg = _reduced_cfg(base)
    return cfg.replace(
        keypoint=dataclasses.replace(cfg.keypoint, input_hw=(64, 128)),
        tracker=dataclasses.replace(cfg.tracker, use_appearance=True, embed_dim=32, reid_slots=8),
    )


def test_run_detector_embeddings_match_jax_on_the_canvas():
    """640x352 frames: a 160x88 image letterboxed into a 160x96 canvas, so
    the boxes move by the gain and the padding."""
    sc = make_scene(num_frames=4, width=640, height=352, num_players=6, fps=8, seed=12)
    kp_params, det_params = _bridged_params()
    reid = osnet_params(11, feature_dim=32)
    model = TModel(config=_cfg(TCFG), keypoint_params=kp_params, detector_params=det_params, reid_params=reid,
                   device="cpu")
    img_hw = sc.frames.shape[1:3]
    geom = model._geometry(img_hw)
    assert geom.enabled and (geom.pad_x or geom.pad_y)
    x = model.upload(sc.frames[:4], geom)
    got = n(model.run_detector(x, geom, img_hw))

    jmodel = JModel(config=_cfg(JCFG), keypoint_params=kp_params, detector_params=det_params, reid_params=reid,
                    verbose_init=False)
    jgeom = jmodel._geometry(img_hw)
    assert dataclasses.asdict(jgeom) == dataclasses.asdict(geom)
    want = np.asarray(jmodel._det_runner(jgeom, img_hw)(jnp.asarray(n(x))))

    assert got.shape == want.shape == (4, 128, 7 + 32)
    valid = want[..., 6] > 0.5
    np.testing.assert_array_equal(got[..., 6] > 0.5, valid)
    assert valid[:, :8].sum() >= 8, "embedded slots must hold detections"
    np.testing.assert_array_equal(got[..., 5][valid], want[..., 5][valid])
    np.testing.assert_allclose(got[..., :4][valid], want[..., :4][valid], atol=1e-2)
    np.testing.assert_allclose(got[..., 4][valid], want[..., 4][valid], atol=1e-4)
    np.testing.assert_allclose(got[:, :8, 7:], want[:, :8, 7:], atol=1e-3)
    assert not got[:, 8:, 7:].any() and not want[:, 8:, 7:].any(), "slots past reid_slots are zeros"
