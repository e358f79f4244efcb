"""PyTorch port, NMS past 1024 candidates and the detector's box mapping,
against the JAX package.

- ``batched_nms`` at ``pre_topk`` 2048 and 4096 on detector outputs with
  thousands of valid, clustered boxes (``kernel_cases.nms_wide_case``),
  two images: slots, boxes, scores, classes and valid bit-equal to the
  JAX ``batched_nms``.  On the card the same call runs the NMS kernel at
  that width (``tests/test_torch_cuda.py``).
- ``CoordinateModel.run_detector`` against the JAX package's detector
  program (``_det_runner``) on identical detector outputs: the JAX
  module's ``yolov8.apply`` and the port's ``detector_model`` both return
  the same seeded (boxes, scores), and both run their real NMS and their
  real map to original pixels.  The rows and the ReID crop boxes (read by
  patching both packages' embedders to return the boxes they are given)
  are bit-equal at gains 0.75 (1280x720), 1.5 (640x360), 0.5 (1920x1080)
  and 2/3 (1440x1080).
- The arithmetic XLA compiles for that map, on values that tell the
  candidates apart: a division by the compile-time gain is a product with
  the float32 reciprocal, and ``b * gain + pad`` is one fused
  multiply-add; ``temporal._WorkMap``, which ``run_detector`` maps with,
  computes both bit for bit.

Tolerances: bit-equal everywhere.  Each ``pre_topk`` and each geometry is
one XLA compile of the JAX function."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.models import yolov8 as jy
from eagle_tpu.ops.nms import batched_nms as jbatched_nms
from eagle_tpu.ops.preprocess import compute_work_geometry as jgeometry
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.ops.nms import batched_nms
from eagle_tpu_torch.ops.preprocess import compute_work_geometry as tgeometry
from eagle_tpu_torch.pipeline import temporal as tt
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.utils.kernel_cases import nms_wide_case

from .torch_parity import n, t

torch.set_num_threads(2)


@pytest.mark.parametrize("pre_topk", [2048, 4096])
def test_batched_nms_past_1024_candidates_bit_equal_to_jax(pre_topk):
    boxes, scores = nms_wide_case(pre_topk + 500, b=2, seed=pre_topk)
    kw = dict(conf_threshold=0.15, iou_threshold=0.7, max_det=128, pre_topk=pre_topk)
    want = [np.asarray(a) for a in jbatched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)]
    got = [n(a) for a in batched_nms(t(boxes), t(scores), **kw)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ((scores.max(-1) > 0.15).sum(1) > 1500).all(), "thousands of valid candidates"
    assert (got[3].sum(1) == 128).all()


def _config(base):
    """The detector's NMS and mapping as the main path runs them; ReID on
    with the histogram embedder, whose embedding step both packages'
    tests replace with the crop boxes it is given."""
    return base.replace(
        detector=dataclasses.replace(base.detector, variant="medium", use_bf16=False),
        tracker=dataclasses.replace(base.tracker, use_appearance=True, embedder="histogram", embed_dim=64),
    )


def _detector_outputs(geom, seed, na=3000):
    """Seeded (boxes (2, na, 4), scores (2, na, classes)) in canvas pixels."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform([0, 0], [geom.canvas_w, geom.canvas_h], (2, na, 2))
    wh = rng.uniform(4, 80, (2, na, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = (rng.uniform(0, 1, (2, na, JCFG.detector.num_classes)) ** 4).astype(np.float32)
    return boxes, scores


@pytest.fixture(scope="module")
def models():
    jm = JModel(config=_config(JCFG), keypoint_fn=lambda b: None, detector_params={}, verbose_init=False)
    tm = TModel(config=_config(TCFG), keypoint_fn=lambda b: None, device="cpu")
    jm._compute_embeddings = lambda x, boxes: boxes
    tm.embed = lambda x, boxes: boxes
    return jm, tm


@pytest.mark.parametrize("hw", [(720, 1280), (360, 640), (1080, 1920), (1080, 1440)])
def test_detector_rows_bit_equal_to_jax(models, monkeypatch, hw):
    jm, tm = models
    jg, tg = jgeometry(hw, JCFG.detector.image_size), tgeometry(hw, TCFG.detector.image_size)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    boxes, scores = _detector_outputs(tg, seed=hw[1])
    monkeypatch.setattr(jy, "apply", lambda params, imgs, **kw: (jnp.asarray(boxes), jnp.asarray(scores)))
    monkeypatch.setattr(tm, "detector_model", lambda imgs: (torch.from_numpy(boxes), torch.from_numpy(scores)))
    x = np.zeros((2, tg.canvas_h, tg.canvas_w, 3), np.uint8)
    want = np.asarray(jm._det_runner(jg, hw)(jnp.asarray(x)))
    got = n(tm.run_detector(t(x), tg, hw))
    assert got.shape == want.shape == (2, TCFG.detector.max_detections, 11)
    np.testing.assert_array_equal(got[..., :7], want[..., :7])  # boxes in original pixels, conf, class, valid
    np.testing.assert_array_equal(got[..., 7:], want[..., 7:])  # the ReID crop boxes on the canvas
    assert want[..., 6].sum() == 2 * TCFG.detector.max_detections


@pytest.mark.parametrize("gain,pad", [(0.75, 2.0), (1.5, 2.0), (2 / 3, 8.0)])
def test_box_map_is_the_arithmetic_xla_compiles(gain, pad):
    g = np.float32(gain)
    b = np.random.default_rng(0).uniform(0, 1300, (100000, 2)).astype(np.float32)
    pad2 = np.array([0.0, pad], np.float32)
    wmap = tt._WorkMap(torch.tensor(g), torch.tensor(np.float32(1) / g), t(pad2))
    orig = np.asarray(jax.jit(lambda v: (v - jnp.asarray(pad2)) / jnp.float32(g))(jnp.asarray(b)))
    canvas = np.asarray(jax.jit(lambda v: v * jnp.float32(g) + jnp.asarray(pad2))(jnp.asarray(b)))
    np.testing.assert_array_equal(n(wmap.to_orig(t(b))), orig)
    np.testing.assert_array_equal(n(wmap.to_frame(t(b))), canvas)
    # the candidates differ on these values: a true division and an unfused multiply-add
    assert (((b - pad2) / g).astype(np.float32) != orig).sum() > 1000
    assert ((b * g + pad2) != canvas).sum() > 10
