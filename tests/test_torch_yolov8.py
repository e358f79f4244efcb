"""PyTorch port, detector: YOLOv8 (weights carried over by the bridge)
and class-aware NMS against the JAX package.

Tolerances: float32 boxes within 2e-4 relative (pixel-scale values) and
scores within 2e-4 (the bar of tests/test_hrnet.py); NMS slots, their
order, classes and validity bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models import yolov8 as jy
from eagle_tpu.ops.nms import batched_nms as jnms
from eagle_tpu.ops.nms import box_iou_matrix as jiou
from eagle_tpu_torch.models import yolov8 as ty
from eagle_tpu_torch.models.bridge import infer_yolov8_variant, yolov8_from_jax
from eagle_tpu_torch.ops.nms import batched_nms, box_iou_matrix

from .torch_parity import n, spread_params, t

torch.set_num_threads(2)


@pytest.mark.parametrize("variant", ["n", "s", "l"])
def test_variant_inference(variant):
    p = jax.eval_shape(lambda: jy.init_params(jax.random.key(0), variant=variant))
    assert infer_yolov8_variant(p) == variant


def test_forward_matches_jax_f32():
    shapes = jax.eval_shape(lambda: jy.init_params(jax.random.key(1), variant="n"))
    params = spread_params(shapes, np.random.default_rng(1), gain=1.0)
    x = np.random.default_rng(0).uniform(size=(2, 64, 96, 3)).astype(np.float32)
    bj, sj = jax.jit(jy.apply)(params, jnp.asarray(x))
    model = yolov8_from_jax(params).eval()
    assert model.variant == "n"
    with torch.no_grad():
        bt, st = model(t(x).permute(0, 3, 1, 2))
    assert bt.shape == bj.shape and st.shape == sj.shape
    np.testing.assert_allclose(n(bt), np.asarray(bj), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(n(st), np.asarray(sj), atol=2e-4)


def _nms_inputs(rng, nb=3, na=700, nc=5):
    """Clustered boxes (overlaps to suppress), a spread of confidences
    with exact ties, some below the floor."""
    centers = rng.uniform(20, 300, (nb, na // 7, 2)).repeat(7, axis=1)
    centers = centers + rng.normal(0, 3, centers.shape)
    wh = rng.uniform(8, 40, (nb, na, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (nb, na, nc)).astype(np.float32) ** 3
    scores[:, ::50] = np.round(scores[:, ::50], 1)  # exact ties
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_slots_bit_equal(seed):
    boxes, scores = _nms_inputs(np.random.default_rng(seed))
    kw = dict(conf_threshold=0.15, iou_threshold=0.7, max_det=128, pre_topk=512)
    want = [np.asarray(a) for a in jnms(jnp.asarray(boxes), jnp.asarray(scores), **kw)]
    got = [n(a) for a in batched_nms(t(boxes), t(scores), **kw)]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].sum(1).min() > 10
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_nms_empty_and_overflow():
    rng = np.random.default_rng(3)
    boxes, scores = _nms_inputs(rng, nb=2, na=420)
    scores[0] = 0.01  # nothing above the floor
    wide = np.tile(np.array([[0, 0, 4, 4]], np.float32), (420, 1)) + 10 * np.arange(420)[:, None]
    boxes[1] = wide  # disjoint boxes: more than max_det survive
    kw = dict(conf_threshold=0.15, iou_threshold=0.7, max_det=64, pre_topk=256)
    want = [np.asarray(a) for a in jnms(jnp.asarray(boxes), jnp.asarray(scores), **kw)]
    got = [n(a) for a in batched_nms(t(boxes), t(scores), **kw)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[3][0].sum() == 0 and got[3][1].sum() == 64


def test_box_iou_matrix():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 50, (6, 2))
    a = np.concatenate([a, a + rng.uniform(1, 20, (6, 2))], -1).astype(np.float32)
    b = np.concatenate([a[:3] + 2, a[:3] + 9], -1)[:, [0, 1, 6, 7]].astype(np.float32)
    np.testing.assert_allclose(n(box_iou_matrix(t(a), t(b))), np.asarray(jiou(jnp.asarray(a), jnp.asarray(b))), atol=1e-7)


def test_seeded_init_shapes():
    model = ty.init_yolov8(seed=1, variant="n")
    with torch.no_grad():
        boxes, scores = model(torch.zeros(1, 3, 64, 96))
    assert boxes.shape == (1, 8 * 12 + 4 * 6 + 2 * 3, 4) and scores.shape[-1] == 5
    assert float(scores.max()) < 0.1  # class bias -4: nothing detected
