"""PyTorch port, keypoint model: HRNet-W48 (weights carried over by the
bridge) and the heatmap decode against the JAX package.

Tolerances: float32 heatmaps within 2e-4 (the bar tests/test_hrnet.py
sets for the JAX model against its torch reference); decoded keypoint
slots (pixel coordinates and validity) bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models import hrnet as jh
from eagle_tpu.ops.heatmap import decode_heatmaps as jdecode
from eagle_tpu_torch.models import hrnet as th
from eagle_tpu_torch.models.bridge import flatten_params, hrnet_from_jax
from eagle_tpu_torch.ops.heatmap import decode_heatmaps

from .torch_parity import n, spread_params, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return spread_params(jax.eval_shape(lambda: jh.init_params(jax.random.key(0))), np.random.default_rng(0))


@pytest.fixture(scope="module")
def outputs(params):
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jh.apply)(params, jnp.asarray(x)))
    model = hrnet_from_jax(params).eval()
    with torch.no_grad():
        got = n(model(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    return want, got


def test_bridge_maps_every_parameter(params):
    sd = flatten_params(params)
    model = th.HRNet()
    assert set(sd) == set(model.state_dict())
    assert sd["stem.conv1.w"].shape == (64, 3, 3, 3)  # HWIO -> OIHW


def test_forward_matches_jax_f32(outputs):
    want, got = outputs
    assert got.shape == want.shape == (2, 16, 24, 57)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_decode_of_model_output_bit_equal(outputs):
    want, got = outputs
    kj, vj = jdecode(jnp.asarray(want), 0.3, (540, 960))
    kt, vt = decode_heatmaps(t(got).permute(0, 3, 1, 2), 0.3, (540, 960))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    np.testing.assert_array_equal(n(kt)[..., :2], np.asarray(kj)[..., :2])
    assert n(vt).sum() > 20


def test_decode_semantics_bit_equal():
    """Planted ties: the first maximum wins inside a map, same-pixel
    duplicates keep the higher score (the larger label on equal scores)."""
    rng = np.random.default_rng(2)
    hm = (rng.uniform(size=(2, 18, 30, 57)) * 0.8).astype(np.float32)
    hm[0, 5, 7, 10] = 0.9
    hm[0, 5, 7, 20] = 0.95
    hm[0, 2, 3, 30] = hm[0, 2, 3, 31] = 0.97  # equal score, same pixel
    hm[0, 9, 9, 40] = hm[0, 11, 12, 40] = 0.99  # two maxima in one map
    hm[1, :, :, 3] = 0.001  # below the floor
    kj, vj = jdecode(jnp.asarray(hm), 0.3, (540, 960))
    kt, vt = decode_heatmaps(t(hm).permute(0, 3, 1, 2), 0.3, (540, 960))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    np.testing.assert_array_equal(n(kt), np.asarray(kj))


def test_upsample_align_corners_matches_jax():
    x = np.random.default_rng(3).normal(size=(1, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jh.upsample_align_corners(jnp.asarray(x), (9, 13)))
    got = n(th.upsample_align_corners(t(x).permute(0, 3, 1, 2), (9, 13)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bf16_forward_runs_and_returns_float32(params):
    model = hrnet_from_jax(params, use_bf16=True).eval()
    with torch.no_grad():
        y = model(torch.zeros(1, 3, 32, 32))
    assert y.dtype == torch.float32 and y.shape == (1, 57, 8, 8)
