"""PyTorch port, ReID: the OSNet module, its two weight loaders, the crop
embedder and the histogram embedder against the JAX package.

Tolerances, all in float32 on the CPU:
- OSNet embeddings (L2-normalised, 512-d) within 1e-4 absolute of JAX
  ``osnet.apply`` on the same weights (bridged from the JAX pytree, or
  loaded from a torchreid state dict by both packages): the convolutions
  sum in another order;
- ``embed_boxes`` within 1e-3: the JAX package resamples the crops with
  one-hot interpolation matmuls (``matmul_crops``), the port with a gather
  at the same sample positions, which agree to ~1e-4 of a pixel;
- histograms within 1e-6: the same hard bins of the same crops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models import osnet as josnet
from eagle_tpu.ops import embed as jembed
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.models import osnet as tosnet
from eagle_tpu_torch.models.bridge import osnet_from_jax
from eagle_tpu_torch.ops import embed as tembed

from .torch_graphs import OSNetTorch, randomize_
from .torch_parity import n, osnet_params, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return osnet_params(3)


def _inputs(shape, seed):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 64, 32, 3), (4, 256, 128, 3)])
def test_osnet_matches_jax(params, shape):
    x = _inputs(shape, 0)
    want = np.asarray(josnet.apply(params, jnp.asarray(x)))
    model = osnet_from_jax(params).eval()
    with torch.no_grad():
        got = n(model(t(x).permute(0, 3, 1, 2).contiguous()))
    assert got.shape == (shape[0], 512)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(want).max() > 0.05 and np.abs(want[0] - want[1]).max() > 1e-3


def test_osnet_torchreid_loader_matches_jax():
    """A torchreid OSNet-x0.25 state dict (tests/torch_graphs.py) through the
    port's loader and through the JAX package's converter."""
    ref = randomize_(OSNetTorch("x0_25"), seed=4)
    sd = ref.state_dict()
    x = _inputs((2, 256, 128, 3), 1)
    want = np.asarray(josnet.apply(josnet.osnet_from_torch(sd), jnp.asarray(x)))
    model = tosnet.osnet_from_torch(sd).eval()
    with torch.no_grad():
        got = n(model(t(x).permute(0, 3, 1, 2).contiguous()))
        graph = n(ref(t(x).permute(0, 3, 1, 2).contiguous()))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, graph, atol=1e-4)


def test_init_osnet_is_seeded():
    a, b = tosnet.init_osnet(5, feature_dim=32), tosnet.init_osnet(5, feature_dim=32)
    c = tosnet.init_osnet(6, feature_dim=32)
    x = torch.from_numpy(_inputs((2, 3, 64, 32), 2))
    with torch.no_grad():
        ea, eb, ec = a(x), b(x), c(x)
    assert ea.shape == (2, 32)
    torch.testing.assert_close(ea, eb, rtol=0, atol=0)
    assert (ea - ec).abs().max() > 1e-3
    np.testing.assert_allclose(n(torch.linalg.vector_norm(ea, dim=-1)), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=2, width=320, height=192, num_players=4, fps=8, seed=7)


def _boxes(scene, integer: bool):
    b = scene.player_boxes[:2, :3].astype(np.float32)  # (2 frames, 3 boxes, 4)
    if integer:
        return np.round(b)
    return b + np.float32(0.37)


@pytest.mark.parametrize("integer", [False, True])
def test_embed_boxes_matches_jax(params, scene, integer):
    boxes = _boxes(scene, integer)
    want = np.asarray(josnet.embed_boxes(params, jnp.asarray(scene.frames[:2]), jnp.asarray(boxes), use_bf16=False))
    model = osnet_from_jax(params).eval()
    with torch.no_grad():
        got = n(tosnet.embed_boxes(model, t(scene.frames[:2]), t(boxes)))
    assert got.shape == (2, 3, 512)
    np.testing.assert_allclose(got, want, atol=1e-3)


def _noise_frames(seed: int = 8):
    """Two smoothed-noise colour frames: no uniform regions, so no crop
    pixel's hue, saturation or value lies on a histogram bin edge."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.normal(size=(2, 192, 320, 3)), (0, 2.0, 2.0, 0))
    return np.clip(128 + 60 * tex / tex.std(), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("integer", [False, True])
def test_histogram_embeddings_match_jax(scene, integer):
    frames = _noise_frames()
    boxes = _boxes(scene, integer).reshape(-1, 4)
    fi = np.repeat(np.arange(2, dtype=np.int32), 3)
    want = np.asarray(jembed.histogram_embeddings(jnp.asarray(frames), jnp.asarray(fi), jnp.asarray(boxes)))
    got = n(tembed.histogram_embeddings(t(frames), t(fi), t(boxes)))
    assert got.shape == (6, 64) and (got > 0).sum(1).min() >= 8
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_histogram_bins_on_edges_follow_the_jax_crops(scene):
    """make_scene's grass has hue 56.25, exactly on a hue-bin edge, so its
    bin follows the last bit of the resampled pixel.  The port's crops are
    bit-equal to the JAX package's ``gather_crops`` run on its own, and its
    histograms to those crops binned in numpy.  (Inside the jitted
    ``histogram_embeddings`` XLA fuses the gather into the binning and may
    round those pixels otherwise: ROADMAP.md Queue 3.)"""
    from eagle_tpu.ops import color as jcolor
    from eagle_tpu.ops import kmeans as jkmeans
    from eagle_tpu_torch.ops import kmeans as tkmeans

    boxes = _boxes(scene, False).reshape(-1, 4)
    fi = np.repeat(np.arange(2, dtype=np.int32), 3)
    crops = np.asarray(jkmeans.gather_crops(jnp.asarray(scene.frames[:2]), jnp.asarray(fi), jnp.asarray(boxes),
                                            grid_hw=(32, 16)))
    got_crops = n(tkmeans.gather_crops(t(scene.frames[:2]), t(fi), t(boxes), grid_hw=(32, 16)))
    np.testing.assert_array_equal(got_crops, crops)
    hsv = np.asarray(jcolor.bgr_to_hsv(jnp.asarray(crops)))
    assert (hsv[..., 0] == 56.25).sum() > 100, "the grass lies on a bin edge"
    hb = np.clip((hsv[..., 0] / 180.0 * 16).astype(np.int64), 0, 15)
    sb = np.clip((hsv[..., 1] / 256.0 * 2).astype(np.int64), 0, 1)
    vb = np.clip((hsv[..., 2] / 256.0 * 2).astype(np.int64), 0, 1)
    flat = ((hb * 2 + sb) * 2 + vb).reshape(len(crops), -1)
    hist = np.stack([np.bincount(f, minlength=64) for f in flat]).astype(np.float32)
    want = hist / np.linalg.norm(hist, axis=-1, keepdims=True)
    np.testing.assert_allclose(n(tembed.histogram_embeddings(t(scene.frames[:2]), t(fi), t(boxes))), want, atol=1e-6)
