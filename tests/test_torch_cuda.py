"""PyTorch port on the card: the CUDA flow kernel against its plain
version, its input checks and its launch count.

The machine with the card has no JAX, so this file imports nothing of
JAX or of the JAX package, and runs without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: status bit-equal; positions
within 1e-2 px on tracked points (the bar tests/test_pallas_flow.py sets
between the JAX package's two flow engines)."""

import numpy as np
import pytest
import torch

from eagle_tpu_torch.ops import optical_flow as of

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _frames(hw=(544, 960), pan=3, seed=0):
    """Two uint8 BGR frames of smoothed noise, the second panned ``pan`` px
    left and 1 px up."""
    from scipy.ndimage import gaussian_filter

    h, w = hw
    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.normal(size=(h + 8, w + 8, 3)), (2.0, 2.0, 0))
    tex = np.clip(128 + 40 * tex / tex.std(), 0, 255).astype(np.uint8)
    return tex[4 : 4 + h, 4 : 4 + w], tex[5 : 5 + h, 4 + pan : 4 + pan + w]


def _points(k, hw=(544, 960), seed=1):
    h, w = hw
    border = np.array([[0, 0], [w - 1, h - 1], [2.5, h / 2], [w - 3, 7.25], [w / 2, h - 1.5]], np.float32)
    rand = np.random.default_rng(seed).uniform([0, 0], [w - 1, h - 1], (max(0, k - len(border)), 2))
    return np.concatenate([border, rand]).astype(np.float32)[:k]


@pytest.mark.parametrize("k", [1, 57, 240])
def test_kernel_matches_plain(dev, k):
    prev, curr = (torch.from_numpy(f).to(dev) for f in _frames())
    pts = torch.from_numpy(_points(k)).to(dev)
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    valid[k // 2] = False
    before = of.launches
    kp, ks = of.lk_flow(prev, curr, pts, valid)
    pp, ps = of.lk_flow_plain(prev, curr, pts, valid)
    torch.cuda.synchronize()
    assert of.launches == before + 1
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ks, ps)
    assert ps.sum() >= (k - 1) // 2
    np.testing.assert_allclose(kp.cpu().numpy()[ps], pp.cpu().numpy()[ps], atol=1e-2)


def test_kernel_checks_its_inputs(dev):
    prev, curr = (torch.from_numpy(f).to(dev) for f in _frames())
    pts = torch.from_numpy(_points(8)).to(dev)
    side = of.roi_side(*prev.shape[:2])
    origin = of.roi_origins(pts, *prev.shape[:2], side, 2)
    pyr = of.roi_pyramids(prev, curr, origin, side, 2)
    before = of.launches
    with pytest.raises(ValueError, match="CUDA"):
        of.lk_flow_engine_cuda(pyr.cpu(), origin.cpu(), pts.cpu(), side, 2)
    with pytest.raises(ValueError, match="odd window"):
        of.lk_flow_engine_cuda(pyr, origin, pts, side, 2, window=16)
    with pytest.raises(ValueError, match="pyramid"):
        of.lk_flow_engine_cuda(pyr[:-1], origin, pts, side, 2)
    assert of.launches == before

