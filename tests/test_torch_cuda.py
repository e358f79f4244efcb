"""PyTorch port on the card: the fused CUDA flow kernel against its plain
version (frames whose rows are not whole 16-byte chunks included, and the
features GMC's 240 grid corners of a frame pair), its one launch a call,
its input checks and its launch count.

The machine with the card has no JAX, so this file imports nothing of
JAX or of the JAX package, and runs without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: status bit-equal; positions
within 1e-2 px on tracked points (the bar tests/test_pallas_flow.py sets
between the JAX package's two flow engines)."""

import json

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
    return np.ascontiguousarray(tex[4 : 4 + h, 4 : 4 + w]), np.ascontiguousarray(tex[5 : 5 + h, 4 + pan : 4 + pan + w])


def _points(k, hw=(544, 960), seed=1):
    h, w = hw
    border = np.array([[0, 0], [w - 1, h - 1], [2.5, h / 2], [w - 3, 7.25], [w / 2, h - 1.5]], np.float32)
    rand = np.random.default_rng(seed).uniform([0, 0], [w - 1, h - 1], (max(0, k - len(border)), 2))
    return np.concatenate([border, rand]).astype(np.float32)[:k]


def _case(dev, k, hw=(544, 960)):
    prev, curr = (torch.from_numpy(f).to(dev) for f in _frames(hw))
    pts = torch.from_numpy(_points(k, hw)).to(dev)
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    valid[k // 2] = False
    return prev, curr, pts, valid


# 544x960: the working canvas (K = 57 keypoints, 240 features-GMC
# corners); 720x1280: raw frames on the identity geometry; 100x160: a frame
# whose ROI side (100) is under 192, so the TMA boxes run past the ROI and,
# for ROIs at the right edge, past the frame; 100x148 and 480x854: rows of
# 444 and 2562 bytes, not whole 16-byte chunks, staged into pitched buffers
@pytest.mark.parametrize(
    "hw,k",
    [((544, 960), 1), ((544, 960), 57), ((544, 960), 240), ((720, 1280), 57), ((100, 160), 57),
     ((100, 148), 57), ((480, 854), 57)],
)
def test_kernel_matches_plain(dev, hw, k):
    prev, curr, pts, valid = _case(dev, k, hw)
    before = of.launches
    kp, ks = of.lk_flow(prev, curr, pts, valid)
    pp, ps = of.lk_flow_plain(prev, curr, pts, valid)
    torch.cuda.synchronize()
    assert of.launches == before + 1
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ks, ps)
    assert ps.sum() >= (k - 1) // 2
    np.testing.assert_allclose(kp.cpu().numpy()[ps], pp.cpu().numpy()[ps], atol=1e-2)


def test_one_device_kernel_per_call(dev, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    prev, curr, pts, valid = _case(dev, 57)
    of.lk_flow(prev, curr, pts, valid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        of.lk_flow(prev, curr, pts, valid)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert [e["cat"] for e in ops] == ["kernel"], [e["name"] for e in ops]
    assert "lk_flow_fused" in ops[0]["name"]


def test_kernel_checks_its_inputs(dev):
    prev, curr, pts, valid = _case(dev, 8)
    before = of.launches
    with pytest.raises(ValueError, match="CUDA"):
        of.lk_flow_cuda(prev.cpu(), curr.cpu(), pts.cpu(), valid.cpu())
    with pytest.raises(ValueError, match="prev_bgr"):  # frames on another device than the points
        of.lk_flow_cuda(prev.cpu(), curr, pts, valid)
    with pytest.raises(ValueError, match="pts"):
        of.lk_flow_cuda(prev, curr, pts.double(), valid)
    with pytest.raises(ValueError, match="valid"):
        of.lk_flow_cuda(prev, curr, pts, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="curr_bgr"):
        of.lk_flow_cuda(prev, curr.float(), pts, valid)
    with pytest.raises(ValueError, match="pts"):
        of.lk_flow_cuda(prev, curr, torch.zeros(8, 3, device=dev), valid)
    with pytest.raises(ValueError, match="curr_bgr"):
        of.lk_flow_cuda(prev, curr[:-1], pts, valid)
    with pytest.raises(ValueError, match="curr_bgr"):  # not contiguous
        of.lk_flow_cuda(prev, curr.transpose(0, 1).contiguous().transpose(0, 1), pts, valid)
    with pytest.raises(ValueError, match="odd window"):
        of.lk_flow_cuda(prev, curr, pts, valid, window=16)
    assert of.launches == before


def test_kernel_stages_a_frame_off_the_16_byte_grid(dev):
    """A frame whose base address is not a multiple of 16 bytes (a view one
    byte into a buffer) is copied into an aligned buffer and tracks as the
    plain version does."""
    prev, curr, pts, valid = _case(dev, 57)
    flat = torch.empty(prev.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = flat[1:].view(prev.shape)
    shifted.copy_(prev)
    assert shifted.data_ptr() % 16
    before = of.launches
    kp, ks = of.lk_flow(shifted, curr, pts, valid)
    pp, ps = of.lk_flow_plain(prev, curr, pts, valid)
    torch.cuda.synchronize()
    assert of.launches == before + 1
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ks, ps)
    np.testing.assert_allclose(kp.cpu().numpy()[ps], pp.cpu().numpy()[ps], atol=1e-2)


@pytest.mark.parametrize("hw", [(100, 148), (480, 854)])
def test_kernel_reads_uploaded_padded_frames_in_place(dev, hw):
    """Frames of ``upload_frames`` whose 3W-byte rows are off the 16-byte
    grid are views of a row-padded buffer: the wrapper hands them to the
    kernel without a copy, and they track as the plain version does on
    contiguous copies."""
    prev_np, curr_np = _frames(hw)
    up = of.upload_frames(np.stack([prev_np, curr_np]), dev)
    assert not up.is_contiguous() and up.stride(1) % 16 == 0
    assert of._pitched(up[1])[0].data_ptr() == up[1].data_ptr()
    pts = torch.from_numpy(_points(57, hw)).to(dev)
    valid = torch.ones(57, dtype=torch.bool, device=dev)
    before = of.launches
    kp, ks = of.lk_flow(up[0], up[1], pts, valid)
    pp, ps = of.lk_flow_plain(up[0].contiguous(), up[1].contiguous(), pts, valid)
    torch.cuda.synchronize()
    assert of.launches == before + 1
    np.testing.assert_array_equal(up.cpu().numpy(), np.stack([prev_np, curr_np]))
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ks, ps)
    np.testing.assert_allclose(kp.cpu().numpy()[ps], pp.cpu().numpy()[ps], atol=1e-2)


@pytest.mark.parametrize("canvas", [False, True])
def test_kernel_matches_plain_on_grid_corners(dev, canvas):
    """The features GMC's flow step: the 240 grid corners of a 1280x720
    frame pair, on the raw frames as the identity path uploads them or on
    the 544x960 canvas of the 4:2:0 prescale and decode.  Neither frame is
    staged into a pitched copy, and the launch counts as one at K = 240."""
    from eagle_tpu_torch.ops.corners import grid_corners
    from eagle_tpu_torch.ops.preprocess import compute_work_geometry, host_letterbox_i420, i420_to_bgr

    frames = np.stack(_frames((720, 1280)))
    if canvas:
        geom = compute_work_geometry((720, 1280), 960)
        x = i420_to_bgr(torch.from_numpy(host_letterbox_i420(frames, geom)).to(dev))
        assert x.shape[1:3] == (544, 960)
    else:
        x = of.upload_frames(frames, dev)
    prev, curr = x[0], x[1]
    assert all(of._pitched(f)[0].data_ptr() == f.data_ptr() for f in (prev, curr))
    pts, valid = grid_corners(prev)
    assert pts.shape == (240, 2) and int(valid.sum()) >= 100
    before = of.launches_by_k.get(240, 0)
    kp, ks = of.lk_flow(prev, curr, pts, valid)
    pp, ps = of.lk_flow_plain(prev, curr, pts, valid)
    torch.cuda.synchronize()
    assert of.launches_by_k.get(240, 0) == before + 1
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ks, ps)
    assert ps.sum() >= 100
    np.testing.assert_allclose(kp.cpu().numpy()[ps], pp.cpu().numpy()[ps], atol=1e-2)
