"""PyTorch port on the card: the fused CUDA flow kernel against its plain
version (frames whose rows are not whole 16-byte chunks included, and the
features GMC's 240 grid corners of a frame pair), its one launch a call,
its input checks and its launch count; its clip-batched launch (C frame
pairs in one launch) against C single launches and the plain version; the
one-shot run's peak device memory against its length; the JV assignment
kernel (``csrc/lap_jv.cu``, one warp a matrix) against its plain version
at every boundary of its columns a lane, on both of its paths (the cost
staged in shared memory, or read from global memory) and at their edge,
in its shared-memory-vector instantiation (n > 1024), on matrices whose
-0.0 and +0.0 tie, its batched launch, all-inf matrices, its input
checks, and ``masked_assignment`` on the card without a host sync; the
auction kernel (``csrc/auction.cu``, one block a matrix) and the NMS
kernel (``csrc/nms.cu``: the overlap bits over the card, the fixed point
in a block an image) against their plain versions (matches and round
counts, keep masks) on the cases of
``eagle_tpu_torch/utils/kernel_cases.py``, at the round cap and at 0, 1, 4
and 11 rounds, on both auction paths, NMS at 1025 to 10,710 candidates,
as batched launches, with their input checks, and
``masked_auction`` / ``batched_nms`` on the card without a host sync; the
multi-device layer: a one-rank NCCL group's runner, gather, halo and
time-sharded scan, and gloo's host transport between two spawned ranks
sharing the card; the eval CLI's entry points: the default detector runner
at full width (one NMS launch a call, what ``run_detector`` gives) and
``evaluate.run`` with oracle runners (perfect metrics); the CLI from an
.mp4 (``main.main --video_path``) with oracle runners of the port's
synthetic scene: the card's four files against the CPU run's (within 1 px
and 1 m, as ``chip_smoke.py``'s cli phase holds them; the team mapping
equal).

The machine with the card has no JAX, so this file imports nothing of
JAX or of the JAX package, and runs without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips, but the one that checks that the eval
CLI refuses to run on the CPU unasked.  Tolerances: status bit-equal; positions
within 1e-2 px on tracked points (the bar tests/test_pallas_flow.py sets
between the JAX package's two flow engines); assignments, round counts
and keep masks bit-equal."""

import json

import numpy as np
import pytest
import torch

from eagle_tpu_torch.ops import assignment as lap
from eagle_tpu_torch.ops import nms
from eagle_tpu_torch.ops import optical_flow as of
from eagle_tpu_torch.utils.kernel_cases import (
    ANCHORS,
    AUCTION_KINDS,
    NMS_KINDS,
    ROUND_CASES,
    auction_case,
    auction_round_case,
    nms_cases,
    nms_wide_case,
    suppress_inputs,
)
from eagle_tpu_torch.utils.lap_bench import lap_costs

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


def _panned_clip(n: int, hw=(120, 148), seed: int = 2):
    """(frames (n, H, W, 3) uint8: smoothed noise panned 1 px a frame,
    keypoint_fn, detector_fn) -- callables that know each frame by its
    content: six keypoints that pan with the texture and three drifting
    player boxes."""
    from scipy.ndimage import gaussian_filter

    h, w = hw
    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.normal(size=(h, w + n, 3)), (1.5, 1.5, 0))
    world = np.clip(128 + 60 * tex / tex.std(), 0, 255).astype(np.uint8)
    frames = np.ascontiguousarray(np.stack([world[:, t : t + w] for t in range(n)]))
    index = {f.tobytes(): t for t, f in enumerate(frames)}
    pts = rng.uniform([30, 20], [w + n - 30, h - 20], (6, 2)).astype(np.float32)

    def keypoint_fn(batch):
        ts = np.array([index[f.tobytes()] for f in batch])
        kp = np.zeros((len(ts), 57, 3), np.float32)
        kp[:, :6, :2] = np.trunc(pts[None] - np.stack([ts, np.zeros_like(ts)], -1)[:, None])
        kp[..., 2] = 0.9
        valid = np.zeros((len(ts), 57), bool)
        valid[:, :6] = (kp[:, :6, 0] > 5) & (kp[:, :6, 0] < w - 5)
        return kp, valid

    def detector_fn(batch):
        ts = np.array([index[f.tobytes()] for f in batch], np.float32)
        b = len(ts)
        boxes = np.zeros((b, 128, 4), np.float32)
        for k, x in enumerate((20.0, 60.0, 100.0)):
            boxes[:, k] = np.stack([x + 0.5 * ts, 40 + 0 * ts, x + 12 + 0.5 * ts, 70 + 0 * ts], -1)
        valid = np.zeros((b, 128), bool)
        valid[:, :3] = True
        return boxes, np.where(valid, 0.9, 0.0).astype(np.float32), np.zeros((b, 128), np.int32), valid

    return frames, keypoint_fn, detector_fn


def test_stream_on_the_card_equals_one_shot_without_staging(dev):
    """``stream_coordinates`` on the card, 148-px frames (444-byte rows, off
    the 16-byte grid, uploaded row-padded), segments 10 + 23 + 7 in blocks
    of 32 + 8: equal to the one-shot run on the card, the flow kernel
    launched at every step, and no frame staged into a pitched copy -- the
    frame handed across the block boundary keeps its buffer's pitch."""
    from eagle_tpu_torch.config import DEFAULT_CONFIG
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    frames, kp_fn, det_fn = _panned_clip(40)
    cfg = DEFAULT_CONFIG.replace(chunk_frames=16)
    one = CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda").get_coordinates(
        frames, 8, num_keypoint_detection=2)
    model = CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda")
    of.staged, launches = 0, of.launches
    blocks = list(model.stream_coordinates([frames[:10], frames[10:33], frames[33:]], 8, num_keypoint_detection=2,
                                           prefetch=False))
    torch.cuda.synchronize()
    assert [len(b) for b in blocks] == [32, 8]
    assert {k: v for b in blocks for k, v in b.items()} == one
    assert of.staged == 0
    assert of.launches - launches >= len(frames) - 1
    assert sum(len(fr["Keypoints"]) for fr in one.values()) > 4 * len(frames)


def _clip_buffer(dev, hw, n_clips: int, length: int, seed: int = 3):
    """``n_clips`` clips of ``length`` frames (smoothed noise panned 1-3 px a
    frame, another texture a clip) in one :func:`alloc_frames` buffer,
    viewed as (C, L, H, W, 3), as the multi-clip runner holds them."""
    buf = of.alloc_frames(n_clips * length, *hw, dev)
    for c in range(n_clips):
        for t in range(length):
            buf[c * length + t].copy_(torch.from_numpy(_frames(hw, pan=1 + c % 3, seed=seed + c)[min(t, 1)]))
    return buf.unflatten(0, (n_clips, length))


@pytest.mark.parametrize("hw,k", [((544, 960), 57), ((720, 1280), 240), ((480, 854), 57)])
def test_batched_launch_equals_single_launches_and_plain(dev, hw, k):
    """C = 4 frame pairs in one launch (frame 1 of each clip against frame
    0, rows padded at 854): every clip's points and status bit-equal to its
    single launch, and to the plain version (status bit-equal, positions
    within 1e-2 px); one launch counted at (C, K)."""
    clips = _clip_buffer(dev, hw, 4, 3)
    prev, curr = clips[:, 0], clips[:, 1]
    pts = torch.stack([torch.from_numpy(_points(k, hw, seed=10 + c)) for c in range(4)]).to(dev)
    valid = torch.ones(4, k, dtype=torch.bool, device=dev)
    valid[1, k // 3] = False
    before, staged = of.launches_by_ck.get((4, k), 0), of.staged
    g, s = of.lk_flow_clips(prev, curr, pts, valid)
    torch.cuda.synchronize()
    assert of.launches_by_ck[(4, k)] == before + 1
    for c in range(4):
        g1, s1 = of.lk_flow(prev[c], curr[c], pts[c], valid[c])
        assert torch.equal(g[c], g1) and torch.equal(s[c], s1), f"clip {c}"
        gp, sp = of.lk_flow_plain(prev[c].contiguous(), curr[c].contiguous(), pts[c], valid[c])
        sp = sp.cpu().numpy()
        np.testing.assert_array_equal(s[c].cpu().numpy(), sp)
        assert sp.sum() >= (k - 1) // 2
        np.testing.assert_allclose(g[c].cpu().numpy()[sp], gp.cpu().numpy()[sp], atol=1e-2)
    assert of.staged == staged


def test_batched_launch_of_one_clip_equals_the_single_launch(dev):
    prev, curr, pts, valid = _case(dev, 57)
    g1, s1 = of.lk_flow(prev, curr, pts, valid)
    g, s = of.lk_flow_clips(prev[None], curr[None], pts[None], valid[None])
    torch.cuda.synchronize()
    assert torch.equal(g[0], g1) and torch.equal(s[0], s1)


def test_batched_launch_checks_the_clip_stride(dev):
    """A clip stride off the 16-byte grid, frames of another stride than
    the other frames', or CPU points raise before launching."""
    clips = _clip_buffer(dev, (100, 160), 2, 2)
    h, w = 100, 160
    pitch = clips.stride(2)
    pts = torch.from_numpy(np.stack([_points(8, (h, w))] * 2)).to(dev)
    valid = torch.ones(2, 8, dtype=torch.bool, device=dev)
    flat = torch.zeros(2 * h * pitch + 64, dtype=torch.uint8, device=dev)
    odd = torch.as_strided(flat, (2, h, w, 3), (h * pitch + 8, pitch, 3, 1))
    before = of.launches
    with pytest.raises(ValueError, match="clip stride"):
        of.lk_flow_clips(odd, odd, pts, valid)
    longer = _clip_buffer(dev, (h, w), 2, 3)  # clips of 3 frames: another clip stride
    with pytest.raises(ValueError, match="curr_bgr"):
        of.lk_flow_clips(clips[:, 0], longer[:, 1], pts, valid)
    with pytest.raises(ValueError, match="CUDA"):  # lk_flow_clips would take the plain version for CPU points
        of.lk_flow_clips_cuda(clips[:, 0], clips[:, 1], pts.cpu(), valid.cpu())
    assert of.launches == before


def test_one_shot_peak_grows_by_the_canvases_only(dev):
    """The one-shot 4:2:0 path decodes PIECE frames at a time into one
    uint8 buffer: from 48 to 96 frames of 1280x720 the peak device memory
    (``max_memory_allocated``) grows by at most the 48 more 544x960 BGR
    canvases plus 5% (the whole-clip decode held ~46 MB of float
    temporaries a frame)."""
    from scipy.ndimage import gaussian_filter

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    rng = np.random.default_rng(5)
    tex = gaussian_filter(rng.normal(size=(720, 1280 + 96, 3)), (2.0, 2.0, 0))
    world = np.clip(128 + 40 * tex / tex.std(), 0, 255).astype(np.uint8)
    frames = np.ascontiguousarray(np.stack([world[:, t : t + 1280] for t in range(96)]))
    model = CoordinateModel(device="cuda")
    model.get_coordinates(frames[:16], 24, num_keypoint_detection=3)  # warm-up

    def peak(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model.get_coordinates(frames[:n], 24, num_keypoint_detection=3)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    p48, p96 = peak(48), peak(96)
    assert p96 - p48 <= 1.05 * 48 * 544 * 960 * 3, (p48, p96)


# ---------------------------------------------------------------------------
# the JV assignment kernel
# ---------------------------------------------------------------------------


def _lap_against_plain(dev, n, kind, seed):
    """One launch at (n, n) on the path and instantiation the kernel picks,
    bit-equal to the plain version; returns (path, columns a lane)."""
    cost = torch.from_numpy(lap_costs(n, kind, seed))
    path, cols = lap.kernel_path(n, dev), lap.kernel_columns(n, dev)
    before, by_path = lap.launches, dict(lap.launches_by_path)
    got = lap.solve_lap(cost.to(dev))
    torch.cuda.synchronize()
    launched = 1 if n else 0
    assert lap.launches == before + launched and lap.launches_by_path[path] == by_path[path] + launched
    assert got.dtype == torch.int32 and got.device.type == "cuda" and got.shape == (n,)
    np.testing.assert_array_equal(got.cpu().numpy(), lap.solve_lap_plain(cost).numpy())
    return path, cols


@pytest.mark.parametrize("n,kind", [(57, "random"), (192, "random"), (192, "tracking"), (300, "random"),
                                    (300, "tracking")])
def test_lap_kernel_matches_plain(dev, n, kind):
    path, cols = _lap_against_plain(dev, n, kind, seed=n)
    assert path == ("global" if n == 300 else "shared")
    assert cols == {57: 2, 192: 6, 300: 10}[n]


@pytest.mark.parametrize("kind", ["random", "tracking"])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 63, 64])
def test_lap_kernel_at_each_boundary_of_its_columns_a_lane(dev, n, kind):
    """n columns (and the sentinel column 0, kept apart) over 32 lanes:
    1, 31, 32, 33, 63, 64 columns fill a lane's K registers exactly, leave
    padding columns, or open the next k."""
    path, cols = _lap_against_plain(dev, n, kind, seed=n + 1)
    if n:
        assert path == "shared" and cols >= -(-n // 32)


def test_lap_kernel_at_the_edge_of_the_shared_path(dev):
    """The largest n whose cost is staged in shared memory and the smallest
    read from global memory, both as ``kernel_path`` reports them."""
    paths = {n: lap.kernel_path(n, dev) for n in range(192, 320)}
    largest = max(n for n, p in paths.items() if p == "shared")
    assert largest >= 238 and all(p == "global" for n, p in paths.items() if n > largest)
    for n, want in ((largest, "shared"), (largest + 1, "global")):
        assert _lap_against_plain(dev, n, "tracking", seed=n)[0] == want


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [57, 192])
def test_lap_kernel_stages_a_matrix_off_the_16_byte_grid(dev, n, offset):
    """A matrix whose base address lies 4, 8 or 12 bytes past a 16-byte
    boundary (a view into a buffer) is staged as an aligned one is: single
    floats up to the boundary, 16-byte loads after it."""
    cost = torch.from_numpy(lap_costs(n, "tracking", seed=n))
    flat = torch.empty(n * n + offset, device=dev)
    shifted = flat[offset:].view(n, n)
    shifted.copy_(cost)
    assert shifted.data_ptr() % 16 == 4 * offset and lap.kernel_path(n, dev) == "shared"
    got = lap.solve_lap(shifted)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), lap.solve_lap_plain(cost).numpy())


@pytest.mark.parametrize("n", [24, 56])
def test_lap_kernel_ties_signed_zeros_as_the_plain_version(dev, n):
    _lap_against_plain(dev, n, "signed_zeros", seed=n)


@pytest.mark.parametrize("n", [1025, 2000])
def test_lap_kernel_with_the_column_vectors_in_shared_memory(dev, n):
    """n > 1024: more than 32 columns a lane, the vectors in shared memory
    (n = 1024 is the last size with its columns in registers): 33 columns
    a lane, one more than a chunk's multiple, and 63."""
    assert lap.kernel_columns(1024, dev) == 32
    path, cols = _lap_against_plain(dev, n, "random", seed=5)
    assert path == "global" and cols == 0


@pytest.mark.parametrize("n", [57, 192, 300])
def test_lap_batched_launch_equals_single_launches(dev, n):
    costs = torch.from_numpy(np.stack([lap_costs(n, kind, seed=s) for s, kind in
                                       enumerate(["random", "tracking", "tracking", "random"])])).to(dev)
    before = lap.launches
    batched = lap.solve_lap(costs)
    singles = [lap.solve_lap(costs[b]) for b in range(4)]
    torch.cuda.synchronize()
    assert lap.launches == before + 5
    for b in range(4):
        assert torch.equal(batched[b], singles[b])
    np.testing.assert_array_equal(batched.cpu().numpy(), lap.solve_lap_plain(costs.cpu()).numpy())


@pytest.mark.parametrize("n", [5, 192, 300, 1025])
def test_lap_kernel_gives_minus_one_rows_on_an_all_inf_matrix(dev, n):
    out = lap.solve_lap(torch.full((2, n, n), float("inf"), device=dev))
    torch.cuda.synchronize()
    assert out.tolist() == [[-1] * n] * 2


def test_lap_kernel_checks_its_inputs(dev):
    before = lap.launches
    with pytest.raises(ValueError, match="CUDA"):
        lap.solve_lap_cuda(torch.zeros(4, 4))
    for bad in (torch.zeros(4, 4, dtype=torch.float64, device=dev), torch.zeros(4, 5, device=dev),
                torch.zeros(8, 8, device=dev)[::2, ::2], torch.zeros(2, 2, 4, 4, device=dev)):
        with pytest.raises(ValueError, match="solve_lap takes"):
            lap.solve_lap(bad)
    assert lap.launches == before
    # a matrix with no finite perfect matching: every row -1, no hang
    out = lap.solve_lap(torch.full((5, 5), float("inf"), device=dev))
    torch.cuda.synchronize()
    assert out.tolist() == [-1] * 5


def test_masked_assignment_on_the_card_makes_no_host_sync(dev):
    rng = np.random.default_rng(4)
    cost = np.ones((64, 128), np.float32)
    near = rng.uniform(size=cost.shape) < 0.1
    cost[near] = rng.uniform(0.05, 0.95, near.sum())
    rows, cols = rng.uniform(size=64) < 0.4, rng.uniform(size=128) < 0.3
    args = [torch.from_numpy(a).to(dev) for a in (cost, rows, cols)]
    lap.masked_assignment(*args, 0.8)  # builds and loads the kernel
    torch.cuda.synchronize()
    before = lap.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        match, matched_col = lap.masked_assignment(*args, 0.8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lap.launches == before + 1
    want_m, want_c = lap.masked_assignment(*(a.cpu() for a in args), 0.8)
    assert torch.equal(match.cpu(), want_m) and torch.equal(matched_col.cpu(), want_c)
    assert (want_m >= 0).sum() >= 5


# ---------------------------------------------------------------------------
# the auction and NMS kernels (csrc/auction.cu, csrc/nms.cu)
# ---------------------------------------------------------------------------


def _auction_inputs(kind, r, c, seed):
    """(benefit (R, C + R), row_ok) on the CPU, as masked_auction builds them."""
    cost, rows, cols, gate = auction_case(kind, r, c, seed)
    feas = torch.from_numpy(rows[:, None] & cols[None, :] & (cost <= gate))
    return lap.auction_benefit(torch.from_numpy(cost), feas, gate, max_cardinality=False)


def _auction_against_plain(dev, benefit, row_ok, c, iterations=512):
    before = lap.auction_launches
    got_m, got_r = lap.auction_rounds(benefit.to(dev), row_ok.to(dev), c, iterations)
    torch.cuda.synchronize()
    assert lap.auction_launches == before + 1
    want_m, want_r = lap.auction_rounds_plain(benefit, row_ok, c, iterations)
    assert got_m.dtype == torch.int64 and got_r.dtype == torch.int32 and got_m.device.type == "cuda"
    assert torch.equal(got_m.cpu(), want_m) and torch.equal(got_r.cpu(), want_r)
    return int(want_r.sum())


#: (R, C) that reach each of csrc/auction.cu's on-chip instantiations (K
#: columns a lane, RW rows a warp): K the least of 1, 2, 4, 6, 8 with 32 K
#: >= C + R, RW the least of 1, 2, 4 with 32 RW >= R; R <= C + R, so RW <= K
ONCHIP_SHAPES = {(1, 1): (20, 12), (2, 1): (20, 30), (2, 2): (40, 20), (4, 1): (30, 80), (4, 2): (40, 60),
                 (4, 4): (100, 20), (6, 1): (32, 150), (6, 2): (64, 128), (6, 4): (96, 96), (8, 1): (16, 240),
                 (8, 2): (64, 192), (8, 4): (128, 128)}


@pytest.mark.parametrize("kind", AUCTION_KINDS)
@pytest.mark.parametrize("r,c", sorted({(12, 20), (1, 1), (33, 2), *ONCHIP_SHAPES.values()}))
def test_auction_kernel_matches_plain(dev, kind, r, c):
    """Each kind at every (K, RW) the on-chip path instantiates, up to its
    limit R = 128, C + R = 256 (the most registers a thread: 1024 threads)."""
    inst = next(k for k in (1, 2, 4, 6, 8) if 32 * k >= c + r), next(w for w in (1, 2, 4) if 32 * w >= r)
    assert (r, c) not in ONCHIP_SHAPES.values() or ONCHIP_SHAPES[inst] == (r, c)
    assert lap.auction_path(r, c + r, dev) == "registers"
    benefit, row_ok = _auction_inputs(kind, r, c, seed=r + c)
    before = lap.auction_launches_by_path["registers"]
    _auction_against_plain(dev, benefit, row_ok, c)
    assert lap.auction_launches_by_path["registers"] == before + 1


@pytest.mark.parametrize("iterations", [0, 1, 2, 3, 40])
@pytest.mark.parametrize("kind", ["tied_block", "ties", "tracking"])
def test_auction_kernel_at_the_round_cap(dev, kind, iterations):
    benefit, row_ok = _auction_inputs(kind, 24, 10, seed=7)
    done = _auction_against_plain(dev, benefit, row_ok, 10, iterations)
    if kind == "tied_block":
        assert done == iterations


@pytest.mark.parametrize("rounds", sorted(ROUND_CASES))
def test_auction_kernel_runs_each_round_case(dev, rounds):
    """64 x 192 benefits whose auctions run 0 (no row can bid: the launch
    returns before it reads the benefit), 1, 4 and 11 rounds."""
    cost, rows, cols, gate = auction_round_case(rounds)
    feas = torch.from_numpy(rows[:, None] & cols[None, :] & (cost <= gate))
    benefit, row_ok = lap.auction_benefit(torch.from_numpy(cost), feas, gate, max_cardinality=False)
    assert _auction_against_plain(dev, benefit, row_ok, 128) == rounds


def test_auction_kernel_reads_a_large_matrix_from_global_memory(dev):
    r, c = 200, 300  # more rows (and columns) than a block keeps in registers
    assert lap.auction_path(r, c + r, dev) == "global"
    before = lap.auction_launches_by_path["global"]
    benefit, row_ok = _auction_inputs("tracking", r, c, seed=1)
    _auction_against_plain(dev, benefit, row_ok, c)
    assert lap.auction_launches_by_path["global"] == before + 1


def test_auction_batched_launch_equals_single_launches(dev):
    cases = [_auction_inputs(kind, 64, 128, seed=s) for s, kind in enumerate(["tracking", "ties", "random", "tracking"])]
    benefit = torch.stack([b for b, _ in cases]).to(dev)
    row_ok = torch.stack([o for _, o in cases]).to(dev)
    before = lap.auction_launches
    match, done = lap.auction_rounds(benefit, row_ok, 128)
    singles = [lap.auction_rounds(benefit[b], row_ok[b], 128) for b in range(4)]
    torch.cuda.synchronize()
    assert lap.auction_launches == before + 5 and match.shape == (4, 64) and done.shape == (4,)
    for b in range(4):
        assert torch.equal(match[b], singles[b][0]) and int(done[b]) == int(singles[b][1])
    want_m, want_r = lap.auction_rounds_plain(benefit.cpu(), row_ok.cpu(), 128)
    assert torch.equal(match.cpu(), want_m) and torch.equal(done.cpu(), want_r)


def test_auction_kernel_adds_its_rounds_to_the_device_tally(dev):
    benefit, row_ok = _auction_inputs("tied_block", 24, 10, seed=7)
    lap.reset_rounds()
    _, done = lap.auction_rounds(benefit.to(dev), row_ok.to(dev), 10, iterations=37)
    _, done2 = lap.auction_rounds(benefit.to(dev), row_ok.to(dev), 10, iterations=5)
    torch.cuda.synchronize()
    assert int(done) == 37 and int(done2) == 5 and lap.device_rounds() == 42 and lap.rounds == 0


def test_auction_kernel_checks_its_inputs(dev):
    before = lap.auction_launches
    b, ok = torch.zeros(4, 7, device=dev), torch.ones(4, dtype=torch.bool, device=dev)
    for args in ((b.double(), ok, 3), (b, ok.int(), 3), (b, ok, 4), (b.t().contiguous().t(), ok, 3),
                 (b, ok.cpu(), 3)):
        with pytest.raises(ValueError, match="auction_rounds takes"):
            lap.auction_rounds(*args)
    assert lap.auction_launches == before


def test_masked_auction_on_the_card_makes_no_host_sync(dev):
    cost, rows, cols, gate = auction_case("tracking", 64, 128, seed=4)
    args = [torch.from_numpy(a).to(dev) for a in (cost, rows, cols)]
    lap.masked_auction(*args, gate)  # builds and loads the kernel
    torch.cuda.synchronize()
    before = lap.auction_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        match, matched_col = lap.masked_auction(*args, gate)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lap.auction_launches == before + 1
    want_m, want_c = lap.masked_auction(*(a.cpu() for a in args), gate)
    assert torch.equal(match.cpu(), want_m) and torch.equal(matched_col.cpu(), want_c)
    assert (want_m >= 0).sum() >= 10


def _suppress_against_plain(dev, shifted, valid, thr=0.7):
    before = nms.launches
    got = nms.suppress(shifted.to(dev), valid.to(dev), thr)
    torch.cuda.synchronize()
    assert nms.launches == before + 1 and got.dtype == torch.bool and got.device.type == "cuda"
    want = nms.suppress_plain(shifted, valid, thr)
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_kernel_matches_plain(dev, seed):
    """One image of each kind at k = 512: clusters, IoU exactly at the
    threshold and one float32 step above, a 12-link chain, nothing above
    the floor, overflow."""
    shifted, valid = suppress_inputs(*nms_cases(seed))
    keep = _suppress_against_plain(dev, shifted, valid)
    thr = NMS_KINDS.index("threshold")
    assert keep[thr, :4].tolist() == [True, True, True, False]
    assert keep[NMS_KINDS.index("chain"), :12].tolist() == [m % 2 == 0 for m in range(12)]


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 100, 512, 1000, 1024])
def test_nms_kernel_at_each_width(dev, k):
    """k candidates: one to 32 column blocks of the overlap grid, a
    ragged last block, the fixed point's block from one warp to 32."""
    boxes, scores = nms_cases(k, na=max(k, 12))
    shifted, valid = suppress_inputs(boxes, scores, k)
    assert shifted.shape[1] == k
    _suppress_against_plain(dev, shifted, valid)
    _suppress_against_plain(dev, shifted, valid, thr=0.3)


@pytest.mark.parametrize("k,b", [(1025, 2), (2048, 2), (4096, 2), (ANCHORS, 1)])
def test_nms_kernel_past_1024_candidates(dev, k, b):
    """Thousands of valid, clustered candidates, up to the detector's
    anchor count, against the plain version on the same CUDA tensors (its
    dense (k, k) block fits on the card)."""
    shifted, valid = suppress_inputs(*nms_wide_case(k, b=b, seed=k), k, device=dev)
    assert shifted.shape == (b, k, 4) and int(valid.sum()) > 600 * b
    before = nms.launches
    got = nms.suppress(shifted, valid, 0.7)
    want = nms.suppress_plain(shifted, valid, 0.7)
    assert nms.launches == before + 1 and torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())


def test_nms_kernel_checks_its_inputs(dev):
    before = nms.launches
    s, v = torch.zeros(2, 8, 4, device=dev), torch.ones(2, 8, dtype=torch.bool, device=dev)
    for args in ((s.double(), v), (s, v.int()), (s[..., :3].contiguous(), v), (s, v.cpu())):
        with pytest.raises(ValueError, match="suppress takes"):
            nms.suppress(*args, 0.7)
    assert nms.suppress(torch.zeros(0, 8, 4, device=dev), torch.zeros(0, 8, dtype=torch.bool, device=dev),
                        0.7).shape == (0, 8)
    assert nms.launches == before
    # any k runs on the card: 1025 candidates, past 32 words of overlap bits a candidate
    boxes, scores = nms_cases(3, na=1100)
    shifted, valid = suppress_inputs(boxes, scores, 1025)
    _suppress_against_plain(dev, shifted, valid)


def test_batched_nms_on_the_card_makes_no_host_sync(dev):
    boxes, scores = (torch.from_numpy(a) for a in nms_cases(2))
    x = boxes.to(dev), scores.to(dev)
    nms.batched_nms(*x)  # builds and loads the kernel
    torch.cuda.synchronize()
    before = nms.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nms.batched_nms(*x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert nms.launches == before + 1
    for g, w in zip(got, nms.batched_nms(boxes, scores)):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# the multi-device layer on the card (eagle_tpu_torch/parallel)
# ---------------------------------------------------------------------------


def _world_of_one(tmp_path, backend: str):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    return dist


def test_a_world_of_one_under_nccl_equals_the_single_device_runner(dev, tmp_path):
    """``MultiClipRunner`` over ``make_mesh()`` of a one-rank NCCL group (its
    clips gathered by NCCL's ``all_gather``) equals the runner on the card
    without a process group, on oracle clips of 24 and 16 frames."""
    from eagle_tpu_torch.config import DEFAULT_CONFIG
    from eagle_tpu_torch.parallel.mesh import make_mesh
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner

    frames, kp_fn, det_fn = _panned_clip(40)
    clips = [frames[:24], frames[24:]]
    cfg = DEFAULT_CONFIG.replace(chunk_frames=16)
    want = MultiClipRunner(CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda")).run(
        clips, 8, num_keypoint_detection=2)
    dist = _world_of_one(tmp_path, "nccl")
    try:
        mesh = make_mesh()
        assert (mesh.size, mesh.backend, mesh.device) == (1, "nccl", torch.device("cuda", torch.cuda.current_device()))
        model = CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda")
        launches = of.launches
        got = MultiClipRunner(model, mesh=mesh).run(clips, 8, num_keypoint_detection=2)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert got == want and of.launches > launches
    assert sum(len(fr["Keypoints"]) for r in got for fr in r.values()) > 4 * len(frames)


def test_gather_and_halo_on_cuda_tensors_under_nccl(dev, tmp_path):
    """At one rank under NCCL: ``gather_batch`` of a CUDA tensor (an NCCL
    ``all_gather``) gives it back on the card; the halo sends nothing and
    gives the frames shifted by one, frame 0 repeated; the time-sharded scan
    over the one rank equals ``scan_chunk``."""
    from eagle_tpu_torch.config import DEFAULT_CONFIG
    from eagle_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev, timesharded_keypoint_scan
    from eagle_tpu_torch.pipeline import temporal

    from .torch_parity import time_inputs

    frames_np, kp_fn, _ = _panned_clip(12)
    dist = _world_of_one(tmp_path, "nccl")
    try:
        mesh = make_mesh()
        x = torch.arange(24, dtype=torch.float32, device=dev).reshape(6, 4)
        got = gather_batch(shard_batch(x, mesh), mesh)
        assert got.device == x.device and torch.equal(got, x)
        np.testing.assert_array_equal(gather_batch(x.cpu().numpy(), mesh), x.cpu().numpy())
        frames = of.upload_frames(frames_np, dev)
        prev = halo_exchange_prev(frames, mesh)
        assert torch.equal(prev[1:], frames[:-1]) and torch.equal(prev[0], frames[0])
        kp, valid = kp_fn(frames_np)
        mem_kp, mem_valid = kp.astype(np.float32), valid.copy()
        mem_valid[np.arange(12) % 4 != 0] = False
        xs = time_inputs(frames_np, mem_kp, mem_valid, 4, 4)
        xs = xs._replace(**{k: v.to(dev) for k, v in xs._asdict().items() if isinstance(v, torch.Tensor)})
        xs = xs._replace(frame_bgr=frames, prev_frame_bgr=prev)
        cfg = DEFAULT_CONFIG
        _, want = temporal.scan_chunk(temporal.init_carry(cfg, dev), xs, cfg, 0)
        for a, b in zip(timesharded_keypoint_scan(mesh, cfg, 0, xs), (want.kp_xy, want.kp_valid, want.H, want.H_ok)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
    assert int(want.kp_valid.sum()) > 2 * len(frames_np)  # six keypoints that pan out of view


def test_gloo_host_transport_under_two_spawned_ranks(dev, tmp_path):
    """Two gloo ranks spawned on the one card: the ring shift of CUDA
    tensors (sent through host copies), the halo and ``gather_batch`` (gloo's
    CUDA ``all_gather``) give the same bytes as the frames themselves."""
    from .torch_parity import gloo_card_rank

    torch.multiprocessing.spawn(gloo_card_rank, args=(2, str(tmp_path / "store"), str(tmp_path)), nprocs=2, join=True)
    frames = torch.arange(8 * 4 * 6 * 3, dtype=torch.int64).remainder(251).to(torch.uint8).reshape(8, 4, 6, 3)
    want_halo = torch.cat([frames[:1], frames[:3], frames[3:4], frames[4:7]])
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert torch.equal(got["shift"], torch.full((3,), 1 - r, dtype=torch.float32))
        assert got["shift_device"].startswith("cuda")
        assert torch.equal(got["gather"], frames) and torch.equal(got["halo"], want_halo)


# ---------------------------------------------------------------------------
# the eval CLI's entry points: the model's default runners and evaluate.run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_scene():
    from eagle_tpu_torch.utils.synthetic import make_scene

    return make_scene(num_frames=16, width=1280, height=720, num_players=10)


def test_default_detector_fn_is_one_nms_launch(dev, eval_scene):
    """``_default_detector_fn`` on 16 frames of 1280x720 with the default
    full-width model: one ``run_detector`` call (one NMS launch), and
    what ``run_detector`` gives on the same frames."""
    from eagle_tpu_torch.config import WorkGeometry
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    model = CoordinateModel(device="cuda")
    frames = eval_scene.frames
    model._default_detector_fn(frames[:2])  # warm-up
    nms.launches = 0
    boxes, conf, cls, valid = model._default_detector_fn(frames)
    assert nms.launches == 1
    rows = model.run_detector(of.upload_frames(frames, dev), WorkGeometry(), (720, 1280)).cpu().numpy()
    np.testing.assert_array_equal(boxes, rows[..., :4])
    np.testing.assert_array_equal(conf, rows[..., 4])
    np.testing.assert_array_equal(cls, rows[..., 5].astype(np.int32))
    np.testing.assert_array_equal(valid, rows[..., 6] > 0.5)
    assert boxes.shape == (16, model.config.detector.max_detections, 4)


def test_evaluate_run_with_oracle_runners_is_perfect(dev, eval_scene):
    """Runners that return the scene's truth (``chip_smoke.py``'s) give
    acc@2px and F1@2 of 1.0 for both models and a box IoU of 1.0."""
    from chip_smoke import eval_oracle_runners
    from eagle_tpu_torch import evaluate
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    truth = evaluate.synthetic_truth(eval_scene)
    keypoints, detections = eval_oracle_runners(truth)
    model = CoordinateModel(keypoint_fn=keypoints, detector_fn=detections, device="cuda")
    res = evaluate.run(model, eval_scene.frames, *truth)
    for name in ("YOLO", "HRNet"):
        assert res[name]["metrics"]["2"] == 1.0 and res[name]["classification"]["f1_2"] == 1.0, name
        assert res[name]["time"] > 0
    assert res["YOLO"]["boxes"]["mean_iou"] == 1.0 and res["YOLO"]["boxes"]["f1"] == 1.0


def test_evaluate_refuses_the_cpu_unless_asked(tmp_path):
    """Without a card and without ``--device cpu`` the eval CLI raises; it
    never runs on the CPU silently.  Runs where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from eagle_tpu_torch import evaluate

    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--frames", "1", "--out", str(tmp_path / "results.json")])


# ---------------------------------------------------------------------------
# the CLI from an .mp4
# ---------------------------------------------------------------------------


def _scene_runners(scene, decoded):
    """Keypoint and detector runners that return the scene's truth for each
    decoded frame, found by its content: the on-plane landmarks in view,
    every player's box and the ball's."""
    from eagle_tpu_torch import pitch

    h, w = scene.frames.shape[1:3]
    kp_img = scene.keypoints_image
    seen = (kp_img[:, 0] >= 5) & (kp_img[:, 0] < w - 5) & (kp_img[:, 1] >= 5) & (kp_img[:, 1] < h - 5)
    seen &= pitch.ON_PLANE_MASK
    index = {f.tobytes(): i for i, f in enumerate(decoded)}
    p = scene.player_boxes.shape[1]

    def keypoints(batch):
        kp = np.zeros((len(batch), 57, 3), np.float32)
        kp[..., :2] = np.trunc(kp_img)
        kp[..., 2] = 0.9
        return kp, np.tile(seen, (len(batch), 1))

    def detections(batch):
        idx = [index[np.asarray(f).tobytes()] for f in batch]
        b = len(idx)
        boxes = np.zeros((b, 128, 4), np.float32)
        cls = np.zeros((b, 128), np.int32)
        valid = np.zeros((b, 128), bool)
        boxes[:, :p] = scene.player_boxes[idx]
        bx, by = scene.ball_image[idx].T
        boxes[:, p] = np.stack([bx - 5, by - 10, bx + 5, by], -1)
        cls[:, p] = 2
        valid[:, : p + 1] = True
        return boxes, np.where(valid, 0.9, 0.0).astype(np.float32), cls, valid

    return keypoints, detections


def test_cli_from_an_mp4_on_the_card_writes_the_cpu_run_files(dev, tmp_path, monkeypatch):
    """``main.main(["--video_path", clip.mp4, ...])`` on the card and with
    ``--device cpu``, the built-in models swapped for runners of the scene's
    truth: the five files each, the flow kernel launched on the card, the
    four JSON files of the card within the cli phase's tolerances of the
    CPU run's, the metadata equal."""
    from chip_smoke import json_mismatch
    from eagle_tpu_torch import main as tmain
    from eagle_tpu_torch.io.video import read_video_array, write_video
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from eagle_tpu_torch.utils.synthetic import make_scene

    scene = make_scene(num_frames=24, width=640, height=360, num_players=8, fps=8, seed=3, pan_speed=1.0)
    mp4 = str(tmp_path / "clip.mp4")
    write_video(scene.frames, mp4, 8)
    decoded, _ = read_video_array(mp4, 8)
    keypoints, detections = _scene_runners(scene, decoded)
    monkeypatch.setattr(tmain, "CoordinateModel", lambda device=None, **_weights: CoordinateModel(
        keypoint_fn=keypoints, detector_fn=detections, device=device))
    files = {}
    for where, flags in (("card", []), ("cpu", ["--device", "cpu"])):
        (tmp_path / where).mkdir()
        monkeypatch.chdir(tmp_path / where)
        before = of.launches
        tmain.main(["--video_path", mp4, "--fps", "8", *flags])
        assert (of.launches > before) == (where == "card")
        out = tmp_path / where / "output" / "clip"
        assert sorted(p.name for p in out.iterdir()) == sorted(
            ["metadata.json", "processed_data.json", "raw_coordinates.json", "raw_data.json", "annotated.mp4"])
        files[where] = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
    assert files["card"]["metadata.json"] == files["cpu"]["metadata.json"]
    assert len(set(files["card"]["metadata.json"]["team_mapping"].values())) == 2
    for name, want in files["cpu"].items():
        assert want, name
        assert json_mismatch(files["card"][name], want, 1.0) is None, name
