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
checks, and ``masked_assignment`` on the card without a host sync.

The machine with the card has no JAX, so this file imports nothing of
JAX or of the JAX package, and runs without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: status bit-equal; positions
within 1e-2 px on tracked points (the bar tests/test_pallas_flow.py sets
between the JAX package's two flow engines); assignments bit-equal."""

import json

import numpy as np
import pytest
import torch

from eagle_tpu_torch.ops import assignment as lap
from eagle_tpu_torch.ops import optical_flow as of
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
