"""PyTorch port, bounded-memory streaming: ``CoordinateModel.
stream_coordinates`` against the JAX package's on the same segments with
oracle models, and against the port's own one-shot ``get_coordinates``;
the streaming video readers (``io/video.py::iter_video,
VideoFrameSource``) against ``read_video_array`` and the JAX package's.

Tolerances: the port's stream against the JAX package's at
``tests/test_torch_coordinate_model.py::assert_coords_match``'s; the port's
stream against the port's one-shot exactly (``==`` on the dicts), in every
case where the JAX package's stream equals its own one-shot
(tests/test_streaming.py); decoded frames bit-equal."""

import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.io import video as jvideo
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.io import video as tvideo
from eagle_tpu_torch.ops.optical_flow import carry_frame
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .test_torch_coordinate_model import _no_dets, assert_coords_match

torch.set_num_threads(2)

#: the oracle clips' size: small frames keep the plain CPU flow's ROIs
#: (and the test) small
W, H = 224, 128


def _models(scene, det_fn=None, kp_fn=None):
    return dict(keypoint_fn=kp_fn or oracle_keypoint_fn(scene), detector_fn=det_fn or oracle_detector_fn(scene))


def check_stream(frames, cuts, fps, models, blocks_expected, prefetch=False, **kw):
    """The port's stream of ``frames`` cut at ``cuts`` against the JAX
    package's stream (assert_coords_match) and the port's one-shot
    (exactly); fresh oracle models for each pass (``models()``).  Returns
    the port's stream."""
    segments = [frames[a:b] for a, b in zip([0, *cuts], [*cuts, len(frames)])]
    jcfg, tcfg = (base.replace(chunk_frames=16) for base in (JCFG, TCFG))
    want = {}
    for block in JModel(config=jcfg, verbose_init=False, **models()).stream_coordinates(
        segments, fps, prefetch=False, **kw
    ):
        want.update(block)
    blocks = list(TModel(config=tcfg, device="cpu", **models()).stream_coordinates(segments, fps, prefetch=prefetch, **kw))
    assert [len(b) for b in blocks] == blocks_expected
    got = {k: v for b in blocks for k, v in b.items()}
    assert sorted(got) == list(range(len(frames)))
    assert_coords_match(got, want, boundary_atol=5e-3)
    one = TModel(config=tcfg, device="cpu", **models()).get_coordinates(frames, fps, **kw)
    assert got == one
    return got


def test_ragged_segments_stream_as_jax_and_as_one_shot():
    """Segments of 10 + 23 + 15 frames come out as blocks of 32 + 16: the
    10 are held, 32 of the 33 run and one is held.  Global keys and
    "Time", the keypoint cadence on the global index, the tracker's ids
    across the block boundary."""
    scene = make_scene(num_frames=48, width=W, height=H, num_players=4, fps=8, seed=7)
    got = check_stream(scene.frames, [10, 33], 8, lambda: _models(scene), [32, 16], num_homography=1,
                       num_keypoint_detection=2)
    assert got[47]["Time"] == "00:05"


def test_final_short_block_with_prefetch():
    """A total that is no chunk multiple: only the last block is short.
    The next block is pulled and prescaled on a worker thread."""
    scene = make_scene(num_frames=40, width=W, height=H, num_players=3, fps=8, seed=9)
    check_stream(scene.frames, [16, 32], 8, lambda: _models(scene), [16, 16, 8], prefetch=True,
                 num_homography=1, num_keypoint_detection=2)


def test_stream_shorter_than_one_chunk():
    scene = make_scene(num_frames=6, width=W, height=H, num_players=2, fps=6, seed=5)
    check_stream(scene.frames, [4], 6, lambda: _models(scene), [6], num_homography=1, num_keypoint_detection=2)


def test_on_demand_recovery_inside_a_later_block():
    """The flow collapses on featureless frames inside the second block:
    the on-demand keypoint round fires within that block's call."""
    base = make_scene(num_frames=32, width=W, height=H, num_players=0, fps=8, seed=3)
    frames = base.frames.copy()
    frames[20:] = 127
    got = check_stream(frames, [16], 8, lambda: _models(base, _no_dets), [16, 16], num_homography=1,
                       num_keypoint_detection=1)
    assert len(got[21]["Keypoints"]) >= 4, "the flagged frames are recovered"


def test_stream_accumulates_its_timer_and_checks_the_resolution():
    scene = make_scene(num_frames=20, width=W, height=H, num_players=2, fps=8, seed=11)
    model = TModel(config=TCFG.replace(chunk_frames=16), device="cpu", **_models(scene))

    class Counting(StageTimer):
        def __call__(self, name):
            self.calls[name] = self.calls.get(name, 0) + 1
            return super().__call__(name)

    timer = Counting(model.device)
    timer.calls = {}
    blocks = list(model.stream_coordinates([scene.frames[:16], scene.frames[16:]], 8, timer=timer, prefetch=False))
    assert len(blocks) == 2 and timer.calls["assembly"] == 2 and set(timer.calls) == set(timer.seconds)
    with pytest.raises(ValueError, match="one resolution"):
        list(model.stream_coordinates([scene.frames[:16], scene.frames[16:, :96]], 8, prefetch=False))


def test_carried_frame_keeps_its_row_stride():
    """The frame a block hands to the next keeps its buffer's row stride
    (here 448 B rows for 148-px frames, 444 B of pixels), so the flow
    kernel reads it in place beside the next block's frames."""
    buf = torch.zeros(2, 20, 448, dtype=torch.uint8)
    buf[:, :, :444] = torch.randint(0, 256, (2, 20, 444), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    frames = buf[:, :, :444].view(2, 20, 148, 3)
    kept = carry_frame(frames[1])
    assert kept.stride() == frames[1].stride() and kept.data_ptr() != frames[1].data_ptr()
    assert torch.equal(kept, frames[1])
    dense = torch.zeros(20, 160, 3, dtype=torch.uint8)
    assert carry_frame(dense).is_contiguous()


# ---------------------------------------------------------------- video IO


@pytest.fixture(scope="module")
def small_video(tmp_path_factory):
    rng = np.random.default_rng(0)
    base = rng.integers(60, 196, (1, 48, 64, 3), dtype=np.uint8)
    drift = (np.arange(20, dtype=np.uint8) * 3)[:, None, None, None]
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    tvideo.write_video(np.clip(base + drift, 0, 255).astype(np.uint8), path, fps=24)
    return path


@pytest.mark.parametrize("fps,segment", [(24, 7), (12, 4)])
def test_iter_video_matches_read_video_array(small_video, fps, segment):
    whole, _ = tvideo.read_video_array(small_video, fps)
    parts = list(tvideo.iter_video(small_video, fps, segment_frames=segment))
    assert [len(p) for p in parts] == [len(p) for p in jvideo.iter_video(small_video, fps, segment_frames=segment)]
    assert all(len(p) == segment for p in parts[:-1])
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    np.testing.assert_array_equal(np.concatenate(parts), np.concatenate(list(jvideo.iter_video(small_video, fps, segment))))
    with pytest.raises(ValueError):
        next(tvideo.iter_video(small_video, fps, segment_frames=0))


@pytest.mark.parametrize("fps", [24, 12])
def test_video_frame_source(small_video, fps):
    whole, _ = tvideo.read_video_array(small_video, fps)
    src = tvideo.VideoFrameSource(small_video, fps)
    jsrc = jvideo.VideoFrameSource(small_video, fps)
    assert len(src) == len(whole) == len(jsrc)
    for i in [0, 3, len(whole) - 1, 5, len(whole) - 1, 2, -1]:  # forward, back, repeat, negative
        np.testing.assert_array_equal(src[i], whole[i])
        np.testing.assert_array_equal(src[i], jsrc[i])
    with pytest.raises(IndexError):
        src[len(whole)]
    assert len(tvideo.VideoFrameSource(small_video, fps, length=5)) == 5
    src.close()
    jsrc.close()
