"""PyTorch port, the CLI from an .mp4 against the JAX package's CLI: the
reference-compatible ``main.py`` (run as its ``main()`` under a patched
``sys.argv``) and ``eagle_tpu_torch.main.main`` decode the same small mp4,
with the same oracle models swapped in for the built-in ones, whole and
with ``--segment_frames``; and the two packages' ``render_annotated_frames``
on the same processed table, frames, coordinates and team mapping.

Tolerances: the four JSON files within 1e-9 (``assert_json_equal``: both
write the tables' floats with pandas' 10 decimals); the annotated frames
bit-equal (both draw with the same OpenCV calls on the same integer
points), and the two annotated.mp4 files decode to equal frames (the same
encoder on equal frames)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.pipeline.processor import Processor as JProcessor
from eagle_tpu.utils.render import render_annotated_frames as jrender
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch import main as tmain
from eagle_tpu_torch.io import video as tvideo
from eagle_tpu_torch.pipeline import processor as tprocessor
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.processor import Processor as TProcessor
from eagle_tpu_torch.utils.render import render_annotated_frames as trender

from .oracles import oracle_detections_at, oracle_detector_fn, oracle_keypoint_fn
from .test_torch_cli import JSON_FILES, _read_outputs, assert_json_equal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS = 8


def _jax_cli():
    """The reference-compatible CLI, ``main.py`` at the repository root, as
    a module of its own."""
    spec = importlib.util.spec_from_file_location("eagle_tpu_reference_cli", os.path.join(REPO, "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 24-frame scene written as an mp4, and its decoded frames."""
    sc = make_scene(num_frames=24, width=320, height=192, num_players=4, fps=FPS, seed=6)
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    tvideo.write_video(list(sc.frames), path, FPS)
    decoded, _ = tvideo.read_video_array(path, FPS)
    return sc, path, decoded


def _detections(sc, decoded):
    """The scene's detections of each decoded frame, found by its content
    (a call cursor would be shifted by a stream's blocks)."""
    index = {f.tobytes(): i for i, f in enumerate(decoded)}

    def fn(batch):
        return tuple(np.stack(a) for a in zip(*(oracle_detections_at(sc, index[np.asarray(f).tobytes()])
                                                for f in batch)))

    return fn


def _capture_writes(monkeypatch, module, attr) -> list:
    """Patch ``module.attr`` (a write_video) to record the frames it is
    given before encoding them."""
    written, write = [], getattr(module, attr)

    def capture(frames, path, fps=24, **kw):
        frames = [np.array(f) for f in frames]
        written.append(frames)
        return write(frames, path, fps, **kw)

    monkeypatch.setattr(module, attr, capture)
    return written


@pytest.mark.parametrize("segment", [0, 16], ids=["whole", "segment_frames"])
def test_port_cli_writes_what_the_jax_cli_writes(clip, tmp_path, monkeypatch, segment):
    sc, path, decoded = clip
    flags = ["--video_path", path, "--fps", str(FPS)] + (["--segment_frames", str(segment)] if segment else [])

    jmain = _jax_cli()
    monkeypatch.setattr(jmain, "CoordinateModel", lambda **_weights: JModel(
        keypoint_fn=oracle_keypoint_fn(sc), detector_fn=_detections(sc, decoded), verbose_init=False))
    jax_frames = _capture_writes(monkeypatch, jmain, "write_video")
    monkeypatch.setattr(sys, "argv", ["main.py", *flags])
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jmain.main()

    monkeypatch.setattr(tmain, "CoordinateModel", lambda device=None, **_weights: TModel(
        keypoint_fn=oracle_keypoint_fn(sc), detector_fn=_detections(sc, decoded), device=device))
    port_frames = _capture_writes(monkeypatch, tvideo, "write_video")
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    tmain.main([*flags, "--device", "cpu"])

    jax_out, port_out = tmp_path / "jax" / "output" / "clip", tmp_path / "port" / "output" / "clip"
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out)) == sorted(JSON_FILES + ["annotated.mp4"])
    got, want = _read_outputs(port_out), _read_outputs(jax_out)
    for name in JSON_FILES:
        assert want[name], name
        assert_json_equal(got[name], want[name], name)
    assert len(want["raw_coordinates.json"]) == len(decoded)
    assert len(set(want["metadata.json"]["team_mapping"].values())) == 2

    (jf,), (pf,) = jax_frames, port_frames
    assert len(pf) == len(jf) == len(decoded)
    for k, (p, j) in enumerate(zip(pf, jf)):
        assert p.dtype == j.dtype == np.uint8 and p.shape == j.shape, k
        assert np.array_equal(p, j), f"annotated frame {k}: {int((p != j).any(-1).sum())} pixels differ"
    assert not np.array_equal(pf[0], decoded[0])  # something was drawn
    jv, _ = tvideo.read_video_array(str(jax_out / "annotated.mp4"), FPS)
    pv, _ = tvideo.read_video_array(str(port_out / "annotated.mp4"), FPS)
    assert pv.shape == (len(decoded), *decoded.shape[1:]) and np.array_equal(pv, jv)


def test_render_matches_jax_on_the_same_table(clip):
    """Both renders on one clip's coordinates, each package's processed
    table of them and one mapping: the reported mapping, then the mapping
    with one player left out (the render skips an unmapped player); the
    frames bit-equal.  One player is detected as a goalkeeper, one enters
    late and one leaves early, so the tables hold goalkeeper columns and
    NaN cells."""
    sc, _, decoded = clip
    drop = {t: {0} for t in range(6)} | {t: {1} for t in range(18, 24)}
    detect = oracle_detector_fn(sc, drop=drop)

    def with_goalkeeper(batch):
        boxes, conf, cls, valid = detect(batch)
        cls[:, 2] = np.where(cls[:, 2] == 0, 1, cls[:, 2])  # the third player slot
        return boxes, conf, cls, valid

    coords = TModel(keypoint_fn=oracle_keypoint_fn(sc), detector_fn=with_goalkeeper, device="cpu").get_coordinates(
        decoded, FPS, num_keypoint_detection=3)
    table, mapping = TProcessor(coords, decoded, FPS, filter_ball_detections=False, device="cpu").process_data()
    df, jmapping = JProcessor(coords, list(decoded), FPS, filter_ball_detections=False).process_data()
    assert mapping == jmapping and len(mapping) >= 4
    assert any(isinstance(v, float) and v != v for c in table.columns for v in table[c])
    assert any(c.startswith("Goalkeeper") and "video" in c for c in table.columns)
    fewer = dict(list(mapping.items())[1:])
    for team_mapping in (mapping, fewer):
        got = list(trender(table, decoded, coords, team_mapping))
        want = list(jrender(df, decoded, coords, team_mapping))
        assert len(got) == len(want) == len(decoded)
        for k, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), f"frame {k}"


def test_streamed_cli_steps_back_a_constant_number_of_times(clip, tmp_path, monkeypatch):
    """``--segment_frames``: the Processor's crops and the render read the
    frames again through a ``VideoFrameSource``, which reopens the file and
    decodes from frame 0 on every step back.  Crops are cut in batches of
    ``VOTE_BATCH`` in frame order; the batches must not step back (here
    ``VOTE_BATCH`` is cut to 8 crops, ~2 frames of the clip), so the file
    is opened for decoding as often as with one batch: once for the
    Processor and once for the render."""
    from chip_smoke import counting_source

    sc, path, decoded = clip
    counts = {"opens": 0, "decoded": 0}
    monkeypatch.setattr(tvideo, "VideoFrameSource", counting_source(counts))
    monkeypatch.setattr(tprocessor, "VOTE_BATCH", 8)
    monkeypatch.setattr(tmain, "CoordinateModel", lambda device=None, **_weights: TModel(
        keypoint_fn=oracle_keypoint_fn(sc), detector_fn=_detections(sc, decoded), device=device))
    monkeypatch.chdir(tmp_path)
    out = tmain.main(["--video_path", path, "--fps", str(FPS), "--segment_frames", "16", "--device", "cpu"])
    assert len(out["processor"].crop_entries) > 8 * 8
    assert counts == {"opens": 2, "decoded": 2 * len(decoded)}, counts
