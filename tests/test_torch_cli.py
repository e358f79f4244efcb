"""PyTorch port, the CLI (``eagle_tpu_torch/main.py``): :func:`run` on a
short synthetic clip with oracle models writes the five outputs, and its
four JSON files parse equal to what the reference CLI's code
(``main.py``, the output block) writes from the JAX package's Processor
on the same coordinates and frames; the port's Processor, JSON writers and
CLI function run with pandas and OpenCV blocked, as on the card's machine.

Tolerances: JSON floats within 1e-9 (the tables' floats are written with
pandas' 10 decimals by both); everything else equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eagle_tpu.pipeline.processor import Processor as JProcessor
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch import main as tmain
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_detections_at, oracle_detector_fn, oracle_keypoint_fn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSON_FILES = ["metadata.json", "processed_data.json", "raw_coordinates.json", "raw_data.json"]


def reference_outputs(root: str, coordinates: dict, frames, fps: int, smooth: bool) -> None:
    """The output block of the reference-compatible CLI (main.py), on the
    JAX package's Processor."""
    os.makedirs(root, exist_ok=True)
    with open(f"{root}/raw_coordinates.json", "w") as f:
        json.dump(coordinates, f, default=float)
    processor = JProcessor(coordinates, frames, fps, filter_ball_detections=False)
    df, team_mapping = processor.process_data(smooth=smooth)
    df.to_json(f"{root}/raw_data.json", orient="records")
    with open(f"{root}/metadata.json", "w") as f:
        json.dump({"fps": fps, "team_mapping": team_mapping}, f, default=str)
    processor.format_data(df).to_json(f"{root}/processed_data.json", orient="records")


def assert_json_equal(got, want, path="$"):
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(want, (int, float)), path
        assert abs(got - want) <= 1e-9, f"{path}: {got} != {want}"
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{path}: keys {list(got)} != {list(want)}"
        for k in want:
            assert_json_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), f"{path}: length"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_equal(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("smooth", [False, True])
def test_cli_run_writes_what_the_reference_cli_writes(tmp_path, smooth):
    sc = make_scene(num_frames=16, width=640, height=360, num_players=6, fps=8, seed=4)
    model = TModel(keypoint_fn=oracle_keypoint_fn(sc), detector_fn=oracle_detector_fn(sc), device="cpu")
    out = tmain.run(sc.frames, sc.fps, str(tmp_path / "port"), model=model, smooth=smooth)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(JSON_FILES + ["annotated.mp4"])
    assert os.path.getsize(tmp_path / "port" / "annotated.mp4") > 0
    assert len(set(out["team_mapping"].values())) == 2
    proc = out["processor"]
    assert len(proc.crop_entries) == len(proc.crop_votes) > 0
    assert {pid for _, pid, _, _ in proc.crop_entries} >= set(out["team_mapping"])
    for stage in ("prescale", "temporal", "crops", "votes", "table", "merge", "format", "json"):
        assert stage in out["timer"].seconds, stage

    reference_outputs(str(tmp_path / "ref"), out["coordinates"], list(sc.frames), sc.fps, smooth)
    for name in JSON_FILES:
        with open(tmp_path / "port" / name) as f:
            got = json.load(f)
        with open(tmp_path / "ref" / name) as f:
            want = json.load(f)
        assert want, name
        assert_json_equal(got, want, name)


def test_cli_main_decodes_the_clip_and_writes_its_outputs(tmp_path, monkeypatch, capsys):
    """``main()`` end to end on an .mp4 (OpenCV is installed here): decode,
    the run with --profile, the five files under output/<name>/.  The
    built-in models are swapped for the oracle ones."""
    from eagle_tpu_torch.io.video import write_video

    sc = make_scene(num_frames=8, width=320, height=192, num_players=4, fps=8, seed=2)
    write_video(list(sc.frames), str(tmp_path / "clip.mp4"), 8)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(
        tmain,
        "CoordinateModel",
        lambda reid_checkpoint=None, device=None, **_weights: TModel(
            keypoint_fn=oracle_keypoint_fn(sc), detector_fn=oracle_detector_fn(sc), reid_checkpoint=reid_checkpoint,
            device=device,
        ),
    )
    tmain.main(["--video_path", str(tmp_path / "clip.mp4"), "--fps", "8", "--device", "cpu", "--profile"])
    out = tmp_path / "output" / "clip"
    assert sorted(os.listdir(out)) == sorted(JSON_FILES + ["annotated.mp4"])
    with open(out / "raw_coordinates.json") as f:
        assert sorted(json.load(f), key=int) == [str(i) for i in range(8)]
    assert '"temporal"' in capsys.readouterr().err


def _read_outputs(out_dir) -> dict:
    out = {}
    for name in JSON_FILES:
        with open(out_dir / name) as f:
            out[name] = json.load(f)
    return out


def test_cli_segment_frames_writes_what_the_one_shot_cli_writes(tmp_path, monkeypatch):
    """``--segment_frames 16`` on an .mp4 of 40 frames: the video streams in
    blocks of 16 + 16 + 8 through ``stream_coordinates``, the Processor and
    the render read frames by index from a lazy ``VideoFrameSource``, and
    the four JSON files equal the one-shot CLI's."""
    from eagle_tpu_torch.io.video import read_video_array, write_video

    sc = make_scene(num_frames=40, width=320, height=192, num_players=4, fps=8, seed=6)
    write_video(list(sc.frames), str(tmp_path / "clip.mp4"), 8)
    decoded, _ = read_video_array(str(tmp_path / "clip.mp4"), 8)
    index = {f.tobytes(): i for i, f in enumerate(decoded)}

    def detections(batch):
        """The scene's detections of each decoded frame, found by its
        content (a call cursor would be shifted by the blocks' batches)."""
        return tuple(np.stack(a) for a in zip(*(oracle_detections_at(sc, index[f.tobytes()]) for f in batch)))

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(
        tmain, "CoordinateModel",
        lambda device=None, **_weights: TModel(keypoint_fn=oracle_keypoint_fn(sc), detector_fn=detections, device=device),
    )
    outs = {}
    for flags in ([], ["--segment_frames", "16"]):
        tmain.main(["--video_path", str(tmp_path / "clip.mp4"), "--fps", "8", "--device", "cpu", *flags])
        out = tmp_path / "output" / "clip"
        assert sorted(os.listdir(out)) == sorted(JSON_FILES + ["annotated.mp4"])
        outs[bool(flags)] = _read_outputs(out)
        for name in os.listdir(out):
            os.remove(out / name)
    assert outs[True] == outs[False]
    assert len(outs[True]["raw_coordinates.json"]) == 40 and outs[True]["metadata.json"]["team_mapping"]


def test_cli_weights_flags_build_the_models_from_checkpoints(tmp_path, monkeypatch):
    """``--keypoint_weights k.pth --detector_weights d.pt --segment_frames
    8``: the reference's HRNet checkpoint and an ultralytics YOLOv8 state
    dict load into the built-in models bit for bit, and the streamed run
    writes the four files.  The models run at a reduced input size."""
    import dataclasses

    import jax

    from eagle_tpu.models import hrnet as jh
    from eagle_tpu.models import yolov8 as jy
    from eagle_tpu_torch.config import DEFAULT_CONFIG
    from eagle_tpu_torch.io.video import write_video
    from eagle_tpu_torch.models.bridge import hrnet_from_jax, yolov8_from_jax

    from .torch_parity import hrnet_reference_state_dict, spread_params, yolov8_ultralytics_state_dict

    rng = np.random.default_rng(2)
    hrnet = hrnet_from_jax(spread_params(jax.eval_shape(lambda: jh.init_params(jax.random.key(0))), rng))
    yolo = yolov8_from_jax(spread_params(
        jax.eval_shape(lambda: jy.init_params(jax.random.key(1), variant="n", num_classes=5)), rng, gain=1.0))
    with torch.no_grad():  # random boxes without a ball would stop the Processor, in both packages alike
        for level in yolo.head["levels"]:
            level.cls_out.b.fill_(-30.0)
    torch.save(hrnet_reference_state_dict(hrnet), tmp_path / "k.pth")
    torch.save(yolov8_ultralytics_state_dict(yolo), tmp_path / "d.pt")
    sc = make_scene(num_frames=12, width=320, height=192, num_players=4, fps=8, seed=2)
    write_video(list(sc.frames), str(tmp_path / "clip.mp4"), 8)
    cfg = DEFAULT_CONFIG.replace(
        detector=dataclasses.replace(DEFAULT_CONFIG.detector, image_size=160, use_bf16=False),
        keypoint=dataclasses.replace(DEFAULT_CONFIG.keypoint, input_hw=(96, 160), use_bf16=False),
        chunk_frames=8,
    )
    built = []

    def model(**kw):
        built.append(TModel(config=cfg, **kw))
        return built[-1]

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmain, "CoordinateModel", model)
    tmain.main(["--video_path", str(tmp_path / "clip.mp4"), "--fps", "8", "--device", "cpu", "--keypoint_weights",
                str(tmp_path / "k.pth"), "--detector_weights", str(tmp_path / "d.pt"), "--segment_frames", "8"])
    (m,) = built
    for got, want in ((m.keypoint_model, hrnet), (m.detector_model, yolo)):
        g, w = got.state_dict(), want.state_dict()
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)
    out = tmp_path / "output" / "clip"
    assert set(JSON_FILES) <= set(os.listdir(out))
    assert sorted(_read_outputs(out)["raw_coordinates.json"], key=int) == [str(i) for i in range(12)]


def test_cli_reid_weights_load_a_torchreid_state_dict(tmp_path, monkeypatch):
    """``--reid_weights r.pt``, a torchreid OSNet-x0.25 state dict, turns
    appearance association on with those weights (the use_appearance=None
    rule) and the run writes its outputs."""
    import dataclasses

    from eagle_tpu_torch.config import DEFAULT_CONFIG
    from eagle_tpu_torch.io.video import write_video

    from .torch_graphs import OSNetTorch, randomize_

    ref = randomize_(OSNetTorch("x0_25"), seed=1)
    torch.save(ref.state_dict(), tmp_path / "r.pt")
    sc = make_scene(num_frames=8, width=320, height=192, num_players=4, fps=8, seed=2)
    write_video(list(sc.frames), str(tmp_path / "clip.mp4"), 8)
    cfg = DEFAULT_CONFIG.replace(
        detector=dataclasses.replace(DEFAULT_CONFIG.detector, use_bf16=False),
        tracker=dataclasses.replace(DEFAULT_CONFIG.tracker, reid_slots=8),
    )
    built = []

    def model(reid_checkpoint=None, device=None, **_weights):
        built.append(TModel(config=cfg, keypoint_fn=oracle_keypoint_fn(sc), detector_fn=oracle_detector_fn(sc),
                            reid_checkpoint=reid_checkpoint, device=device))
        return built[-1]

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmain, "CoordinateModel", model)
    tmain.main(["--video_path", str(tmp_path / "clip.mp4"), "--fps", "8", "--device", "cpu",
                "--reid_weights", str(tmp_path / "r.pt")])
    (m,) = built
    assert m.config.tracker.use_appearance and m.reid_model is not None
    x = torch.randn(2, 3, 256, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(m.reid_model(x), ref(x), rtol=0, atol=1e-4)
    assert sorted(os.listdir(tmp_path / "output" / "clip")) == sorted(JSON_FILES + ["annotated.mp4"])


_NO_PANDAS_NO_CV2 = r"""
import json, os, sys
sys.modules["pandas"] = None
sys.modules["cv2"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eagle_tpu_torch.main import run
from eagle_tpu_torch.io.output import dumps_records
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

n, h, w = 10, 120, 192
rng = np.random.default_rng(0)
frames = np.empty((n, h, w, 3), np.uint8)
frames[:] = (60, 140, 70)
frames += rng.integers(0, 10, frames.shape, dtype=np.uint8)
jerseys = [(30, 30, 210), (200, 60, 20)]
boxes = np.zeros((n, 128, 4), np.float32)
valid = np.zeros((n, 128), bool)
cls = np.zeros((n, 128), np.int32)
for i in range(n):
    for p in range(4):
        x, y = 20 + 40 * p + i, 90
        frames[i, y - 30 : y - 12, x - 7 : x + 7] = jerseys[p % 2]
        boxes[i, p] = (x - 9, y - 34, x + 9, y)
        valid[i, p] = True
    boxes[i, 4] = (100 + 3 * i, 40, 106 + 3 * i, 46)
    valid[i, 4] = True
    cls[i, 4] = 2
index = {frames[i].tobytes(): i for i in range(n)}
kp = np.zeros((57, 3), np.float32)
kp[:6, :2] = rng.uniform(10, 100, (6, 2))

def keypoints(batch):
    v = np.zeros((len(batch), 57), bool)
    v[:, :6] = True
    return np.tile(kp, (len(batch), 1, 1)), v

def detections(batch):
    idx = [index[f.tobytes()] for f in batch]
    return boxes[idx], np.where(valid[idx], 0.9, 0.0).astype(np.float32), cls[idx], valid[idx]

d = sys.argv[1]
model = CoordinateModel(keypoint_fn=keypoints, detector_fn=detections, device="cpu")
out = run(frames, 5, d, model=model, annotated=False)
assert sorted(os.listdir(d)) == ["metadata.json", "processed_data.json", "raw_coordinates.json", "raw_data.json"]
for name in os.listdir(d):
    json.load(open(os.path.join(d, name)))
assert sorted(set(out["team_mapping"].values())) == [0, 1], out["team_mapping"]
assert json.loads(dumps_records(out["table"].records())) == json.load(open(os.path.join(d, "raw_data.json")))
try:
    run(frames, 5, d, model=model, annotated=True)
    raise SystemExit("annotated.mp4 without OpenCV must raise")
except ImportError as e:
    assert "OpenCV" in str(e), e
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("pandas", "cv2", "jax", "eagle_tpu") and sys.modules[m] is not None)
assert not bad, bad
print("no pandas, no cv2: ok")
"""


def test_processor_writers_and_cli_run_without_pandas_or_cv2(tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", _NO_PANDAS_NO_CV2, str(tmp_path)],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=240,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "no pandas, no cv2: ok" in r.stdout
