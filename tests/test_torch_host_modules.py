"""PyTorch port, the host modules of the multi-device slice against the
JAX package's: the time-sharded ball selector
(``Processor.parse_ball_detections_segmented``), the ``.msgpack`` writer
(``models/checkpoint.py::{save_params, convert_and_save}`` and the
``convert_weights`` CLI), ``utils/pitchplot.py`` and the host team votes
(``ProcessorConfig.team_assign="host"``, ``Processor.detect_color``).

Tolerance: none.  Picks, file bytes, restored trees, polygons, drawn line
data, colour counts and team mappings are equal."""

import sys

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from eagle_tpu.config import ProcessorConfig as JConfig
from eagle_tpu.models import checkpoint as jcheckpoint
from eagle_tpu.models import hrnet as jh
from eagle_tpu.models import yolov8 as jy
from eagle_tpu.pipeline.processor import Processor as JProcessor
from eagle_tpu.utils import pitchplot as jplot
from eagle_tpu_torch.config import ProcessorConfig as TConfig
from eagle_tpu_torch.models import bridge
from eagle_tpu_torch.models import checkpoint as tcheckpoint
from eagle_tpu_torch.models.convert_weights import main as convert_cli
from eagle_tpu_torch.ops.color import bgr_to_hsv_u8
from eagle_tpu_torch.pipeline.processor import Processor as TProcessor
from eagle_tpu_torch.utils import pitchplot as tplot

from .test_timeshard import _ball_stream
from .test_torch_processor import made_clip
from .torch_parity import (
    assert_trees_bit_equal,
    hrnet_reference_state_dict,
    osnet_params,
    spread_params,
    yolov8_ultralytics_state_dict,
)

torch.set_num_threads(2)

EMPTY = {0: {"Coordinates": {}, "Boundaries": [None] * 4, "Keypoints": {}}}


# ---------------------------------------------------------------------------
# the time-sharded ball selector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("segments,passes", [(4, 2), (8, 2), (8, 3)])
@pytest.mark.parametrize("filt", [False, True])
def test_segmented_ball_selection_matches_jax(segments, passes, filt):
    stream = _ball_stream(seed=segments + 10 * passes)
    frames = np.zeros((1, 8, 8, 3), np.uint8)
    kw = dict(segments=segments, filter=filt, threshold=100, passes=passes)
    want = JProcessor(EMPTY, frames, 8).parse_ball_detections_segmented(stream, **kw)
    got = TProcessor(EMPTY, frames, 8, device="cpu").parse_ball_detections_segmented(stream, **kw)
    assert got == want
    seq = TProcessor(EMPTY, frames, 8, device="cpu").parse_ball_detections_with_kalman(stream, filter=filt, threshold=100)
    n = len(stream)
    exact_until = round(passes * n / segments)
    assert got[:exact_until] == seq[:exact_until] and got != stream


def test_segmented_ball_selection_falls_back_as_jax_does():
    """A segment with no filter of its own and no warm carry: the exact
    sequential pass, never raw candidate lists."""
    stream = _ball_stream(n=40, seed=3, none_rate=0.0)
    for t in range(12, 40):
        stream[t] = None
    stream[20] = [(125.0, 100.0), (500.0, 500.0)]
    frames = np.zeros((1, 8, 8, 3), np.uint8)
    kw = dict(segments=4, filter=False, threshold=100, passes=2)
    got = TProcessor(EMPTY, frames, 8, device="cpu").parse_ball_detections_segmented(stream, **kw)
    assert got == JProcessor(EMPTY, frames, 8).parse_ball_detections_segmented(stream, **kw)
    assert all(v is None or (isinstance(v, tuple) and len(v) == 2) for v in got)


# ---------------------------------------------------------------------------
# the .msgpack writer
# ---------------------------------------------------------------------------


def _trees():
    hr = spread_params(jax.eval_shape(lambda: jh.init_params(jax.random.key(0))), np.random.default_rng(0))
    yolo = spread_params(jax.eval_shape(lambda: jy.init_params(jax.random.key(1), variant="n", num_classes=5)),
                         np.random.default_rng(1), gain=1.0)
    return {"hrnet": (hr, bridge.hrnet_from_jax), "yolov8": (yolo, bridge.yolov8_from_jax),
            "osnet": (osnet_params(5, feature_dim=64), bridge.osnet_from_jax)}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("model", ["hrnet", "yolov8", "osnet"])
def test_save_params_writes_the_jax_packages_bytes(tmp_path, trees, model):
    """The port's file is byte for byte the JAX package's ``save_params``
    (``flax.serialization.to_bytes`` of the tree's numpy leaves), from the
    tree and from the port's module (``bridge.params_from_module``); both
    packages read it back bit-equal, the JAX package with a template."""
    params, build = trees[model]
    want = jcheckpoint.save_params(params, str(tmp_path / "jax.msgpack"))
    want_bytes = open(want, "rb").read()
    assert want_bytes == flax.serialization.to_bytes(jax.tree.map(np.asarray, params))
    got = tcheckpoint.save_params(params, str(tmp_path / "port.msgpack"))
    assert open(got, "rb").read() == want_bytes
    module = tcheckpoint.save_params(build(params), str(tmp_path / "module.msgpack"))
    assert open(module, "rb").read() == want_bytes
    assert_trees_bit_equal(jcheckpoint.load_params(got, template=jax.tree.map(np.asarray, params)), params)
    assert_trees_bit_equal(tcheckpoint.load_params(got), jcheckpoint.load_params(want))


def test_writer_follows_flax_on_scalars_order_and_chunks(tmp_path, monkeypatch):
    """``to_bytes`` equals flax's on a tree of every leaf kind (insertion
    order kept, lists keyed by index, numpy scalars as type 3, Python
    numbers in msgpack's smallest encodings); with the chunk limit lowered
    in both, leaves over it are chunked alike, and the port's reader joins
    the chunks."""
    tree = {"b": [np.float32(1.5), None, {"x": np.arange(300, dtype=np.int64)}], "a": np.zeros((), np.float32),
            "n": list(range(12)), 3: 2.5, "s": "x" * 40, "i": [-1, -100, -40000, 200, 70000, 2**40, True, b"ab"]}
    assert tcheckpoint.to_bytes(tree) == flax.serialization.to_bytes(tree)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(tcheckpoint, "MAX_CHUNK_SIZE", 256)
    big = {"w": np.arange(1000, dtype=np.float32).reshape(10, 100), "v": {"u": np.ones(3, np.float32)}}
    assert tcheckpoint.to_bytes(big) == flax.serialization.to_bytes(big)
    path = tcheckpoint.save_params(big, str(tmp_path / "chunked.msgpack"))
    assert_trees_bit_equal(tcheckpoint.load_params(path), big)
    assert_trees_bit_equal(jcheckpoint.load_params(path, template=big), big)


@pytest.mark.parametrize("kind", ["hrnet", "yolov8"])
def test_convert_and_save_writes_the_jax_packages_file(tmp_path, trees, kind):
    """A synthetic reference ``.pth`` (HRNet) and ultralytics state dict
    (YOLOv8-n) through both packages' ``convert_and_save``, and through the
    port's CLI: the same bytes."""
    params, build = trees[kind]
    writer = hrnet_reference_state_dict if kind == "hrnet" else yolov8_ultralytics_state_dict
    src = tmp_path / f"{kind}.pt"
    torch.save(writer(build(params)), src)
    want = open(jcheckpoint.convert_and_save(str(src), str(tmp_path / "jax.msgpack"), kind), "rb").read()
    got = tcheckpoint.convert_and_save(str(src), str(tmp_path / "port" / "out.msgpack"), kind)
    assert open(got, "rb").read() == want
    convert_cli(["--kind", kind, "--src", str(src), "--out", str(tmp_path / "cli.msgpack")])
    assert (tmp_path / "cli.msgpack").read_bytes() == want
    with pytest.raises(ValueError, match="unknown kind"):
        tcheckpoint.convert_and_save(str(src), str(tmp_path / "x.msgpack"), "resnet")


# ---------------------------------------------------------------------------
# pitchplot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_voronoi_polygons_match_jax(seed):
    rng = np.random.default_rng(seed)
    xs, ys = rng.uniform(2, 103, 22), rng.uniform(2, 66, 22)
    teams = (np.arange(22) % 2).astype(int)
    got, want = tplot.voronoi_polygons(xs, ys, teams), jplot.voronoi_polygons(xs, ys, teams)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 11
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_draw_pitch_draws_the_jax_packages_lines():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a, b) = plt.subplots(1, 2)
    try:
        tplot.draw_pitch(a, line_color="yellow", pitch_color="navy", linewidth=1.2)
        jplot.draw_pitch(b, line_color="yellow", pitch_color="navy", linewidth=1.2)
        assert len(a.lines) == len(b.lines) >= 24 and len(a.collections) == len(b.collections) == 3
        for la, lb in zip(a.lines, b.lines):
            np.testing.assert_array_equal(la.get_xydata(), lb.get_xydata())
            assert (la.get_color(), la.get_linewidth(), la.get_zorder()) == (lb.get_color(), lb.get_linewidth(), lb.get_zorder())
        for ca, cb in zip(a.collections, b.collections):
            np.testing.assert_array_equal(ca.get_offsets(), cb.get_offsets())
        assert (a.get_xlim(), a.get_ylim(), a.get_aspect(), a.get_facecolor(), a.axison) == (
            b.get_xlim(), b.get_ylim(), b.get_aspect(), b.get_facecolor(), b.axison)
    finally:
        plt.close(fig)


# ---------------------------------------------------------------------------
# the host team votes
# ---------------------------------------------------------------------------


def test_hsv_is_cv2s_on_every_colour():
    cv2 = pytest.importorskip("cv2")
    a = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([a & 255, (a >> 8) & 255, a >> 16], -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(bgr_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


def test_host_team_votes_match_jax():
    """Every eligible crop of a made clip and 12 noise crops: the same
    colour counts as the JAX package's ``detect_color``, and the same team
    mapping, which ``process_data`` returns."""
    coords, frames, fps = made_clip(n=24)
    tproc = TProcessor(coords, frames, fps, config=TConfig(team_assign="host"), device="cpu")
    jproc = JProcessor(coords, frames, fps, config=JConfig(team_assign="host"))
    entries = tproc._crop_entries()
    assert entries == jproc._crop_entries() and len(entries) > 40
    rng = np.random.default_rng(5)
    crops = [np.asarray(frames[fi])[y1:y2, x1:x2] for fi, _pid, (x1, y1, x2, y2), _ in entries]
    crops += [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8) for h, w in rng.integers(4, 40, (12, 2))]
    for crop in crops:
        assert tproc.detect_color(crop) == jproc.detect_color(crop)
    mapping = jproc.get_team_mapping()
    assert tproc.get_team_mapping() == mapping and len(set(mapping.values())) == 2
    assert tproc.process_data()[1] == mapping


def test_host_votes_without_sklearn_raise(monkeypatch):
    coords, frames, fps = made_clip(n=4)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    proc = TProcessor(coords, frames, fps, config=TConfig(team_assign="host"), device="cpu")
    with pytest.raises(ImportError, match="sklearn"):
        proc.get_team_mapping()
