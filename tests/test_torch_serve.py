"""PyTorch port, clip-pipelined serving (``eagle_tpu_torch/pipeline/
serve.py::serve_clips``): the results equal the reference's sequential
order -- ``get_coordinates``, then the ``Processor`` and ``format_data``,
one clip at a time -- with the Processor of clip k on a worker thread
while clip k+1 is perceived, and clip k+1's host prescale prefetched.

Tolerance: none (coordinates, the table with NaN equal to NaN, the team
mapping and the formatted records are equal)."""

import math

import pytest
import torch

from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.pipeline import serve as serve_mod
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.processor import Processor
from eagle_tpu_torch.pipeline.serve import ClipResult, serve_clips

from .oracles import oracle_detector_fn, oracle_keypoint_fn

torch.set_num_threads(2)

FPS = 10


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=10, width=320, height=192, num_players=4, fps=FPS, seed=31)


def _clips(scene):
    return [scene.frames, scene.frames[:8], scene.frames[2:]]


def _model(scene):
    """A fresh model a pass: the oracle detector carries a call cursor, so
    a model used twice would see other detections the second time."""
    return TModel(keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene), device="cpu")


def assert_tables_equal(a, b):
    def same(x, y):
        if isinstance(x, float) and math.isnan(x):
            return isinstance(y, float) and math.isnan(y)
        return type(x) is type(y) and x == y

    assert a.index == b.index and list(a.columns) == list(b.columns)
    for c in a.columns:
        assert len(a[c]) == len(b[c]) and all(map(same, a[c], b[c])), c


@pytest.fixture(scope="module")
def sequential(scene):
    """The reference's order, by hand."""
    model = _model(scene)
    out = []
    for clip in _clips(scene):
        coords = model.get_coordinates(clip, FPS, num_keypoint_detection=2)
        proc = Processor(coords, clip, FPS, device="cpu")
        table, mapping = proc.process_data()
        out.append(ClipResult(coords, table, mapping, proc.format_data(table)))
    return out


@pytest.mark.parametrize("overlap", [False, True])
def test_serve_matches_sequential_exactly(scene, sequential, overlap):
    """Three clips from a generator, in order, each equal to its sequential
    run."""
    served = list(serve_clips(_model(scene), iter(_clips(scene)), FPS, num_keypoint_detection=2, overlap=overlap))
    assert len(served) == 3
    for got, exp in zip(served, sequential):
        assert got.coordinates == exp.coordinates
        assert_tables_equal(got.table, exp.table)
        assert got.team_mapping == exp.team_mapping and len(set(exp.team_mapping.values())) == 2
        assert got.formatted == exp.formatted


def test_serve_empty_iterable(scene):
    assert list(serve_clips(_model(scene), [], FPS)) == []
    assert list(serve_clips(_model(scene), iter([]), FPS, overlap=True)) == []


def test_overlap_auto_follows_available_cpus(scene, monkeypatch):
    """``overlap="auto"`` starts the two worker pools exactly when a spare
    core exists; the results are the same either way."""
    import eagle_tpu_torch.utils as utils_mod

    built = []
    real = serve_mod.ThreadPoolExecutor

    class Recording(real):
        def __init__(self, *a, **kw):
            built.append(True)
            super().__init__(*a, **kw)

    monkeypatch.setattr(serve_mod, "ThreadPoolExecutor", Recording)
    monkeypatch.setattr(utils_mod, "available_cpus", lambda: 1)
    (one,) = serve_clips(_model(scene), [scene.frames[:6]], FPS)
    assert built == []
    monkeypatch.setattr(utils_mod, "available_cpus", lambda: 8)
    (many,) = serve_clips(_model(scene), [scene.frames[:6]], FPS)
    assert len(built) == 2
    assert one.coordinates == many.coordinates and one.formatted == many.formatted
