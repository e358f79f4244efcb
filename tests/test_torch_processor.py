"""PyTorch port, the Processor (``eagle_tpu_torch/pipeline/processor.py``,
pandas-free) against the JAX package's (pandas) on identical coordinates
and frames: the oracle pipeline's coordinates of a synthetic clip, and a
seeded clip of hand-made coordinates that reaches every branch (rows
without persons, frames without a homography, ids seen once and dropped
by the coverage floor, goalkeepers that were players, track fragments
that merge, several ball candidates, the ball jump filter).

Tolerances: none.  The team mappings are equal, the tables are equal cell
by cell after the port's records go through pandas (columns, index, every
tuple and every NaN), and ``format_data``'s records are equal."""

import math

import numpy as np
import pandas as pd
import pytest
import torch

from eagle_tpu.config import ProcessorConfig as JConfig
from eagle_tpu.ops.kalman import CvKalman2D as JKalman
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.pipeline.processor import Processor as JProcessor
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import ProcessorConfig as TConfig
from eagle_tpu_torch.ops.kalman import CvKalman2D as TKalman
from eagle_tpu_torch.pipeline.processor import Processor as TProcessor

from .oracles import oracle_detector_fn, oracle_keypoint_fn

torch.set_num_threads(2)

JERSEYS = [(30, 30, 210), (200, 60, 20)]  # BGR: red, blue


@pytest.fixture(scope="module")
def oracle_clip():
    sc = make_scene(num_frames=20, width=960, height=540, num_players=6, fps=20, seed=11)
    coords = JModel(
        keypoint_fn=oracle_keypoint_fn(sc), detector_fn=oracle_detector_fn(sc), verbose_init=False
    ).get_coordinates(sc.frames, sc.fps, num_homography=1, num_keypoint_detection=3, verbose=False)
    return coords, list(sc.frames), sc.fps


def made_clip(n: int = 120, h: int = 360, w: int = 640, fps: int = 20, seed: int = 0):
    """(coords, frames, fps): hand-made ``get_coordinates`` output over
    frames painted to match it (green pitch, players as jersey-coloured
    torsos over dark shorts)."""
    rng = np.random.default_rng(seed)
    frames = np.empty((n, h, w, 3), np.uint8)
    frames[:] = (60, 140, 70)
    frames += rng.integers(0, 12, frames.shape, dtype=np.uint8)
    # id -> (team, list of (first, last) frame spans, start x, y, speed)
    players = {
        1: (0, [(0, n - 1)], 60, 120, 1.0),
        2: (1, [(0, n - 1)], 400, 220, -0.8),
        3: (0, [(5, 70)], 150, 260, 1.5),
        4: (1, [(0, 40)], 300, 100, 2.0),
        # 4's continuation after an 8-frame gap, close to where 4 left off
        9: (1, [(49, n - 1)], 300, 100, 2.0),
        5: (0, [(20, 30), (34, 90)], 500, 300, -1.2),
        7: (1, [(60, 60)], 200, 180, 0.0),  # seen in one frame: under the coverage floor
    }
    goalkeepers = {3: [(75, n - 1)], 20: [(0, n - 1)]}  # 3 turns from player to goalkeeper
    coords = {}
    for i in range(n):
        objs = {"Player": {}, "Goalkeeper": {}}
        homography = i % 7 != 3
        for pid, (team, spans, x0, y0, v) in players.items():
            if not any(a <= i <= b for a, b in spans) or (i % 11 == 5 and pid in (1, 2)):
                continue
            cx, by = int(x0 + v * i), int(y0 + 3 * math.sin(i / 5 + pid))
            box = [cx - 12, by - 50, cx + 12, by]
            frames[i, by - 45 : by - 20, cx - 10 : cx + 10] = JERSEYS[team]
            frames[i, by - 20 : by - 2, cx - 8 : cx + 8] = (20, 20, 20)
            tc = [int(cx / 6), int(by / 5)] if homography and i % 5 else None
            objs["Player"][pid] = {"BBox": box, "Confidence": 0.9, "Transformed_Coordinates": tc}
        for gid, spans in goalkeepers.items():
            if not any(a <= i <= b for a, b in spans):
                continue
            cx, by = 600 if gid == 20 else int(150 + 1.5 * i), 200 if gid == 20 else int(260 + 3 * math.sin(i / 5 + 3))
            box = [cx - 12, by - 50, cx + 12, by]
            frames[i, by - 45 : by - 20, cx - 10 : cx + 10] = (40, 220, 220)
            tc = [int(cx / 6), int(by / 5)] if homography else None
            objs["Goalkeeper"][gid] = {"BBox": box, "Confidence": 0.8, "Transformed_Coordinates": tc}
        if i % 13 == 6:  # a frame with nobody in it
            objs = {"Player": {}, "Goalkeeper": {}}
        if i % 4:
            balls = {}
            for k in range(1 + i % 3):
                bx = 320 + 2.5 * i + 40 * k * (-1) ** i + (150 if i == 50 and k == 0 else 0)
                by = 200 + i
                box = [int(bx) - 4, int(by) - 8, int(bx) + 4, int(by)]
                tc = [int(bx / 6), int(by / 5)] if homography and k != 1 else None
                balls[k] = {"BBox": box, "Confidence": 0.9 - 0.2 * k + 0.01 * (i % 2), "Transformed_Coordinates": tc}
            objs["Ball"] = balls
        corners = [(2.5 + 0.01 * i, 68), (10.0, 0), (95.25, 0), (101.5 - 0.01 * i, 68)]
        coords[i] = {
            "Coordinates": objs,
            "Time": f"00:{i // fps:02d}",
            "Keypoints": {},
            "Boundaries": corners if homography else [None, None, None, None],
        }
    return coords, list(frames), fps


def _as_frame(table) -> pd.DataFrame:
    """The port's table through pandas, as the JAX package builds its own."""
    return pd.DataFrame(
        {c: pd.Series(cells, index=table.index, dtype=object) for c, cells in table.columns.items()},
        index=table.index,
    )


def _same_cell(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def assert_tables_equal(got, want: pd.DataFrame) -> None:
    got = _as_frame(got)
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index)
    for col in want.columns:
        for k in want.index:
            assert _same_cell(got.at[k, col], want.at[k, col]), f"{col}@{k}: {got.at[k, col]!r} != {want.at[k, col]!r}"


def assert_records_equal(got: list, want: pd.DataFrame) -> None:
    want = want.to_dict("records")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if key == "Boundaries":
                assert all(_same_cell(a, b) for a, b in zip(g[key], w[key])) and len(g[key]) == len(w[key])
                continue
            assert [(x["ID"], x.get("Type")) for x in g[key]] == [(x["ID"], x.get("Type")) for x in w[key]]
            assert all(_same_cell(x["Coordinates"], y["Coordinates"]) for x, y in zip(g[key], w[key]))


def run_both(clip, smooth=False, filter_ball=False, merge=True):
    coords, frames, fps = clip
    jp = JProcessor(coords, frames, fps, filter_ball_detections=filter_ball,
                    config=JConfig(enable_fragment_merge=merge))
    tp = TProcessor(coords, frames, fps, filter_ball_detections=filter_ball,
                    config=TConfig(enable_fragment_merge=merge), device="cpu")
    want, want_map = jp.process_data(smooth=smooth)
    got, got_map = tp.process_data(smooth=smooth)
    return (got, got_map, tp.format_data(got)), (want, want_map, jp.format_data(want))


@pytest.mark.parametrize("smooth,filter_ball", [(False, False), (True, False), (False, True)])
def test_processor_matches_jax_on_the_oracle_clip(oracle_clip, smooth, filter_ball):
    (got, got_map, got_fmt), (want, want_map, want_fmt) = run_both(oracle_clip, smooth, filter_ball)
    assert got_map == want_map and len(set(got_map.values())) == 2
    assert_tables_equal(got, want)
    assert_records_equal(got_fmt, want_fmt)


@pytest.mark.parametrize(
    "smooth,filter_ball,merge", [(False, False, True), (True, False, True), (False, True, True), (False, False, False)]
)
def test_processor_matches_jax_on_a_made_clip(smooth, filter_ball, merge):
    clip = made_clip()
    (got, got_map, got_fmt), (want, want_map, want_fmt) = run_both(clip, smooth, filter_ball, merge)
    assert got_map == want_map
    assert set(got_map.values()) == {0, 1}
    assert_tables_equal(got, want)
    assert_records_equal(got_fmt, want_fmt)
    cols = set(got.columns)
    assert "Player_7" not in cols, "the coverage floor drops an id seen once"
    assert "Player_3_video" not in cols and "Goalkeeper_3_video" in cols, "player 3 became goalkeeper 3"
    assert ("Player_9_video" in cols) != merge, "fragment 9 merges into 4"


def test_processor_on_a_clip_without_detections():
    n = 4
    coords = {
        i: {"Coordinates": {}, "Time": "00:00", "Keypoints": {},
            "Boundaries": [[0.0, 0.0], [0.0, 0.0], [105.0, 0.0], [105.0, 68.0]]}
        for i in range(n)
    }
    frames = list(np.zeros((n, 64, 64, 3), np.uint8))
    proc = TProcessor(coords, frames, 24, device="cpu")
    table, team_mapping = proc.process_data()
    want, want_map = JProcessor(coords, frames, 24).process_data()
    assert want.empty and want_map == {}
    assert table.empty and team_mapping == {} and table.records() == []
    assert proc.format_data(table) == []


def test_cv_kalman_matches_jax_step_by_step():
    rng = np.random.default_rng(0)
    a, b = JKalman((10.5, 20.25), (1.5, -0.75)), TKalman((10.5, 20.25), (1.5, -0.75))
    for step in range(40):
        if step % 3 == 0:
            z = rng.normal([100, 50], 20, 2).astype(np.float32).reshape(2, 1)
            np.testing.assert_array_equal(b.correct(z), a.correct(z))
        else:
            np.testing.assert_array_equal(b.predict(), a.predict())
        for name in ("state_pre", "state_post", "p_pre", "p_post"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
            assert getattr(b, name).dtype == np.float32


def test_processor_needs_the_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TProcessor({}, [], 24)
    with pytest.raises(NotImplementedError, match="team_assign"):
        TProcessor({}, [], 24, config=TConfig(team_assign="host"), device="cpu")
