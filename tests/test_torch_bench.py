"""PyTorch port: the end-to-end bench (``python -m eagle_tpu_torch.bench``)
at a tiny size on the CPU, its oracle rows against ``tests/oracles.py``,
the injected model against the JAX ``CoordinateModel`` under the JAX
bench's injection (``bench.py:182-260``), and ``StageTimer.summary``
against the JAX package's.

Tolerances: the oracle rows and keypoints bit-equal; the injected runs'
coordinates at ``tests/test_torch_coordinate_model.py``'s oracle-clip
tolerances (boundaries within 5 mm, boxes and pitch positions within 1,
confidences within 1e-4, keypoints, classes and ids equal).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.models import hrnet as jh
from eagle_tpu.models import yolov8 as jy
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.profiling import StageTimer as JTimer
from eagle_tpu_torch import bench
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.coordinate_model import StageTimer as TTimer
from eagle_tpu_torch.utils import oracles as toracles
from eagle_tpu_torch.utils.synthetic import make_scene

from . import oracles as joracles
from .test_torch_coordinate_model import assert_coords_match
from .torch_parity import spread_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tiny configuration: YOLOv8-m at a 160-px canvas and HRNet-W48 at
#: 64x96, float32 (the working-resolution path of 320x192 frames)
TINY = dict(image_size=160, input_hw=(64, 96))


def tiny(cfg):
    return cfg.replace(
        detector=dataclasses.replace(cfg.detector, variant="medium", image_size=TINY["image_size"], use_bf16=False),
        keypoint=dataclasses.replace(cfg.keypoint, input_hw=TINY["input_hw"], use_bf16=False),
    )


@pytest.fixture(scope="module")
def params():
    """Seeded HRNet-W48 and YOLOv8-m pytrees of the JAX package with
    signal-preserving weights; the port takes them through the bridge."""
    rng = np.random.default_rng(0)
    kp = spread_params(jax.eval_shape(lambda: jh.init_params(jax.random.key(0))), rng)
    det = jax.eval_shape(lambda: jy.init_params(jax.random.key(1), variant="m", num_classes=5))
    return kp, spread_params(det, rng, gain=1.0)


def test_oracle_rows_bit_equal_to_the_test_oracles():
    """(a) ``utils/oracles.py`` against ``tests/oracles.py``, every frame,
    with and without dropped players."""
    scene = make_scene(num_frames=6, width=640, height=360, num_players=10, fps=6, seed=4)
    for t in range(len(scene.frames)):
        for drop in ((), (1, 4)):
            got = toracles.oracle_detections_at(scene, t, 32, drop)
            want = joracles.oracle_detections_at(scene, t, 32, drop)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    got = toracles.oracle_keypoint_fn(scene)(scene.frames[:3])
    want = joracles.oracle_keypoint_fn(scene)(scene.frames[:3])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_bench_runs_at_a_tiny_size_on_the_cpu(params, capsys):
    """(b) ``bench.run`` with the tiny model on an 8-frame 320x192 scene,
    two reps: the last stdout line is the headline with every key, the
    device is "cpu" with no device metric, each path's launch counters were
    read (the CPU runs the kernels' plain versions: no launch), and the
    gates pass."""
    scene = make_scene(num_frames=8, width=320, height=192, num_players=10, fps=8, seed=0)
    model = TModel(config=tiny(TCFG), keypoint_params=params[0], detector_params=params[1], device="cpu")
    ret = bench.run(model, scene, reps=2, budget_s=600)
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[-1])
    assert head == json.loads(json.dumps(ret)) and sorted(head) == sorted(bench.KEYS)
    assert len(lines) == 4, "the start, each rep and the untimed window"
    assert head["status"] == "ok", head["status"]
    assert head["device"] == "cpu" and head["reps"] == 2 and head["frames"] == 8
    for m in bench.METRICS:
        lo, hi = head[f"{m}_spread"]
        assert 0 < lo <= head[m] <= hi
    assert head["value"] == head["end_to_end_720p_frames_per_sec"]
    assert head["players_per_frame"] >= bench.MIN_PLAYERS
    assert head["players_pitch_error_m_median"] < 2.0
    assert head["prescale_ms_per_frame"] > 0 and head["temporal_ms_per_frame"] > 0
    for key in ("dispatch_ms", "rtt_ms", "peak_device_memory_GiB", "temporal_blocking_calls_per_frame",
                "temporal_waiting_calls_per_frame", "temporal_device_idle_share", "detector_device_idle_share",
                "traced_kernels", "traced_run_launches"):
        assert head[key] is None, key
    assert list(head["launches"]) == list(bench.PATHS)
    for counts in head["launches"].values():
        assert counts == {"lk_flow": 0, "auction": 0, "nms": 0, "ransac_keys": 0, "eigh9": 0, "lap_jv": 0}


def test_injection_cursor_follows_the_batches(params):
    """The detector wrapper's rows follow the batches' real sizes and wrap
    modulo the clip; ``reset`` starts over; the keypoint wrapper tiles the
    landmarks to its batch; both return the oracle's values exactly."""
    scene = make_scene(num_frames=20, width=320, height=192, num_players=10, fps=8, seed=1)
    model = TModel(config=tiny(TCFG), keypoint_params=params[0], detector_params=params[1], device="cpu")
    inj = bench.OracleInjection(model, scene)
    hw = (192, 320)
    geom = model._geometry(hw)
    x = model.upload(scene.frames, geom)
    for lo, hi, rows in ((0, 16, range(16)), (0, 16, [16, 17, 18, 19, *range(12)]), (16, 20, range(12, 16))):
        got = model.run_detector(x[lo:hi], geom, hw)
        assert torch.equal(got, torch.from_numpy(inj.det_rows[list(rows)])), (lo, hi)
    inj.reset()
    assert torch.equal(model.run_detector(x[4:8], geom, hw), torch.from_numpy(inj.det_rows[:4]))
    kp = model.run_keypoints(x[:3], geom, hw)
    assert torch.equal(kp, torch.from_numpy(np.tile(inj.kp_row, (3, 1, 1))))


def test_bench_entry_point_imports_no_jax_and_needs_a_card():
    """(c) ``python -m eagle_tpu_torch.bench --help`` loads no module of JAX
    or the JAX package; without a card and without ``--device cpu`` the
    bench raises before it runs anything."""
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['bench', '--help']\n"
        "try:\n"
        "    runpy.run_module('eagle_tpu_torch.bench', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print('loaded', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'eagle_tpu')))\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=REPO, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    for flag in ("--frames", "--reps", "--budget-s", "--seed", "--device"):
        assert flag in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "loaded []"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(["--reps", "1"])


def _jax_injected(model, scene):
    """The JAX bench's injection (``bench.py:182-260``) on a JAX model:
    the detector program's values replaced by the scene's rows at a cursor
    advanced by each piece's size, the keypoint programs' by the still
    camera's landmarks; every real program still runs."""
    n = len(scene.frames)
    hw = scene.frames.shape[1:3]
    geom = model._geometry(hw)
    real_det = model._det_runner(geom, hw)
    d = model.config.detector.max_detections
    rows = []
    for t in range(n):
        b, s, c, v = joracles.oracle_detections_at(scene, t, d)
        rows.append(np.concatenate([b, s[:, None], c.astype(np.float32)[:, None], v.astype(np.float32)[:, None]], -1))
    rows = np.stack(rows)
    cursor = {"i": 0}

    @jax.jit
    def mix(real, oracle):
        return oracle + 0.0 * real[..., :7]

    def injected_det(piece):
        real = real_det(piece)
        b = int(piece.shape[0])
        start = cursor["i"] % n
        cursor["i"] += b
        return mix(real, jnp.asarray(rows[(start + np.arange(b)) % n]))

    model._jit_cache[("det", geom, hw)] = injected_det
    okp, ovalid = joracles.oracle_keypoint_fn(scene)(scene.frames[:1])
    kp_row = np.concatenate([okp[0], ovalid[0].astype(np.float32)[:, None]], -1)
    real_pieces, real_kp = model._kp_pieces_runner, model._kp_runner

    def injected_pieces(g, h, pattern):
        real = real_pieces(g, h, pattern)

        def run(*pieces):
            real(*pieces)
            return np.tile(kp_row, (len(pattern), 1, 1))

        return run

    def injected_kp(g, h):
        real = real_kp(g, h)

        def run(batch):
            real(batch)
            return np.tile(kp_row, (len(batch), 1, 1))

        return run

    model._kp_pieces_runner, model._kp_runner = injected_pieces, injected_kp
    return model


def test_injected_model_matches_jax_under_the_same_injection(params):
    """(d) The port's injected model (:class:`bench.OracleInjection`) and
    the JAX model under the JAX bench's injection, same weights, on a
    12-frame scene: the same coordinates, and both hold the scene's
    truth."""
    scene = make_scene(num_frames=12, width=320, height=192, num_players=10, fps=12, seed=2)
    kw = dict(bench.CADENCE)
    jmodel = JModel(config=tiny(JCFG), keypoint_params=params[0], detector_params=params[1], verbose_init=False)
    want = _jax_injected(jmodel, scene).get_coordinates(scene.frames, scene.fps, verbose=False, **kw)
    tmodel = TModel(config=tiny(TCFG), keypoint_params=params[0], detector_params=params[1], device="cpu")
    assert tmodel._geometry((192, 320)).enabled
    bench.OracleInjection(tmodel, scene)
    got = tmodel.get_coordinates(scene.frames, scene.fps, **kw)
    assert assert_coords_match(got, want, boundary_atol=5e-3) >= 10 * len(scene.frames) * 0.8
    assert bench.players_per_frame(got) >= bench.MIN_PLAYERS
    assert all(len(fr["Keypoints"]) >= 4 and fr["Boundaries"][0] is not None for fr in got.values())


def test_stage_timer_summary_matches_jax():
    """``StageTimer.summary()``: the JAX package's stages, keys and call
    counts, largest total first."""
    jt, tt = JTimer(), TTimer(torch.device("cpu"))
    for name, reps in (("detector", 3), ("temporal", 1), ("assembly", 2)):
        for _ in range(reps):
            for timer in (jt, tt):
                with timer(name):
                    sum(range(100))
    got, want = tt.summary(), jt.summary()
    assert sorted(got) == sorted(want) and tt.counts == dict(jt.counts)
    assert list(got) == sorted(tt.seconds, key=tt.seconds.get, reverse=True)
    for name in want:
        assert sorted(got[name]) == sorted(want[name]) == ["calls", "mean_ms", "total_s"]
        assert got[name]["calls"] == want[name]["calls"]
