"""PyTorch port, the frame-sharded keypoint and detector steps and the
clip-parallel scan (``eagle_tpu_torch/parallel/pipeline.py``) on 2 and 4
gloo ranks (``tests/torch_parity.py::RankPool``; the ranks import no JAX),
against the JAX package's ``sharded_keypoint_step``,
``sharded_detector_step`` and ``multi_clip_scan`` on a mesh of as many of
the 8 virtual CPU devices, on the same inputs and weights.

The steps: 8 random 64x96 frames (``tests/test_parallel.py``'s) through
the port's HRNet and YOLOv8-n with weights redrawn from a seed
(``torch_parity.spread_module``), the JAX package given the same weights
(``bridge.params_from_module``); 64x96 letterboxed to 64 puts the
un-letterboxing's pad and gain to work.  The scan: ranks + 1 make_scene
clips of 4 frames (so one rank holds two clips, one a single clip, and at
4 ranks one none) with oracle keypoints on even steps, oracle detections
in ``tests/test_parallel.py``'s 8 slots and homography gates that differ
between clips; the port with ``derive_prev`` on and off (the previous
frames then given as the shifted frames) and packed, the JAX package
once, with ``derive_prev`` and ``packed``.  ``tests/test_parallel.py``'s
own clip inputs are random keypoints whose homography fits are near
singular (condition ~3e6), where float32 summation order moves a
projection by up to 0.55 m; those inputs stay in
``tests/test_torch_parallel.py``, held against the flat mesh and one
process.

The JAX package compiles each program (HRNet's ~20 s); the module fixture
compiles them in threads while the ranks run.

Tolerances: keypoint validity and pixels bit-equal, heatmap scores within
2e-4 (tests/test_torch_hrnet.py's bar); boxes within 2e-4 relative and
absolute, scores within 2e-4, classes and validity bit-equal
(tests/test_torch_yolov8.py's); the scan as the port's temporal tests
(masks, keypoint pixels, flags, track ids and classes bit-equal, track
boxes within 1e-3 px, homographies project the valid on-plane keypoints
within 5 mm of each other), and the port's packed rows bit-equal to its
plain outputs."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu import pitch
from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.config import MeshConfig
from eagle_tpu.ops.homography import perspective_transform as jproject
from eagle_tpu.parallel.mesh import make_mesh, pad_to_multiple, shard_batch
from eagle_tpu.parallel.pipeline import multi_clip_scan, sharded_detector_step, sharded_keypoint_step
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.models.bridge import params_from_module
from eagle_tpu_torch.models.hrnet import init_hrnet
from eagle_tpu_torch.models.yolov8 import init_yolov8
from eagle_tpu_torch.pipeline import temporal as tt

from . import torch_parity as tp
from .oracles import oracle_detections_at, oracle_keypoint_fn

torch.set_num_threads(2)

RANKS = (2, 4)
HW, IMAGE_SIZE, SEED, L, D = (64, 96), 64, 5, 4, 8


def step_frames() -> np.ndarray:
    return np.random.default_rng(1).integers(0, 255, (8, *HW, 3), dtype=np.uint8)


def clip_inputs(c: int) -> dict:
    """``c`` make_scene clips of ``L`` frames as numpy FrameInputs fields
    (clip axis first, time second)."""
    rows = {k: [] for k in ("frame_bgr", "model_kp", "model_kp_valid", "is_kp_frame", "is_h_frame", "det_boxes",
                            "det_conf", "det_cls", "det_valid")}
    for ci in range(c):
        sc = make_scene(num_frames=L, width=320, height=192, num_players=4, fps=8, seed=60 + ci)
        kp, valid = oracle_keypoint_fn(sc)(sc.frames)
        is_kp = np.arange(L) % 2 == 0
        dets = [oracle_detections_at(sc, f, max_det=D) for f in range(L)]
        rows["frame_bgr"].append(sc.frames)
        rows["model_kp"].append(np.where(is_kp[:, None, None], kp, 0).astype(np.float32))
        rows["model_kp_valid"].append(valid & is_kp[:, None])
        rows["is_kp_frame"].append(is_kp)
        rows["is_h_frame"].append((np.arange(L) + ci) % 2 == 0)
        for i, k in enumerate(("det_boxes", "det_conf", "det_cls", "det_valid")):
            rows[k].append(np.stack([d[i] for d in dets]))
    xs = {k: np.stack(v) for k, v in rows.items()}
    xs["det_cls"] = xs["det_cls"].astype(np.int64)
    xs["prev_frame_bgr"] = xs["frame_bgr"][:, np.maximum(np.arange(L) - 1, 0)]
    xs["t"] = np.tile(np.arange(L), (c, 1))
    return xs


def jax_steps(ranks: int, frames: np.ndarray) -> list:
    """The JAX package's sharded keypoint and detector steps on ``ranks``
    devices with the ranks' weights: [kp, valid, boxes, scores, classes,
    det valid]."""
    cfg = JCFG.replace(keypoint=dataclasses.replace(JCFG.keypoint, input_hw=HW, use_bf16=False),
                       detector=dataclasses.replace(JCFG.detector, image_size=IMAGE_SIZE, max_detections=16,
                                                    use_bf16=False))
    mesh = make_mesh(MeshConfig(data_parallel=ranks), devices=jax.devices()[:ranks])
    hrnet = params_from_module(tp.spread_module(init_hrnet(0), 1))
    yolo = params_from_module(tp.spread_module(init_yolov8(1, "n"), 2, gain=1.0))
    x = shard_batch(frames, mesh)
    out = (*sharded_keypoint_step(mesh, hrnet, cfg, HW)(x), *sharded_detector_step(mesh, yolo, cfg, HW, variant="n")(x))
    return [np.asarray(a) for a in out]


def jax_clip_scan(ranks: int, xs: dict) -> tt.FrameOutputs:
    """The JAX package's ``multi_clip_scan`` (``derive_prev``, ``packed``) on
    ``ranks`` devices, the clips edge-padded to a multiple of the mesh as
    its sharding needs: every real clip's outputs, unpacked."""
    cfg = tp.clip_scan_config(JCFG)
    mesh = make_mesh(MeshConfig(data_parallel=ranks), devices=jax.devices()[:ranks])
    c = len(xs["t"])
    padded = {k: pad_to_multiple(v, ranks)[0] for k, v in xs.items() if k != "prev_frame_bgr"}
    cp = len(padded["t"])
    x = jt.FrameInputs(
        **{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in padded.items()},
        prev_frame_bgr=jnp.zeros_like(padded["frame_bgr"]),
        det_embed=jnp.zeros((cp, L, D, 1), jnp.float32),
    )
    carries = jax.vmap(lambda _: jt.init_carry(cfg))(jnp.arange(cp))
    _, rows = multi_clip_scan(mesh, cfg, jax.random.key(SEED), derive_prev=True, packed=True)(carries, x)
    rows = np.asarray(rows)[:c]
    return tt.FrameOutputs(*(np.stack(f) for f in zip(*(jt.unpack_outputs(r, cfg.tracker.max_tracks) for r in rows))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """{ranks: {"steps": (the ranks' results, JAX's), "scan": ({variant: the
    ranks' outputs}, JAX's)}}."""
    frames = step_frames()
    inputs = {r: clip_inputs(r + 1) for r in RANKS}
    pools = {r: tp.RankPool(r, str(tmp_path_factory.mktemp("store") / "rendezvous")) for r in RANKS}
    variants = {"derived": (False, True), "given": (False, False), "packed": (True, True)}
    try:
        with ThreadPoolExecutor(2) as ex:
            want_steps = {r: ex.submit(jax_steps, r, frames) for r in RANKS}
            want_scan = {r: ex.submit(jax_clip_scan, r, inputs[r]) for r in RANKS}
            for pool in pools.values():
                pool.submit(tp.job_sharded_steps, frames, HW, IMAGE_SIZE)
            got_steps = {r: pool.collect() for r, pool in pools.items()}
            got_scan = {r: {} for r in RANKS}
            for name, (packed, derive) in variants.items():
                for r, pool in pools.items():
                    pool.submit(tp.job_clip_scan, 1, inputs[r], SEED, packed, derive)
                for r, pool in pools.items():
                    got_scan[r][name] = pool.collect()
            return {r: dict(steps=(got_steps[r], want_steps[r].result()), scan=(got_scan[r], want_scan[r].result()))
                    for r in RANKS}
    finally:
        for pool in pools.values():
            pool.close()


def _frames_match(got: tt.FrameOutputs, want: tt.FrameOutputs, where: str) -> None:
    """The port's temporal tolerances, clip by clip and step by step."""
    for ci in range(len(want.kp_xy)):
        for s in range(L):
            g = tt.FrameOutputs(*(f[ci, s] for f in got))
            w = tt.FrameOutputs(*(f[ci, s] for f in want))
            at = f"{where}: clip {ci} step {s}"
            for name in ("kp_valid", "need_kp", "H_ok", "track_valid"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=f"{at} {name}")
            kv, tv = w.kp_valid, w.track_valid
            np.testing.assert_array_equal(g.kp_xy[kv], w.kp_xy[kv], err_msg=at)
            np.testing.assert_array_equal(g.track_id[tv], w.track_id[tv], err_msg=at)
            np.testing.assert_array_equal(g.track_cls[tv], w.track_cls[tv], err_msg=at)
            np.testing.assert_allclose(g.track_boxes[tv], w.track_boxes[tv], atol=1e-3, err_msg=at)
            if bool(w.H_ok):
                on = pitch.ON_PLANE_MASK & kv
                pj = np.asarray(jproject(jnp.asarray(w.H), jnp.asarray(w.kp_xy[on])))
                pt = np.asarray(jproject(jnp.asarray(g.H), jnp.asarray(w.kp_xy[on])))
                np.testing.assert_allclose(pt, pj, atol=5e-3, err_msg=at)


@pytest.mark.parametrize("ranks", RANKS, ids=["2ranks", "4ranks"])
def test_sharded_steps_match_jax(runs, ranks):
    got, want = runs[ranks]["steps"]
    kp_w, valid_w, boxes_w, scores_w, cls_w, dvalid_w = want
    for res in got:
        kp, valid, boxes, scores, cls, dvalid = res["sharded"]
        np.testing.assert_array_equal(valid, valid_w)
        np.testing.assert_array_equal(kp[..., :2][valid], kp_w[..., :2][valid_w])
        np.testing.assert_allclose(kp[..., 2][valid], kp_w[..., 2][valid_w], atol=2e-4)
        np.testing.assert_array_equal(dvalid, dvalid_w)
        np.testing.assert_array_equal(cls[dvalid], cls_w[dvalid_w])
        np.testing.assert_allclose(boxes[dvalid], boxes_w[dvalid_w], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(scores[dvalid], scores_w[dvalid_w], atol=2e-4)
    assert valid_w.sum() > 0 and dvalid_w.sum() > 0, "the spread weights find keypoints and boxes"
    inside = boxes_w[dvalid_w]
    assert (inside >= 0).all() and (inside[:, [0, 2]] <= HW[1] - 1).all() and (inside[:, [1, 3]] <= HW[0] - 1).all()


@pytest.mark.parametrize("ranks", RANKS, ids=["2ranks", "4ranks"])
def test_clip_scan_matches_jax(runs, ranks):
    got, want = runs[ranks]["scan"]
    for name in ("derived", "given"):
        for r, out in enumerate(got[name]):
            _frames_match(out, want, f"{name}, rank {r}")
    max_tracks = want.track_id.shape[-1]
    for r, rows in enumerate(got["packed"]):
        plain = got["derived"][r]
        for ci, clip_rows in enumerate(rows):
            for field, a, b in zip(plain._fields, tt.unpack_outputs(clip_rows, max_tracks), plain):
                np.testing.assert_array_equal(a, b[ci].astype(a.dtype), err_msg=f"packed, rank {r}, clip {ci} {field}")
    assert want.H_ok.any(axis=1).all() and want.track_valid.any(axis=-1).all(), "every clip solves and tracks"
