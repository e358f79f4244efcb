"""PyTorch port, ``TrackerConfig(assignment="exact")``: the port's tracker
with the JV solver against the numpy transcription of boxmot 15.0.2
(``tests/boxmot_oracle.py``, whose lapjv is scipy's optimum under the cost
limit) on the recorded streams of ``tests/test_tracker_parity.py``, as
``test_parity_exact_solver`` holds the JAX package (the slice as a whole
with the exact solver: ``tests/test_torch_exact_slice.py``).

Tolerances: ``tests/test_tracker_parity.py``'s (ids, matched detection
indices and classes equal, confidences within 1e-5, boxes within 0.75 px,
1 px under GMC warps: the port's float32 Kalman filter against the
oracle's float64 one)."""

import numpy as np
import pytest
import torch

from eagle_tpu_torch.config import TrackerConfig
from eagle_tpu_torch.ops import launch_counts
from eagle_tpu_torch.track import botsort

from .test_tracker_parity import D_SLOTS, T_SLOTS, _assert_streams_equal, _make_stream, _run_oracle
from .torch_parity import n, t

torch.set_num_threads(2)


def _run_port(stream, cfg, warps=None, embs=None):
    """The port's tracker over a stream of (N, 6) detections in D_SLOTS
    slots: per frame {track id: (box, detection index, conf, class)}."""
    e_dim = cfg.embed_dim if cfg.use_appearance else 1
    state = botsort.init_state(T_SLOTS, e_dim)
    frames = []
    for f, dets in enumerate(stream):
        b = np.zeros((D_SLOTS, 4), np.float32)
        c = np.zeros(D_SLOTS, np.float32)
        k = np.zeros(D_SLOTS, np.int64)
        v = np.zeros(D_SLOTS, bool)
        e = np.zeros((D_SLOTS, e_dim), np.float32)
        m = len(dets)
        b[:m], c[:m], k[:m], v[:m] = dets[:, :4], dets[:, 4], dets[:, 5], True
        if embs is not None:
            e[:m] = embs[f]
        state, out = botsort.step(
            state, t(b), t(c), t(k), t(v), cfg,
            gmc_warp=None if warps is None else t(warps[f]),
            det_embed=t(e) if cfg.use_appearance else None,
        )
        valid = n(out.valid)
        frames.append({
            int(tid): (box, int(d), float(cf), int(cl))
            for tid, box, d, cf, cl in zip(
                n(out.track_id)[valid], n(out.boxes)[valid], n(out.det_idx)[valid], n(out.conf)[valid],
                n(out.cls)[valid],
            )
        })
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_tracker_matches_boxmot(seed):
    stream = _make_stream(seed=seed)
    cfg = TrackerConfig(max_tracks=T_SLOTS, assignment="exact", gmc="off")
    launches = launch_counts.get("lap_jv")
    _assert_streams_equal(_run_port(stream, cfg), _run_oracle(stream))
    assert launch_counts.get("lap_jv") == launches  # CPU tensors: the plain version, no kernel


def test_exact_tracker_matches_boxmot_under_gmc_warp():
    rng = np.random.default_rng(5)
    stream = _make_stream(seed=5, dropout=0.08)
    warps = []
    for _ in stream:
        ang, s = rng.normal(0, 0.004), 1.0 + rng.normal(0, 0.002)
        tx, ty = rng.normal(0, 3.0, 2)
        warps.append(np.asarray([[s * np.cos(ang), -s * np.sin(ang), tx], [s * np.sin(ang), s * np.cos(ang), ty]],
                                np.float32))
    cfg = TrackerConfig(max_tracks=T_SLOTS, assignment="exact", gmc="affine")
    _assert_streams_equal(_run_port(stream, cfg, warps=warps), _run_oracle(stream, warps=warps), box_atol=1.0)


def test_exact_tracker_matches_boxmot_with_reid_embeddings():
    """The same stream as ``test_parity_with_reid_embeddings``."""
    rng = np.random.default_rng(9)
    n_targets = 6
    ident = rng.normal(0, 1, (n_targets, 16)).astype(np.float32)
    ident /= np.linalg.norm(ident, axis=1, keepdims=True)
    stream, embs = [], []
    pos = rng.uniform([100, 100], [1100, 500], (n_targets, 2))
    vel = rng.uniform(-3, 3, (n_targets, 2))
    for f in range(30):
        dets, es = [], []
        for i in range(n_targets):
            if rng.uniform() < 0.1 and f > 1:
                continue
            p = pos[i] + f * vel[i] + rng.normal(0, 0.5, 2)
            dets.append([p[0] - 15, p[1] - 60, p[0] + 15, p[1], rng.uniform(0.75, 0.95), 0.0])
            e = ident[i] + rng.normal(0, 0.05, 16).astype(np.float32)
            es.append(e / np.linalg.norm(e))
        stream.append(np.asarray(dets, np.float32).reshape(-1, 6))
        embs.append(np.asarray(es, np.float32).reshape(-1, 16))
    cfg = TrackerConfig(max_tracks=T_SLOTS, assignment="exact", gmc="off", use_appearance=True, embed_dim=16)
    _assert_streams_equal(_run_port(stream, cfg, embs=embs), _run_oracle(stream, embs=embs, with_reid=True))
