"""PyTorch port, tracker: BoT-SORT steps with either solver (the auction
and, ``assignment="exact"``, the JV solver), the auction solver and the
Kalman filter against the JAX package on the same detection streams.

Tolerances: track ids, emit masks, matched detection indices and classes
bit-equal frame by frame; boxes within 1e-2 px and confidences within
1e-6 (float32 Kalman filters with another summation order); auction
matches bit-equal.  With appearance embeddings: ids, active and emit
masks and matched detections bit-equal, Kalman means within 1e-4 (the
relative float32 error of the means' pixel values) and track embeddings
within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import TrackerConfig as JTrackerConfig
from eagle_tpu.ops import kalman as jk
from eagle_tpu.ops.assignment import masked_auction as jauction
from eagle_tpu.track import botsort as jbs
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import TrackerConfig
from eagle_tpu_torch.ops import kalman as tk
from eagle_tpu_torch.ops.assignment import masked_auction
from eagle_tpu_torch.track import botsort as tbs

from .oracles import oracle_detections_at
from .torch_parity import n, t

torch.set_num_threads(2)


def _scene_stream(seed: int, n_frames: int = 24):
    """Oracle detections of a make_scene clip, with dropouts, confidence
    dips into the BYTE low band and a player leaving."""
    scene = make_scene(num_frames=n_frames, width=960, height=540, num_players=8, fps=24, seed=seed, pan_speed=1.0)
    rng = np.random.default_rng(seed)
    stream = []
    for f in range(n_frames):
        drop = {p for p in range(8) if rng.uniform() < 0.1 and f > 1} | ({7} if f >= 15 else set())
        b, c, k, v = oracle_detections_at(scene, f, max_det=32, drop=drop)
        c = np.where(v & (rng.uniform(size=32) < 0.15) & (f > 2), rng.uniform(0.2, 0.45, 32), c).astype(np.float32)
        b = b + rng.normal(0, 0.5, b.shape).astype(np.float32) * v[:, None]
        stream.append((b, c, k, v))
    warps = [
        np.array([[1.0 + rng.normal(0, 0.002), -0.003, rng.normal(0, 2)], [0.003, 1.0, rng.normal(0, 2)]], np.float32)
        for _ in range(n_frames)
    ]
    return stream, warps


@pytest.mark.parametrize(
    "seed,gmc,assignment",
    [pytest.param(seed, gmc, a, id=f"{seed}-{gmc}" + ("" if a == "auction" else "-exact"))
     for a in ("auction", "exact") for seed, gmc in [(0, "off"), (1, "affine"), (2, "affine")]],
)
def test_tracker_ids_bit_equal(seed, gmc, assignment):
    stream, warps = _scene_stream(seed)
    jcfg = JTrackerConfig(max_tracks=24, gmc=gmc, assignment=assignment)
    tcfg = TrackerConfig(max_tracks=24, gmc=gmc, assignment=assignment)
    js = jbs.init_state(24, 1)
    jstep = jax.jit(jbs.step, static_argnames=("cfg",))
    ts = tbs.init_state(24)
    for f, (b, c, k, v) in enumerate(stream):
        warp = warps[f] if gmc != "off" else None
        js, jo = jstep(js, jnp.asarray(b), jnp.asarray(c), jnp.asarray(k), jnp.asarray(v), cfg=jcfg,
                       gmc_warp=None if warp is None else jnp.asarray(warp))
        ts, to = tbs.step(ts, t(b), t(c), t(k).long(), t(v), tcfg, gmc_warp=None if warp is None else t(warp))
        valid = np.asarray(jo.valid)
        np.testing.assert_array_equal(n(to.valid), valid, err_msg=f"frame {f}")
        for name in ("track_id", "det_idx", "cls"):
            np.testing.assert_array_equal(
                n(getattr(to, name))[valid], np.asarray(getattr(jo, name))[valid], err_msg=f"frame {f} {name}"
            )
        np.testing.assert_allclose(n(to.boxes)[valid], np.asarray(jo.boxes)[valid], atol=1e-2, err_msg=f"frame {f}")
        np.testing.assert_allclose(n(to.conf)[valid], np.asarray(jo.conf)[valid], atol=1e-6)
        np.testing.assert_array_equal(n(ts.active), np.asarray(js.active))
        assert int(ts.next_id) == int(js.next_id)
    assert int(ts.next_id) > 8


@pytest.mark.parametrize("seed", range(4))
def test_auction_bit_equal(seed):
    rng = np.random.default_rng(seed)
    r, c = 24, 32
    cost = rng.uniform(0, 1, (r, c)).astype(np.float32)
    cost[:, ::7] = np.round(cost[:, ::7], 1)  # ties
    rows = rng.uniform(size=r) < 0.8
    cols = rng.uniform(size=c) < 0.8
    mj, uj = jauction(jnp.asarray(cost), jnp.asarray(rows), jnp.asarray(cols), 0.8)
    mt, ut = masked_auction(t(cost), t(rows), t(cols), 0.8)
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    np.testing.assert_array_equal(n(ut), np.asarray(uj))


def test_kalman_matches_jax():
    rng = np.random.default_rng(5)
    xywh = rng.uniform([50, 50, 10, 30], [900, 500, 40, 80], (6, 4)).astype(np.float32)
    mj, cj = (np.asarray(a) for a in jk.kf_initiate_batch(jnp.asarray(xywh)))
    mt, ct = tk.kf_initiate(t(xywh))
    np.testing.assert_allclose(n(mt), mj, rtol=1e-6)
    np.testing.assert_allclose(n(ct), cj, rtol=1e-6)
    mj, cj = (np.asarray(a) for a in jk.kf_predict_batch(jnp.asarray(mj), jnp.asarray(cj)))
    mt, ct = tk.kf_predict(mt, ct)
    np.testing.assert_allclose(n(mt), mj, rtol=1e-5)
    np.testing.assert_allclose(n(ct), cj, rtol=1e-5)
    z = (xywh + rng.normal(0, 1, xywh.shape)).astype(np.float32)
    mj, cj = (np.asarray(a) for a in jk.kf_update_batch(jnp.asarray(mj), jnp.asarray(cj), jnp.asarray(z)))
    mt, ct = tk.kf_update(mt, ct, t(z))
    np.testing.assert_allclose(n(mt), mj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(n(ct), cj, rtol=1e-4, atol=1e-6)


def _crossing_stream(n_frames: int = 24, e: int = 16, seed: int = 0):
    """Six players in a scripted clip: two stand 12 px apart and jitter by
    5 px (their boxes overlap, so IoU alone cannot tell them apart), two
    cross, detections come in shuffled slots with dropouts and dips into
    the BYTE low band, and each player's embedding is its own unit vector
    plus noise."""
    rng = np.random.default_rng(seed)
    start = np.array([[300, 200], [312, 204], [150, 380], [450, 300], [700, 150], [760, 420]], float)
    vel = np.array([[0, 0], [0, 0], [10, -3], [-10, 3], [1, 2], [-2, 1]], float)
    ident = rng.normal(size=(6, e))
    ident /= np.linalg.norm(ident, axis=1, keepdims=True)
    stream = []
    for f in range(n_frames):
        b = np.zeros((32, 4), np.float32)
        c = np.zeros(32, np.float32)
        k = np.zeros(32, np.int32)
        v = np.zeros(32, bool)
        emb = np.zeros((32, e), np.float32)
        slots = rng.permutation(10)
        for p in range(6):
            if f > 1 and rng.uniform() < 0.08:
                continue
            x, y = start[p] + vel[p] * f + (rng.normal(0, 5, 2) if p < 2 else 0)
            s = slots[p]
            b[s] = (x - 18, y - 80, x + 18, y)
            c[s] = 0.9 if rng.uniform() > 0.12 or f < 3 else rng.uniform(0.2, 0.45)
            v[s] = True
            z = ident[p] + rng.normal(0, 0.08, e)
            emb[s] = z / np.linalg.norm(z)
        stream.append((b, c, k, v, emb))
    return stream


@pytest.mark.parametrize("assignment", ["auction", "exact"])
def test_tracker_with_appearance_matches_jax(assignment):
    stream = _crossing_stream()
    jcfg = JTrackerConfig(max_tracks=24, gmc="off", use_appearance=True, embed_dim=16, assignment=assignment)
    tcfg = TrackerConfig(max_tracks=24, gmc="off", use_appearance=True, embed_dim=16, assignment=assignment)
    iou_only = JTrackerConfig(max_tracks=24, gmc="off", use_appearance=False, assignment=assignment)
    jstep = jax.jit(jbs.step, static_argnames=("cfg",))
    js, js_iou = jbs.init_state(24, 16), jbs.init_state(24, 16)
    ts = tbs.init_state(24, 16)
    changed = 0  # frames where appearance changes the JAX tracker's association
    for f, (b, c, k, v, emb) in enumerate(stream):
        dets = (jnp.asarray(b), jnp.asarray(c), jnp.asarray(k), jnp.asarray(v))
        js, jo = jstep(js, *dets, cfg=jcfg, det_embed=jnp.asarray(emb))
        js_iou, jo_iou = jstep(js_iou, *dets, cfg=iou_only, det_embed=jnp.asarray(emb))
        ts, to = tbs.step(ts, t(b), t(c), t(k).long(), t(v), tcfg, det_embed=t(emb))
        valid = np.asarray(jo.valid)
        pairs = {(d, i) for d, i in zip(np.asarray(jo.det_idx)[valid], np.asarray(jo.track_id)[valid])}
        iou_valid = np.asarray(jo_iou.valid)
        changed += pairs != {(d, i) for d, i in zip(np.asarray(jo_iou.det_idx)[iou_valid],
                                                     np.asarray(jo_iou.track_id)[iou_valid])}
        np.testing.assert_array_equal(n(to.valid), valid, err_msg=f"frame {f}")
        np.testing.assert_array_equal(n(ts.active), np.asarray(js.active), err_msg=f"frame {f}")
        active = np.asarray(js.active)
        np.testing.assert_array_equal(n(ts.track_id)[active], np.asarray(js.track_id)[active])
        for name in ("track_id", "det_idx"):
            np.testing.assert_array_equal(
                n(getattr(to, name))[valid], np.asarray(getattr(jo, name))[valid], err_msg=f"frame {f} {name}"
            )
        np.testing.assert_allclose(n(ts.mean)[active], np.asarray(js.mean)[active], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(n(ts.embed)[active], np.asarray(js.embed)[active], atol=1e-5)
    assert int(ts.next_id) == int(js.next_id)
    assert changed >= 5, "the clip must be one where appearance changes the association"
