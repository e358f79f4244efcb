"""PyTorch port, the temporal scan as a device program a chunk
(``pipeline/step_graph.py``, ``temporal.temporal_step_static``) and the
device RANSAC keys (``ops/prng.py::ransac_keys``), held on the CPU against
the JAX package and the port's eager loop; plus the reference-compatible
names the port gained beside them.

On the CPU the step graph runs the static step eagerly on its slots (the
capture itself needs the card: ``tests/test_torch_cuda.py``).

Tolerances: the keys, the minimal sets, masks, ids and every field of
the static step against the eager step bit-equal; against the JAX step as
in tests/test_torch_temporal.py (keypoint pixels, masks, ids bit-equal,
homographies projecting the keypoints within 5 mm); whole runs through
``get_coordinates`` equal dicts against the eager loop and, against the
JAX package, ``assert_coords_match`` (boundaries within 5 mm)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu import native as jnative
from eagle_tpu import pitch
from eagle_tpu import processor as jproc
from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.ops import homography as jh
from eagle_tpu.ops import nms as jnms
from eagle_tpu.pipeline import processor as jpproc
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch import native as tnative
from eagle_tpu_torch import processor as tproc
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.ops import homography as th
from eagle_tpu_torch.ops import nms as tnms
from eagle_tpu_torch.ops import prng
from eagle_tpu_torch.pipeline import processor as tpproc
from eagle_tpu_torch.pipeline import temporal as tt
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner as TRunner

from .oracles import oracle_detections_at, oracle_detector_fn, oracle_keypoint_fn
from .test_torch_coordinate_model import _no_dets, assert_coords_match
from .test_torch_multiclip_flat import _det_rows, _fid
from .torch_parity import chunk_model, gumbel_top4, n, t, tie_masks

torch.set_num_threads(2)

KEY_CASES = [(0, 0), (0, 1), (3, 17), (7, 10**6), (1, 2**31 - 1)]


@pytest.mark.parametrize("seed,step", KEY_CASES)
def test_keys_give_the_jax_minimal_sets(seed, step):
    """The device draw's plain version: the keys are ``jax.random.bits >>
    9`` under ``fold_in(key(seed), t)``, and their top 4 are the minimal
    sets of ``jax.random.gumbel`` + ``top_k`` and of the port's host
    gumbel (``prng.gumbel``) ordered the same way."""
    key = jax.random.fold_in(jax.random.key(seed), step)
    keys = prng.ransac_keys(seed, torch.tensor(step), 512, 57)
    assert keys.dtype == torch.int32
    bits = np.asarray(jax.random.bits(key, (512, 57), jnp.uint32))
    np.testing.assert_array_equal(n(keys), (bits >> np.uint32(9)).astype(np.int32))
    gumbel = prng.gumbel(prng.fold_in(prng.key(seed), step), (512, 57))
    for valid in tie_masks(np.random.default_rng(step % 1000 + seed)):
        want = np.asarray(jh._sample_minimal_sets(key, jnp.asarray(valid), 512))
        np.testing.assert_array_equal(n(th.sample_minimal_sets(keys, t(valid))), want)
        np.testing.assert_array_equal(gumbel_top4(gumbel, valid), want)


def test_tied_keys_order_as_their_gumbels():
    """Equal keys give equal gumbels: both orders take the lower index
    first, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 4, (64, 57)).astype(np.int32)
    u = np.maximum(np.finfo(np.float32).tiny, keys.astype(np.float32) * np.float32(2.0**-23))
    gumbel = -np.log(-np.log(u))
    for valid in tie_masks(rng):
        want = np.asarray(jax.lax.top_k(jnp.asarray(gumbel) + jnp.where(jnp.asarray(valid), 0.0, -jnp.inf), 4)[1])
        np.testing.assert_array_equal(n(th.sample_minimal_sets(t(keys), t(valid))), want)
        np.testing.assert_array_equal(gumbel_top4(gumbel, valid), want)


# ---------------------------------------------------------------------------
# the static step
# ---------------------------------------------------------------------------

PAN = 2.0
KP_EVERY, H_EVERY, DARK = 4, 7, (6, 7)


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=9, width=640, height=360, num_players=6, fps=10, seed=4, pan_speed=PAN)


@pytest.mark.parametrize("gmc", ["affine", "features"])
def test_static_step_equals_the_eager_step_and_jax(scene, gmc):
    """Nine steps: t = 0, keypoint frames every 4, homography frames every
    7; frames 6 and 7 are featureless, so the flow collapses at frame 7 (no
    model keypoints: an on-demand flag) and the homography frame 7 is
    starved (a retry, solved at frame 8 from its model keypoints).  With
    the default keypoint-flow GMC and with the features GMC (grid corners,
    their flow at K = 240 and the robust fit, whose tally the static and
    the eager step write alike: the fallback on frames 6-8 only, whose
    previous or current frame is featureless)."""
    frames = scene.frames.copy()
    frames[list(DARK)] = 127
    kp0, valid0 = oracle_keypoint_fn(scene)(scene.frames[:1])
    jcfg = JCFG.replace(tracker=dataclasses.replace(JCFG.tracker, gmc=gmc))
    tcfg = TCFG.replace(tracker=dataclasses.replace(TCFG.tracker, gmc=gmc))
    jstep = jax.jit(jt.temporal_step, static_argnames=("cfg",))
    jc, ec, sc = jt.init_carry(jcfg), tt.init_carry(tcfg, "cpu"), tt.init_carry(tcfg, "cpu")
    gum = tt.ransac_draws(0, tcfg, "cpu")
    seen = {"need_kp": 0, "retry": 0, "h_ok": 0}
    tally = {"eager": torch.zeros(2, dtype=torch.int64), "static": torch.zeros(2, dtype=torch.int64)}
    fallbacks = []
    for f in range(len(frames)):
        is_kp, is_h = f % KP_EVERY == 0, f % H_EVERY == 0
        kp = kp0[0].copy()
        kp[:, 0] = np.trunc(scene.keypoints_image[:, 0] + PAN * f)
        mk = kp if is_kp else np.zeros((57, 3), np.float32)
        mv = valid0[0] if is_kp else np.zeros(57, bool)
        b, c, k, v = oracle_detections_at(scene, f)
        common = dict(model_kp=mk, model_kp_valid=mv, det_boxes=b, det_conf=c, det_valid=v)
        prev = frames[max(f - 1, 0)]
        jx = jt.FrameInputs(
            frame_bgr=jnp.asarray(frames[f]), prev_frame_bgr=jnp.asarray(prev), is_kp_frame=jnp.bool_(is_kp),
            is_h_frame=jnp.bool_(is_h), det_cls=jnp.asarray(k), det_embed=jnp.zeros((128, 1)), t=jnp.int32(f),
            **{a: jnp.asarray(x) for a, x in common.items()},
        )
        base = dict(frame_bgr=t(frames[f]), prev_frame_bgr=t(prev), det_cls=t(k).long(), **{a: t(x) for a, x in common.items()})
        jc, jo = jstep(jc, jx, cfg=jcfg, base_key=jax.random.key(0))
        ex = tt.FrameInputs(is_kp_frame=is_kp, is_h_frame=is_h, t=f, **base)
        ec, eo = tt.temporal_step(ec, ex, tcfg, gum, tally["eager"])
        sx = tt.FrameInputs(is_kp_frame=torch.tensor(is_kp), is_h_frame=torch.tensor(is_h), t=torch.tensor(f), **base)
        sc, so = tt.temporal_step_static(sc, sx, tcfg, 0, tally["static"])
        np.testing.assert_array_equal(n(tally["static"]), n(tally["eager"]), err_msg=f"frame {f} tally")
        fallbacks.append(int(tally["static"][0]))
        for name, a, b_ in zip(eo._fields, eo, so):
            np.testing.assert_array_equal(n(b_), n(a), err_msg=f"frame {f} {name}: static != eager")
        for a, b_ in zip([*ec[:-1], *ec.tracker], [*sc[:-1], *sc.tracker]):
            np.testing.assert_array_equal(n(b_), n(a), err_msg=f"frame {f} carry")
        for name in ("kp_valid", "need_kp", "H_ok", "track_valid"):
            np.testing.assert_array_equal(n(getattr(so, name)), np.asarray(getattr(jo, name)), err_msg=f"frame {f} {name}")
        kv, tv = np.asarray(jo.kp_valid), np.asarray(jo.track_valid)
        np.testing.assert_array_equal(n(so.kp_xy)[kv], np.asarray(jo.kp_xy)[kv], err_msg=f"frame {f}")
        np.testing.assert_array_equal(n(so.track_id)[tv], np.asarray(jo.track_id)[tv])
        np.testing.assert_array_equal(n(sc.retry_h), np.asarray(jc.retry_h), err_msg=f"frame {f} retry")
        if bool(jo.H_ok):
            on = pitch.ON_PLANE_MASK & kv
            pj = np.asarray(jh.perspective_transform(jo.H, jnp.asarray(np.asarray(jo.kp_xy)[on])))
            pt = np.asarray(jh.perspective_transform(jnp.asarray(n(so.H)), jnp.asarray(np.asarray(jo.kp_xy)[on])))
            np.testing.assert_allclose(pt, pj, atol=5e-3)
        seen["need_kp"] += bool(so.need_kp)
        seen["retry"] += bool(sc.retry_h)
        seen["h_ok"] += bool(so.H_ok)
    assert seen["need_kp"] and seen["retry"] and seen["h_ok"], seen
    assert n(so.track_valid).sum() >= 5
    # the tally is written by the features GMC only
    want = [int(f in DARK or f - 1 in DARK) for f in range(len(frames))] if gmc == "features" else [0] * len(frames)
    assert fallbacks == want


# ---------------------------------------------------------------------------
# the step graph through get_coordinates
# ---------------------------------------------------------------------------


def _ondemand_case():
    """A clip whose first frame carries no keypoints (backward seeding) and
    that turns featureless at frame 8 (on-demand keypoint rounds)."""
    base = make_scene(num_frames=12, width=640, height=360, num_players=3, fps=8, seed=1)
    frames = base.frames.copy()
    frames[8:] = 127
    inner = oracle_keypoint_fn(base)

    def make_kp_fn(calls):
        def fn(batch):
            calls.append(len(batch))
            kp, valid = inner(batch)
            if len(calls) == 1:
                valid = valid.copy()
                valid[0] = False
            return kp, valid

        return fn

    return base, frames, make_kp_fn


def test_step_graph_runs_on_demand_rounds_as_the_eager_loop_and_jax():
    """4-frame chunks: the rounds resume at the flagged frame's chunk and
    give the eager loop's dict, and the JAX package's."""
    base, frames, make_kp_fn = _ondemand_case()
    kw = dict(num_keypoint_detection=2, num_homography=2)
    runs = {}
    for path in ("chunks", "frames"):
        calls = []
        m = chunk_model(path, keypoint_fn=make_kp_fn(calls), detector_fn=oracle_detector_fn(base))
        runs[path] = (m.get_coordinates(frames, 8, **kw), m.ondemand_rounds, m.frames_stepped, calls)
    got, rounds, stepped, calls = runs["chunks"]
    assert got == runs["frames"][0]
    assert rounds >= 1 and len(calls) >= 2
    # the flagged frame 9 lies in chunk 2: the round re-steps frames 8-11
    assert stepped == 12 + 4 * rounds and runs["frames"][2] == 12 + 3 * rounds
    # the JAX package's run in 16-frame chunks: its program runs 16 frames,
    # not 96, and its rounds resume at chunk 0 (a chunk is a unit of work,
    # not of the result)
    jcfg = dataclasses.replace(JCFG, chunk_frames=16)
    want = JModel(config=jcfg, keypoint_fn=make_kp_fn([]), detector_fn=oracle_detector_fn(base),
                  verbose_init=False).get_coordinates(frames, 8, verbose=False, **kw)
    assert_coords_match(got, want, boundary_atol=5e-3)
    assert len(got[9]["Keypoints"]) >= 4


def _gmc_counts() -> list:
    """(name, request, value) of the ``gmc:*`` counts of the span log's last
    ``stream_coordinates`` call."""
    from eagle_tpu_torch.utils.profiling import LOG

    recs = LOG.records()
    call = [r.id for r in recs if r.kind == "call" and r.name == "stream_coordinates"][-1]
    return [(r.name, r.request, r.value) for r in recs if r.call == call and r.name.startswith("gmc:")]


@pytest.mark.parametrize(
    "appearance,gmc", [(False, "affine"), (True, "affine"), (True, "features")], ids=["False", "True", "features"]
)
def test_step_graph_streams_as_the_eager_loop(appearance, gmc):
    """Two blocks (segments of 5 and 7 frames cut into whole 4-frame chunks:
    blocks of 4 and 8): the carry and the previous frame pass between the
    blocks; equal to the eager stream and to the one-shot run.  Also with
    the tracker's appearance association (the histogram embedder's 64-d
    rows ride the detection slots), and with it the features GMC, whose
    tally both paths log alike: the counts ``gmc:frames``, ``gmc:fallback``
    and ``gmc:inliers`` a 4-frame chunk, under the block's request."""
    base = make_scene(num_frames=12, width=640, height=360, num_players=4, fps=8, seed=2)
    kw = dict(num_keypoint_detection=3, num_homography=2)
    tracker = dataclasses.replace(TCFG.tracker, use_appearance=True, embedder="histogram", embed_dim=64, gmc=gmc)
    cfg = dict(config=TCFG.replace(tracker=tracker)) if appearance else {}
    out, counts = {}, {}
    for path in ("chunks", "frames"):
        m = chunk_model(path, keypoint_fn=oracle_keypoint_fn(base), detector_fn=oracle_detector_fn(base), **cfg)
        blocks = list(m.stream_coordinates([base.frames[:5], base.frames[5:]], 8, prefetch=False, **kw))
        assert [sorted(b) for b in blocks] == [list(range(4)), list(range(4, 12))]
        out[path] = {k: v for b in blocks for k, v in b.items()}
        counts[path] = _gmc_counts()
    assert out["chunks"] == out["frames"]
    assert counts["chunks"] == counts["frames"]
    if gmc == "features":
        frames = [(req, v) for name, req, v in counts["chunks"] if name == "gmc:frames"]
        assert frames == [(0, 4), (4, 4), (4, 4)]
        inliers = [v for name, _, v in counts["chunks"] if name == "gmc:inliers"]
        assert min(inliers) >= 4 * TCFG.tracker.gmc_min_features  # a textured still scene: no fallback
    else:
        assert counts["chunks"] == []
    one_shot = chunk_model("chunks", keypoint_fn=oracle_keypoint_fn(base), detector_fn=oracle_detector_fn(base), **cfg)
    assert one_shot.get_coordinates(base.frames, 8, **kw) == out["chunks"]


def test_step_graph_resets_at_each_flattened_clip():
    """The flattened multi-clip stream (built-in models with fakes that read
    a stamped frame id, as tests/test_torch_multiclip_flat.py): the carry
    restarts at every clip's t = 0 inside the chunk (clips of 6 and 5
    frames padded to 6, 4-frame chunks); equal to the eager loop's and to
    each clip's own run."""
    scene = make_scene(num_frames=1, width=320, height=192, num_players=0, fps=8, seed=6)
    lens = [6, 5]
    clips = []
    for ci, ln in enumerate(lens):
        fr = np.stack([scene.frames[0]] * ln)
        for i in range(ln):
            fr[i, :32, :32] = 40 + 8 * (ci * 6 + i)
        clips.append(fr)
    kp, valid = oracle_keypoint_fn(scene)(scene.frames[:1])
    packed = np.concatenate([kp[0], valid[0].astype(np.float32)[:, None]], -1)

    def model(path):
        cfg = TCFG.replace(
            detector=dataclasses.replace(TCFG.detector, image_size=160),
            keypoint=dataclasses.replace(TCFG.keypoint, input_hw=(96, 160)),
        )
        m = chunk_model(path, config=cfg)
        m.run_detector = lambda x, g, hw, timer=None: torch.from_numpy(_det_rows(_fid(x.numpy(), np), np))
        m.run_keypoints = lambda x, g, hw: torch.from_numpy(np.tile(packed[None], (len(x), 1, 1)))
        return m

    kw = dict(num_homography=2, num_keypoint_detection=2)
    got = TRunner(model("chunks")).run(clips, 8, **kw)
    assert got == TRunner(model("frames")).run(clips, 8, **kw)
    single = model("chunks")
    for ci, clip in enumerate(clips):
        assert single.get_coordinates(clip, 8, **kw) == got[ci], f"clip {ci}"
    assert all(len(fr["Coordinates"].get("Player", {})) == 1 for r in got for fr in r.values())


def test_the_card_takes_the_step_graph_with_features_gmc_too():
    """On the card the temporal stage runs as captured chunks whatever the
    GMC, the features GMC included (its step graph is made, not refused);
    ``_temporal_path`` forces the eager loop."""
    from eagle_tpu_torch.pipeline.step_graph import StepGraph

    m = TModel(keypoint_fn=lambda b: None, detector_fn=_no_dets, device="cpu")
    assert not m._captured_scan(m.config)
    feats = m.config.replace(tracker=dataclasses.replace(m.config.tracker, gmc="features"))
    sg = StepGraph(feats, (64, 96), 4, 7, 0, False, "cpu")
    assert sg.gmc_stats is not None and sg.out.shape[1] == tt.packed_width(feats.tracker.max_tracks) + 2
    m.device = torch.device("cuda")  # the choice only; nothing runs
    assert m._captured_scan(m.config) and m._captured_scan(feats)
    m._temporal_path = "frames"
    assert not m._captured_scan(m.config) and not m._captured_scan(feats)


def test_launch_counts_registry():
    """The wrappers' one registry, as the host counts it (a capture's device
    increments need the card: tests/test_torch_cuda.py): names and their
    details, a reset by prefix, the paused warm-up (a kernel's own counter
    handed out as scratch), snapshot and restore."""
    from eagle_tpu_torch.ops import launch_counts as lc

    dev = torch.device("cpu")
    saved = lc.snapshot()
    lc.reset("tk")
    lc.add(dev, "tk", "tk/a")
    lc.add(dev, "tk", "tk/b")
    lc.counter("tk_rounds", dev).add_(5)
    assert (lc.get("tk"), lc.details("tk"), lc.get("tk_rounds")) == (2, {"a": 1, "b": 1}, 5)
    with lc.paused():
        lc.add(dev, "tk")
        lc.counter("tk_rounds", dev).add_(7)
    assert (lc.get("tk"), lc.get("tk_rounds")) == (2, 5)
    inner = lc.snapshot()
    lc.add(dev, "tk", "tk/c")
    lc.restore(inner)
    assert (lc.get("tk"), lc.details("tk")) == (2, {"a": 1, "b": 1})
    lc.reset("tk")
    assert (lc.get("tk"), lc.details("tk"), lc.get("tk_rounds")) == (0, {}, 5)
    lc.restore(saved)
    assert lc.get("tk_rounds") == 0


# ---------------------------------------------------------------------------
# reference-compatible names
# ---------------------------------------------------------------------------


def test_processor_names_match_jax():
    assert tproc.color_ranges == jproc.color_ranges and tpproc.COLOR_RANGES == jpproc.COLOR_RANGES
    assert (tpproc.PITCH_WIDTH, tpproc.PITCH_HEIGHT) == (jpproc.PITCH_WIDTH, jpproc.PITCH_HEIGHT)
    for a, b in (((3.0, 4.0), (0.0, 0.0)), ((1.5, -2.0), (4.0, 2.5))):
        assert tproc.calculate_distance(a, b) == jproc.calculate_distance(a, b)
    kt, kj = tproc.KalmanFilter((10.0, 5.0), (1.0, -0.5)), jproc.KalmanFilter((10.0, 5.0), (1.0, -0.5))
    for z in ((11.0, 4.6), (12.2, 4.1), (13.0, 3.4)):
        np.testing.assert_array_equal(kt.predict(), kj.predict())
        np.testing.assert_array_equal(kt.correct(np.array(z)), kj.correct(np.array(z)))


@pytest.mark.parametrize("seed", range(2))
def test_single_image_nms_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (300, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (300, 2)).astype(np.float32)], -1)
    scores = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 0.5, 64, 256)
    got = tnms.nms(t(boxes), t(scores), 0.3, 0.5, 64, 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    assert np.asarray(want[3]).sum() > 10


def test_ransac_homography_cfg_matches_jax():
    rng = np.random.default_rng(3)
    H = np.array([[9.0, 1.5, 120.0], [0.2, -6.0, 600.0], [0.0005, 0.004, 1.0]])
    world = pitch.WORLD_XY.astype(np.float64)
    img = world @ H[:, :2].T + H[:, 2]
    src = np.trunc(img[:, :2] / img[:, 2:] + rng.normal(0, 0.7, (57, 2))).astype(np.float32)
    valid = pitch.ON_PLANE_MASK & (rng.uniform(size=57) < 0.7)
    key = jax.random.fold_in(jax.random.key(0), 9)
    Hj, inl_j, ok_j = jh.ransac_homography_cfg(jnp.asarray(src), jnp.asarray(world.astype(np.float32)),
                                               jnp.asarray(valid), key, JCFG.homography)
    sets = th.sample_minimal_sets(prng.ransac_keys(0, torch.tensor(9), TCFG.homography.ransac_iters, 57), t(valid))
    Ht, inl_t, ok_t = th.ransac_homography_cfg(t(src), t(world.astype(np.float32)), t(valid), sets, TCFG.homography)
    assert bool(ok_t) == bool(ok_j) and bool(ok_t)
    np.testing.assert_array_equal(n(inl_t), np.asarray(inl_j))
    proj = lambda h: np.asarray(jh.perspective_transform(jnp.asarray(h), jnp.asarray(src[valid])))
    np.testing.assert_allclose(proj(n(Ht)), proj(np.asarray(Hj)), atol=5e-3)


def test_prescale_available_matches_jax():
    assert tnative.prescale_available() is True
    assert tnative.prescale_available() == jnative.prescale_available()
