"""PyTorch port, temporal step: flow with filters, colour, geometry,
the camera-motion warp, backward seeding and whole temporal steps against
the JAX package on make_scene clips.

Tolerances: masks, keypoint pixels (integer-truncated), track ids and
homography flags bit-equal; mean hues within 1e-4; synthesized points
bit-equal (rounded to integers); warps within 1e-4; homographies project
the keypoints to within 5 mm of each other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu import pitch
from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.ops import color as jcolor
from eagle_tpu.ops import geometry as jgeo
from eagle_tpu.ops.homography import perspective_transform as jproject
from eagle_tpu.ops.preprocess import compute_work_geometry
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.config import WorkGeometry
from eagle_tpu_torch.ops import color as tcolor
from eagle_tpu_torch.ops import geometry as tgeo
from eagle_tpu_torch.pipeline import temporal as tt

from .oracles import oracle_detections_at, oracle_keypoint_fn
from .torch_parity import n, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=10, width=960, height=540, num_players=6, fps=10, seed=4, pan_speed=PAN)


PAN = 2.0


def _kp(scene, f: int = 0):
    """Oracle keypoints of frame ``f`` (the camera pans PAN px a frame)."""
    kp, valid = oracle_keypoint_fn(scene)(scene.frames[:1])
    kp = kp[0].copy()
    kp[:, 0] = np.trunc(scene.keypoints_image[:, 0] + PAN * f)
    return kp, valid[0]


@pytest.mark.parametrize("work", [False, True])
def test_flow_with_filters_matches_jax(scene, work):
    kp, valid = _kp(scene)
    jcfg, tcfg = JCFG, TCFG
    frames = scene.frames
    if work:  # sample on a rescaled canvas: coordinates map through the geometry
        g = compute_work_geometry((540, 960), 640)
        jcfg = jcfg.replace(work=g)
        tcfg = tcfg.replace(work=WorkGeometry(**dataclasses.asdict(g)))
        from eagle_tpu.ops.preprocess import host_letterbox

        frames = host_letterbox(frames[:2], g)
    want = jt.flow_with_filters(jnp.asarray(frames[1]), jnp.asarray(frames[0]), jnp.asarray(kp[:, :2]), jnp.asarray(valid), jcfg)
    got = tt.flow_with_filters(t(frames[1]), t(frames[0]), t(kp[:, :2]), t(valid), tcfg)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert np.asarray(want[1]).sum() >= 8
    ok = np.asarray(want[1])
    np.testing.assert_array_equal(n(got[0])[ok], np.asarray(want[0])[ok])


def test_window_mean_hue_and_hsv(scene):
    frame = scene.frames[3]
    pts = np.random.default_rng(0).uniform(-5, 965, (40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        n(tcolor.window_mean_hue(t(frame), t(pts))), np.asarray(jcolor.window_mean_hue(jnp.asarray(frame), jnp.asarray(pts))),
        atol=1e-4,
    )
    px = np.random.default_rng(1).integers(0, 256, (64, 3), np.uint8)
    np.testing.assert_allclose(n(tcolor.bgr_to_hsv(t(px))), np.asarray(jcolor.bgr_to_hsv(jnp.asarray(px))), atol=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_synthesis_and_median_match_jax(scene, seed):
    rng = np.random.default_rng(seed)
    kp, valid = _kp(scene)
    valid = valid & (rng.uniform(size=57) < 0.5)
    xy = kp[:, :2] + rng.integers(-2, 3, (57, 2))
    want = jgeo.synthesize_keypoints(jnp.asarray(xy), jnp.asarray(valid))
    got = tgeo.synthesize_keypoints(t(xy), t(valid))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    vals = rng.normal(size=21).astype(np.float32)
    for interp in (False, True):
        np.testing.assert_allclose(
            float(tgeo.masked_median(t(vals), t(valid[:21]), interp)),
            float(jgeo.masked_median(jnp.asarray(vals), jnp.asarray(valid[:21]), interp)),
            rtol=1e-7,
        )


def test_gmc_warp_matches_jax():
    rng = np.random.default_rng(2)
    prev = rng.uniform(0, 900, (57, 2)).astype(np.float32)
    new = (prev @ np.array([[1.01, 0.02], [-0.02, 0.99]], np.float32).T + [3.0, -2.0]).astype(np.float32)
    for k_valid in (2, 30):
        valid = np.zeros(57, bool)
        valid[:k_valid] = True
        want = np.asarray(jt.estimate_gmc_warp(jnp.asarray(prev), jnp.asarray(new), jnp.asarray(valid)))
        np.testing.assert_allclose(n(tt.estimate_gmc_warp(t(prev), t(new), t(valid))), want, atol=1e-4)


def test_backward_seed_matches_jax(scene):
    kp, valid = _kp(scene, 4)
    frames = scene.frames[:5]
    want = jt.backward_seed(jnp.asarray(frames), jnp.asarray(kp[:, :2]), jnp.asarray(valid), JCFG)
    got = tt.backward_seed(t(frames), t(kp[:, :2]), t(valid), TCFG)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[0])[n(got[1])], np.asarray(want[0])[np.asarray(want[1])])


def test_temporal_steps_match_jax(scene):
    """Ten whole steps with oracle keypoints on cadence frames and oracle
    detections; RANSAC draws from the same (reproduced) random stream."""
    key = jax.random.key(0)
    jstep = jax.jit(jt.temporal_step, static_argnames=("cfg",))
    jc = jt.init_carry(JCFG)
    tc = tt.init_carry(TCFG, "cpu")
    gum = tt.ransac_draws(0, TCFG, "cpu")
    for f in range(len(scene.frames)):
        is_kp = f % 3 == 0
        kp, valid = _kp(scene, f)
        mk = kp if is_kp else np.zeros((57, 3), np.float32)
        mv = valid if is_kp else np.zeros(57, bool)
        b, c, k, v = oracle_detections_at(scene, f)
        common = dict(model_kp=mk, model_kp_valid=mv, det_boxes=b, det_conf=c, det_valid=v)
        prev = scene.frames[max(f - 1, 0)]
        jx = jt.FrameInputs(
            frame_bgr=jnp.asarray(scene.frames[f]), prev_frame_bgr=jnp.asarray(prev),
            is_kp_frame=jnp.bool_(is_kp), is_h_frame=jnp.bool_(f % 5 == 0), det_cls=jnp.asarray(k),
            det_embed=jnp.zeros((128, 1)), t=jnp.int32(f), **{a: jnp.asarray(x) for a, x in common.items()},
        )
        tx = tt.FrameInputs(
            frame_bgr=t(scene.frames[f]), prev_frame_bgr=t(prev), is_kp_frame=is_kp, is_h_frame=f % 5 == 0,
            det_cls=t(k).long(), t=f, **{a: t(x) for a, x in common.items()},
        )
        jc, jo = jstep(jc, jx, cfg=JCFG, base_key=key)
        tc, to = tt.temporal_step(tc, tx, TCFG, gum)
        for name in ("kp_valid", "need_kp", "H_ok", "track_valid"):
            np.testing.assert_array_equal(n(getattr(to, name)), np.asarray(getattr(jo, name)), err_msg=f"frame {f} {name}")
        kv = np.asarray(jo.kp_valid)
        np.testing.assert_array_equal(n(to.kp_xy)[kv], np.asarray(jo.kp_xy)[kv], err_msg=f"frame {f}")
        tv = np.asarray(jo.track_valid)
        np.testing.assert_array_equal(n(to.track_id)[tv], np.asarray(jo.track_id)[tv])
        if bool(jo.H_ok):
            on = pitch.ON_PLANE_MASK & kv
            pj = np.asarray(jproject(jo.H, jnp.asarray(np.asarray(jo.kp_xy)[on])))
            pt = np.asarray(jproject(jnp.asarray(n(to.H)), jnp.asarray(np.asarray(jo.kp_xy)[on])))
            np.testing.assert_allclose(pt, pj, atol=5e-3)
    assert bool(jo.H_ok) and tv.sum() >= 5
