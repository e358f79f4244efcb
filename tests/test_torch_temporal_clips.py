"""PyTorch port, the clip-batched temporal step:
``temporal.temporal_step_clips`` on C = 3 make_scene clips over four steps
whose homography gates differ between the clips (at the first step only
clip 0's ``do_h`` is on, at the second only clip 1's), against the port's
single-clip step clip by clip, and with the features GMC against the JAX
package's ``temporal_step_clips`` (the default tracker's clip step is
held against the JAX package's through the runner,
tests/test_torch_multiclip.py; one compile of the JAX step costs ~20 s
here); and ``optical_flow.lk_flow_clips`` on CPU tensors against single
calls of the plain version.

Tolerances: against the JAX package as in tests/test_torch_temporal.py
(masks, keypoint pixels, track ids and flags bit-equal; homographies
project the keypoints to within 5 mm of each other; track boxes within
1e-3 px, float32 Kalman updates summed in another order).  Against the
port's own single-clip step, clip by clip: every output and carry leaf
bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu import pitch
from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.ops.homography import perspective_transform as jproject
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.ops import optical_flow as of
from eagle_tpu_torch.pipeline import temporal as tt

from .oracles import oracle_detections_at, oracle_keypoint_fn
from .torch_parity import n, t

torch.set_num_threads(2)

C, STEPS = 3, 4
#: is_h_frame per step and clip: only clip 0's gate at step 0, clip 1's at 1
H_FRAMES = [[True, False, False], [False, True, False], [False, False, False], [True, True, True]]


@pytest.fixture(scope="module")
def scenes():
    return [make_scene(num_frames=STEPS, width=320, height=192, num_players=4, fps=8, seed=60 + i) for i in range(C)]


def _inputs(scenes, f: int):
    """Step ``f``'s per-clip numpy inputs: oracle keypoints on even steps
    (clip 1's withheld at step 2), oracle detections."""
    rows = []
    for ci, sc in enumerate(scenes):
        is_kp = f % 2 == 0 and not (ci == 1 and f == 2)
        kp, valid = oracle_keypoint_fn(sc)(sc.frames[f : f + 1])
        b, c, k, v = oracle_detections_at(sc, f)
        rows.append(dict(
            frame=sc.frames[f], prev=sc.frames[max(f - 1, 0)], is_kp=f % 2 == 0,
            mk=kp[0] if is_kp else np.zeros((57, 3), np.float32), mv=valid[0] if is_kp else np.zeros(57, bool),
            b=b, c=c, k=k, v=v,
        ))
    return rows


@pytest.mark.parametrize("gmc", ["affine", "features"])
def test_temporal_step_clips_matches_jax(scenes, gmc):
    """Every step, clip by clip: equal to the single-clip step; with the
    features GMC, also to the JAX package's clip-batched step."""
    against_jax = gmc == "features"
    jcfg = JCFG.replace(tracker=dataclasses.replace(JCFG.tracker, gmc=gmc))
    tcfg = TCFG.replace(tracker=dataclasses.replace(TCFG.tracker, gmc=gmc))
    key = jax.random.key(0)
    jstep = jax.jit(jt.temporal_step_clips, static_argnames=("cfg",))
    jc = jax.vmap(lambda _: jt.init_carry(jcfg))(jnp.arange(C))
    tc = tt.stack_clips([tt.init_carry(tcfg, "cpu") for _ in range(C)])
    singles = [tt.init_carry(tcfg, "cpu") for _ in range(C)]
    gum = tt.ransac_draws(0, tcfg, "cpu")
    solved = 0
    for f in range(STEPS):
        rows = _inputs(scenes, f)

        def stacked(name):
            return np.stack([r[name] for r in rows])

        jx = jt.FrameInputs(
            frame_bgr=jnp.asarray(stacked("frame")), prev_frame_bgr=jnp.asarray(stacked("prev")),
            model_kp=jnp.asarray(stacked("mk")), model_kp_valid=jnp.asarray(stacked("mv")),
            is_kp_frame=jnp.asarray(stacked("is_kp")), is_h_frame=jnp.asarray(H_FRAMES[f]),
            det_boxes=jnp.asarray(stacked("b")), det_conf=jnp.asarray(stacked("c")), det_cls=jnp.asarray(stacked("k")),
            det_valid=jnp.asarray(stacked("v")), det_embed=jnp.zeros((C, 128, 1)), t=jnp.full((C,), f, jnp.int32),
        )
        tx = tt.FrameInputs(
            frame_bgr=t(stacked("frame")), prev_frame_bgr=t(stacked("prev")), model_kp=t(stacked("mk")),
            model_kp_valid=t(stacked("mv")), is_kp_frame=[r["is_kp"] for r in rows], is_h_frame=H_FRAMES[f],
            det_boxes=t(stacked("b")), det_conf=t(stacked("c")), det_cls=t(stacked("k")).long(),
            det_valid=t(stacked("v")), t=[f] * C,
        )
        tc, to = tt.temporal_step_clips(tc, tx, tcfg, gum)
        for ci in range(C):
            singles[ci], so = tt.temporal_step(singles[ci], tt.clip_at(tx, ci), tcfg, gum)
            for leaf, want in zip(tt.clip_at(to, ci), so):
                assert torch.equal(leaf, want), f"step {f} clip {ci}: the clip step differs from the single step"
            for leaf, want in zip(jax.tree.leaves(tuple(tt.clip_at(tc, ci))), jax.tree.leaves(tuple(singles[ci]))):
                assert torch.equal(leaf, want), f"step {f} clip {ci}: carries differ"
        solved += int(to.H_ok.sum())
        if not against_jax:
            continue
        jc, jo = jstep(jc, jx, cfg=jcfg, base_key=key)
        for ci in range(C):
            jo_c = jax.tree.map(lambda a: np.asarray(a)[ci], jo)
            to_c = tt.clip_at(to, ci)
            for name in ("kp_valid", "need_kp", "H_ok", "track_valid"):
                np.testing.assert_array_equal(n(getattr(to_c, name)), getattr(jo_c, name), err_msg=f"step {f} clip {ci} {name}")
            kv, tv = jo_c.kp_valid, jo_c.track_valid
            np.testing.assert_array_equal(n(to_c.kp_xy)[kv], jo_c.kp_xy[kv], err_msg=f"step {f} clip {ci}")
            np.testing.assert_array_equal(n(to_c.track_id)[tv], jo_c.track_id[tv])
            np.testing.assert_allclose(n(to_c.track_boxes)[tv], jo_c.track_boxes[tv], atol=1e-3)
            if bool(jo_c.H_ok):
                on = pitch.ON_PLANE_MASK & kv
                pj = np.asarray(jproject(jnp.asarray(jo_c.H), jnp.asarray(jo_c.kp_xy[on])))
                pt = np.asarray(jproject(jnp.asarray(n(to_c.H)), jnp.asarray(jo_c.kp_xy[on])))
                np.testing.assert_allclose(pt, pj, atol=5e-3)
    assert solved >= C and int(to.track_valid.sum()) >= C


def test_lk_flow_clips_plain_equals_single_calls(scenes):
    """On CPU tensors the batched flow is the plain version clip by clip:
    the same points and status as C single calls."""
    rng = np.random.default_rng(3)
    prev = t(np.stack([sc.frames[0] for sc in scenes]))
    curr = t(np.stack([sc.frames[1] for sc in scenes]))
    pts = t(rng.uniform([0, 0], [319, 191], (C, 20, 2)).astype(np.float32))
    valid = t(rng.random((C, 20)) < 0.9)
    g, s = of.lk_flow_clips(prev, curr, pts, valid)
    assert g.shape == (C, 20, 2) and s.shape == (C, 20)
    for ci in range(C):
        g1, s1 = of.lk_flow_plain(prev[ci], curr[ci], pts[ci], valid[ci])
        assert torch.equal(g[ci], g1) and torch.equal(s[ci], s1)
    assert int(s.sum()) > 0
