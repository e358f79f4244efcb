"""PyTorch port, ``MultiClipRunner`` on its flattened path (the built-in
models on the working geometry: ``get_coordinates(_clip_lens=)``), with
the model runners replaced by fakes that read a frame id stamped into
every frame from the device canvas, as
tests/test_multiclip.py::test_multiclip_flattened_path_matches_single_per_clip
holds the JAX package: three clips of 8, 6 and 3 frames at 320x192
(canvas 96x160), against the JAX package's runner on the same path and
against each clip's own ``get_coordinates``.

The clips reach every rule of the flattened stream: unequal lengths (pad
frames discarded); clip 0 turns featureless at frame 5 (an on-demand
round); clip 1 (base 8) is barren before its frame 2 and seeds backward
from its frame 4; clip 2 is barren at frame 0 and three frames long, so it
cannot seed, though the pad copies of its frame 2 at t = 4 carry
keypoints (pad frames are never sampled).

Tolerances: against the JAX package as in
tests/test_torch_coordinate_model.py (``assert_coords_match``, boundaries
within 5 mm); against the port's single-clip runs, equal dicts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.parallel.mesh import make_mesh
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.pipeline.multiclip import MultiClipRunner as JRunner
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner as TRunner

from .oracles import oracle_keypoint_fn
from .test_torch_coordinate_model import assert_coords_match

torch.set_num_threads(2)

H, W = 192, 320
LENS = [8, 6, 3]
L = max(LENS)
FPS = 8
KW = dict(num_homography=1, num_keypoint_detection=2)


def _small(cfg):
    """A 160-px detector canvas (96x160 for 320x192 frames) and 32-frame
    chunks (the JAX package's scan program pads to a chunk)."""
    return cfg.replace(
        detector=dataclasses.replace(cfg.detector, image_size=160),
        keypoint=dataclasses.replace(cfg.keypoint, input_hw=(96, 160)),
        chunk_frames=32,
    )


def _fid(x, xp):
    """The frame id stamped as a flat 32x32 block (16x16 on the canvas)."""
    return xp.round((x[:, 4:12, 4:12].astype(xp.float32).mean(axis=(1, 2, 3)) - 40.0) / 8.0)


def _det_rows(fid, xp):
    """One player box a frame, placed by its id."""
    b = fid.shape[0]
    row = xp.stack([100 + 3 * fid, xp.full(b, 60.0), 120 + 3 * fid, xp.full(b, 120.0), xp.full(b, 0.9),
                    xp.zeros(b), xp.ones(b)], -1).astype(xp.float32)
    return xp.concatenate([row[:, None], xp.zeros((b, 127, 7), xp.float32)], 1)


@pytest.fixture(scope="module")
def case():
    scene = make_scene(num_frames=1, width=W, height=H, num_players=0, fps=FPS, seed=6)

    def stamped(fid):
        f = scene.frames[0].copy()
        f[:32, :32] = 40 + 8 * fid
        return f

    clips = [np.stack([stamped(ci * L + t) for t in range(n)]) for ci, n in enumerate(LENS)]
    clips[0][5:, 40:] = 127
    kp, valid = oracle_keypoint_fn(scene)(scene.frames[:1])
    kp_packed = np.concatenate([kp[0], valid[0].astype(np.float32)[:, None]], -1)

    def kp_rows(fid, xp):
        barren = ((fid >= L) & (fid < 2 * L) & (fid % L < 2)) | (fid == 2 * L)
        out = xp.tile(xp.asarray(kp_packed)[None], (fid.shape[0], 1, 1))
        return xp.concatenate([out[:, :, :3], xp.where(barren[:, None], 0.0, out[:, :, 3])[..., None]], -1)

    jm = JModel(config=_small(JCFG), keypoint_params={}, detector_params={}, verbose_init=False)
    jm._det_runner = lambda g, hw: jax.jit(lambda x: _det_rows(_fid(x, jnp), jnp))
    jm._kp_runner = lambda g, hw: (lambda x: kp_rows(_fid(x, jnp), jnp))
    want = JRunner(jm, mesh=make_mesh(devices=jax.devices()[:1])).run(clips, FPS, **KW)

    def model():
        m = TModel(config=_small(TCFG), device="cpu")
        m.run_detector = lambda x, g, hw, timer=None: torch.from_numpy(_det_rows(_fid(x.numpy(), np), np))
        m.run_keypoints = lambda x, g, hw: torch.from_numpy(kp_rows(_fid(x.numpy(), np), np))
        return m

    m = model()
    assert m._geometry((H, W)).enabled
    got = TRunner(m).run(clips, FPS, **KW)
    return dict(clips=clips, model=model, want=want, got=got, rounds=m.ondemand_rounds)


def test_flattened_runner_matches_jax(case):
    assert [len(r) for r in case["got"]] == LENS
    for ci in range(len(LENS)):
        assert_coords_match(case["got"][ci], case["want"][ci], boundary_atol=5e-3)


def test_flattened_runner_clips_equal_their_single_runs(case):
    single = case["model"]()  # the fakes hold no state: one model runs every clip
    for ci, clip in enumerate(case["clips"]):
        assert single.get_coordinates(clip, FPS, **KW) == case["got"][ci], f"clip {ci}"


def test_flattened_runner_seeds_per_clip_at_a_nonzero_base_and_never_from_pads(case):
    got = case["got"]
    assert len(got[1][0]["Keypoints"]) >= 4, "clip 1 (base 8) seeds backward from its frame 4"
    assert len(got[2][0]["Keypoints"]) == 0, "clip 2's only real sample is barren; pads never seed"


def test_flattened_runner_runs_on_demand_rounds(case):
    assert case["rounds"] >= 1
    assert all(len(case["got"][0][t]["Keypoints"]) >= 4 for t in range(5, 8))
