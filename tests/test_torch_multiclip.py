"""PyTorch port, ``MultiClipRunner`` on its clip-batched path (custom
models): four make_scene clips of 8, 8, 5 and 3 frames at 320x192 with
oracle models, against the JAX package's runner on the same path and
against each clip's own ``get_coordinates``.

The clips are built to reach every rule of the path: clip 1 cuts to a
featureless image at frame 4 (flow collapse: an on-demand keypoint
round); clips 2 and 3 carry no keypoints on their first two frames, so
clip 2 (base 16) seeds backward from its frame 4, and clip 3, three frames
long, cannot seed (its only sample is frame 0; the pad copies of its last
frame at t = 4 are never sampled).

Tolerances: against the JAX package as in
tests/test_torch_coordinate_model.py (``assert_coords_match``, boundaries
within 5 mm); against the port's own single-clip runs, equal dicts."""

import jax
import numpy as np
import pytest
import torch

from eagle_tpu.parallel.mesh import make_mesh
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.pipeline.multiclip import MultiClipRunner as JRunner
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.parallel.mesh import Mesh
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel
from eagle_tpu_torch.pipeline.coordinate_model import StageTimer
from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner as TRunner

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .test_multiclip import _MultiSceneOracles
from .test_torch_coordinate_model import assert_coords_match

torch.set_num_threads(2)

LENS = [8, 8, 5, 3]
L = max(LENS)
FPS = 8
KW = dict(num_homography=1, num_keypoint_detection=2)
#: a pixel value that marks the frames whose keypoints the oracle withholds
MARK = np.array([1, 2, 3], np.uint8)


@pytest.fixture(scope="module")
def case():
    scenes = [make_scene(num_frames=n, width=320, height=192, num_players=4, fps=FPS, seed=40 + i) for i, n in enumerate(LENS)]
    clips = [s.frames.copy() for s in scenes]
    clips[1][4:] = 127  # LK's structure tensor is singular: the flow collapses
    for c in (2, 3):
        clips[c][:2, 0, 0] = MARK
    inner = oracle_keypoint_fn(scenes[0])  # static cameras: the same landmarks in every scene

    def kp_fn(batch):
        kp, valid = inner(batch)
        valid = valid.copy()
        valid[(np.asarray(batch)[:, 0, 0] == MARK).all(-1)] = False
        return kp, valid

    want = JRunner(
        JModel(keypoint_fn=kp_fn, detector_fn=_MultiSceneOracles(scenes, L), verbose_init=False),
        mesh=make_mesh(devices=jax.devices()[:1]),
    ).run(clips, FPS, **KW)
    model = TModel(keypoint_fn=kp_fn, detector_fn=_MultiSceneOracles(scenes, L), device="cpu")
    timer = StageTimer(model.device)
    got = TRunner(model).run(clips, FPS, profile=timer, **KW)
    return dict(scenes=scenes, clips=clips, kp_fn=kp_fn, want=want, got=got, model=model, timer=timer)


def test_clip_batched_runner_matches_jax(case):
    assert [len(r) for r in case["got"]] == LENS
    for ci in range(len(LENS)):
        assert_coords_match(case["got"][ci], case["want"][ci], boundary_atol=5e-3)
    assert sum(len(o) for r in case["got"] for fr in r.values() for o in fr["Coordinates"].values()) > 50


def test_clip_batched_runner_clips_equal_their_single_runs(case):
    for ci, scene in enumerate(case["scenes"]):
        single = TModel(keypoint_fn=case["kp_fn"], detector_fn=oracle_detector_fn(scene), device="cpu")
        assert single.get_coordinates(case["clips"][ci], FPS, **KW) == case["got"][ci], f"clip {ci}"


def test_clip_batched_runner_seeds_per_clip_and_never_from_pads(case):
    got = case["got"]
    assert len(got[2][0]["Keypoints"]) >= 4, "clip 2 seeds backward from its frame 4"
    assert len(got[3][0]["Keypoints"]) == 0, "clip 3 has no real sample to seed from"


def test_clip_batched_runner_runs_on_demand_rounds(case):
    assert case["model"].ondemand_rounds >= 1
    assert all(len(case["got"][1][t]["Keypoints"]) >= 4 for t in range(4, L)), "the flagged frames get keypoints"
    assert {"prescale", "detector", "keypoints", "temporal", "assembly"} <= set(case["timer"].seconds)


def test_runner_takes_one_device_and_rejects_a_mesh_of_more():
    """The runner takes a mesh of one rank (a one-device sequence, or none)
    or of N ranks (``make_mesh``'s, on the model's device; the multi-rank
    runs are tests/test_torch_multiclip_mesh.py); a bare sequence of more
    than one device, with no process group, raises and names ``make_mesh``
    (each rank of a larger mesh is a process of its own)."""
    model = TModel(keypoint_fn=lambda b: None, detector_fn=lambda b: None, device="cpu")
    assert TRunner(model, mesh=[torch.device("cpu")]).mesh.size == 1
    assert TRunner(model).mesh.size == 1
    ranks = Mesh(None, "gloo", 0, 0, 3, (0, 1, 2), (3,), ("data",), torch.device("cpu"))
    assert TRunner(model, mesh=ranks).mesh.size == 3
    with pytest.raises(ValueError, match="make_mesh"):
        TRunner(model, mesh=[torch.device("cpu"), torch.device("cpu")])
