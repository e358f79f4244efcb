"""PyTorch port, the config interactions of ``tests/test_config_matrix.py``
held against the JAX package: each of its five cases (appearance
embeddings with the auction, OSNet with the exact solver and calibration,
the translation GMC, calibration with the auction streamed, the histogram
streamed) runs ``get_coordinates`` (or ``stream_coordinates``) of both
packages on the same ``make_scene`` clip with the same oracle models, and
the port's output must match the JAX package's.  The OSNet case gives both
packages one seeded OSNet pytree (bridged into the port), float32.

The clip is that file's scene cut to 24 frames (blocks of 16 + 8 when
streamed, ``chunk_frames=16``, the piece size).  The two cases with the
exact solver run in tests/test_torch_config_matrix_exact.py on 8 frames:
on the CPU the port's JV is its plain Python loop (~1 s a frame here), and
one file of all five would run past a minute.

Tolerances as in tests/test_torch_coordinate_model.py (a): keypoints,
classes and track ids equal; boxes and image points within 1 px, pitch
positions within 1 m, confidences within 1e-4; boundaries within 5 mm."""

import numpy as np
import pytest
import torch

from eagle_tpu import config as jconfig
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch import config as tconfig
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .test_torch_coordinate_model import assert_coords_match
from .torch_parity import osnet_params

torch.set_num_threads(2)

FRAMES = 24
BLOCK = 16

#: tests/test_config_matrix.py's cases, as plain keyword arguments of each
#: package's TrackerConfig / DetectorConfig
CASES = {
    "hist-appearance+auction": dict(
        tracker=dict(max_tracks=16, use_appearance=True, embedder="histogram", embed_dim=64, assignment="auction"),
    ),
    "osnet+exact+calibration": dict(
        detector=dict(use_bf16=False),
        tracker=dict(max_tracks=16, use_appearance=True, embedder="osnet", embed_dim=16, reid_slots=4,
                     assignment="exact", gmc="off"),
        calibration=True,
    ),
    "gmc-translation+smoothless": dict(tracker=dict(max_tracks=16, gmc="translation", assignment="exact")),
    "calibration+auction+stream": dict(
        tracker=dict(max_tracks=16, assignment="auction", gmc="affine"), calibration=True, stream=True,
    ),
    "hist-appearance+stream": dict(
        tracker=dict(max_tracks=16, use_appearance=True, embedder="histogram", embed_dim=64), stream=True,
    ),
}


EXACT = sorted(n for n, c in CASES.items() if c["tracker"].get("assignment") == "exact")


def _coordinates(pkg, model_cls, scene, case: dict, **model_kw) -> dict:
    cfg = pkg.DEFAULT_CONFIG.replace(
        chunk_frames=BLOCK,
        tracker=pkg.TrackerConfig(**case["tracker"]),
        detector=pkg.DetectorConfig(**case.get("detector", {})),
    )
    model = model_cls(config=cfg, keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene),
                      **model_kw)
    kw = dict(num_homography=1, num_keypoint_detection=2, calibration=case.get("calibration", False))
    if case.get("stream"):
        out = {}
        for block in model.stream_coordinates([scene.frames[:BLOCK], scene.frames[BLOCK:]], scene.fps,
                                               prefetch=False, **kw):
            out.update(block)
        return out
    return model.get_coordinates(scene.frames, scene.fps, **kw)


def check_case(name: str, frames: int) -> None:
    """Both packages on ``frames`` frames of the scene under case ``name``:
    the port's coordinates match the JAX package's, frame by frame, and
    track at least 3 of the 5 players a frame."""
    case = CASES[name]
    scene = make_scene(num_frames=frames, width=480, height=270, num_players=5, fps=8, seed=21)
    reid = {}
    if case["tracker"].get("embedder") == "osnet":
        reid = dict(reid_params=osnet_params(7, feature_dim=case["tracker"]["embed_dim"]))
    want = _coordinates(jconfig, JModel, scene, case, verbose_init=False, **reid)
    got = _coordinates(tconfig, TModel, scene, case, device="cpu", **reid)
    assert sorted(got) == list(range(frames))
    assert assert_coords_match(got, want, boundary_atol=5e-3) >= 3 * frames
    for fr in got.values():
        assert set(fr) >= {"Coordinates", "Time", "Keypoints", "Boundaries"}
    assert np.mean([len(fr["Coordinates"].get("Player", {})) for fr in got.values()]) >= 3


@pytest.mark.parametrize("name", sorted(set(CASES) - set(EXACT)))
def test_config_combination_matches_jax(name):
    check_case(name, FRAMES)
