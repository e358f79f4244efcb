"""PyTorch port, bounded-memory streaming with the reference's tracker:
``CoordinateModel.stream_coordinates`` with the features GMC and OSNet
appearance (small widths, float32) against the JAX package's stream on
the same segments, and against the port's own one-shot ``get_coordinates``.
The block boundary is where the tracker's carry and the previous frame
pass from one call to the next; the features GMC flows the previous
frame's 240 grid corners, so a block's first step reads the previous
block's last frame.

Tolerances: against the JAX package at
``tests/test_torch_coordinate_model.py::assert_coords_match``'s; against
the port's one-shot exactly (``==`` on the dicts)."""

import dataclasses

import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .test_torch_coordinate_model import assert_coords_match
from .test_torch_streaming import H, W, _models
from .torch_parity import osnet_params

torch.set_num_threads(2)


def test_reference_tracker_streams_across_blocks():
    """The reference's tracker: the features GMC (the flow at K = 240 on the
    previous frame's corners, which for a block's first frame is the
    previous block's last) and float32 OSNet appearance, carried across
    the block boundary."""
    scene = make_scene(num_frames=18, width=W, height=H, num_players=6, fps=12, seed=3, pan_speed=2.0)
    tracker = dict(use_appearance=True, embedder="osnet", embed_dim=32, reid_slots=8, gmc="features")
    jcfg, tcfg = (
        base.replace(chunk_frames=16, detector=dataclasses.replace(base.detector, use_bf16=False),
                     tracker=dataclasses.replace(base.tracker, **tracker))
        for base in (JCFG, TCFG)
    )
    reid = osnet_params(7, feature_dim=32)
    segments = [scene.frames[:9], scene.frames[9:]]
    want = {}
    for block in JModel(config=jcfg, reid_params=reid, verbose_init=False, **_models(scene)).stream_coordinates(
        segments, 12, num_keypoint_detection=3, prefetch=False
    ):
        want.update(block)
    blocks = list(TModel(config=tcfg, reid_params=reid, device="cpu", **_models(scene)).stream_coordinates(
        segments, 12, num_keypoint_detection=3, prefetch=False))
    assert [len(b) for b in blocks] == [16, 2]
    got = {k: v for b in blocks for k, v in b.items()}
    assert assert_coords_match(got, want, boundary_atol=5e-3) >= 6 * 18
    one = TModel(config=tcfg, reid_params=reid, device="cpu", **_models(scene)).get_coordinates(
        scene.frames, 12, num_keypoint_detection=3)
    assert got == one
