"""PyTorch port, the reference's tracker end to end: ``get_coordinates``
of both packages with ReID appearance association (OSNet-x0.25), on a
12-frame panning make_scene clip with six players and
oracle keypoint and detector callables (the identity geometry; the crops
are cut from the original frames).  The OSNet weights are one JAX pytree,
bridged into the port.  The same with the HSV histogram and with the
features GMC (one file each keeps every file well under a minute):
tests/test_torch_{histogram,features_gmc}_pipeline.py.

Tolerances as in tests/test_torch_coordinate_model.py: keypoints, classes
and track ids equal; boxes within 1 px; boundaries within 5 mm.
"""

import dataclasses

import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .test_torch_coordinate_model import assert_coords_match
from .torch_parity import osnet_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=12, width=320, height=192, num_players=6, fps=12, seed=3, pan_speed=2.0)


def _cfg(base, **tracker):
    return base.replace(
        detector=dataclasses.replace(base.detector, use_bf16=False),
        tracker=dataclasses.replace(base.tracker, **tracker),
    )


SETTINGS = {
    "osnet": dict(use_appearance=True, embedder="osnet", embed_dim=32, reid_slots=8),
    "histogram": dict(use_appearance=True, embedder="histogram", embed_dim=64),
}


def test_osnet_appearance_matches_jax(scene):
    check_pipeline(scene, SETTINGS["osnet"])


def check_pipeline(scene, tracker: dict) -> None:
    """get_coordinates of both packages with oracle models and this tracker
    configuration (float32 OSNet when the embedder is OSNet)."""
    reid = None
    if tracker["embedder"] == "osnet":
        reid = osnet_params(7, feature_dim=tracker["embed_dim"])
    kw = dict(num_keypoint_detection=3)
    want = JModel(
        config=_cfg(JCFG, **tracker), keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene),
        reid_params=reid, verbose_init=False,
    ).get_coordinates(scene.frames, scene.fps, verbose=False, **kw)
    model = TModel(
        config=_cfg(TCFG, **tracker), keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene),
        reid_params=reid, device="cpu",
    )
    assert model.config.tracker.use_appearance and (model.reid_model is None) == (reid is None)
    got = model.get_coordinates(scene.frames, scene.fps, **kw)
    assert assert_coords_match(got, want, boundary_atol=5e-3) >= 6 * len(scene.frames)


def _no_models():
    return dict(keypoint_fn=lambda b: None, detector_fn=lambda b: None, device="cpu")


def test_reid_configuration_follows_the_jax_rules(tmp_path):
    """use_appearance=None means on exactly when ReID weights are given; the
    embedder and the feature width are checked; .msgpack raises, naming the
    checkpoint loaders' ROADMAP item; OSNet without weights warns."""
    assert not TModel(**_no_models()).config.tracker.use_appearance
    m = TModel(reid_params=osnet_params(0), **_no_models())
    assert m.config.tracker.use_appearance and m.reid_model.fc.w.shape == (128, 512)
    on = _cfg(TCFG, use_appearance=True)
    with pytest.warns(UserWarning, match="RANDOM"):
        assert TModel(config=on, **_no_models()).reid_model is not None
    with pytest.raises(NotImplementedError, match="item 3"):
        TModel(reid_checkpoint=str(tmp_path / "osnet.msgpack"), **_no_models())
    with pytest.raises(ValueError, match="embed_dim"):
        TModel(config=_cfg(TCFG, use_appearance=True, embedder="histogram"), **_no_models())
    with pytest.raises(ValueError, match="embedder"):
        TModel(config=_cfg(TCFG, use_appearance=True, embedder="sift"), **_no_models())
    with pytest.raises(ValueError, match="would not use them"):
        TModel(config=_cfg(TCFG, use_appearance=False), reid_params=osnet_params(0), **_no_models())
    with pytest.raises(ValueError, match="feature dim 32"):
        TModel(config=on, reid_params=osnet_params(0, feature_dim=32), **_no_models())
