"""PyTorch port, the slice as a whole: ``CoordinateModel.get_coordinates``
of both packages on make_scene clips, with (a) the oracle keypoint and
detector callables and (b) the built-in HRNet-W48 / YOLOv8 with the same
(bridged) weights at a reduced input size.  Also: the port and
``chip_smoke.py`` import nothing of JAX or the JAX package, nor flax,
msgpack, onnx, pandas or OpenCV (the card's machine has none of them),
and the port never falls back to the CPU quietly.

Tolerances, per frame of the two dicts:
- the frame keys, "Time", "Keypoints" (names and integer pixels), the
  object classes and their track ids are equal;
- "Boundaries" (metres, float64 line solves on the projected image
  corners) agree within 5 mm (a): the homographies are fitted to the same
  integer keypoints and polished by float32 Gauss-Newton steps in another
  summation order; within 5 cm (b), where the pitch spans a 320-px image;
- "BBox" and "Image_Bottom_center" (integer pixels) within 1 px and
  "Transformed_Coordinates" (integer metres) within 1 m: each is an
  integer truncation of float32 values that agree to ~1e-4, which flips
  when the value lies that close to an integer;
- "Confidence" within 1e-4 (the detector scores' float32 bar).
"""

import dataclasses
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DEFAULT_CONFIG as JCFG
from eagle_tpu.models import hrnet as jh
from eagle_tpu.models import yolov8 as jy
from eagle_tpu.ops.preprocess import compute_work_geometry as jgeometry
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.config import DEFAULT_CONFIG as TCFG
from eagle_tpu_torch.ops.preprocess import host_letterbox_i420
from eagle_tpu_torch.pipeline import temporal as tt
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .oracles import oracle_detector_fn, oracle_keypoint_fn
from .torch_parity import spread_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_dets(batch):
    b = len(batch)
    return (
        np.zeros((b, 128, 4), np.float32),
        np.zeros((b, 128), np.float32),
        np.zeros((b, 128), np.int32),
        np.zeros((b, 128), bool),
    )


def assert_coords_match(got: dict, want: dict, boundary_atol: float) -> int:
    """Compare two get_coordinates dicts at the tolerances of the module
    docstring; returns the number of objects compared."""
    assert sorted(got) == sorted(want)
    n_obj = 0
    for i in want:
        g, w = got[i], want[i]
        assert g["Time"] == w["Time"], i
        assert g["Keypoints"] == w["Keypoints"], f"frame {i} keypoints"
        for bg, bw in zip(g["Boundaries"], w["Boundaries"]):
            assert (bg is None) == (bw is None), f"frame {i} boundaries"
            if bw is not None:
                np.testing.assert_allclose(bg, bw, atol=boundary_atol, err_msg=f"frame {i}")
        assert sorted(g["Coordinates"]) == sorted(w["Coordinates"]), i
        for cls, objs in w["Coordinates"].items():
            assert sorted(g["Coordinates"][cls]) == sorted(objs), f"frame {i} {cls} ids"
            for oid, ow in objs.items():
                og = g["Coordinates"][cls][oid]
                assert sorted(og) == sorted(ow), f"frame {i} {cls} {oid}"
                np.testing.assert_allclose(og["BBox"], ow["BBox"], atol=1)
                np.testing.assert_allclose(og["Confidence"], ow["Confidence"], atol=1e-4)
                if "Image_Bottom_center" in ow:
                    np.testing.assert_allclose(og["Image_Bottom_center"], ow["Image_Bottom_center"], atol=1)
                tw, tg = ow["Transformed_Coordinates"], og["Transformed_Coordinates"]
                assert (tg is None) == (tw is None), f"frame {i} {cls} {oid}"
                if tw is not None:
                    np.testing.assert_allclose(tg, tw, atol=1)
                n_obj += 1
    return n_obj


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=20, width=960, height=540, num_players=6, fps=20, seed=11)


def test_oracle_slice_matches_jax(scene):
    """(a) Oracle models: keypoint cadence, backward-free seeding, flow,
    synthesis, RANSAC, the tracker and the assembly over 20 frames."""
    kw = dict(num_homography=1, num_keypoint_detection=3)
    want = JModel(
        keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene), verbose_init=False
    ).get_coordinates(scene.frames, scene.fps, verbose=False, **kw)
    got = TModel(
        keypoint_fn=oracle_keypoint_fn(scene), detector_fn=oracle_detector_fn(scene), device="cpu"
    ).get_coordinates(scene.frames, scene.fps, **kw)
    assert assert_coords_match(got, want, boundary_atol=5e-3) > 100
    assert all(len(fr["Keypoints"]) >= 4 and fr["Boundaries"][0] is not None for fr in got.values())


def test_backward_seed_and_on_demand_rounds_match_jax():
    """(a) A clip whose first frames carry no keypoints (backward seeding
    from the first cadence frame that has them) and that cuts to a
    featureless image (flow collapse: on-demand keypoint rounds)."""
    base = make_scene(num_frames=12, width=640, height=360, num_players=0, fps=8, seed=1)
    frames = base.frames.copy()
    frames[8:] = 127
    inner = oracle_keypoint_fn(base)

    def make_kp_fn(calls):
        def fn(batch):
            calls.append(len(batch))
            kp, valid = inner(batch)
            if len(calls) == 1:  # the first cadence batch: frame 0 sees nothing
                valid = valid.copy()
                valid[0] = False
            return kp, valid

        return fn

    jcalls, tcalls = [], []
    want = JModel(keypoint_fn=make_kp_fn(jcalls), detector_fn=_no_dets, verbose_init=False).get_coordinates(
        frames, 8, num_keypoint_detection=2, verbose=False
    )
    got = TModel(keypoint_fn=make_kp_fn(tcalls), detector_fn=_no_dets, device="cpu").get_coordinates(
        frames, 8, num_keypoint_detection=2
    )
    assert_coords_match(got, want, boundary_atol=5e-3)
    assert len(tcalls) >= 2, "the flow collapse must trigger an on-demand keypoint round"
    assert len(got[1]["Keypoints"]) >= 4, "frame 1 is seeded by backward flow"
    assert len(got[9]["Keypoints"]) >= 4, "the flagged frames get model keypoints"


def _reduced_cfg(base):
    """The built-in-model tests' configuration: YOLOv8-m at a 160-px canvas,
    HRNet at 96x160, float32, and the homography off (``min_points`` above
    57; see test_builtin_models_slice_matches_jax)."""
    return base.replace(
        detector=dataclasses.replace(base.detector, variant="medium", image_size=160, use_bf16=False),
        keypoint=dataclasses.replace(base.keypoint, input_hw=(96, 160), use_bf16=False),
        homography=dataclasses.replace(base.homography, min_points=58),
    )


def _bridged_params():
    """Seeded HRNet-W48 and YOLOv8-m parameter pytrees of the JAX package,
    with signal-preserving weights (tests/torch_parity.py)."""
    rng = np.random.default_rng(0)
    kp_params = spread_params(jax.eval_shape(lambda: jh.init_params(jax.random.key(0))), rng)
    det_shapes = jax.eval_shape(lambda: jy.init_params(jax.random.key(1), variant="m", num_classes=5))
    return kp_params, spread_params(det_shapes, rng, gain=1.0)


def _small_scene():
    return make_scene(num_frames=8, width=320, height=192, num_players=4, fps=8, seed=5)


def test_builtin_models_slice_matches_jax():
    """(b) Built-in HRNet-W48 and YOLOv8-m with the same weights (JAX
    pytrees, bridged into the port) on the working-resolution path at a
    reduced size: 320x192 frames, detector canvas 160x96, keypoint input
    96x160 -- the native 4:2:0 prescale, the BT.601 inverse, both CNNs in
    float32, NMS, decode, flow, synthesis and the tracker.

    Random weights give keypoints with no consistent pitch geometry.  A
    homography fitted to them is decided by rounding: on this clip a
    1e-4 px shift of the JAX package's own input swaps the winning RANSAC
    hypothesis for another one with the same number of inliers.  So the
    homography is switched off here (``min_points`` above 57), and the
    homography path is held by the oracle tests above."""
    sc = _small_scene()
    kp_params, det_params = _bridged_params()
    kw = dict(num_keypoint_detection=2)
    want = JModel(
        config=_reduced_cfg(JCFG), keypoint_params=kp_params, detector_params=det_params, verbose_init=False
    ).get_coordinates(sc.frames, sc.fps, verbose=False, **kw)
    model = TModel(config=_reduced_cfg(TCFG), keypoint_params=kp_params, detector_params=det_params, device="cpu")
    assert model._geometry((192, 320)).enabled
    got = model.get_coordinates(sc.frames, sc.fps, **kw)
    n_obj = assert_coords_match(got, want, boundary_atol=5e-2)
    assert n_obj > 20 and sum(len(fr["Keypoints"]) for fr in got.values()) > 20


def test_backward_seed_flows_over_the_cv2_decode(monkeypatch):
    """(b) On the working-geometry (4:2:0) path the backward seed flows
    over OpenCV's decode of the uploaded planes -- what the reference
    seeds over, its host copies decoded by cv2 -- and seeds what the JAX
    package's ``backward_seed`` seeds on those frames.  Frame 0's model
    keypoints are cut below 4, so the seed runs from the next cadence
    frame.  Bit-equal frames, masks and (integer) positions."""
    sc = _small_scene()
    kp_params, det_params = _bridged_params()
    model = TModel(config=_reduced_cfg(TCFG), keypoint_params=kp_params, detector_params=det_params, device="cpu")
    keypoints_at = model._keypoints_at

    def frame0_barren(idx, *args):
        rows = keypoints_at(idx, *args)
        if 0 in idx:
            rows[idx.index(0), :, 3] = 0.0
        return rows

    seen = {}

    def spy(frames, seed_xy, seed_valid, cfg):
        out = real_seed(frames, seed_xy, seed_valid, cfg)
        seen.update(frames=frames.numpy(), xy=seed_xy.numpy(), valid=seed_valid.numpy(), cfg=cfg,
                    out=[o.numpy() for o in out])
        return out

    real_seed = tt.backward_seed
    monkeypatch.setattr(model, "_keypoints_at", frame0_barren)
    monkeypatch.setattr(tt, "backward_seed", spy)
    model.get_coordinates(sc.frames, sc.fps, num_keypoint_detection=2)
    assert seen, "frame 0 has no keypoints: the backward seed must run"
    geom = model._geometry((192, 320))
    planes = host_letterbox_i420(sc.frames[: len(seen["frames"])], geom)
    cv2_frames = np.stack([cv2.cvtColor(p, cv2.COLOR_YUV2BGR_I420) for p in planes])
    np.testing.assert_array_equal(seen["frames"], cv2_frames)

    jgeom = jgeometry((192, 320), 160)
    assert dataclasses.asdict(jgeom) == dataclasses.asdict(seen["cfg"].work)
    want_xy, want_valid = (
        np.asarray(a)
        for a in jt.backward_seed(
            jnp.asarray(cv2_frames), jnp.asarray(seen["xy"]), jnp.asarray(seen["valid"]),
            _reduced_cfg(JCFG).replace(work=jgeom),
        )
    )
    got_xy, got_valid = seen["out"]
    np.testing.assert_array_equal(got_valid, want_valid)
    assert want_valid[:-1].sum() >= 4, "the seed must reach the earlier frames"
    np.testing.assert_array_equal(got_xy[got_valid], want_xy[want_valid])


def test_upload_decodes_in_pieces_bit_equal_to_one_decode(monkeypatch):
    """The 4:2:0 upload is decoded PIECE frames at a time into one uint8
    frame buffer (the decode's float temporaries are one piece's, not the
    clip's); its bytes equal one ``i420_to_bgr`` of the whole clip's planes
    (20 frames: a full piece and a short one)."""
    from eagle_tpu_torch.ops.preprocess import i420_to_bgr
    from eagle_tpu_torch.pipeline import coordinate_model as cm

    frames = np.random.default_rng(8).integers(0, 256, (cm.PIECE + 4, 192, 320, 3), dtype=np.uint8)
    model = TModel(config=_reduced_cfg(TCFG), device="cpu")
    geom = model._geometry((192, 320))
    whole = i420_to_bgr(torch.from_numpy(host_letterbox_i420(frames, geom)))
    decoded = []

    def spy(planes):
        decoded.append(len(planes))
        return i420_to_bgr(planes)

    monkeypatch.setattr(cm, "i420_to_bgr", spy)
    assert torch.equal(model.upload(frames, geom), whole)
    assert decoded == [cm.PIECE, 4]


def test_processor_is_exported_at_the_top_level():
    import eagle_tpu_torch
    from eagle_tpu_torch.pipeline.processor import Processor

    assert eagle_tpu_torch.Processor is Processor
    assert "Processor" in eagle_tpu_torch.__all__


def test_default_runners_are_bound_but_not_custom():
    """Without injected callables the default runner entries are bound as
    ``_keypoint_fn`` / ``_detector_fn`` (as the JAX package binds them),
    and the flags every path branches on stay False."""
    model = TModel(device="cpu")
    assert model._keypoint_fn == model._default_keypoint_fn
    assert model._detector_fn == model._default_detector_fn
    assert not model._custom_kp and not model._custom_det
    assert model._geometry((720, 1280)).enabled


def test_default_device_is_the_card_without_fallback():
    """No card and no explicit device="cpu": construction raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(keypoint_fn=lambda b: None, detector_fn=_no_dets)


_PROBE = """
import importlib, pkgutil, sys
import numpy as np
import torch
torch.set_num_threads(2)
import eagle_tpu_torch
import eagle_tpu_torch.evaluate
import eagle_tpu_torch.main
import eagle_tpu_torch.models.bridge
import eagle_tpu_torch.models.osnet
import eagle_tpu_torch.ops.corners
import eagle_tpu_torch.ops.embed
import eagle_tpu_torch.ops.kmeans
import eagle_tpu_torch.pipeline.multiclip
import eagle_tpu_torch.pipeline.processor
import eagle_tpu_torch.pipeline.transfer
import eagle_tpu_torch.utils.synthetic
import eagle_tpu_torch.validate_acceptance
from eagle_tpu_torch.config import DEFAULT_CONFIG
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
for m in pkgutil.walk_packages(eagle_tpu_torch.__path__, "eagle_tpu_torch."):
    importlib.import_module(m.name)

rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
kp = np.zeros((57, 3), np.float32)
kp[:6, :2] = rng.uniform(10, 50, (6, 2))

def keypoints(batch):
    b = len(batch)
    valid = np.zeros((b, 57), bool)
    valid[:, :6] = True
    return np.tile(kp, (b, 1, 1)), valid

def detections(batch):
    b = len(batch)
    return (np.zeros((b, 128, 4), np.float32), np.zeros((b, 128), np.float32),
            np.zeros((b, 128), np.int32), np.zeros((b, 128), bool))

res = CoordinateModel(keypoint_fn=keypoints, detector_fn=detections, device="cpu").get_coordinates(frames, 3)
assert sorted(res) == [0, 1, 2], res
# the reference's tracker: OSNet ReID (seeded random weights) and the features GMC
tracker = DEFAULT_CONFIG.tracker.__class__(use_appearance=True, embed_dim=32, reid_slots=2, gmc="features")
model = CoordinateModel(config=DEFAULT_CONFIG.replace(tracker=tracker), keypoint_fn=keypoints,
                        detector_fn=detections, device="cpu")
assert model.reid_model is not None
assert sorted(model.get_coordinates(frames, 3)) == [0, 1, 2]
# streaming (a prefetch thread) and serving (the Processor's thread)
plain = CoordinateModel(keypoint_fn=keypoints, detector_fn=detections, device="cpu")
blocks = list(plain.stream_coordinates([frames[:2], frames[2:]], 3, prefetch=True))
assert sorted(k for b in blocks for k in b) == [0, 1, 2]
from eagle_tpu_torch.pipeline.serve import serve_clips
assert len(list(serve_clips(plain, [frames, frames[:2]], 3, overlap=True))) == 2
# multi-clip runs (the clip-batched step) and the other prescale modes
from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner
assert [len(r) for r in MultiClipRunner(plain).run([frames, frames[:2]], 3)] == [3, 2]
for extra in (dict(prescale="device"), dict(upload_format="bgr")):
    built = CoordinateModel(config=DEFAULT_CONFIG.replace(**extra), device="cpu")
    geom = built._geometry((360, 640))
    assert built.upload(rng.integers(0, 256, (2, 360, 640, 3), dtype=np.uint8), geom).shape == (2, 544, 960, 3)
# the multi-device layer on a one-rank mesh, the .msgpack writer, pitchplot
# (scipy only) and the time-sharded ball selector
import tempfile
from eagle_tpu_torch.models.checkpoint import load_params, save_params
from eagle_tpu_torch.parallel import mesh as pmesh, timeshard as pts
from eagle_tpu_torch.pipeline.processor import Processor
from eagle_tpu_torch.utils.pitchplot import voronoi_polygons
one = pmesh.make_mesh(device="cpu")
assert [len(r) for r in MultiClipRunner(plain, mesh=one).run([frames, frames[:2]], 3)] == [3, 2]
assert pts.halo_exchange_prev(torch.from_numpy(frames), one).shape == frames.shape
path = save_params({"w": np.ones(3, np.float32)}, tempfile.mkdtemp() + "/w.msgpack")
assert load_params(path)["w"].shape == (3,)
assert len(voronoi_polygons([10, 50, 90], [20, 30, 40], [0, 1, 0])[0]) == 2
balls = [[(10.0 + t, 20.0)] for t in range(12)]
proc = Processor({0: {}}, frames[:1], 3, device="cpu")
assert proc.parse_ball_detections_segmented(balls, segments=3) == proc.parse_ball_detections_with_kalman(balls)
# the eval CLI's body on the OpenCV-free synthetic scene
from eagle_tpu_torch import evaluate
from eagle_tpu_torch.utils.synthetic import make_scene
sc = make_scene(num_frames=2, width=160, height=96, num_players=3)
scored = evaluate.run(plain, sc.frames, *evaluate.synthetic_truth(sc, (96, 160)))
assert sorted(scored) == ["HRNet", "YOLO"], scored
# the checkpoint writers chip_smoke.py uses, and chip_smoke.py itself
import chip_smoke
from tests.torch_parity import hrnet_reference_state_dict, yolov8_ultralytics_state_dict
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack", "onnx", "eagle_tpu", "pandas", "cv2"))
assert not bad, bad
# no import statement of them anywhere in the package or chip_smoke.py
import ast, pathlib
for path in [*pathlib.Path("eagle_tpu_torch").rglob("*.py"), pathlib.Path("chip_smoke.py")]:
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "onnx", "eagle_tpu")]
        assert not bad, (str(path), bad)
print("hermetic")
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    r = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=240,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "hermetic" in r.stdout
