"""PyTorch port, the checkpoint loaders (``eagle_tpu_torch/models/
{convert,onnx_import,checkpoint}.py`` and ``CoordinateModel``'s
``*_checkpoint=`` keywords) against the JAX package's
(``eagle_tpu/models/{convert,yolov8,onnx_import,checkpoint}.py``) on the
same files: the reference's HRNet ``.pth``, an ultralytics YOLOv8 ``.pt``,
fused and unfused ``.onnx`` exports, and ``.msgpack`` files of HRNet,
YOLOv8 and OSNet written by the JAX package's ``save_params``.

Tolerance: none.  The loaders' pytrees are equal leaf for leaf (paths,
``None`` leaves, dtypes, shapes and bytes), and the port's modules built
from a file have state dicts bit-equal to the ones the weight bridge builds
from the JAX package's pytree of the same file.  The writers of the
reference's and ultralytics' layouts (tests/torch_parity.py) are first
proved against the JAX package's converters."""

import jax
import numpy as np
import pytest
import torch

from eagle_tpu.models import convert as jconvert
from eagle_tpu.models import hrnet as jh
from eagle_tpu.models import onnx_import as jonnx
from eagle_tpu.models import yolov8 as jy
from eagle_tpu.models.checkpoint import load_params as jload_params
from eagle_tpu.models.checkpoint import save_params
from eagle_tpu_torch.models import bridge
from eagle_tpu_torch.models import checkpoint as tcheckpoint
from eagle_tpu_torch.models import convert as tconvert
from eagle_tpu_torch.models import onnx_import as tonnx
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from .test_onnx_import import _fuse_tree, _write_onnx
from .torch_graphs import YoloV8Torch, randomize_
from .torch_parity import (
    assert_trees_bit_equal,
    hrnet_reference_state_dict,
    osnet_params,
    spread_params,
    yolov8_ultralytics_state_dict,
)

torch.set_num_threads(2)


def _no_dets(batch):
    b = len(batch)
    return np.zeros((b, 128, 4), np.float32), np.zeros((b, 128), np.float32), np.zeros((b, 128), np.int32), np.zeros((b, 128), bool)


@pytest.fixture(scope="module")
def hrnet_params():
    return spread_params(jax.eval_shape(lambda: jh.init_params(jax.random.key(0))), np.random.default_rng(0))


def _yolo_params(variant: str, seed: int = 1):
    shapes = jax.eval_shape(lambda: jy.init_params(jax.random.key(1), variant=variant, num_classes=5))
    return spread_params(shapes, np.random.default_rng(seed), gain=1.0)


def assert_modules_bit_equal(got: torch.nn.Module, want: torch.nn.Module) -> None:
    g, w = got.state_dict(), want.state_dict()
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("model", ["hrnet", "yolov8n", "yolov8m"])
def test_reference_layout_writers_invert_the_jax_converters(hrnet_params, model):
    """The test-side writers of the reference's KeypointModel layout and of
    ultralytics' layout, from a port module: the JAX package's converter of
    their output gives the module's pytree back, leaf for leaf."""
    if model == "hrnet":
        sd = hrnet_reference_state_dict(bridge.hrnet_from_jax(hrnet_params))
        assert assert_trees_bit_equal(jconvert.hrnet_from_torch(sd), hrnet_params) == 1462
    else:
        params = _yolo_params(model[-1])
        sd = yolov8_ultralytics_state_dict(bridge.yolov8_from_jax(params))
        assert "model.22.dfl.conv.weight" in sd
        assert assert_trees_bit_equal(jy.yolov8_from_torch(sd), params) > 290


def test_hrnet_pth_loads_as_the_jax_loader_does(tmp_path, hrnet_params):
    path = str(tmp_path / "keypoints_main.pth")
    torch.save(hrnet_reference_state_dict(bridge.hrnet_from_jax(hrnet_params)), path)
    want = jconvert.load_hrnet_checkpoint(path)
    assert_trees_bit_equal(tconvert.load_hrnet_checkpoint(path), want)
    model = TModel(keypoint_checkpoint=path, detector_fn=_no_dets, device="cpu")
    assert_modules_bit_equal(model.keypoint_model, bridge.hrnet_from_jax(want, use_bf16=True).eval())


def test_ultralytics_pt_loads_as_the_jax_loader_does(tmp_path):
    """An ultralytics state dict of the ultralytics graph (torch_graphs),
    BatchNorm eps 1e-3 folded into the variance by both converters."""
    path = str(tmp_path / "detector.pt")
    torch.save(randomize_(YoloV8Torch("n"), seed=3).state_dict(), path)
    want = jy.yolov8_from_torch(torch.load(path, map_location="cpu", weights_only=True))
    assert_trees_bit_equal(tconvert.yolov8_from_torch(torch.load(path, map_location="cpu", weights_only=True)), want)
    model = TModel(keypoint_fn=lambda b: None, detector_checkpoint=path, device="cpu")
    assert model.detector_model.variant == "n"
    assert_modules_bit_equal(model.detector_model, bridge.yolov8_from_jax(want, use_bf16=True).eval())


@pytest.mark.parametrize("fused", [True, False])
def test_onnx_loads_as_the_jax_loader_does(tmp_path, fused):
    """An ultralytics export (BatchNorm folded into conv biases) and an
    unfused graph (the state dict's names), written as
    tests/test_onnx_import.py writes them; the exporters' wrapper prefix is
    stripped alike."""
    path = str(tmp_path / "detector.onnx")
    if fused:
        _write_onnx(path, _fuse_tree(_yolo_params("n")))
    else:
        sd = randomize_(YoloV8Torch("n"), seed=4).state_dict()
        _write_onnx(path, {f"wrapper.{k}": v.numpy() for k, v in sd.items() if "num_batches" not in k})
    init, nodes = tonnx.parse_onnx(path)
    jinit, jnodes = jonnx.parse_onnx(path)
    assert_trees_bit_equal(init, jinit)
    assert nodes == jnodes
    want = jonnx.load_yolov8_onnx(path)
    assert_trees_bit_equal(tonnx.load_yolov8_onnx(path), want)
    model = TModel(keypoint_fn=lambda b: None, detector_checkpoint=path, device="cpu")
    assert_modules_bit_equal(model.detector_model, bridge.yolov8_from_jax(want, use_bf16=True).eval())


@pytest.mark.parametrize("model", ["hrnet", "yolov8", "osnet"])
def test_msgpack_loads_as_flax_restores(tmp_path, hrnet_params, model):
    """``save_params`` files of each model: the port's reader (no flax, no
    msgpack) gives flax's restored pytree leaf for leaf, lists as maps keyed
    "0", "1", ... and ``None`` kept, and builds the same modules."""
    import dataclasses

    from eagle_tpu_torch.config import DEFAULT_CONFIG

    params = {"hrnet": hrnet_params, "yolov8": _yolo_params("n"), "osnet": osnet_params(5, feature_dim=64)}[model]
    path = save_params(params, str(tmp_path / f"{model}.msgpack"))
    want = jload_params(path)
    got = tcheckpoint.load_params(path)
    assert_trees_bit_equal(got, want)
    if model == "hrnet":
        assert got["transition2"]["0"] is None and len(got["layer1"]) == 4
        built = TModel(keypoint_checkpoint=path, detector_fn=_no_dets, device="cpu").keypoint_model
        ref = bridge.hrnet_from_jax(want, use_bf16=True)
    elif model == "yolov8":
        built = TModel(keypoint_fn=lambda b: None, detector_checkpoint=path, device="cpu").detector_model
        ref = bridge.yolov8_from_jax(want, use_bf16=True)
    else:
        tracker = dataclasses.replace(DEFAULT_CONFIG.tracker, use_appearance=True, embed_dim=64)
        built = TModel(
            config=DEFAULT_CONFIG.replace(tracker=tracker), keypoint_fn=lambda b: None, detector_fn=_no_dets,
            reid_checkpoint=path, device="cpu",
        ).reid_model
        ref = bridge.osnet_from_jax(want, use_bf16=True)
    assert_modules_bit_equal(built, ref.eval())


def test_msgpack_reader_raises_on_what_it_does_not_know(tmp_path):
    """No quiet fallback: an extension type flax checkpoints do not use, a
    malformed chunked array (shape but no chunks), a truncated file and a
    document that is not a tree each raise, naming the problem."""
    import msgpack

    def write(name, obj=None, raw=None):
        p = tmp_path / name
        p.write_bytes(raw if raw is not None else msgpack.packb(obj, use_bin_type=True))
        return str(p)

    good = save_params({"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, str(tmp_path / "good.msgpack"))
    np.testing.assert_array_equal(tcheckpoint.load_params(good)["w"], np.arange(6, dtype=np.float32).reshape(2, 3))
    cases = [
        (write("ext.msgpack", {"w": msgpack.ExtType(2, b"\x92\x01\x02")}), "extension type 2"),
        (write("chunk.msgpack", {"w": {"__msgpack_chunked_array__": True, "shape": {}}}), "chunked"),
        (write("cut.msgpack", raw=open(good, "rb").read()[:-3]), "truncated"),
        (write("list.msgpack", [1, 2]), "not a parameter tree"),
        (write("dtype.msgpack", {"w": msgpack.ExtType(1, msgpack.packb([[2], "float99", b"12345678"]))}), "dtype"),
    ]
    for path, what in cases:
        with pytest.raises(ValueError, match=what):
            tcheckpoint.load_params(path)


def test_converters_name_a_missing_key():
    """A state dict that lacks a key the model needs raises a KeyError
    naming the key and the layout."""
    with pytest.raises(KeyError, match="unnormalized_model.0.conv1.weight"):
        tconvert.hrnet_from_torch({})
    sd = randomize_(YoloV8Torch("n"), seed=3).state_dict()
    del sd["model.9.cv2.bn.running_var"]
    with pytest.raises(KeyError, match="ultralytics YOLOv8 state dict has no 'model.9.cv2.bn.running_var'"):
        tconvert.yolov8_from_torch(sd)
