"""Torch checkpoint -> parameter-pytree converters (counterpart of the JAX
package's ``eagle_tpu/models/convert.py`` and the ultralytics converters
of ``eagle_tpu/models/yolov8.py``).

The reference ships torch weights: ``keypoints_main.pth`` for HRNet (a
``KeypointModel`` state dict) and ``detector_*.pt`` for YOLOv8 (an
ultralytics state dict).  These functions map such a state dict onto the
parameter pytree of the JAX package's models -- nested dicts and lists of
float32 numpy arrays, conv kernels HWIO -- which
:mod:`eagle_tpu_torch.models.bridge` turns into the port's modules.  The
pytree is the same, leaf for leaf, as the JAX package's converters give,
so a checkpoint loads to the same weights in both packages.  numpy only
(plus ``torch.load`` in :func:`load_hrnet_checkpoint`); a key the model
needs and the state dict lacks raises ``KeyError`` naming it.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from eagle_tpu_torch.models.hrnet import STAGE2, STAGE3, STAGE4
from eagle_tpu_torch.models.layers import BN_EPS

Params = dict


class _Keys:
    """A state dict whose missing keys raise a ``KeyError`` that names the
    key and the layout being read."""

    def __init__(self, sd: Mapping[str, Any], layout: str):
        self.sd, self.layout = sd, layout

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def __getitem__(self, key: str):
        if key not in self.sd:
            raise KeyError(f"{self.layout} state dict has no {key!r}: not a checkpoint of this model")
        return self.sd[key]


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _conv_w(sd, name: str) -> np.ndarray:
    """OIHW torch conv weight -> HWIO."""
    return _np(sd[name]).transpose(2, 3, 1, 0)


# ---------------------------------------------------------------------------
# HRNet (the reference's KeypointModel)
# ---------------------------------------------------------------------------


def _bn(sd, prefix: str) -> dict:
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }


def _conv_bn(sd, conv: str, bn: str) -> dict:
    return {"w": _conv_w(sd, f"{conv}.weight"), "bn": _bn(sd, bn)}


def hrnet_from_torch(state_dict: Mapping[str, Any]) -> Params:
    """A reference ``KeypointModel`` state dict (the backbone under
    ``unnormalized_model.0``, the 3x3 head conv under
    ``unnormalized_model.1``) -> the HRNet-W48 parameter pytree."""
    sd = _Keys(state_dict, "HRNet KeypointModel")
    B = "unnormalized_model.0"

    params: dict = {}
    params["stem"] = {
        "conv1": _conv_bn(sd, f"{B}.conv1", f"{B}.bn1"),
        "conv2": _conv_bn(sd, f"{B}.conv2", f"{B}.bn2"),
    }
    layer1 = []
    for k in range(4):
        p = {
            "conv1": _conv_bn(sd, f"{B}.layer1.{k}.conv1", f"{B}.layer1.{k}.bn1"),
            "conv2": _conv_bn(sd, f"{B}.layer1.{k}.conv2", f"{B}.layer1.{k}.bn2"),
            "conv3": _conv_bn(sd, f"{B}.layer1.{k}.conv3", f"{B}.layer1.{k}.bn3"),
        }
        if f"{B}.layer1.{k}.downsample.0.weight" in sd:
            p["down"] = _conv_bn(sd, f"{B}.layer1.{k}.downsample.0", f"{B}.layer1.{k}.downsample.1")
        layer1.append(p)
    params["layer1"] = layer1

    params["transition1"] = [
        _conv_bn(sd, f"{B}.transition1.0.0", f"{B}.transition1.0.1"),
        [_conv_bn(sd, f"{B}.transition1.1.0.0", f"{B}.transition1.1.0.1")],
    ]
    params["transition2"] = [None, None, [_conv_bn(sd, f"{B}.transition2.2.0.0", f"{B}.transition2.2.0.1")]]
    params["transition3"] = [
        None,
        None,
        None,
        [_conv_bn(sd, f"{B}.transition3.3.0.0", f"{B}.transition3.3.0.1")],
    ]

    for stage, (num_modules, num_branches, num_blocks, _ch) in (
        ("stage2", STAGE2),
        ("stage3", STAGE3),
        ("stage4", STAGE4),
    ):
        modules = []
        for m in range(num_modules):
            S = f"{B}.{stage}.{m}"
            branches = [
                [
                    {
                        "conv1": _conv_bn(sd, f"{S}.branches.{b}.{k}.conv1", f"{S}.branches.{b}.{k}.bn1"),
                        "conv2": _conv_bn(sd, f"{S}.branches.{b}.{k}.conv2", f"{S}.branches.{b}.{k}.bn2"),
                    }
                    for k in range(num_blocks)
                ]
                for b in range(num_branches)
            ]
            multi_scale = not (stage == "stage4" and m == num_modules - 1)
            fuse = []
            for i in range(num_branches if multi_scale else 1):
                row = []
                for j in range(num_branches):
                    F = f"{S}.fuse_layers.{i}.{j}"
                    if i == j:
                        row.append(None)
                    elif j > i:
                        row.append(_conv_bn(sd, f"{F}.0", f"{F}.1"))
                    else:
                        row.append([_conv_bn(sd, f"{F}.{k}.0", f"{F}.{k}.1") for k in range(i - j)])
                fuse.append(row)
            modules.append({"branches": branches, "fuse": fuse})
        params[stage] = modules

    params["head"] = {
        "w": _conv_w(sd, "unnormalized_model.1.weight"),
        "b": _np(sd["unnormalized_model.1.bias"]),
    }
    return params


def load_hrnet_checkpoint(path: str) -> Params:
    """A ``.pth`` HRNet checkpoint (a ``KeypointModel`` state dict) ->
    the parameter pytree (``torch.load(weights_only=True)``)."""
    import torch

    return hrnet_from_torch(torch.load(path, map_location="cpu", weights_only=True))


# ---------------------------------------------------------------------------
# YOLOv8 (ultralytics)
# ---------------------------------------------------------------------------

#: pytree path -> ultralytics module index
_BACKBONE_MAP = [
    ("stem", 0), ("down2", 1), ("c2f2", 2), ("down3", 3), ("c2f3", 4),
    ("down4", 5), ("c2f4", 6), ("down5", 7), ("c2f5", 8), ("sppf", 9),
]
_NECK_MAP = [
    ("c2f_up4", 12), ("c2f_up3", 15), ("down34", 16),
    ("c2f_down4", 18), ("down45", 19), ("c2f_down5", 21),
]

#: ultralytics builds its Conv BatchNorm2d with eps=1e-3, the models here
#: fold BN with 1e-5 (:data:`BN_EPS`); the converter adds the difference to
#: the stored variance so that sqrt(var' + 1e-5) == sqrt(var + 1e-3)
_ULTRALYTICS_BN_EPS = 1e-3


def _cv(sd, prefix: str) -> Params:
    """ultralytics Conv module: ``{prefix}.conv.weight`` + ``{prefix}.bn.*``."""
    return {
        "w": _np(sd[f"{prefix}.conv.weight"]).transpose(2, 3, 1, 0),
        "bn": {
            "scale": _np(sd[f"{prefix}.bn.weight"]),
            "bias": _np(sd[f"{prefix}.bn.bias"]),
            "mean": _np(sd[f"{prefix}.bn.running_mean"]),
            "var": _np(sd[f"{prefix}.bn.running_var"]) + (_ULTRALYTICS_BN_EPS - BN_EPS),
        },
    }


def _identity_var() -> np.float32:
    """The float32 variance v with rsqrt(v + BN_EPS) == 1 exactly, so an
    identity BN around fused conv weights is a bit-exact no-op."""
    v = np.float32(1.0) - np.float32(BN_EPS)
    while np.float32(v + np.float32(BN_EPS)) < np.float32(1.0):
        v = np.nextafter(v, np.float32(2.0), dtype=np.float32)
    while np.float32(v + np.float32(BN_EPS)) > np.float32(1.0):
        v = np.nextafter(v, np.float32(0.0), dtype=np.float32)
    return v


def _cv_fused(sd, prefix: str) -> Params:
    """Fused ultralytics Conv (BN folded at export, the conv carries a
    bias): wrapped in an exactly-identity BN that holds the bias."""
    b = _np(sd[f"{prefix}.conv.bias"])
    c = b.shape[0]
    return {
        "w": _np(sd[f"{prefix}.conv.weight"]).transpose(2, 3, 1, 0),
        "bn": {
            "scale": np.ones((c,), np.float32),
            "bias": b,
            "mean": np.zeros((c,), np.float32),
            "var": np.full((c,), _identity_var(), np.float32),
        },
    }


def _yolov8(sd, prefix: str, cv) -> Params:
    """The YOLOv8 pytree from an ultralytics layout whose Conv modules
    ``cv(sd, prefix)`` converts."""

    def c2f(p):
        out = {"cv1": cv(sd, f"{p}.cv1"), "cv2": cv(sd, f"{p}.cv2"), "m": []}
        i = 0
        while f"{p}.m.{i}.cv1.conv.weight" in sd:
            out["m"].append({"cv1": cv(sd, f"{p}.m.{i}.cv1"), "cv2": cv(sd, f"{p}.m.{i}.cv2")})
            i += 1
        return out

    backbone: Params = {}
    for name, idx in _BACKBONE_MAP:
        p = f"{prefix}{idx}"
        if name.startswith("c2f"):
            backbone[name] = c2f(p)
        elif name == "sppf":
            backbone[name] = {"cv1": cv(sd, f"{p}.cv1"), "cv2": cv(sd, f"{p}.cv2")}
        else:
            backbone[name] = cv(sd, p)
    neck: Params = {}
    for name, idx in _NECK_MAP:
        p = f"{prefix}{idx}"
        neck[name] = c2f(p) if name.startswith("c2f") else cv(sd, p)

    d = f"{prefix}22"
    levels = [
        {
            "box": [cv(sd, f"{d}.cv2.{i}.0"), cv(sd, f"{d}.cv2.{i}.1")],
            "box_out": {"w": _conv_w(sd, f"{d}.cv2.{i}.2.weight"), "b": _np(sd[f"{d}.cv2.{i}.2.bias"])},
            "cls": [cv(sd, f"{d}.cv3.{i}.0"), cv(sd, f"{d}.cv3.{i}.1")],
            "cls_out": {"w": _conv_w(sd, f"{d}.cv3.{i}.2.weight"), "b": _np(sd[f"{d}.cv3.{i}.2.bias"])},
        }
        for i in range(3)
    ]
    return {"backbone": backbone, "neck": neck, "head": {"levels": levels}}


def yolov8_from_torch(state_dict: Mapping[str, Any], prefix: str = "model.") -> Params:
    """An ultralytics YOLOv8 state dict (module indices ``model.0`` ..
    ``model.22``; the detect head's ``cv2`` box and ``cv3`` class branches)
    -> the YOLOv8 parameter pytree.  The DFL projection conv is implicit in
    the decode and is not read."""
    return _yolov8(_Keys(state_dict, "ultralytics YOLOv8"), prefix, _cv)


def yolov8_from_fused(weights: Mapping[str, Any], prefix: str = "model.") -> Params:
    """A BN-fused ultralytics weight mapping (what an ONNX export holds:
    ``model.fuse()`` folds every BatchNorm into its conv) -> the YOLOv8
    parameter pytree."""
    return _yolov8(_Keys(weights, "fused ultralytics YOLOv8"), prefix, _cv_fused)
