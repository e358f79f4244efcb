"""Weight bridge: the JAX package's HRNet / YOLOv8 / OSNet parameter
pytrees (nested dicts and lists with numpy-convertible leaves, HWIO conv
kernels) -> this package's state dicts (OIHW).

The port's modules name their sub-modules after the pytree keys, so the
map is mechanical: dict keys and list indices join with ".", ``None``
entries are skipped (their ``nn.Identity`` placeholders hold no state),
and every 4-D leaf, a conv kernel, is transposed HWIO -> OIHW (a depthwise
kernel (3, 3, 1, C) becomes (C, 1, 3, 3)).  Nothing here imports the JAX
package: leaves only need ``numpy.asarray``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from eagle_tpu_torch.models.hrnet import HRNet
from eagle_tpu_torch.models import osnet
from eagle_tpu_torch.models.osnet import OSNet
from eagle_tpu_torch.models.yolov8 import VARIANTS, YOLOv8, _scaled


def flatten_params(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Pytree -> flat {dotted path: float32 tensor} in the port's layout."""
    out: dict[str, torch.Tensor] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}."))
        return out
    arr = np.asarray(tree, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    out[prefix[:-1]] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C", copy=True))
    return out


def hrnet_from_jax(params: Any, use_bf16: bool = False) -> HRNet:
    """HRNet module holding the weights of a JAX ``hrnet`` pytree."""
    sd = flatten_params(params)
    model = HRNet(num_keypoints=sd["head.b"].shape[0], use_bf16=use_bf16)
    model.load_state_dict(sd, strict=True)
    return model


def infer_yolov8_variant(params: Any) -> str:
    """The VARIANTS key whose width and depth match a JAX pytree."""
    stem_out = tuple(params["backbone"]["stem"]["w"].shape)[-1]
    depth = len(params["backbone"]["c2f2"]["m"])
    for name in VARIANTS:
        ch, n, _ = _scaled(name)
        if ch(64) == stem_out and n(3) == depth:
            return name
    raise ValueError(f"no YOLOv8 variant has stem width {stem_out} and depth {depth}")


def yolov8_from_jax(params: Any, use_bf16: bool = False) -> YOLOv8:
    """YOLOv8 module holding the weights of a JAX ``yolov8`` pytree."""
    sd = flatten_params(params)
    num_classes = sd["head.levels.0.cls_out.b"].shape[0]
    model = YOLOv8(infer_yolov8_variant(params), num_classes, use_bf16)
    model.load_state_dict(sd, strict=True)
    return model


def osnet_from_jax(params: Any, use_bf16: bool = False) -> OSNet:
    """OSNet module holding the weights of a JAX ``osnet`` pytree."""
    return osnet.from_state_dict(flatten_params(params), use_bf16)
