"""Seeded weights in the published layouts, made on the device.

The benchmark draws every tensor of a state dict (an ultralytics YOLOv8
``model.*`` dict, Eagle's HRNet ``KeypointModel`` dict) from ``--seed`` with
one ``torch.Generator`` on the card, in one call a kind of tensor, then
saves the dicts as the published checkpoints are saved (``torch.save`` of a
state dict, float16 as ultralytics ships its weights) so that the program
loads them through its public loaders, as it would trained weights.

The draws keep activations near unit scale through the whole depth, so
that the outputs the judge compares vary over the image instead of
saturating: convolutions are He-normal; BatchNorm's affine terms are
drawn around the identity, and its running statistics are then set from
one frame by the float32 reference (``reference.yolov8.calibrate``); the
BatchNorm that closes a residual branch or feeds a sum of branches is
scaled down (``DAMP``) so that sums of many residual blocks stay bounded;
the heads' class logits are centred at -2.
"""

from __future__ import annotations

import math
import re

import torch

#: scale of the BatchNorm weight that closes a residual branch or feeds a
#: fused sum (see the module docstring)
DAMP = 0.3
#: dtype the checkpoints are saved in
SAVE_DTYPE = torch.float16

#: BatchNorm modules (by key prefix) whose output is added to a residual
#: stream or to other branches' outputs
_DAMPED = (
    re.compile(r"\.m\.\d+\.cv2\.bn$"),  # YOLOv8 bottleneck's second conv
    re.compile(r"layer1\.\d+\.bn3$"),  # HRNet Bottleneck's last conv
    re.compile(r"branches\.\d+\.\d+\.bn2$"),  # HRNet BasicBlock's last conv
    re.compile(r"fuse_layers\.\d+\.\d+(\.\d+)?\.1$"),  # HRNet fusion terms
)


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def draw(layout: dict, seed: int, device) -> dict:
    """A state dict of ``layout`` ({key: shape}) drawn from ``seed`` on
    ``device`` in float32: each kind of tensor in one call, then split."""
    g = _gen(seed, device)
    kinds: dict[str, list[str]] = {}
    for key in layout:
        field = key.rsplit(".", 1)[1]
        kind = "conv" if field == "weight" and len(layout[key]) == 4 else field
        kinds.setdefault(kind, []).append(key)
    out = {}
    for kind, keys in kinds.items():
        sizes = [math.prod(layout[k]) for k in keys]
        if kind == "running_var":
            flat = torch.rand(sum(sizes), generator=g, device=device) + 0.5
        else:
            flat = torch.randn(sum(sizes), generator=g, device=device)
        for key, part in zip(keys, torch.split(flat, sizes)):
            out[key] = part.view(layout[key])
    for key, v in out.items():
        prefix, field = key.rsplit(".", 1)
        shape = layout[key]
        if len(shape) == 4 and field == "weight":
            v.mul_(math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))
            if _is_head(prefix):
                v.mul_(math.sqrt(0.5))
        elif field == "weight":  # BatchNorm's scale
            v.mul_(0.1).add_(DAMP if any(p.search(prefix) for p in _DAMPED) else 1.0)
        elif field in ("bias", "running_mean"):
            if _is_head(prefix):
                v.mul_(0.1).add_(-2.0 if ".cv3." in prefix else 0.0)
            else:
                v.mul_(0.1)
    return out


def _is_head(prefix: str) -> bool:
    """The output convolutions (they carry a bias, no BatchNorm)."""
    return prefix == "unnormalized_model.1" or re.search(r"\.cv[23]\.\d+\.2$", prefix) is not None


def for_saving(sd: dict, extra: dict | None = None) -> dict:
    """The state dict as a checkpoint holds it: float16 on the host, with
    BatchNorm's ``num_batches_tracked`` and ``extra`` entries."""
    out = {k: v.to(SAVE_DTYPE).cpu() for k, v in sd.items()}
    for k in sd:
        if k.endswith(".running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    out.update(extra or {})
    return out


def as_loaded(sd: dict, device) -> dict:
    """What a reader of the saved checkpoint gets, in float32 on
    ``device``: the float16 values, widened."""
    return {k: v.to(SAVE_DTYPE).to(device=device, dtype=torch.float32) for k, v in sd.items()}


def dfl_projection() -> dict:
    """The ultralytics Detect head's fixed DFL projection (bins 0..15)."""
    return {"model.22.dfl.conv.weight": torch.arange(16, dtype=SAVE_DTYPE).view(1, 16, 1, 1)}
