"""FLOPs of the networks' forwards, 2 x the multiply-adds of every
convolution and fully connected product, counted by running the
benchmark's plain references on the ``meta`` device (shapes only) at the
input a cell's frames give."""

from __future__ import annotations

import torch

from benchmark.reference import hrnet, osnet, yolov8
from benchmark.reference.ops import FlopCounter


def _meta(layout: dict) -> dict:
    return {k: torch.empty(shape, device="meta") for k, shape in layout.items()}


def detector(cfg: dict, input_hw) -> int:
    """FLOPs of one frame through YOLOv8 ``cfg`` at ``input_hw``."""
    ops = FlopCounter()
    yolov8.YOLOv8(_meta(yolov8.layout(cfg)), cfg, ops)(torch.empty(1, 3, *input_hw, device="meta"))
    return ops.flops


def keypoints(cfg: dict, input_hw) -> int:
    """FLOPs of one frame through HRNet ``cfg`` at ``input_hw``."""
    ops = FlopCounter()
    hrnet.HRNet(_meta(hrnet.layout(cfg)), cfg, ops)(torch.empty(1, 3, *input_hw, device="meta"))
    return ops.flops


def reid(cfg: dict) -> int:
    """FLOPs of one crop through OSNet ``cfg`` at its ``input_hw``."""
    ops = FlopCounter()
    osnet.OSNet(_meta(osnet.layout(cfg)), cfg, ops)(torch.empty(1, 3, *cfg["input_hw"], device="meta"))
    return ops.flops
