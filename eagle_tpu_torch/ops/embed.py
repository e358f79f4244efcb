"""The histogram appearance embedder (PyTorch counterpart of
``eagle_tpu/ops/embed.py``): an HSV colour histogram of each detection
crop, the alternative to OSNet in the tracker's appearance slot that needs
no weights."""

from __future__ import annotations

import torch

from eagle_tpu_torch.ops.color import bgr_to_hsv
from eagle_tpu_torch.ops.kmeans import gather_crops

HIST_BINS = (16, 2, 2)  # hue x saturation x value -> 64-dim


def histogram_embeddings(
    frames: torch.Tensor, frame_idx: torch.Tensor, boxes: torch.Tensor, grid_hw=(32, 16)
) -> torch.Tensor:
    """(F, H, W, 3) uint8 frames + (B,) frame indices + (B, 4) xyxy boxes
    -> (B, 64) L2-normalised HSV histograms, hard bins by broadcast
    compare."""
    crops = gather_crops(frames, frame_idx, boxes, grid_hw=grid_hw)  # (B, gh, gw, 3)
    hsv = bgr_to_hsv(crops)
    nh, ns, nv = HIST_BINS
    hbin = torch.clamp((hsv[..., 0] / 180.0 * nh).to(torch.int64), 0, nh - 1)
    sbin = torch.clamp((hsv[..., 1] / 256.0 * ns).to(torch.int64), 0, ns - 1)
    vbin = torch.clamp((hsv[..., 2] / 256.0 * nv).to(torch.int64), 0, nv - 1)
    flat_bin = (hbin * ns + sbin) * nv + vbin  # (B, gh, gw)
    eq = flat_bin[..., None] == torch.arange(nh * ns * nv, device=frames.device)
    hist = eq.sum(dim=(1, 2)).to(torch.float32)
    return hist / torch.clamp(torch.linalg.vector_norm(hist, dim=-1, keepdim=True), min=1e-9)
