"""Colour-space ops with cv2 8-bit HSV conventions (H in [0, 180), S and
V in [0, 255]); PyTorch counterpart of ``eagle_tpu/ops/color.py``."""

from __future__ import annotations

import numpy as np
import torch

#: cv2's 8-bit HSV tables (``hsv_shift`` 12): 255 / v and 180 / (6 diff)
#: in fixed point
_HSV_SHIFT = 12
_SDIV = np.array([0] + [round((255 << _HSV_SHIFT) / i) for i in range(1, 256)], np.int64)
_HDIV = np.array([0] + [round((180 << _HSV_SHIFT) / (6 * i)) for i in range(1, 256)], np.int64)


def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8/float BGR -> float32 HSV with cv2 ranges."""
    x = bgr.to(torch.float32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    m = torch.minimum(torch.minimum(r, g), b)
    c = v - m
    one = torch.ones_like(c)
    safe_c = torch.where(c > 0, c, one)
    hr = torch.remainder((g - b) / safe_c, 6.0)
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    h6 = torch.where(v == r, hr, torch.where(v == g, hg, hb))
    h = torch.where(c > 0, h6 * 30.0, torch.zeros_like(c))
    s = torch.where(v > 0, c / torch.where(v > 0, v, one) * 255.0, torch.zeros_like(c))
    return torch.stack([h, s, v], dim=-1)


def bgr_to_hsv_u8(bgr: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 BGR -> uint8 HSV as ``cv2.cvtColor(.., COLOR_BGR2HSV)``
    computes it (its integer tables and rounding; equal on all 2^24
    colours), in numpy on the host."""
    x = np.asarray(bgr).astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hue(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR -> (...,) cv2-scale hue."""
    return bgr_to_hsv(bgr)[..., 0]


def value(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR -> (...,) float32 brightness (HSV V) = max channel."""
    x = bgr.to(torch.float32)
    return torch.maximum(torch.maximum(x[..., 0], x[..., 1]), x[..., 2])


def extract_windows(
    frame: torch.Tensor, pts_xy_int: torch.Tensor, size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size windows around integer points (x, y), start-clipped into
    the image.  (H, W[, C]) frame -- a colour frame or a 2-D map such as
    :func:`value` of one -> (windows (K, size, size[, C]), origins (K, 2)
    as (x, y)); callers mask cells against their ranges."""
    h, w = frame.shape[:2]
    half = size // 2
    x0 = torch.clamp(pts_xy_int[:, 0] - half, 0, max(0, w - size))
    y0 = torch.clamp(pts_xy_int[:, 1] - half, 0, max(0, h - size))
    ar = torch.arange(size, device=frame.device)
    rows = y0[:, None] + ar[None, :]
    cols = x0[:, None] + ar[None, :]
    wins = frame[rows[:, :, None], cols[:, None, :]]
    return wins, torch.stack([x0, y0], dim=-1)


def window_mean_hue(frame_bgr: torch.Tensor, pts: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Mean hue of the (2r+1)^2 window around each integer point, the
    window intersected with the image.  frame (H, W, 3) uint8, pts (K, 2)
    pixel coords (truncated toward zero) -> (K,) float32."""
    h, w, _ = frame_bgr.shape
    x = torch.clamp(pts[:, 0].to(torch.int64), 0, w - 1)
    y = torch.clamp(pts[:, 1].to(torch.int64), 0, h - 1)
    d = 2 * radius + 1
    wins, org = extract_windows(frame_bgr, torch.stack([x, y], -1), d)
    ar = torch.arange(d, device=frame_bgr.device)
    rows = org[:, 1][:, None] + ar[None, :]
    cols = org[:, 0][:, None] + ar[None, :]
    row_ok = (rows >= torch.clamp(y - radius, min=0)[:, None]) & (
        rows < torch.clamp(y + radius + 1, max=h)[:, None]
    )
    col_ok = (cols >= torch.clamp(x - radius, min=0)[:, None]) & (
        cols < torch.clamp(x + radius + 1, max=w)[:, None]
    )
    inb = row_ok[:, :, None] & col_ok[:, None, :]
    hues = hue(wins)
    cnt = torch.clamp(inb.sum(dim=(1, 2)), min=1)
    return torch.where(inb, hues, torch.zeros_like(hues)).sum(dim=(1, 2)) / cnt
