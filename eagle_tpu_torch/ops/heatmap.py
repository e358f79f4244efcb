"""Heatmap decoding for the keypoint model (PyTorch counterpart of
``eagle_tpu/ops/heatmap.py``).

Per heatmap: flat argmax (the first maximum on ties, as numpy and
``jnp.argmax`` give it), integer-truncated image coordinates
``px * img_w // (W - 1)``, the score floor and the caller's threshold,
then same-pixel dedup keeping the highest score (the larger label on equal
scores).
"""

from __future__ import annotations

import torch


def decode_heatmaps(
    heatmaps: torch.Tensor,
    conf: float,
    image_hw: tuple[int, int],
    score_floor: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode (N, K, H, W) sigmoid heatmaps (NCHW, the model's layout).

    Returns kp (N, K, 3) float32 [x, y, score] and valid (N, K) bool."""
    n, k, h, w = heatmaps.shape
    img_h, img_w = image_hw
    flat = heatmaps.reshape(n, k, h * w)
    idx = torch.argmax(flat, dim=-1)  # first maximum on ties
    score = torch.gather(flat, -1, idx[..., None])[..., 0]
    py = idx // w
    px = idx % w
    xi = (px * img_w // max(1, w - 1)).to(torch.float32)
    yi = (py * img_h // max(1, h - 1)).to(torch.float32)

    valid = (score > score_floor) & (score >= conf)

    key = yi * img_w + xi
    same = key[:, :, None] == key[:, None, :]
    s_i = score[:, :, None]
    s_j = score[:, None, :]
    lab = torch.arange(k, device=heatmaps.device)
    j_wins = (s_j > s_i) | ((s_j == s_i) & (lab[None, None, :] > lab[None, :, None]))
    beaten = (same & j_wins & valid[:, None, :]).any(dim=-1)
    valid = valid & ~beaten

    kp = torch.stack([xi, yi, score], dim=-1)
    return kp, valid
