"""Batched 8-state constant-velocity Kalman filter on (x, y, w, h) boxes
with size-scaled noise (the ByteTrack / BoT-SORT formulation); PyTorch
counterpart of the batched filter in ``eagle_tpu/ops/kalman.py``.  Every
function takes a leading track axis."""

from __future__ import annotations

import torch

STD_POS = 1.0 / 20.0
STD_VEL = 1.0 / 160.0


def _F(ref: torch.Tensor) -> torch.Tensor:
    """Constant-velocity transition: position += velocity."""
    ones = torch.ones(4, dtype=ref.dtype, device=ref.device)
    return torch.eye(8, dtype=ref.dtype, device=ref.device) + torch.diag(ones, diagonal=4)


def _H(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, 8, dtype=ref.dtype, device=ref.device)


def kf_initiate(xywh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """New-track states from measurements: (T, 4) -> ((T, 8), (T, 8, 8))."""
    mean = torch.cat([xywh, torch.zeros_like(xywh)], dim=-1)
    w, h = xywh[:, 2], xywh[:, 3]
    std = torch.stack(
        [
            2 * STD_POS * w, 2 * STD_POS * h, 2 * STD_POS * w, 2 * STD_POS * h,
            10 * STD_VEL * w, 10 * STD_VEL * h, 10 * STD_VEL * w, 10 * STD_VEL * h,
        ],
        dim=-1,
    )
    return mean, torch.diag_embed(std * std)


def kf_predict(mean: torch.Tensor, cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Time update with size-scaled process noise: (T, 8), (T, 8, 8)."""
    w, h = mean[:, 2], mean[:, 3]
    std = torch.stack(
        [
            STD_POS * w, STD_POS * h, STD_POS * w, STD_POS * h,
            STD_VEL * w, STD_VEL * h, STD_VEL * w, STD_VEL * h,
        ],
        dim=-1,
    )
    F = _F(mean)
    mean = mean @ F.T
    cov = F @ cov @ F.T + torch.diag_embed(std * std)
    return mean, cov


def kf_update(
    mean: torch.Tensor, cov: torch.Tensor, z: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Measurement update with size-scaled observation noise: (T, 8),
    (T, 8, 8), (T, 4)."""
    w, h = mean[:, 2], mean[:, 3]
    std = torch.stack([STD_POS * w, STD_POS * h, STD_POS * w, STD_POS * h], dim=-1)
    H = _H(mean)
    s = H @ cov @ H.T + torch.diag_embed(std * std)
    k = torch.linalg.solve_ex(s, H @ cov)[0].transpose(-1, -2)  # (T, 8, 4) Kalman gain
    innov = z - mean @ H.T
    mean = mean + (k @ innov[..., None])[..., 0]
    cov = cov - k @ H @ cov
    return mean, cov


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner boxes -> centre/size."""
    return torch.cat([(b[..., 2:] + b[..., :2]) * 0.5, b[..., 2:] - b[..., :2]], dim=-1)


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    half = b[..., 2:] * 0.5
    return torch.cat([b[..., :2] - half, b[..., :2] + half], dim=-1)
