"""Kalman filters (counterpart of ``eagle_tpu/ops/kalman.py``):

1. a batched 8-state constant-velocity filter on (x, y, w, h) boxes with
   size-scaled noise (the ByteTrack / BoT-SORT formulation) in torch;
   every function takes a leading track axis;
2. :class:`CvKalman2D`, the ball selector's sequential 4-state filter,
   float32 numpy on the host: a faithful emulation of
   ``cv2.KalmanFilter(4, 2)`` with its pre/post state semantics.
"""

from __future__ import annotations

import numpy as np
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


class CvKalman2D:
    """Exact numpy emulation of cv2.KalmanFilter(4, 2) as the ball selector
    configures it: F couples position and velocity with dt = 1, Q = 1e-5 I,
    R = 1e-1 I, errorCovPost = I, statePre set directly.  cv2 zero-
    initialises errorCovPre, so a correct() before any predict() leaves the
    state unchanged, as in the reference."""

    def __init__(self, initial_state, initial_velocity):
        self.F = np.array([[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        self.H = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
        self.Q = np.eye(4, dtype=np.float32) * 1e-5
        self.R = np.eye(2, dtype=np.float32) * 1e-1
        self.state_pre = np.array(
            [initial_state[0], initial_state[1], initial_velocity[0], initial_velocity[1]],
            np.float32,
        ).reshape(4, 1)
        self.state_post = np.zeros((4, 1), np.float32)
        self.p_pre = np.zeros((4, 4), np.float32)
        self.p_post = np.eye(4, dtype=np.float32)

    def predict(self) -> np.ndarray:
        self.state_pre = self.F @ self.state_post
        self.p_pre = self.F @ self.p_post @ self.F.T + self.Q
        # cv2 copies pre -> post so chained predicts keep advancing
        self.state_post = self.state_pre.copy()
        self.p_post = self.p_pre.copy()
        return self.state_pre

    def correct(self, measurement: np.ndarray) -> np.ndarray:
        z = np.asarray(measurement, np.float32).reshape(2, 1)
        s = self.H @ self.p_pre @ self.H.T + self.R
        k = self.p_pre @ self.H.T @ np.linalg.inv(s)
        self.state_post = self.state_pre + k @ (z - self.H @ self.state_pre)
        self.p_post = self.p_pre - k @ self.H @ self.p_pre
        return self.state_post
