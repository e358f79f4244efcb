"""The least work of one launch of the hand-written Lucas-Kanade flow kernel
(``csrc/lk_flow.cu``), from its shapes and points alone.

A frozen copy of ``chip_smoke.py``'s ``lk_flow_work`` and of the ROI
placement it needs (``ops/optical_flow.py``'s ``roi_origins``,
``level_sizes`` and ``roi_side``).  The copy counts no Newton step (the
original counts the live ones from the plain version's record, which a
trace does not hold), so its instructions are a lower bound and the
roofline share it gives cannot pass the kernel's true share.

Bytes: the BGR bytes of the union of the points' ROIs in each frame, each
read once, plus the points and their flags read and the outputs written.
Instructions (a multiply, an add or a fused multiply-add each): the gray
of that union in both frames (4 a pixel), each point's pyramid (8 an
output pixel of each axis pass, both frames), and per level the previous
patch (~20 a tap), Scharr gradients (~24 a tap) and the structure tensor
(6 a tap).
"""

from __future__ import annotations

import numpy as np

from benchmark.work import peaks

#: per-point ROI side at full resolution, and the pyramid's levels and window
ROI_SIDE, LEVELS, WINDOW = 192, 2, 15


def roi_side(h: int, w: int) -> int:
    return min(ROI_SIDE, h - h % 4, w - w % 4)


def level_sizes(side: int, levels: int) -> list[int]:
    sizes = [side]
    for _ in range(levels):
        sizes.append((sizes[-1] + 1) // 2)
    return sizes


def roi_origins(pts: np.ndarray, h: int, w: int, side: int, levels: int) -> np.ndarray:
    """(K, 2) ROI origins (x, y): centred on the point, clipped inside the
    frame, aligned down to a multiple of 2**levels."""
    factor = 2**levels
    fl = np.floor(pts).astype(np.int64)

    def align(v, limit):
        return (np.clip(v - side // 2, 0, max(0, limit - side)) // factor) * factor

    return np.stack([align(fl[:, 0], w), align(fl[:, 1], h)], -1)


def work(pts: np.ndarray, hw) -> tuple[int, int]:
    """(bytes, instructions) of one flow step of the points ``pts`` (K, 2)
    in frame pixels on frames of ``hw``, with no Newton step counted."""
    h, w = hw
    side = roi_side(h, w)
    origin = roi_origins(pts, h, w, side, LEVELS)
    k = len(origin)
    union = np.zeros((h, w), bool)
    for x0, y0 in origin.tolist():
        union[y0 : y0 + side, x0 : x0 + side] = True
    n_union = int(union.sum())
    nbytes = 2 * 3 * n_union + k * (8 + 1) + k * (8 + 1)
    sizes = level_sizes(side, LEVELS)
    pyr_ops = sum(8 * (s * sd + sd * sd) for s, sd in zip(sizes, sizes[1:]))
    ext = WINDOW + 2
    setup = ext * ext * 20 + WINDOW * WINDOW * (24 + 6)
    ops = 2 * 4 * n_union + k * (2 * pyr_ops + len(sizes) * setup)
    return nbytes, ops


def least_seconds(pts: np.ndarray, hw) -> float:
    """The least time of one launch at the published peaks: the larger of
    its bytes over HBM bandwidth and its instructions over the float32
    instruction rate."""
    nbytes, ops = work(pts, hw)
    return max(nbytes / peaks.HBM_BYTES, ops / peaks.F32_INSTR)
