"""2-D line geometry: masked median, total-least-squares line fits, line
intersections and the pitch-keypoint synthesis step (PyTorch counterpart
of ``eagle_tpu/ops/geometry.py``)."""

from __future__ import annotations

import numpy as np
import torch

from eagle_tpu_torch import pitch
from eagle_tpu_torch.utils import device_constant


def masked_median(values: torch.Tensor, valid: torch.Tensor, interpolate: bool = False) -> torch.Tensor:
    """Median of the valid entries of a 1-D tensor (0.0 when none).
    ``interpolate=False`` picks the LOWER-middle element for even counts;
    ``interpolate=True`` averages the two middle elements.  The middle
    elements are gathered on the device (indexing with a 0-d tensor would
    read the index back to the host)."""
    s, _ = torch.sort(torch.where(valid, values, torch.full_like(values, torch.inf)))
    count = valid.sum()
    lo_idx = torch.clamp(count - 1, min=0) // 2
    hi_idx = (torch.clamp(count - 1, min=0) - lo_idx) if interpolate else lo_idx
    mid = torch.stack([lo_idx, hi_idx]).clamp(max=s.shape[0] - 1)
    lo, hi = s.gather(0, mid)
    return torch.where(count > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def fit_lines(points: torch.Tensor, masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Total-least-squares lines of masked point groups (cv2.fitLine
    DIST_L2): principal axis of the covariance, anchored at the centroid.
    points (N, 2), masks (G, N) -> lines (G, 4) (vx, vy, x0, y0), valid
    (G,) (>= 2 points and non-degenerate)."""
    m = masks.to(points.dtype)
    counts = m.sum(dim=-1)
    denom = torch.clamp(counts, min=1.0)[:, None]
    centroid = (m[..., None] * points[None]).sum(dim=1) / denom
    d = (points[None] - centroid[:, None]) * m[..., None]
    cxx = (d[..., 0] * d[..., 0]).sum(dim=-1)
    cyy = (d[..., 1] * d[..., 1]).sum(dim=-1)
    cxy = (d[..., 0] * d[..., 1]).sum(dim=-1)
    theta = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
    lines = torch.stack([torch.cos(theta), torch.sin(theta), centroid[:, 0], centroid[:, 1]], dim=-1)
    line_valid = (counts >= 2) & (cxx + cyy > 1e-9)
    return lines, line_valid


def intersect_lines(l1: torch.Tensor, l2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Intersect infinite lines (vx, vy, x0, y0); broadcasts.  Returns
    (point (..., 2), valid (...,)), invalid when near-parallel."""
    vx1, vy1, x1, y1 = l1[..., 0], l1[..., 1], l1[..., 2], l1[..., 3]
    vx2, vy2, x2, y2 = l2[..., 0], l2[..., 1], l2[..., 2], l2[..., 3]
    det = vx1 * (-vy2) - vy1 * (-vx2)
    ok = torch.abs(det) >= 1e-8
    safe_det = torch.where(ok, det, torch.ones_like(det))
    t = ((x2 - x1) * (-vy2) - (y2 - y1) * (-vx2)) / safe_det
    return torch.stack([x1 + t * vx1, y1 + t * vy1], dim=-1), ok


_X_MASKS = np.array(pitch.X_LINE_MASKS)
_Y_MASKS = np.array(pitch.Y_LINE_MASKS)
_GRID_IDS = np.array(pitch.LINE_GRID_IDS)
_ON_PLANE = np.array(pitch.ON_PLANE_MASK)
# priority of each grid cell in the reference's iteration order
# (outer loop = y-line insertion order, inner = x-line insertion order)
_CELL_PRIORITY = (
    np.asarray(pitch.Y_LINE_ORDER)[None, :] * len(pitch.X_LINE_ORDER)
    + np.asarray(pitch.X_LINE_ORDER)[:, None]
).astype(np.int64)


def _synthesis_consts(dev) -> tuple[torch.Tensor, ...]:
    """(x masks, y masks, grid ids, on-plane mask, cell priorities) on
    ``dev``, uploaded once a device (:func:`device_constant`)."""
    return device_constant(("synthesis", str(torch.device(dev))), lambda: tuple(
        torch.from_numpy(a).to(dev)
        for a in (_X_MASKS, _Y_MASKS, _GRID_IDS.astype(np.int64), _ON_PLANE, _CELL_PRIORITY.reshape(-1))
    ))


def synthesize_keypoints(
    kp_xy: torch.Tensor,
    kp_valid: torch.Tensor,
    min_points_per_line: int = 2,
    max_new_points: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fill undetected landmarks at the intersections of fitted pitch lines
    (one line per shared world-X and shared world-Y family), capped at
    ``max_new_points`` in the reference's iteration order; synthesized
    points are rounded to integers.  (57, 2), (57,) -> same."""
    dev = kp_xy.device
    x_masks, y_masks, ids, on_plane, prio = _synthesis_consts(dev)
    usable = kp_valid & on_plane
    x_lines, x_ok = fit_lines(kp_xy, x_masks & usable[None, :])
    y_lines, y_ok = fit_lines(kp_xy, y_masks & usable[None, :])
    if min_points_per_line > 2:
        x_ok = x_ok & ((x_masks & usable[None, :]).sum(-1) >= min_points_per_line)
        y_ok = y_ok & ((y_masks & usable[None, :]).sum(-1) >= min_points_per_line)

    nx, ny = ids.shape
    pts, par_ok = intersect_lines(y_lines[None, :, :], x_lines[:, None, :])  # (nx, ny, 2)
    cell_ok = (ids >= 0) & x_ok[:, None] & y_ok[None, :] & par_ok & ~kp_valid[ids.clamp(min=0)]

    # cap at max_new_points in priority order: a cell is kept when fewer
    # than max_new_points ok cells precede it
    ok_flat = cell_ok.reshape(-1)
    order = torch.argsort(prio)
    rank_among_ok = torch.cumsum(ok_flat[order].to(torch.int64), 0) - 1
    keep_sorted = ok_flat[order] & (rank_among_ok < max_new_points)
    keep = torch.zeros_like(ok_flat)
    keep[order] = keep_sorted

    flat_ids = ids.reshape(-1)
    flat_pts = torch.round(pts.reshape(-1, 2))
    safe_ids = torch.where(keep, flat_ids, torch.full_like(flat_ids, 57))
    new_xy = torch.zeros(58, 2, dtype=kp_xy.dtype, device=dev)
    new_xy[safe_ids] = flat_pts.to(kp_xy.dtype)
    new_mask = torch.zeros(58, dtype=torch.bool, device=dev)
    new_mask[safe_ids] = keep
    new_xy, new_mask = new_xy[:57], new_mask[:57]
    return torch.where(new_mask[:, None], new_xy, kp_xy), kp_valid | new_mask
