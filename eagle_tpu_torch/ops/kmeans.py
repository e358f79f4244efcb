"""Batched k=2 KMeans and jersey-colour votes for the team assignment
(PyTorch counterpart of ``eagle_tpu/ops/kmeans.py``).

Every player crop is resampled to one fixed grid, so all crops of a clip
cluster in one batched fixed-iteration Lloyd solve on the device, and the
HSV colour-range counts reduce in one pass.  Crops of integer boxes are
cut and resampled on the host (:func:`gather_crops_host`, cv2's bytes
without OpenCV), so only (B, gh, gw, 3) uint8 cross to the device.

The principal axis that seeds the two centroids takes a canonical sign
(its largest-magnitude component positive; see :func:`kmeans2`): LAPACK
on the CPU and cuSOLVER on the card may return either sign, which would
swap the labels, and a crop whose four corners split 2-2 between the
clusters counts its background by label.
"""

from __future__ import annotations

import numpy as np
import torch

from eagle_tpu_torch import native
from eagle_tpu_torch.ops.color import bgr_to_hsv

#: (name, lower, upper) cv2-HSV jersey colour ranges; red wraps, handled by
#: merging red2 into red after counting
COLOR_TABLE = [
    ("red", (0, 100, 100), (10, 255, 255)),
    ("red2", (160, 100, 100), (179, 255, 255)),
    ("orange", (11, 100, 100), (25, 255, 255)),
    ("yellow", (26, 100, 100), (35, 255, 255)),
    ("green", (36, 100, 100), (85, 255, 255)),
    ("cyan", (86, 100, 100), (95, 255, 255)),
    ("blue", (96, 100, 100), (125, 255, 255)),
    ("purple", (126, 100, 100), (145, 255, 255)),
    ("magenta", (146, 100, 100), (159, 255, 255)),
    ("white", (0, 0, 200), (180, 30, 255)),
    ("gray", (0, 0, 50), (180, 30, 200)),
    ("black", (0, 0, 0), (180, 255, 50)),
]
COLOR_NAMES = [c[0] for c in COLOR_TABLE]
_LOWER = np.array([c[1] for c in COLOR_TABLE], np.float32)
_UPPER = np.array([c[2] for c in COLOR_TABLE], np.float32)


def _sq_dist(pixels: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) pixels, (B, 3) centroid -> (B, N) squared distances,
    summed over the channels in a fixed order (the same bits on every
    device)."""
    d = pixels - c[:, None, :]
    d = d * d
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def kmeans2(pixels: torch.Tensor, valid: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Batched 2-means over pixel sets: pixels (B, N, 3) float32, valid
    (B, N) bool -> labels (B, N) int64.  Deterministic PCA init: the
    centroids start at mean -+ half the largest projection along the
    principal colour axis, then ``iters`` Lloyd steps.  A pixel equally
    far from both centroids takes cluster 0.

    The axis's sign is made canonical (largest-magnitude component
    positive) so that the CPU and the card label alike.  Cluster sums are
    sums of integer-valued float32 pixels, exact in any order, so after the
    initial centroids every step is the same on every device."""
    w = valid.to(pixels.dtype)[..., None]
    n = torch.clamp(w.sum(1), min=1.0)
    mean = (pixels * w).sum(1) / n  # (B, 3)
    d = (pixels - mean[:, None]) * w
    d64 = d.to(torch.float64)
    cov = torch.einsum("bnc,bnd->bcd", d64, d64).to(torch.float32) / n[..., None]
    _, vecs = torch.linalg.eigh(cov)
    axis = vecs[..., -1]  # principal eigenvector, (B, 3)
    lead = torch.gather(axis, 1, axis.abs().argmax(dim=1, keepdim=True))
    axis = torch.where(lead < 0, -axis, axis)
    proj = (d[..., 0] * axis[:, None, 0] + d[..., 1] * axis[:, None, 1]) + d[..., 2] * axis[:, None, 2]
    spread = torch.sqrt(proj * proj).amax(1, keepdim=True)
    half = axis * spread * 0.5
    c0, c1 = mean - half, mean + half

    def labels(c0, c1):
        return (_sq_dist(pixels, c1) < _sq_dist(pixels, c0)).to(torch.int64)

    for _ in range(iters):
        lab = labels(c0, c1)
        in1 = (lab == 1) & valid
        in0 = (lab == 0) & valid
        cents = []
        for m in (in0, in1):
            mf = m.to(pixels.dtype)
            num = (pixels * mf[..., None]).sum(1)
            den = torch.clamp(mf.sum(1)[:, None], min=1e-6)
            cents.append(num / den)
        c0, c1 = cents
    return labels(c0, c1)


def gather_crops(frames: torch.Tensor, frame_idx: torch.Tensor, boxes: torch.Tensor, grid_hw=(64, 32)) -> torch.Tensor:
    """Resample arbitrary boxes to a fixed grid with one bilinear gather:
    frames (F, H, W, 3) uint8, frame_idx (B,), boxes (B, 4) xyxy ->
    (B, gh, gw, 3) float32.  Samples pixel centres like slicing
    ``crop[y1:y2, x1:x2]`` then resizing (``src = (dst + 0.5) * scale -
    0.5``, clipped to [0, dim - 1.001])."""
    gh, gw = grid_hw
    _, h, w, _ = frames.shape
    dev = frames.device
    boxes = boxes.to(torch.float32)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ty = (torch.arange(gh, device=dev) + 0.5) / gh
    tx = (torch.arange(gw, device=dev) + 0.5) / gw

    def along(t, lo, hi):
        # lo + t * (hi - lo) rounded once, as the JAX package's fused
        # multiply-add rounds it (float32 products are exact in float64)
        pos = t[None, :].double() * (hi - lo)[:, None].double() + lo[:, None].double()
        return pos.to(torch.float32) - 0.5

    ys = torch.clamp(along(ty, y1, y2), 0.0, h - 1.001)
    xs = torch.clamp(along(tx, x1, x2), 0.0, w - 1.001)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    fy = (ys - y0)[:, :, None, None]
    fx = (xs - x0)[:, None, :, None]
    fi = frame_idx.to(torch.int64)[:, None, None]
    yy, xx = y0[:, :, None], x0[:, None, :]
    img = frames.to(torch.float32)
    v00 = img[fi, yy, xx]
    v01 = img[fi, yy, xx + 1]
    v10 = img[fi, yy + 1, xx]
    v11 = img[fi, yy + 1, xx + 1]
    # v00 (1-fy)(1-fx) + v01 (1-fy) fx + v10 fy (1-fx) + v11 fy fx, each
    # product rounded left to right and every sum fused with the product
    # on its left, as XLA contracts the JAX package's expression: the
    # same bits, so hard bins of the crops (the histogram embedder) agree
    out = _fma(v00 * (1 - fy), 1 - fx, v01 * (1 - fy) * fx)
    out = _fma(v10 * fy, 1 - fx, out)
    return _fma(v11 * fy, fx, out)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (float32 products are exact
    in float64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def gather_crops_host(frames, frame_idx: np.ndarray, boxes: np.ndarray, grid_hw=(64, 32)) -> np.ndarray:
    """Host twin of :func:`gather_crops`, rounded to uint8: (B, gh, gw, 3).

    Integer boxes inside the frame (the Processor's clipped bboxes) are cut
    and resized exactly as ``cv2.resize(frame[y1:y2, x1:x2], (gw, gh),
    INTER_LINEAR)`` does, by the host C++
    (:func:`eagle_tpu_torch.native.crops_linear_u8c3`); fractional boxes
    take the float gather in numpy.  ``frames`` may be a list of frames or
    an (F, H, W, 3) stack; a list is never stacked.  The size is read from
    the first frame the crops read, not frame 0: a lazy source read in
    batches of ascending frames then never steps back."""
    gh, gw = grid_hw
    frame_idx = np.asarray(frame_idx)
    h, w = np.asarray(frames[int(frame_idx.min()) if len(frame_idx) else 0]).shape[:2]
    boxes = np.asarray(boxes, np.float32)
    ib = np.rint(boxes).astype(np.int64)
    if (
        np.abs(boxes - ib).max(initial=0.0) < 1e-6
        and (ib[:, 0] >= 0).all()
        and (ib[:, 1] >= 0).all()
        and (ib[:, 2] <= w).all()
        and (ib[:, 3] <= h).all()
        and (ib[:, 2] > ib[:, 0]).all()
        and (ib[:, 3] > ib[:, 1]).all()
    ):
        return native.crops_linear_u8c3(frames, frame_idx, ib, grid_hw)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ty = (np.arange(gh, dtype=np.float32) + 0.5) / gh
    tx = (np.arange(gw, dtype=np.float32) + 0.5) / gw
    ys = y1[:, None] + ty[None, :] * (y2 - y1)[:, None] - 0.5
    xs = x1[:, None] + tx[None, :] * (x2 - x1)[:, None] - 0.5
    ys = np.clip(ys, 0.0, np.float32(h - 1.001))
    xs = np.clip(xs, 0.0, np.float32(w - 1.001))
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    fy = (ys - y0)[:, :, None, None].astype(np.float32)
    fx = (xs - x0)[:, None, :, None].astype(np.float32)
    fi = np.asarray(frame_idx, np.int64)
    out = np.empty((len(boxes), gh, gw, 3), np.uint8)
    for f in np.unique(fi):
        sel = np.flatnonzero(fi == f)
        img = np.asarray(frames[int(f)])
        yy0, xx0 = y0[sel][:, :, None], x0[sel][:, None, :]
        v00 = img[yy0, xx0].astype(np.float32)
        v01 = img[yy0, xx0 + 1].astype(np.float32)
        v10 = img[yy0 + 1, xx0].astype(np.float32)
        v11 = img[yy0 + 1, xx0 + 1].astype(np.float32)
        sfy, sfx = fy[sel], fx[sel]
        vals = v00 * (1 - sfy) * (1 - sfx) + v01 * (1 - sfy) * sfx + v10 * sfy * (1 - sfx) + v11 * sfy * sfx
        out[sel] = np.clip(np.rint(vals), 0, 255).astype(np.uint8)
    return out


def crop_color_votes(crops_bgr: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Per-crop foreground jersey-colour histogram: crops (B, gh, gw, 3)
    uint8 or float BGR -> (B, 12) int32 pixel counts per COLOR_NAMES entry
    (red2 merged into red, its slot zeroed).  KMeans(k=2) on the RGB
    pixels; the cluster holding at least 3 of the 4 corners is background,
    a 2-2 split makes cluster 0 background; foreground pixels are counted
    in each HSV range."""
    crops_bgr = crops_bgr.to(torch.float32)
    b, gh, gw, _ = crops_bgr.shape
    dev = crops_bgr.device
    rgb = crops_bgr.flip(-1).reshape(b, gh * gw, 3)
    lab2d = kmeans2(rgb, torch.ones((b, gh * gw), dtype=torch.bool, device=dev), iters=iters).reshape(b, gh, gw)
    corners = lab2d[:, 0, 0] + lab2d[:, 0, -1] + lab2d[:, -1, 0] + lab2d[:, -1, -1]
    background = (corners >= 3).to(torch.int64)
    fg = lab2d != background[:, None, None]

    hsv = bgr_to_hsv(crops_bgr)  # (B, gh, gw, 3)
    lo = torch.from_numpy(_LOWER).to(dev)
    hi = torch.from_numpy(_UPPER).to(dev)
    in_range = ((hsv[..., None, :] >= lo) & (hsv[..., None, :] <= hi)).all(-1)  # (B, gh, gw, 12)
    counts = (in_range & fg[..., None]).sum(dim=(1, 2)).to(torch.int32)
    red = counts[:, 0] + counts[:, 1]
    counts[:, 0] = red
    counts[:, 1] = 0
    return counts
