"""Full-frame sparse corner features for the camera-motion estimate
(PyTorch counterpart of ``eagle_tpu/ops/corners.py``).

The reference's tracker (boxmot's BoTSORT) estimates camera motion with its
sparse-optical-flow GMC: ``cv2.goodFeaturesToTrack`` corners on the
previous gray frame, tracked by pyramidal LK, then a robust partial-affine
fit.  Here, as in the JAX package:

- the Shi-Tomasi response (the smaller eigenvalue of the 3x3-summed
  structure tensor of central-difference gradients);
- one corner per cell of a fixed GRID (the cell pitch plays minDistance's
  role), valid when its response reaches ``quality_level`` times the
  frame's peak, goodFeaturesToTrack's acceptance rule;
- a 4-DOF fit (rotation, uniform scale, translation) by annealed trimming
  instead of RANSAC sampling.

Everything stays on the tensor's device: the fit's degenerate-set choice is
a ``torch.where``, never a host branch.  Ties between equal responses in a
cell resolve to the first in row-major order (``torch.argmax``, as
``jnp.argmax``), and the sums keep the JAX package's order of additions.
"""

from __future__ import annotations

import torch

from eagle_tpu_torch.ops.geometry import masked_median

#: default grid (rows, cols): 240 fixed corner slots a frame
GRID = (12, 20)


def _gray(bgr: torch.Tensor) -> torch.Tensor:
    """cv2's BGR2GRAY weights, unrounded float32 (not the flow's rounded
    ``optical_flow.bgr_to_gray``)."""
    x = bgr.to(torch.float32)
    return x[..., 0] * 0.114 + x[..., 1] * 0.587 + x[..., 2] * 0.299


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum by shifted adds, zero outside: rows first (x + up +
    down), then columns (+ left + right)."""
    z = torch.zeros_like(x[:1])
    v = x + torch.cat([z, x[:-1]], 0) + torch.cat([x[1:], z], 0)
    zc = torch.zeros_like(v[:, :1])
    return v + torch.cat([zc, v[:, :-1]], 1) + torch.cat([v[:, 1:], zc], 1)


def corner_response(gray: torch.Tensor) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue response map (H, W) of a gray frame."""
    h, w = gray.shape
    zr = torch.zeros((1, w), dtype=gray.dtype, device=gray.device)
    zc = torch.zeros((h, 1), dtype=gray.dtype, device=gray.device)
    ix = (torch.cat([gray[:, 1:], zc], 1) - torch.cat([zc, gray[:, :-1]], 1)) * 0.5
    iy = (torch.cat([gray[1:], zr], 0) - torch.cat([zr, gray[:-1]], 0)) * 0.5
    sxx = _box3(ix * ix)
    syy = _box3(iy * iy)
    sxy = _box3(ix * iy)
    tr = sxx + syy
    det_gap = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy * sxy, min=0.0))
    return 0.5 * (tr - det_gap)


def grid_corners(
    bgr: torch.Tensor,
    grid: tuple[int, int] = GRID,
    quality_level: float = 0.01,
    margin: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The best corner of each grid cell of a (H, W, 3) uint8 BGR frame:
    ``(pts (K, 2) float32 x, y, valid (K,) bool)``, ``K = grid[0] *
    grid[1]`` fixed slots.  ``margin`` masks a border band (LK needs its
    window and pyramid halo inside the frame); a slot is valid when its
    cell's peak response reaches ``quality_level`` times the frame's."""
    h, w, _ = bgr.shape
    gr, gc = grid
    dev = bgr.device
    resp = corner_response(_gray(bgr))
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    inb = (
        (ys[:, None] >= margin)
        & (ys[:, None] < h - margin)
        & (xs[None, :] >= margin)
        & (xs[None, :] < w - margin)
    )
    resp = torch.where(inb, resp, torch.full_like(resp, -1.0))

    # trailing pixels beyond gr*ch / gc*cw lie in the masked margin
    ch, cw = h // gr, w // gc
    cells = resp[: gr * ch, : gc * cw].reshape(gr, ch, gc, cw).permute(0, 2, 1, 3)
    flat = cells.reshape(gr * gc, ch * cw)
    idx = torch.argmax(flat, dim=-1)
    best = flat.amax(dim=-1)
    slot = torch.arange(gr * gc, device=dev)
    x = (slot % gc) * cw + idx % cw
    y = (slot // gc) * ch + idx // cw
    pts = torch.stack([x.to(torch.float32), y.to(torch.float32)], -1)
    valid = best >= quality_level * torch.clamp(resp.max(), min=1e-12)
    return pts, valid


def fit_similarity_robust(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 3,
    inlier_px: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Robust 4-DOF partial-affine from masked correspondences (the role of
    boxmot's ``cv2.estimateAffinePartial2D(..., RANSAC, 3.0)``): a
    least-squares fit, then ``rounds`` times drop the residuals above
    ``max(inlier_px, 2.5 x median residual)`` and refit while at least 4
    survive.  Returns ``(warp (2, 3) float32, n_inliers ())``, the final
    residuals within ``inlier_px``; ``x' = a x - b y + tx``, ``y' = b x + a
    y + ty``."""

    def fit(m):
        cnt = torch.clamp(m.sum(), min=1.0)
        mx = (src * m[:, None]).sum(0) / cnt
        md = (dst * m[:, None]).sum(0) / cnt
        s = (src - mx) * m[:, None]
        d = (dst - md) * m[:, None]
        denom = torch.clamp((s * s).sum(), min=1e-9)
        a = (s * d).sum() / denom
        b = (s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0]).sum() / denom
        R = torch.stack([torch.stack([a, -b]), torch.stack([b, a])])
        t = md - R @ mx
        return torch.cat([R, t[:, None]], 1)

    def residuals(warp):
        d = src @ warp[:, :2].T + warp[:, 2] - dst
        return torch.sqrt((d * d).sum(-1))

    warp = fit(valid.to(torch.float32))
    for _ in range(rounds):
        r = residuals(warp)
        med = masked_median(r, valid, interpolate=True)
        keep = valid & (r <= torch.clamp(2.5 * med, min=inlier_px))
        m = keep.to(torch.float32)
        warp = torch.where(m.sum() >= 4, fit(m), warp)
    n_inl = (valid & (residuals(warp) <= inlier_px)).sum()
    return warp, n_inl
