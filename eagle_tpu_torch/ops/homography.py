"""Plane homography: normalised DLT, fixed-hypothesis RANSAC with MSAC
scoring and an LMedS fallback, Gauss-Newton polish, perspective
transforms (PyTorch counterpart of ``eagle_tpu/ops/homography.py``).

The minimal sets are an input: :func:`sample_minimal_sets` turns the
JAX package's Gumbel draw (reproduced on the host by
:mod:`eagle_tpu_torch.ops.prng`) into the same index sets, and unit tests
can feed both packages explicit sets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eagle_tpu_torch.ops import prng


def perspective_transform(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) homographies to points (..., N, 2), elementwise."""
    x, y = pts[..., 0], pts[..., 1]
    h = H[..., None, :, :]
    u = h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]
    v = h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]
    w = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    return torch.stack([u / w, v / w], dim=-1)


def _normalization(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalisation (..., 3, 3) for weighted points (..., N, 2)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    centroid = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((pts - centroid[..., None, :]) ** 2).sum(-1))
    mean_d = torch.clamp((d * w).sum(-1) / wsum, min=1e-9)
    s = math.sqrt(2.0) / mean_d
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    rows = [
        torch.stack([s, z, -s * centroid[..., 0]], -1),
        torch.stack([z, s, -s * centroid[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ]
    return torch.stack(rows, -2)


def dlt_homography(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted normalised DLT, batched: src/dst (..., N, 2), weights
    (..., N) -> (..., 3, 3) mapping src -> dst, scaled so H[2, 2] == 1
    where possible."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    w = weights.to(torch.float32)
    Ts = _normalization(src, w)
    Td = _normalization(dst, w)
    s = perspective_transform(Ts, src)
    d = perspective_transform(Td, dst)
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows_u = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    rows_v = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2N, 9)
    ww = torch.cat([w, w], dim=-1)
    ATA = torch.matmul((A * ww[..., None]).transpose(-1, -2), A)
    _, vecs = torch.linalg.eigh(ATA)
    Hn = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    H = torch.linalg.solve_ex(Td, torch.matmul(Hn, Ts))[0]
    h22 = H[..., 2, 2]
    scale = torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))
    return H / scale[..., None, None]


def reprojection_errors(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Forward transfer error ||dst - H src|| per point: (..., N)."""
    d = perspective_transform(H, src) - dst
    return torch.sqrt((d * d).sum(-1))


def _residual_and_jacobian(h8, src, dst, w):
    """Weighted transfer residuals (2N,) interleaved (x0, y0, x1, ...) of
    the homography [h8, 1] and their Jacobian (2N, 8)."""
    x, y = src[:, 0], src[:, 1]
    u = h8[0] * x + h8[1] * y + h8[2]
    v = h8[3] * x + h8[4] * y + h8[5]
    q = h8[6] * x + h8[7] * y + 1.0
    pu, pv = u / q, v / q
    r = torch.stack([(pu - dst[:, 0]) * w, (pv - dst[:, 1]) * w], -1).reshape(-1)
    z = torch.zeros_like(x)
    inv = w / q
    ju = torch.stack([x * inv, y * inv, inv, z, z, z, -pu * x * inv, -pu * y * inv], -1)
    jv = torch.stack([z, z, z, x * inv, y * inv, inv, -pv * x * inv, -pv * y * inv], -1)
    return r, torch.stack([ju, jv], 1).reshape(-1, 8)


def _residual(h8, src, dst, w):
    x, y = src[:, 0], src[:, 1]
    q = h8[6] * x + h8[7] * y + 1.0
    pu = (h8[0] * x + h8[1] * y + h8[2]) / q
    pv = (h8[3] * x + h8[4] * y + h8[5]) / q
    return torch.stack([(pu - dst[:, 0]) * w, (pv - dst[:, 1]) * w], -1).reshape(-1)


def _gauss_newton_refine(H, src, dst, w, steps: int) -> torch.Tensor:
    """Damped Gauss-Newton on the 8 free parameters (h22 = 1) of the
    weighted forward transfer error; only improving steps are taken."""
    h22 = H[2, 2]
    scale = torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))
    h8 = (H / scale).reshape(-1)[:8]
    eye = 1e-6 * torch.eye(8, dtype=h8.dtype, device=h8.device)
    for _ in range(steps):
        r, J = _residual_and_jacobian(h8, src, dst, w)
        delta = torch.linalg.solve_ex(J.T @ J + eye, J.T @ r)[0]
        h_new = h8 - delta
        better = torch.sum(_residual(h_new, src, dst, w) ** 2) < torch.sum(r * r)
        h8 = torch.where(better, h_new, h8)
    return torch.cat([h8, torch.ones(1, dtype=h8.dtype, device=h8.device)]).reshape(3, 3)


def ransac_gumbel(seed: int, t: int, iters: int, n: int) -> np.ndarray:
    """The reference's per-frame Gumbel draw
    ``jax.random.gumbel(fold_in(key(seed), t), (iters, n))``, on the host."""
    return prng.gumbel(prng.fold_in(prng.key(seed), t), (iters, n))


def sample_minimal_sets(gumbel: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Gumbel top-4 over the valid points: (iters, N) noise + (N,) mask ->
    (iters, 4) indices, equal scores ordered by lower index (as
    ``jax.lax.top_k``)."""
    scores = gumbel + torch.where(valid, 0.0, -torch.inf)[None, :]
    _, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return idx[:, :4]


def ransac_homography(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    sets: torch.Tensor,
    threshold: float = 5.0,
    refine_steps: int = 4,
    lmeds_fallback: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC homography over the given minimal ``sets`` (iters, 4).

    src, dst (N, 2) image / world points; valid (N,) usable
    correspondences.  Every hypothesis is scored at once (inlier count,
    ties broken by the MSAC truncated error); when fewer than 4 inliers
    remain, the least-median-of-squares hypothesis and its robust scale
    decide the inliers instead.  The chosen inliers' DLT is polished by
    Gauss-Newton.  Returns (H (3, 3), inliers (N,), ok ())."""
    n = src.shape[0]
    iters = sets.shape[0]
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    nvalid = valid.sum()

    Hs = dlt_homography(src[sets], dst[sets], torch.ones(iters, 4, dtype=src.dtype, device=src.device))
    errs = reprojection_errors(Hs, src[None].expand(iters, n, 2), dst[None].expand(iters, n, 2))
    finite = torch.isfinite(errs)
    inl = (errs < threshold) & valid[None, :] & finite
    counts = inl.sum(-1)
    trunc = torch.where(inl, errs, torch.full_like(errs, threshold)).sum(-1)
    score = counts.to(src.dtype) * 1e6 - trunc
    best = torch.argmax(score)
    best_inl = inl[best]
    ok_ransac = (nvalid >= 4) & (counts[best] >= 4)
    chosen_inl = best_inl

    if lmeds_fallback:
        sq = torch.where(valid[None, :] & finite, errs * errs, torch.full_like(errs, torch.inf))
        sq_sorted, _ = torch.sort(sq, dim=-1)
        med_idx = torch.clamp(nvalid // 2, 0, n - 1)
        med = sq_sorted[:, med_idx]
        best_lm = torch.argmin(torch.where(torch.isfinite(med), med, torch.full_like(med, torch.inf)))
        med_best = med[best_lm]
        nv = torch.clamp(nvalid.to(src.dtype), min=5.0)
        sigma = 2.5 * 1.4826 * (1.0 + 5.0 / (nv - 4.0)) * torch.sqrt(med_best)
        sigma = torch.clamp(sigma, min=1e-3)
        lm_inl = (errs[best_lm] <= sigma) & valid & finite[best_lm]
        ok_lmeds = (nvalid >= 4) & (lm_inl.sum() >= 4) & torch.isfinite(med_best)
        use_lm = ~ok_ransac & ok_lmeds
        chosen_inl = torch.where(use_lm, lm_inl, best_inl)
        ok = ok_ransac | ok_lmeds
    else:
        ok = ok_ransac

    w = chosen_inl.to(src.dtype)
    H = dlt_homography(src, dst, w)
    H = _gauss_newton_refine(H, src, dst, w, refine_steps)
    final_err = reprojection_errors(H, src, dst)
    final_inl = (final_err < threshold) & valid & torch.isfinite(final_err)
    if lmeds_fallback:
        final_inl = torch.where(ok_ransac, final_inl, chosen_inl & torch.isfinite(final_err))
    ok = ok & (final_inl.sum() >= 4) & torch.isfinite(H).all()
    H = torch.where(ok, H, torch.eye(3, dtype=src.dtype, device=src.device))
    return H, final_inl & ok, ok
