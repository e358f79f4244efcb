"""The sequential per-frame step of the pipeline (PyTorch counterpart of
``eagle_tpu/pipeline/temporal.py``).

The JAX package runs this step under ``lax.scan``; here it is a Python
function called once per frame in a loop.  The carry holds the
genuinely sequential state -- keypoints, homography, the retry flag and
the tracker.  Per frame, in order:

  1. LK optical-flow propagation of the previous keypoints (the flow
     kernel) with the movement z-score and hue-change filters;
  2. the keypoint cadence / merge rules on fixed 57-slot tensors;
  3. geometric keypoint synthesis, then the brightness-snap calibration
     when ``PipelineConfig.calibration`` is on;
  4. RANSAC homography at the configured cadence, with retry on failure
     and inlier filtering -- ``lax.cond`` becomes a Python ``if`` on a
     host bool, one device sync per frame;
  5. a BoT-SORT step on the frame's detections (with their appearance
     embeddings when ``TrackerConfig.use_appearance``), after the camera-
     motion warp: fitted to the keypoint flow, or with ``gmc="features"``
     to grid corners of the previous frame tracked by the same flow kernel
     (:func:`_features_gmc_warp`).

:func:`temporal_step_clips` is one step of C clips at once (the JAX
package's clip-batched step): the flow of all clips is one launch of the
kernel (the features GMC's corners another), RANSAC is gated once on any
clip's need, and the rest runs clip by clip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eagle_tpu_torch import pitch
from eagle_tpu_torch.config import PipelineConfig
from eagle_tpu_torch.ops import color
from eagle_tpu_torch.ops.corners import fit_similarity_robust, grid_corners
from eagle_tpu_torch.ops.geometry import masked_median, synthesize_keypoints
from eagle_tpu_torch.ops.homography import ransac_homography, sample_minimal_sets
from eagle_tpu_torch.ops.optical_flow import lk_flow, lk_flow_clips
from eagle_tpu_torch.track import botsort

FLOW_BACKENDS = ("xla", "pallas2")

_ON_PLANE = np.array(pitch.ON_PLANE_MASK)
_WORLD_XY = pitch.WORLD_XY.astype(np.float32)


class TemporalCarry(NamedTuple):
    kp_xy: torch.Tensor  # (57, 2) previous keypoints (integer-valued floats)
    kp_valid: torch.Tensor  # (57,)
    H: torch.Tensor  # (3, 3) image -> pitch homography
    H_ok: torch.Tensor  # () any homography ever computed
    retry_h: torch.Tensor  # () recompute at the next frame
    tracker: botsort.TrackerState


class FrameInputs(NamedTuple):
    frame_bgr: torch.Tensor  # (H, W, 3) uint8
    prev_frame_bgr: torch.Tensor  # (H, W, 3) uint8 previous frame
    model_kp: torch.Tensor  # (57, 3) memoized keypoint-model output
    model_kp_valid: torch.Tensor  # (57,)
    is_kp_frame: bool  # t % keypoint_interval == 0
    is_h_frame: bool  # t % homography_interval == 0
    det_boxes: torch.Tensor  # (D, 4) xyxy
    det_conf: torch.Tensor  # (D,)
    det_cls: torch.Tensor  # (D,)
    det_valid: torch.Tensor  # (D,)
    t: int  # frame index
    #: (D, E) appearance embeddings; None when appearance is off
    det_embed: torch.Tensor | None = None


class FrameOutputs(NamedTuple):
    kp_xy: torch.Tensor  # (57, 2)
    kp_valid: torch.Tensor  # (57,)
    #: non-cadence frame whose flow collapsed below 4 points with no
    #: memoized model output: the caller runs the keypoint model on demand
    need_kp: torch.Tensor
    H: torch.Tensor  # (3, 3)
    H_ok: torch.Tensor  # ()
    track_boxes: torch.Tensor  # (T, 4)
    track_id: torch.Tensor  # (T,)
    track_conf: torch.Tensor  # (T,)
    track_cls: torch.Tensor  # (T,)
    track_valid: torch.Tensor  # (T,)


def check_config(cfg: PipelineConfig) -> None:
    """Raise on settings this port does not run (yet)."""
    if cfg.flow.backend not in FLOW_BACKENDS:
        raise ValueError(
            f"unknown flow backend {cfg.flow.backend!r}; valid: 'xla', 'pallas2' (synonyms: "
            "the flow step runs the CUDA kernel on the card, its plain version on the CPU)"
        )


def init_carry(cfg: PipelineConfig, device) -> TemporalCarry:
    return TemporalCarry(
        kp_xy=torch.zeros(57, 2, device=device),
        kp_valid=torch.zeros(57, dtype=torch.bool, device=device),
        H=torch.eye(3, device=device),
        H_ok=torch.zeros((), dtype=torch.bool, device=device),
        retry_h=torch.zeros((), dtype=torch.bool, device=device),
        tracker=botsort.init_state(
            cfg.tracker.max_tracks, cfg.tracker.embed_dim if cfg.tracker.use_appearance else 1, device
        ),
    )


def estimate_gmc_warp(
    prev_xy: torch.Tensor, new_xy: torch.Tensor, valid: torch.Tensor, affine: bool = True
) -> torch.Tensor:
    """Camera-motion warp (2, 3) from tracked keypoint correspondences:
    the least-squares affine on the valid pairs (centred normal
    equations), or the median translation below 3 pairs (always, with
    ``affine=False``)."""
    dev = prev_xy.device
    tx = masked_median(new_xy[:, 0] - prev_xy[:, 0], valid)
    ty = masked_median(new_xy[:, 1] - prev_xy[:, 1], valid)
    trans = torch.eye(2, 3, device=dev)
    trans[:, 2] = torch.stack([tx, ty])
    if not affine:
        return trans
    m = valid.to(torch.float32)
    cnt = m.sum()
    mu = (prev_xy * m[:, None]).sum(0) / torch.clamp(cnt, min=1.0)
    a = (prev_xy - mu) * m[:, None]
    b = (new_xy - mu) * m[:, None]
    A = torch.cat([a, m[:, None]], dim=-1)  # (K, 3), masked rows = 0
    M = A.T @ A + 1e-4 * torch.eye(3, device=dev)
    sol = torch.linalg.solve_ex(M, A.T @ b)[0]  # (3, 2): [R^T; t'^T]
    R = sol[:2].T
    t = sol[2] + mu - R @ mu
    aff = torch.cat([R, t[:, None]], dim=1)
    return torch.where(cnt >= 3, aff, trans)


class _WorkMap(NamedTuple):
    """Original pixels <-> the frames' pixels (the canvas with a working
    geometry, identity otherwise) in the JAX package's compiled float32
    arithmetic: XLA fuses ``x * gain + pad`` into one multiply-add and
    turns the division by the constant gain into a multiplication by its
    float32 reciprocal."""

    scale: torch.Tensor  # () float32 gain
    inv: torch.Tensor  # () float32 1 / gain, rounded once
    pad: torch.Tensor  # (2,) float32 pad_x, pad_y

    def to_frame(self, xy: torch.Tensor) -> torch.Tensor:
        # the float64 product of two float32 values and the sum with an
        # integer pad are exact, so one rounding gives the fused result
        return (xy.to(torch.float64) * self.scale.to(torch.float64) + self.pad.to(torch.float64)).to(torch.float32)

    def to_orig(self, xy: torch.Tensor) -> torch.Tensor:
        return (xy - self.pad) * self.inv


def _to_work(cfg: PipelineConfig, dev) -> _WorkMap:
    g = cfg.work
    gain = np.float32(g.gain if g.enabled else 1.0)
    return _WorkMap(
        torch.tensor(gain, device=dev),
        torch.tensor(np.float32(1.0) / gain, device=dev),
        torch.tensor([g.pad_x, g.pad_y] if g.enabled else [0.0, 0.0], dtype=torch.float32, device=dev),
    )


def _flow_args(cfg: PipelineConfig) -> dict:
    f = cfg.flow
    return dict(window=f.window, levels=f.pyramid_levels, iterations=f.iterations, epsilon=f.epsilon)


def flow_with_filters(
    frame_bgr: torch.Tensor,
    prev_frame_bgr: torch.Tensor,
    kp_xy: torch.Tensor,
    kp_valid: torch.Tensor,
    cfg: PipelineConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optical-flow keypoint propagation with the reference's filters
    (movement z-score > 2 and 3x3 mean hue change > 25 rejected).  Returns
    integer-truncated points + mask, in ORIGINAL image coordinates; with a
    working geometry the frames are canvases and points are mapped through
    the letterbox for sampling only."""
    if cfg.flow.backend not in FLOW_BACKENDS:
        check_config(cfg)
    wmap = _to_work(cfg, kp_xy.device)
    new_w, status = lk_flow(prev_frame_bgr, frame_bgr, wmap.to_frame(kp_xy), kp_valid, **_flow_args(cfg))
    return _flow_filters(frame_bgr, kp_xy, new_w, status, cfg, wmap)


def _flow_filters(frame_bgr, kp_xy, new_w, status, cfg: PipelineConfig, wmap: _WorkMap) -> tuple[torch.Tensor, torch.Tensor]:
    """The filters of :func:`flow_with_filters` on the flow step's result
    (``new_w`` in the frame's pixels)."""
    g = cfg.work
    new_pts = wmap.to_orig(new_w)
    if g.enabled:
        status = (
            status
            & (new_pts[:, 0] >= 0)
            & (new_pts[:, 0] <= g.orig_w - 1)
            & (new_pts[:, 1] >= 0)
            & (new_pts[:, 1] <= g.orig_h - 1)
        )
    d = new_pts - kp_xy
    moves = torch.sqrt((d * d).sum(-1))
    n = torch.clamp(status.sum(), min=1)
    zero = torch.zeros_like(moves)
    mean = torch.where(status, moves, zero).sum() / n
    var = torch.where(status, (moves - mean) ** 2, zero).sum() / n
    std = torch.sqrt(var) + 1e-6
    z_ok = (moves - mean) / std <= cfg.flow.zscore_max

    new_int = torch.trunc(new_pts)
    k = kp_xy.shape[0]
    hue_both = color.window_mean_hue(
        frame_bgr, torch.cat([wmap.to_frame(kp_xy), wmap.to_frame(new_int)], dim=0)
    )
    hue_ok = torch.abs(hue_both[k:] - hue_both[:k]) <= cfg.flow.hue_delta_max
    return new_int, status & z_ok & hue_ok


def calibrate_keypoints(
    frame_bgr: torch.Tensor,
    kp_xy: torch.Tensor,
    kp_valid: torch.Tensor,
    offset: int = 3,
    threshold: float = 150.0,
) -> torch.Tensor:
    """Brightness-snap calibration: a valid in-frame keypoint whose own
    brightness (HSV V) is below ``threshold`` moves to the brightest pixel
    of the [x-3, x+3) x [y-3, y+3) window clipped to the frame (first one
    in row-major order on ties).  Points are truncated toward zero; the
    others come back truncated and unclipped."""
    h, w, _ = frame_bgr.shape
    d = 2 * offset
    x = kp_xy[:, 0].to(torch.int64)
    y = kp_xy[:, 1].to(torch.int64)
    in_bounds = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xs = torch.clamp(x, 0, w - 1)
    ys = torch.clamp(y, 0, h - 1)

    v, org = color.extract_windows(color.value(frame_bgr), torch.stack([xs, ys], -1), d)
    ar = torch.arange(d, device=frame_bgr.device)
    rows = org[:, 1][:, None] + ar[None, :]  # absolute ys
    cols = org[:, 0][:, None] + ar[None, :]
    x_min = torch.clamp(xs - offset, min=0)
    y_min = torch.clamp(ys - offset, min=0)
    row_ok = (rows >= y_min[:, None]) & (rows < torch.clamp(ys + offset, max=h)[:, None])
    col_ok = (cols >= x_min[:, None]) & (cols < torch.clamp(xs + offset, max=w)[:, None])
    cell_ok = row_ok[:, :, None] & col_ok[:, None, :]
    # the point's own brightness, read out of the same window
    at_pt = (rows == ys[:, None])[:, :, None] & (cols == xs[:, None])[:, None, :]
    base_v = torch.where(at_pt, v, torch.zeros_like(v)).sum(dim=(1, 2))

    masked = torch.where(cell_ok, v, torch.full_like(v, -1.0)).reshape(v.shape[0], -1)
    best = torch.argmax(masked, dim=-1)
    by_abs = torch.gather(rows, 1, (best // d)[:, None])[:, 0]
    bx_abs = torch.gather(cols, 1, (best % d)[:, None])[:, 0]
    # the reference's index math: clip(x + index in the clipped window - 3)
    adj_x = torch.clamp(xs + (bx_abs - x_min) - offset, 0, w - 1)
    adj_y = torch.clamp(ys + (by_abs - y_min) - offset, 0, h - 1)

    snap = kp_valid & in_bounds & (base_v < threshold)
    out_x = torch.where(snap, adj_x, x)
    out_y = torch.where(snap, adj_y, y)
    return torch.stack([out_x, out_y], dim=-1).to(kp_xy.dtype)


def _calibrate(frame_bgr, kp_xy, kp_valid, cfg: PipelineConfig) -> torch.Tensor:
    """Calibration in the frame's pixels.  With a working geometry the snap
    runs on the canvas (+-3 canvas px) and only the moved points map back,
    truncated; untouched points keep their exact coordinates."""
    g = cfg.work
    if not g.enabled:
        return calibrate_keypoints(frame_bgr, kp_xy, kp_valid)
    wmap = _to_work(cfg, kp_xy.device)
    kpw = torch.trunc(wmap.to_frame(kp_xy))
    snapped = calibrate_keypoints(frame_bgr, kpw, kp_valid)
    moved = (snapped != kpw).any(dim=-1, keepdim=True)
    return torch.where(moved, torch.trunc(wmap.to_orig(snapped)), kp_xy)


def _pre_homography(carry: TemporalCarry, xs: FrameInputs, cfg: PipelineConfig, flow=None):
    """Flow + cadence merge + synthesis + calibration.  Returns (flow_xy,
    flow_valid, kp_xy, kp_valid, need_kp, corr_valid, do_h) with do_h a
    0-d bool tensor.  ``flow``: the filtered flow, when the caller ran it
    (the clip-batched step)."""
    t0 = xs.t > 0
    if flow is None:
        flow = flow_with_filters(xs.frame_bgr, xs.prev_frame_bgr, carry.kp_xy, carry.kp_valid & t0, cfg)
    flow_xy, flow_valid = flow

    model_valid = xs.model_kp_valid
    model_xy = xs.model_kp[:, :2]
    model_count = model_valid.sum()
    # flow participates on non-model frames, or when the model found < 4
    use_flow = (model_count < 4) | (not xs.is_kp_frame) if t0 else torch.zeros((), dtype=torch.bool, device=model_xy.device)
    kp_valid = (flow_valid & use_flow) | model_valid
    kp_xy = torch.where(model_valid[:, None], model_xy, flow_xy)
    # reference on-demand detection trigger
    need_kp = (model_count == 0) & (flow_valid.sum() < 4) & (t0 and not xs.is_kp_frame)

    if cfg.synthesis.enabled:
        syn_xy, syn_valid = synthesize_keypoints(
            kp_xy,
            kp_valid,
            min_points_per_line=cfg.synthesis.min_points_per_line,
            max_new_points=cfg.synthesis.max_new_points,
        )
        do_syn = kp_valid.sum() >= cfg.synthesis.min_keypoints
        kp_xy = torch.where(do_syn, syn_xy, kp_xy)
        kp_valid = torch.where(do_syn, syn_valid, kp_valid)

    if cfg.calibration:
        kp_xy = _calibrate(xs.frame_bgr, kp_xy, kp_valid, cfg)

    corr_valid = kp_valid & torch.from_numpy(_ON_PLANE).to(kp_valid.device)
    do_h = (xs.is_h_frame | carry.retry_h) & (corr_valid.sum() >= cfg.homography.min_points)
    return flow_xy, flow_valid, kp_xy, kp_valid, need_kp, corr_valid, do_h


def _run_ransac(kp_xy, corr_valid, gumbel: torch.Tensor, cfg: PipelineConfig):
    sets = sample_minimal_sets(gumbel, corr_valid)
    return ransac_homography(
        kp_xy.to(torch.float32),
        torch.from_numpy(_WORLD_XY).to(kp_xy.device),
        corr_valid,
        sets,
        threshold=cfg.homography.reproj_threshold,
        refine_steps=cfg.homography.refine_steps,
        lmeds_fallback=cfg.homography.lmeds_fallback,
    )


def temporal_step(
    carry: TemporalCarry,
    xs: FrameInputs,
    cfg: PipelineConfig,
    gumbel_fn,
) -> tuple[TemporalCarry, FrameOutputs]:
    """One frame.  ``gumbel_fn(t)`` returns the frame's (iters, 57) RANSAC
    Gumbel noise as a tensor on the device (drawn only on frames that
    solve a homography)."""
    flow_xy, flow_valid, kp_xy, kp_valid, need_kp, corr_valid, do_h = _pre_homography(
        carry, xs, cfg
    )
    if bool(do_h):
        H_new, inliers, h_success = _run_ransac(kp_xy, corr_valid, gumbel_fn(xs.t), cfg)
    else:
        H_new, inliers = carry.H, kp_valid
        h_success = torch.zeros((), dtype=torch.bool, device=kp_xy.device)
    return _post_homography(
        carry, xs, cfg, flow_xy, flow_valid, kp_xy, kp_valid, need_kp, H_new, inliers, h_success
    )


def _grid_corner_flow(prev_bgr, curr_bgr, cfg: PipelineConfig):
    """The features GMC's corners: (pts, pvalid) of the previous frame
    (:func:`grid_corners`) and their flow to the current frame (new_pts,
    status), one launch of the flow kernel on the card at K = 240."""
    pts, pvalid = grid_corners(prev_bgr)
    return (pts, pvalid, *lk_flow(prev_bgr, curr_bgr, pts, pvalid, **_flow_args(cfg)))


def _features_gmc_warp(carry, xs: FrameInputs, cfg: PipelineConfig, flow_xy, flow_valid, corners=None) -> torch.Tensor:
    """Full-frame sparse-feature GMC (``TrackerConfig.gmc="features"``,
    boxmot's sparse-optical-flow GMC): the grid corners of the previous
    frame, tracked to the current frame by the flow step (the CUDA kernel
    on the card, at K = 240; ``corners`` is that result when the caller ran
    it, :func:`_grid_corner_flow`), and the robust 4-DOF fit.  Below
    ``gmc_min_features`` inliers the keypoint-flow affine takes its place
    (a ``torch.where``: no host sync).

    With a working geometry the frames are canvases: the fit runs in canvas
    pixels and maps back to original ones (``x_c = g x_o + p``: ``R_o =
    R_c``, ``t_o = (R_c p + t_c - p) / g``)."""
    if corners is None:
        corners = _grid_corner_flow(xs.prev_frame_bgr, xs.frame_bgr, cfg)
    pts, pvalid, new_pts, status = corners
    warp, n_inl = fit_similarity_robust(pts, new_pts, pvalid & status)
    g = cfg.work
    if g.enabled:  # with the padding as Python numbers: nothing is uploaded
        R = warp[:, :2]
        shift = R[:, 0] * g.pad_x + R[:, 1] * g.pad_y + warp[:, 2]
        t = torch.stack([shift[0] - g.pad_x, shift[1] - g.pad_y]) / g.gain
        warp = torch.cat([R, t[:, None]], 1)
    fallback = estimate_gmc_warp(carry.kp_xy, flow_xy, flow_valid, affine=True)
    return torch.where(n_inl >= cfg.tracker.gmc_min_features, warp, fallback)


def _post_homography(
    carry, xs, cfg, flow_xy, flow_valid, kp_xy, kp_valid, need_kp, H_new, inliers, h_success, corners=None
):
    H = torch.where(h_success, H_new, carry.H)
    H_ok = carry.H_ok | h_success
    # on success the keypoint set collapses to the homography inliers
    kp_valid = torch.where(h_success, inliers, kp_valid)
    # a failed or starved attempt at an interval frame retries next frame
    attempted = carry.retry_h | xs.is_h_frame
    retry_h = attempted & ~h_success

    gmc = None
    if cfg.tracker.gmc == "features":
        gmc = _features_gmc_warp(carry, xs, cfg, flow_xy, flow_valid, corners)
    elif cfg.tracker.gmc != "off":
        gmc = estimate_gmc_warp(carry.kp_xy, flow_xy, flow_valid, affine=cfg.tracker.gmc == "affine")
    tracker, tout = botsort.step(
        carry.tracker,
        xs.det_boxes,
        xs.det_conf,
        xs.det_cls,
        xs.det_valid,
        cfg.tracker,
        gmc_warp=gmc,
        det_embed=xs.det_embed if cfg.tracker.use_appearance else None,
    )
    new_carry = TemporalCarry(
        kp_xy=kp_xy, kp_valid=kp_valid, H=H, H_ok=H_ok, retry_h=retry_h, tracker=tracker
    )
    out = FrameOutputs(
        kp_xy=kp_xy,
        kp_valid=kp_valid,
        need_kp=need_kp,
        H=H,
        H_ok=H_ok,
        track_boxes=tout.boxes,
        track_id=tout.track_id,
        track_conf=tout.conf,
        track_cls=tout.cls,
        track_valid=tout.valid,
    )
    return new_carry, out


def clip_at(tree, c: int):
    """Clip ``c`` of a carry, inputs or outputs with a leading clip axis
    (nested named tuples of tensors; host sequences are indexed too)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(clip_at(v, c) for v in tree))
    v = tree[c]
    return v.item() if isinstance(v, np.generic) else v


def stack_clips(trees: list):
    """The inverse of :func:`clip_at`: per-clip named tuples of tensors ->
    one with a leading clip axis."""
    first = trees[0]
    if hasattr(first, "_fields"):
        return type(first)(*(stack_clips([t[i] for t in trees]) for i in range(len(first))))
    return torch.stack(trees)


def temporal_step_clips(
    carries: TemporalCarry,
    xs: FrameInputs,
    cfg: PipelineConfig,
    gumbel_fn,
) -> tuple[TemporalCarry, FrameOutputs]:
    """One time step for a batch of C clips: every carry and input leaf has
    a leading clip axis (``is_kp_frame``, ``is_h_frame`` and ``t`` are host
    sequences of C; the frames (C, H, W, 3) views in the layout
    :func:`lk_flow_clips` takes).  Counterpart of the JAX package's
    ``temporal_step_clips``:

    - the flow of all C clips is one launch of the flow kernel, and with
      ``gmc="features"`` the 240 grid corners of all clips one more;
    - RANSAC is gated once, on any clip's ``do_h`` (one host sync): then
      every clip solves, each with its own within-clip ``t``'s draws
      (``gumbel_fn(t)``), and keeps its result only where its own gate is
      on (``h_success = ok & do_h``);
    - the merge, synthesis, calibration and the tracker run clip by clip.

    Each clip's carry and outputs equal :func:`temporal_step` on that clip
    alone, bit for bit."""
    n_clips = len(xs.t)
    clips = [clip_at(xs, c) for c in range(n_clips)]
    cars = [clip_at(carries, c) for c in range(n_clips)]
    wmap = _to_work(cfg, carries.kp_xy.device)
    live = torch.stack([car.kp_valid & (x.t > 0) for car, x in zip(cars, clips)])
    new_w, status = lk_flow_clips(xs.prev_frame_bgr, xs.frame_bgr, wmap.to_frame(carries.kp_xy), live, **_flow_args(cfg))
    pre = [
        _pre_homography(car, x, cfg, flow=_flow_filters(x.frame_bgr, car.kp_xy, new_w[c], status[c], cfg, wmap))
        for c, (car, x) in enumerate(zip(cars, clips))
    ]
    corners = [None] * n_clips
    if cfg.tracker.gmc == "features":
        grids = [grid_corners(p) for p in xs.prev_frame_bgr]
        pts, pvalid = torch.stack([g[0] for g in grids]), torch.stack([g[1] for g in grids])
        moved, ok = lk_flow_clips(xs.prev_frame_bgr, xs.frame_bgr, pts, pvalid, **_flow_args(cfg))
        corners = [(pts[c], pvalid[c], moved[c], ok[c]) for c in range(n_clips)]
    do_h = torch.stack([p[6] for p in pre])
    dev = do_h.device
    if bool(do_h.any()):
        solved = [_run_ransac(p[2], p[5], gumbel_fn(x.t), cfg) for p, x in zip(pre, clips)]
    else:
        solved = [(car.H, p[3], torch.zeros((), dtype=torch.bool, device=dev)) for car, p in zip(cars, pre)]
    steps = [
        _post_homography(car, x, cfg, *p[:5], H_new, inliers, ok & p[6], corners[c])
        for c, (car, x, p, (H_new, inliers, ok)) in enumerate(zip(cars, clips, pre, solved))
    ]
    return stack_clips([s[0] for s in steps]), stack_clips([s[1] for s in steps])


def backward_seed(
    frames_bgr: torch.Tensor,
    seed_xy: torch.Tensor,
    seed_valid: torch.Tensor,
    cfg: PipelineConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-frame seeding: from keypoints at frame j (the last of
    ``frames_bgr`` (J+1, H, W, 3)) flow BACKWARD to frame 0.  Returns
    (kp_xy (J+1, 57, 2), kp_valid (J+1, 57)); the last row repeats the
    seed."""
    j = frames_bgr.shape[0] - 1
    kp_xy, kp_valid = seed_xy, seed_valid
    xs_xy, xs_valid = [], []
    for idx in range(j - 1, -1, -1):
        # track from frame idx+1 to frame idx starting at kp_{idx+1} (the
        # reference's inverted-arguments backward pass)
        flow_xy, flow_valid = flow_with_filters(frames_bgr[idx + 1], frames_bgr[idx], kp_xy, kp_valid, cfg)
        any_flow = flow_valid.any()
        kp_xy = torch.where(any_flow, flow_xy, kp_xy)
        kp_valid = torch.where(any_flow, flow_valid, kp_valid)
        xs_xy.append(kp_xy)
        xs_valid.append(kp_valid)
    out_xy = torch.stack(xs_xy[::-1] + [seed_xy]) if xs_xy else seed_xy[None]
    out_valid = torch.stack(xs_valid[::-1] + [seed_valid]) if xs_valid else seed_valid[None]
    return out_xy, out_valid
