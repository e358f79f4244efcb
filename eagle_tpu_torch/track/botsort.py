"""BoT-SORT-style multi-object tracker as a fixed-shape state machine
(PyTorch counterpart of ``eagle_tpu/track/botsort.py``; boxmot 15.0.2's
BoTSORT cascade).

Per frame: Kalman predict of the activated pool (lost tracks with zeroed
size velocity; tentative tracks not predicted), the affine camera-motion
warp on every live track, then the BYTE cascade -- confirmed tracks x
high-confidence detections (IoU gate ``match_thresh``), still-tracked
leftovers x low-confidence detections (IoU gate 0.5), tentative tracks x
remaining high detections (score-fused IoU gate 0.7) -- the measurement
update, the lifecycle, spawning of new tracks into free slots (k-th free
slot takes the k-th new detection) and duplicate suppression between
tracked and lost tracks.  Each stage is one gated assignment by
``TrackerConfig.assignment``'s solver, as in the JAX package: the auction
(the default) or the exact JV solver (``"exact"``: on the card one launch of
the ``lap_jv`` kernel a stage, with no host sync).

With ``TrackerConfig.use_appearance`` and per-detection embeddings (the
ReID role: OSNet or the HSV histogram), the first and third stages take
``min(cost, cosine distance / 2)``, the appearance distance gated to 1 where
it exceeds ``appearance_thresh`` or the IoU distance exceeds
``proximity_thresh``; matched tracks keep an EMA of their detections'
embeddings and a new track starts from its detection's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eagle_tpu_torch.config import TrackerConfig
from eagle_tpu_torch.ops.assignment import masked_assignment, masked_auction
from eagle_tpu_torch.ops.kalman import (
    kf_initiate,
    kf_predict,
    kf_update,
    xywh_to_xyxy,
    xyxy_to_xywh,
)
from eagle_tpu_torch.ops.nms import box_iou_matrix


class TrackerState(NamedTuple):
    mean: torch.Tensor  # (T, 8) xywh + velocities
    cov: torch.Tensor  # (T, 8, 8)
    active: torch.Tensor  # (T,) slot holds a live (tracked or lost) track
    confirmed: torch.Tensor  # (T,) activated (outputs are emitted)
    lost_for: torch.Tensor  # (T,) frames since last update; 0 = updated
    track_id: torch.Tensor  # (T,) int64
    conf: torch.Tensor  # (T,)
    cls: torch.Tensor  # (T,) int64
    embed: torch.Tensor  # (T, E) EMA appearance embedding (zeros if unused)
    start_frame: torch.Tensor  # (T,) frame the track spawned on
    next_id: torch.Tensor  # () int64
    frame: torch.Tensor  # () int64 (1-based after first step)


class TrackerOutput(NamedTuple):
    boxes: torch.Tensor  # (T, 4) xyxy
    track_id: torch.Tensor  # (T,)
    conf: torch.Tensor  # (T,)
    cls: torch.Tensor  # (T,)
    det_idx: torch.Tensor  # (T,) matched detection index this frame, -1 if none
    valid: torch.Tensor  # (T,) emit mask


def init_state(max_tracks: int = 64, embed_dim: int = 64, device="cpu") -> TrackerState:
    t = max_tracks
    i64 = dict(dtype=torch.int64, device=device)
    return TrackerState(
        mean=torch.zeros(t, 8, device=device),
        cov=torch.zeros(t, 8, 8, device=device),
        active=torch.zeros(t, dtype=torch.bool, device=device),
        confirmed=torch.zeros(t, dtype=torch.bool, device=device),
        lost_for=torch.zeros(t, **i64),
        track_id=torch.zeros(t, **i64),
        conf=torch.zeros(t, device=device),
        cls=torch.zeros(t, **i64),
        embed=torch.zeros(t, embed_dim, device=device),
        start_frame=torch.zeros(t, **i64),
        next_id=torch.ones((), **i64),
        frame=torch.zeros((), **i64),
    )


def _fuse_score(cost, det_conf):
    """ByteTrack fuse_score: similarity scaled by detection confidence."""
    return 1.0 - (1.0 - cost) * det_conf[None, :]


def step(
    state: TrackerState,
    det_boxes: torch.Tensor,
    det_conf: torch.Tensor,
    det_cls: torch.Tensor,
    det_valid: torch.Tensor,
    cfg: TrackerConfig = TrackerConfig(),
    gmc_warp: torch.Tensor | None = None,
    det_embed: torch.Tensor | None = None,
) -> tuple[TrackerState, TrackerOutput]:
    """Advance the tracker one frame on the fixed-shape NMS outputs
    det_boxes (D, 4) xyxy, det_conf (D,), det_cls (D,), det_valid (D,).

    gmc_warp: optional (2, 3) camera-motion affine since the last frame,
    applied with boxmot's multi_gmc semantics (the 2x2 part rotates every
    (x, y) / (w, h) / velocity pair of the state).
    det_embed: optional (D, E) L2-normalised appearance embeddings, used
    when ``cfg.use_appearance`` (None there behaves as False)."""
    appearance = bool(cfg.use_appearance) and det_embed is not None
    T = state.mean.shape[0]
    D = det_boxes.shape[0]
    dev = det_boxes.device
    frame = state.frame + 1

    damp = torch.ones(T, 8, device=dev)
    damp[:, 6:] = torch.where((state.lost_for > 0)[:, None], 0.0, 1.0)
    pred_mean, pred_cov = kf_predict(state.mean * damp, state.cov)
    predict = state.confirmed
    mean = torch.where(predict[:, None], pred_mean, state.mean)
    cov = torch.where(predict[:, None, None], pred_cov, state.cov)
    if gmc_warp is not None and cfg.gmc != "off":
        R = gmc_warp[:, :2]
        t_xy = gmc_warp[:, 2]
        warped = (mean.reshape(T, 4, 2) @ R.T).reshape(T, 8)
        warped = torch.cat([warped[:, :2] + t_xy, warped[:, 2:]], dim=1)
        wcov = torch.einsum("ap,tipjq,bq->tiajb", R, cov.reshape(T, 4, 2, 4, 2), R).reshape(T, 8, 8)
        mean = torch.where(state.active[:, None], warped, mean)
        cov = torch.where(state.active[:, None, None], wcov, cov)
    mean = torch.where(state.active[:, None], mean, state.mean)
    cov = torch.where(state.active[:, None, None], cov, state.cov)
    track_boxes = xywh_to_xyxy(mean[:, :4])

    was_tracked = state.active & (state.lost_for == 0)
    high = det_valid & (det_conf > cfg.track_high_thresh)
    low = det_valid & (det_conf > cfg.track_low_thresh) & (det_conf < cfg.track_high_thresh)

    iou_c = 1.0 - box_iou_matrix(track_boxes, det_boxes)  # (T, D)
    solver = masked_auction if cfg.assignment == "auction" else masked_assignment

    # appearance distance, shared by stages 1 and 3: cosine distance / 2,
    # 1 for distant boxes or dissimilar appearance
    if appearance:
        emb_d = 0.5 * (1.0 - state.embed @ det_embed.T)
        emb_d = torch.where((emb_d > cfg.appearance_thresh) | (iou_c > cfg.proximity_thresh), 1.0, emb_d)

    # stage 1: confirmed pool x high detections
    rows1 = state.active & state.confirmed
    cost1 = _fuse_score(iou_c, det_conf) if cfg.fuse_first_associate else iou_c
    if appearance:
        cost1 = torch.minimum(cost1, emb_d)
    m1, used_det1 = solver(cost1, rows1, high, cfg.match_thresh)
    # stage 2: still-tracked unmatched x low detections, raw IoU gate 0.5
    rows2 = rows1 & was_tracked & (m1 < 0)
    m2, _ = solver(iou_c, rows2, low, 0.5)
    # stage 3: tentative tracks x leftover high detections, fused gate 0.7
    rows3 = state.active & ~state.confirmed
    cols3 = high & ~used_det1
    cost3 = _fuse_score(iou_c, det_conf)
    if appearance:
        cost3 = torch.minimum(cost3, emb_d)
    m3, used_det3 = solver(cost3, rows3, cols3, 0.7)

    match = torch.where(m1 >= 0, m1, torch.where(m2 >= 0, m2, m3))
    matched = match >= 0

    # measurement update for matched tracks (one-hot selection products)
    det_ids = torch.arange(D, device=dev)
    sel = (match[:, None] == det_ids[None, :]).to(det_boxes.dtype)  # (T, D)
    z = sel @ xyxy_to_xywh(det_boxes)
    z = torch.where(matched[:, None], z, mean[:, :4])
    new_mean, new_cov = kf_update(mean, cov, z)
    mean = torch.where(matched[:, None], new_mean, mean)
    cov = torch.where(matched[:, None, None], new_cov, cov)
    conf = torch.where(matched, sel @ det_conf, state.conf)
    cls = torch.where(matched, (sel @ det_cls.to(sel.dtype)).to(torch.int64), state.cls)
    confirmed = state.confirmed | matched
    lost_for = torch.where(matched, 0, state.lost_for + 1)

    embed = state.embed
    if appearance:
        ema = cfg.embed_momentum * embed + (1.0 - cfg.embed_momentum) * (sel @ det_embed)
        norm = torch.clamp(torch.linalg.vector_norm(ema, dim=-1, keepdim=True), min=1e-9)
        embed = torch.where(matched[:, None], ema / norm, embed)

    # lifecycle: drop stale lost tracks and unmatched tentatives
    active = state.active & (matched | (state.confirmed & (lost_for <= cfg.track_buffer)))

    # spawn new tracks from leftover high detections
    new_det = high & ~used_det1 & ~used_det3 & (det_conf >= cfg.new_track_thresh)
    new_rank = torch.cumsum(new_det.to(torch.int64), 0) - 1
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    n_new = new_det.sum()
    spawn = free & (free_rank < n_new)
    pair = (spawn[:, None] & new_det[None, :] & (free_rank[:, None] == new_rank[None, :])).to(
        det_boxes.dtype
    )
    src_xywh = pair @ xyxy_to_xywh(det_boxes)
    src_xywh = torch.where(spawn[:, None], src_xywh, torch.ones_like(src_xywh))
    init_mean, init_cov = kf_initiate(src_xywh)
    mean = torch.where(spawn[:, None], init_mean, mean)
    cov = torch.where(spawn[:, None, None], init_cov, cov)
    conf = torch.where(spawn, pair @ det_conf, conf)
    cls = torch.where(spawn, (pair @ det_cls.to(pair.dtype)).to(torch.int64), cls)
    track_id = torch.where(spawn, state.next_id + torch.where(spawn, free_rank, 0), state.track_id)
    confirmed = torch.where(spawn, frame == 1, confirmed)
    lost_for = torch.where(spawn, 0, lost_for)
    active = active | spawn
    start_frame = torch.where(spawn, frame, state.start_frame)
    if appearance:
        embed = torch.where(spawn[:, None], pair @ det_embed, embed)

    # duplicate suppression (boxmot remove_duplicate_stracks): a tracked and
    # a lost track with IoU distance < 0.15 -> the shorter-lived one goes
    boxes_now = xywh_to_xyxy(mean[:, :4])
    tracked_now = active & (lost_for == 0)
    lost_now = active & (lost_for > 0)
    dup_iou = box_iou_matrix(boxes_now, boxes_now)
    age = (frame - lost_for) - start_frame
    pair_dup = tracked_now[:, None] & lost_now[None, :] & (dup_iou > 0.85)
    older_t = age[:, None] > age[None, :]
    kill = (pair_dup & older_t).any(dim=0) | (pair_dup & ~older_t).any(dim=1)
    active = active & ~kill

    new_state = TrackerState(
        mean=mean,
        cov=cov,
        active=active,
        confirmed=confirmed,
        lost_for=lost_for,
        track_id=track_id,
        conf=conf,
        cls=cls,
        embed=embed,
        start_frame=start_frame,
        next_id=state.next_id + n_new,
        frame=frame,
    )
    emit = active & confirmed & (matched | spawn)
    spawn_det = (pair * det_ids[None, :].to(pair.dtype)).sum(1).to(torch.int64)
    out = TrackerOutput(
        boxes=xywh_to_xyxy(mean[:, :4]),
        track_id=track_id,
        conf=conf,
        cls=cls,
        det_idx=torch.where(matched, match, torch.where(spawn, spawn_det, -1)),
        valid=emit,
    )
    return new_state, out
