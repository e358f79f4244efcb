"""Class-aware non-maximum suppression with fixed output slots (PyTorch
counterpart of ``eagle_tpu/ops/nms.py``).

Confidence top-K pre-selection (a stable descending sort, so equal
confidences keep the lower anchor first, as ``jax.lax.top_k`` does), one
dense IoU block, greedy suppression, and compaction of the kept boxes into
score-descending slots.  The tracker's slot order depends on this order.
"""

from __future__ import annotations

import torch

MAX_WH = 7680.0  # class-separation offset (ultralytics convention)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    conf_threshold: float = 0.15,
    iou_threshold: float = 0.7,
    max_det: int = 128,
    pre_topk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image class-aware NMS over a batch.

    boxes (B, A, 4) xyxy; scores (B, A, nc), class = argmax, conf = max.
    Returns boxes (B, max_det, 4), scores (B, max_det), cls (B, max_det)
    int32, valid (B, max_det) bool, score-descending."""
    nb, na, _ = boxes.shape
    dev = boxes.device
    conf, cls = scores.max(dim=-1)
    cls = torch.argmax(scores, dim=-1).to(torch.int32)  # first maximum on ties
    cand = conf > conf_threshold
    k = min(pre_topk, na)
    masked = torch.where(cand, conf, torch.full_like(conf, -torch.inf))
    top_conf, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_conf, order = top_conf[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(nb, k, 4))
    top_cls = torch.gather(cls, 1, order)
    top_valid = torch.isfinite(top_conf)

    shifted = top_boxes + top_cls.to(boxes.dtype)[..., None] * MAX_WH
    iou = box_iou_matrix(shifted, shifted)
    ar = torch.arange(k, device=dev)
    tri_overlap = (
        (iou > iou_threshold)
        & (ar[:, None] < ar[None, :])
        & top_valid[:, :, None]
        & top_valid[:, None, :]
    )  # (b, i, j): kept i would suppress j

    # greedy suppression as a fixed-point iteration: keep[j] iff no kept
    # higher-scored i overlaps it; the fixed point is unique (it is fixed
    # by induction over j) and is reached within k passes
    keep = top_valid
    for _ in range(k):
        suppressed = (tri_overlap & keep[:, :, None]).any(dim=1)
        new = top_valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new

    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    slot = torch.where(keep & (pos < max_det), pos, torch.full_like(pos, max_det))
    out_boxes = torch.zeros(nb, max_det + 1, 4, dtype=boxes.dtype, device=dev)
    out_boxes.scatter_(1, slot[..., None].expand(nb, k, 4), top_boxes)
    out_scores = torch.zeros(nb, max_det + 1, dtype=conf.dtype, device=dev)
    out_scores.scatter_(1, slot, top_conf)
    out_cls = torch.zeros(nb, max_det + 1, dtype=torch.int32, device=dev)
    out_cls.scatter_(1, slot, top_cls)
    n_kept = torch.clamp(keep.sum(dim=-1), max=max_det)
    out_valid = torch.arange(max_det, device=dev)[None, :] < n_kept[:, None]
    return out_boxes[:, :max_det], out_scores[:, :max_det], out_cls[:, :max_det], out_valid
