"""Model-evaluation harness (PyTorch port's copy of ``eagle_tpu/eval.py``).

The reference ships only stored eval metrics (PDJ-style accuracy and
precision/recall/F1 at 2/4/8/12-pixel thresholds for both models) without
the harness that produced them.  This module is that harness:
distance-thresholded point metrics for the keypoint model and the detector
(bottom-center points), in the same metric schema, plus box-IoU detection
metrics.

Inputs are numpy arrays or tensors (on any device: they are copied to the
host).  Everything is computed on the host in numpy, as in the JAX package,
with its dtypes and its greedy matching order (numpy's ``argsort`` over the
flattened distance or IoU matrix), so ties match the same pairs.
"""

from __future__ import annotations

import numpy as np

THRESHOLDS = (2, 4, 8, 12)


def _host(x):
    """A tensor as a numpy array on the host; anything else as it is."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def _match_points(pred: np.ndarray, pred_valid: np.ndarray, gt: np.ndarray, gt_valid: np.ndarray):
    """Greedy nearest matching of predicted to ground-truth points.
    Returns distances of matched pairs and (n_pred, n_gt, n_matched)."""
    p = pred[pred_valid]
    g = gt[gt_valid]
    if len(p) == 0 or len(g) == 0:
        return np.zeros((0,)), len(p), len(g), 0
    d = np.linalg.norm(p[:, None] - g[None, :], axis=-1)
    dists = []
    used_p, used_g = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(d, axis=None), d.shape))[0]
    for pi, gi in order:
        if pi in used_p or gi in used_g:
            continue
        used_p.add(int(pi))
        used_g.add(int(gi))
        dists.append(d[pi, gi])
    return np.asarray(dists), len(p), len(g), len(dists)


def point_metrics(
    pred: np.ndarray,
    pred_valid: np.ndarray,
    gt: np.ndarray,
    gt_valid: np.ndarray,
    thresholds=THRESHOLDS,
    labeled: bool = True,
) -> dict:
    """PDJ-style accuracy + precision/recall/F1 at pixel thresholds.

    ``labeled=True`` compares slot-to-slot (keypoints: the index is the
    label); ``labeled=False`` greedily matches unordered point sets
    (detections).  Shapes: (N, K, 2) points, (N, K) masks.

    Returns the reference's results.json metric schema: ``metrics["<k>"]``
    (bare threshold string, e.g. ``metrics["4"]``) = fraction of
    predictions within k px, ``classification.{precision,recall,f1}_k``
    and ``classification.pdj``.
    """
    pred = np.asarray(_host(pred), float)
    gt = np.asarray(_host(gt), float)
    pred_valid = np.asarray(_host(pred_valid), bool)
    gt_valid = np.asarray(_host(gt_valid), bool)

    n_pred = int(pred_valid.sum())
    n_gt = int(gt_valid.sum())
    per_t_tp = {t: 0 for t in thresholds}
    all_dists = []

    for i in range(len(pred)):
        if labeled:
            both = pred_valid[i] & gt_valid[i]
            d = np.linalg.norm(pred[i][both] - gt[i][both], axis=-1)
            all_dists.append(d)
            for t in thresholds:
                per_t_tp[t] += int((d <= t).sum())
        else:
            d, _, _, _ = _match_points(pred[i], pred_valid[i], gt[i], gt_valid[i])
            all_dists.append(d)
            for t in thresholds:
                per_t_tp[t] += int((d <= t).sum())

    dists = np.concatenate(all_dists) if all_dists else np.zeros((0,))
    out = {"metrics": {}, "classification": {}}
    for t in thresholds:
        tp = per_t_tp[t]
        # reference artifact schema (reference
        # eagle/models/weights/results.json): metrics keyed by the bare
        # threshold string, classification carrying the raw counts too
        out["metrics"][str(t)] = tp / max(n_pred, 1)
        precision = tp / max(n_pred, 1)
        recall = tp / max(n_gt, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        out["classification"][f"precision_{t}"] = precision
        out["classification"][f"recall_{t}"] = recall
        out["classification"][f"f1_{t}"] = f1
        out["classification"][f"true_positives_{t}"] = tp
        out["classification"][f"false_positives_{t}"] = n_pred - tp
        out["classification"][f"false_negatives_{t}"] = n_gt - tp
    # PDJ at 0.05 x a nominal 240-px torso scale ~ the mean-threshold style
    out["classification"]["pdj"] = float(np.mean([out["metrics"][str(t)] for t in thresholds]))
    return out


def box_iou(a, b) -> np.ndarray:
    """(N, M) IoU of xyxy boxes a (N, 4) and b (M, 4)."""
    a, b = _host(a), _host(b)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ua = (
        ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
        + ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None]
        - inter
    )
    return inter / np.maximum(ua, 1e-9)


def detection_metrics(
    pred_boxes, pred_valid, gt_boxes, gt_valid, iou_threshold: float = 0.5
) -> dict:
    """Box-level precision/recall/F1 + mean matched IoU at a threshold.
    Shapes: (N, D, 4) boxes, (N, D) masks."""
    pred_boxes, pred_valid, gt_boxes, gt_valid = (_host(x) for x in (pred_boxes, pred_valid, gt_boxes, gt_valid))
    tp = 0
    n_pred = 0
    n_gt = 0
    matched_ious = []
    for i in range(len(pred_boxes)):
        p = np.asarray(pred_boxes[i])[np.asarray(pred_valid[i], bool)]
        g = np.asarray(gt_boxes[i])[np.asarray(gt_valid[i], bool)]
        n_pred += len(p)
        n_gt += len(g)
        if len(p) == 0 or len(g) == 0:
            continue
        iou = box_iou(p, g)
        order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
        used_p, used_g = set(), set()
        for pi, gi in order:
            if pi in used_p or gi in used_g or iou[pi, gi] < iou_threshold:
                continue
            used_p.add(int(pi))
            used_g.add(int(gi))
            tp += 1
            matched_ious.append(iou[pi, gi])
    precision = tp / max(n_pred, 1)
    recall = tp / max(n_gt, 1)
    return {
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-9),
        "mean_iou": float(np.mean(matched_ious)) if matched_ious else 0.0,
        "num_pred": n_pred,
        "num_gt": n_gt,
    }


def pitch_rmse(pred_xy, pred_valid, gt_xy, gt_valid) -> float:
    """RMSE of matched pitch-coordinate points (the driver's parity
    metric: <= 1e-2 m vs the reference)."""
    pred_xy, pred_valid, gt_xy, gt_valid = (_host(x) for x in (pred_xy, pred_valid, gt_xy, gt_valid))
    errs = []
    for i in range(len(pred_xy)):
        d, _, _, m = _match_points(
            np.asarray(pred_xy[i]), np.asarray(pred_valid[i], bool),
            np.asarray(gt_xy[i]), np.asarray(gt_valid[i], bool),
        )
        errs.append(d)
    e = np.concatenate(errs) if errs else np.zeros((0,))
    return float(np.sqrt(np.mean(e**2))) if len(e) else float("nan")
