"""Inputs that hold the auction and NMS kernels to their plain versions
(numpy, seeded): the same cases feed the CPU tests against the JAX
package, the card tests and ``chip_smoke.py``.

- :func:`auction_case`: a gated (R, C) problem as ``masked_auction`` takes
  it, of a kind: ``tracking`` (sparse near pairs, as the tracker's IoU
  costs), ``random``, ``ties`` (costs on a grid of four values: most rows
  hold several equal best columns), ``tied_block`` (one cost everywhere,
  more rows than columns: a price war that runs into the round cap) and
  ``infeasible`` (a third of the rows with no pair under the gate).
- :func:`auction_round_case`: a 64 x 128 ``tracking`` problem whose
  auction runs a given number of rounds (0, 1, 4 or 11), for the kernel's
  cost a launch and a round.
- :func:`nms_cases`: one batch of images, one a kind: clustered boxes,
  pairs at IoU exactly the threshold and one float32 step above it, a
  suppression chain, an image with nothing above the confidence floor,
  and one whose disjoint boxes overflow ``max_det``.
- :func:`nms_wide_case`: a batch of detector outputs with thousands of
  valid, clustered boxes, for NMS at any candidate count up to the
  detector's anchor count (:data:`ANCHORS`).
- :func:`suppress_inputs`: the (shifted boxes, valid) that ``batched_nms``
  hands the suppression on such detector outputs, the kernel's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from eagle_tpu_torch.ops import nms
from eagle_tpu_torch.ops.nms import box_iou_matrix

AUCTION_KINDS = ("tracking", "random", "ties", "tied_block", "infeasible")
NMS_KINDS = ("clusters", "threshold", "chain", "empty", "overflow")
#: the gate of :func:`auction_case` (the tracker's ``match_thresh``)
GATE = 0.8
#: the IoU threshold :func:`nms_cases` builds its edge pairs for (the
#: detector's ``nms_iou``)
NMS_IOU = 0.7
#: links of the suppression chain: box m overlaps box m + 1 by IoU 0.82
#: and box m + 2 by 0.67, so the fixed point takes a pass a link or two
CHAIN = 12
#: the detector's anchors at its 544 x 960 canvas (strides 8, 16, 32)
ANCHORS = 68 * 120 + 34 * 60 + 17 * 30


def auction_case(kind: str, r: int, c: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """(cost (r, c) float32, row_valid (r,) bool, col_valid (c,) bool,
    gate)."""
    rng = np.random.default_rng(seed)
    rows, cols = np.ones(r, bool), np.ones(c, bool)
    if kind == "tracking":
        cost = np.ones((r, c))
        near = rng.uniform(size=(r, c)) < 0.2
        cost[near] = rng.uniform(0.05, 0.95, near.sum())
        rows, cols = rng.uniform(size=r) < 0.75, rng.uniform(size=c) < 0.75
    elif kind == "random":
        cost = rng.uniform(0, 1, (r, c))
        rows, cols = rng.uniform(size=r) < 0.8, rng.uniform(size=c) < 0.8
    elif kind == "ties":
        cost = rng.integers(0, 4, (r, c)) / 4.0
    elif kind == "tied_block":
        cost = np.full((r, c), 0.1)
    elif kind == "infeasible":
        cost = rng.uniform(0, 1, (r, c))
        cost[rng.uniform(size=r) < 0.35] = 2.0
    else:
        raise ValueError(f"auction_case kind must be one of {AUCTION_KINDS}, got {kind!r}")
    return cost.astype(np.float32), rows, cols, GATE


#: rounds -> (the ``tracking`` case's seed, the rows left valid): 0 rounds
#: (no valid row: the launch returns before reading the benefit), 1 round
#: (7 bidding rows, no conflict), 4 rounds (48, 9, 4 and 1 bidding rows),
#: 11 rounds (47, 11, 5, then 1 a round)
ROUND_CASES = {0: (10, 0), 1: (6, 8), 4: (10, 64), 11: (19, 64)}


def auction_round_case(rounds: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """:func:`auction_case` ``("tracking", 64, 128, seed)`` with only its
    first ``rows_left`` rows left valid (``ROUND_CASES[rounds]``): its
    auction runs ``rounds`` rounds."""
    seed, rows_left = ROUND_CASES[rounds]
    cost, rows, cols, gate = auction_case("tracking", 64, 128, seed)
    return cost, rows & (np.arange(64) < rows_left), cols, gate


def _iou(a: np.ndarray, b: np.ndarray) -> np.float32:
    """IoU of two xyxy float32 boxes as ``box_iou_matrix`` computes it."""
    return np.float32(box_iou_matrix(torch.from_numpy(a[None]), torch.from_numpy(b[None]))[0, 0])


def threshold_pairs(thr: float = NMS_IOU) -> np.ndarray:
    """Two pairs of class-0 boxes (4, 4) float32: a 10 x 10 box and one of
    height h inside it, first with IoU exactly float32(thr) (not
    suppressed: the test is IoU > thr), then with the least h above whose
    IoU exceeds it (suppressed)."""
    f, t = np.float32, np.float32(thr)
    big = np.array([0, 0, 10, 10], np.float32)
    h = f(10 * thr)
    while _iou(big, np.array([0, 0, 10, h], np.float32)) > t:
        h = np.nextafter(h, f(0))
    while _iou(big, np.array([0, 0, 10, h], np.float32)) < t:
        h = np.nextafter(h, f(20))
    at = np.array([0, 0, 10, h], np.float32)
    if _iou(big, at) != t:
        raise ValueError(f"no box height gives IoU exactly float32({thr})")
    while _iou(big, np.array([0, 0, 10, h], np.float32)) <= t:
        h = np.nextafter(h, f(20))
    above = np.array([0, 0, 10, h], np.float32)
    off = np.array([100, 0, 100, 0], np.float32)
    return np.stack([big, at, big + off, above + off])


def nms_cases(seed: int, na: int = 600, nc: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(boxes (5, na, 4) float32 xyxy, scores (5, na, nc) float32), one
    image of each of NMS_KINDS, in that order.  The special boxes take the
    highest scores (descending in their order), so they lead the
    score-sorted candidates."""
    rng = np.random.default_rng(seed)
    boxes = np.empty((len(NMS_KINDS), na, 4), np.float32)
    scores = np.empty((len(NMS_KINDS), na, nc), np.float32)
    for im, kind in enumerate(NMS_KINDS):
        centers = rng.uniform(20, 900, (na // 6 + 1, 2)).repeat(6, axis=0)[:na]
        centers = centers + rng.normal(0, 3, centers.shape)
        wh = rng.uniform(8, 60, (na, 2))
        boxes[im] = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
        scores[im] = 0.8 * rng.uniform(0, 1, (na, nc)) ** 3
        scores[im, ::40] = np.round(scores[im, ::40], 1)  # exact confidence ties
        special = None
        if kind == "threshold":
            special = threshold_pairs()
        elif kind == "chain":
            m = np.arange(CHAIN, dtype=np.float32)[:, None]
            special = np.array([[2000, 2000, 2010, 2010]], np.float32) + m * np.array([[1, 0, 1, 0]], np.float32)
        elif kind == "empty":
            scores[im] = 0.01
        elif kind == "overflow":
            boxes[im] = np.array([[0, 0, 4, 4]], np.float32) + 10 * np.arange(na, dtype=np.float32)[:, None]
            scores[im, :, 0] = rng.uniform(0.5, 0.9, na)
        if special is not None:
            s = len(special)
            boxes[im, :s] = special
            scores[im, :s] = 0.0
            scores[im, :s, 0] = 0.99 - 0.01 * np.arange(s)
    return boxes, scores


def nms_wide_case(na: int, b: int = 2, seed: int = 0, nc: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(boxes (b, na, 4) float32 xyxy, scores (b, na, nc) float32): ``na``
    anchors' boxes in clusters of 1 to 8 around centres over a 1920 x 1080
    image (8 to 120 px wide, jittered by 2 px, so a cluster's boxes
    overlap each other at IoUs around the threshold), about 70% of them
    scoring above the 0.15 floor, with some exact confidence ties."""
    rng = np.random.default_rng(seed)
    boxes = np.empty((b, na, 4), np.float32)
    scores = np.empty((b, na, nc), np.float32)
    for im in range(b):
        sizes = rng.integers(1, 9, na)
        owner = np.repeat(np.arange(na), sizes)[:na]
        centers = rng.uniform([0, 0], [1920, 1080], (na, 2))[owner] + rng.normal(0, 2, (na, 2))
        wh = rng.uniform(8, 120, (na, 2))[owner] * rng.uniform(0.85, 1.15, (na, 2))
        boxes[im] = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
        scores[im] = 0.05 * rng.uniform(0, 1, (na, nc))
        cls = rng.integers(0, nc, na)
        scores[im, np.arange(na), cls] = np.where(rng.uniform(size=na) < 0.7, rng.uniform(0.16, 0.99, na),
                                                  rng.uniform(0.0, 0.14, na))
        scores[im, ::50] = np.round(scores[im, ::50], 2)  # exact confidence ties
    return boxes, scores


def suppress_inputs(boxes: np.ndarray, scores: np.ndarray, k: int = 512, device="cpu"):
    """(shifted (B, k, 4), valid (B, k)) as ``batched_nms`` hands them to
    the suppression at ``pre_topk=k`` on these detector outputs, on
    ``device``: ``batched_nms``'s own set-up, run with ``nms.suppress``
    recorded and not run (no kernel is launched)."""
    seen = []
    real = nms.suppress

    def record(shifted, valid, thr):
        seen.append((shifted, valid))
        return valid

    x = (torch.from_numpy(a).to(device) for a in (boxes, scores))
    nms.suppress = record
    try:
        nms.batched_nms(*x, pre_topk=k)
    finally:
        nms.suppress = real
    return seen[0]
