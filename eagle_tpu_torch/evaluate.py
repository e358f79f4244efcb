"""Model evaluation CLI (the port's ``scripts/evaluate.py``): ``results.json``.

    python -m eagle_tpu_torch.evaluate [--keypoint_weights K] [--detector_weights D]
        [--video clip.mp4 --labels labels.json] [--frames 32] [--out results.json] [--device cpu]

Writes the metric schema of the reference's stored eval artifact
(``eagle/models/weights/results.json``): ``YOLO`` and ``HRNet``, each with
``metrics`` (acc@{2,4,8,12}px), ``classification`` (precision, recall, F1
and the TP / FP / FN counts at each threshold, and ``pdj``) and ``time``;
``YOLO`` also has ``boxes`` (IoU-matched detection metrics).  The metrics
are those of :mod:`eagle_tpu_torch.eval`, the JAX package's harness.

Without ``--video`` it scores the models on the synthetic scene of
:mod:`eagle_tpu_torch.utils.synthetic` (32 frames of 1280x720, 10 players),
which draws without OpenCV, so this mode runs on the card's machine; with
``--video`` and ``--labels`` ({frame: {"keypoints": [[x, y, id], ...],
"boxes": [[x1, y1, x2, y2, cls], ...]}}) it scores a real clip, decoded by
OpenCV (imported only then).

The models run on the card unless ``--device cpu`` is given; with no card
and no ``--device cpu`` the model's construction raises.  :func:`run` is
the body without argv.

``time`` is seconds a frame of the one call of the model's runner over all
the frames, read after ``torch.cuda.synchronize()`` on the model's device,
so that it counts the device's work.  The JAX script stops its keypoint
clock before its device arrays are ready (asynchronous dispatch), so the two
packages' ``time`` values are not comparable.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser

import numpy as np
import torch

from eagle_tpu_torch import pitch
from eagle_tpu_torch.eval import _host, detection_metrics, point_metrics
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

#: the synthetic mode's frame size
SYNTHETIC_HW = (720, 1280)


def _timed(model, fn, frames):
    """(seconds a frame, fn(frames)), the clock read after the model's
    device has finished the call's work."""

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    sync()
    t0 = time.perf_counter()
    out = fn(frames)
    sync()
    return (time.perf_counter() - t0) / len(frames), out


def synthetic_truth(scene, hw=SYNTHETIC_HW):
    """(gt_kp (N, 57, 2), gt_kp_valid (N, 57), gt_boxes (N, P, 4),
    gt_box_valid (N, P)) of a synthetic scene: the landmarks that lie in the
    frame and on the pitch plane, and every player's box."""
    n = len(scene.frames)
    kp = scene.keypoints_image
    h, w = hw
    inb = (kp[:, 0] >= 0) & (kp[:, 0] < w) & (kp[:, 1] >= 0) & (kp[:, 1] < h) & pitch.ON_PLANE_MASK
    gt_boxes = scene.player_boxes
    return np.tile(kp, (n, 1, 1)), np.tile(inb, (n, 1)), gt_boxes, np.ones(gt_boxes.shape[:2], bool)


def read_labels(path: str, n: int):
    """The ground truth of ``n`` frames from a labels JSON, as the JAX
    script parses it (frames past ``n`` are ignored; box classes too)."""
    with open(path) as f:
        labels = json.load(f)
    gt_kp = np.zeros((n, 57, 2))
    gt_kp_valid = np.zeros((n, 57), bool)
    max_gt = max(len(v.get("boxes", [])) for v in labels.values())
    gt_boxes = np.zeros((n, max_gt, 4))
    gt_box_valid = np.zeros((n, max_gt), bool)
    for k, v in labels.items():
        t = int(k)
        if t >= n:
            continue
        for x, y, kid in v.get("keypoints", []):
            gt_kp[t, int(kid)] = (x, y)
            gt_kp_valid[t, int(kid)] = True
        for i, (x1, y1, x2, y2, _cls) in enumerate(v.get("boxes", [])):
            gt_boxes[t, i] = (x1, y1, x2, y2)
            gt_box_valid[t, i] = True
    return gt_kp, gt_kp_valid, gt_boxes, gt_box_valid


def run(model, frames, gt_kp, gt_kp_valid, gt_boxes, gt_box_valid) -> dict:
    """The ``results.json`` dict of ``model``'s keypoint and detector runners
    (``model._keypoint_fn``, ``model._detector_fn``, one call each over all
    the frames) against the ground truth."""
    kp_time, (kp, kp_valid) = _timed(model, model._keypoint_fn, frames)
    kp_metrics = point_metrics(kp[:, :, :2], kp_valid, gt_kp, gt_kp_valid, labeled=True)

    det_time, dets = _timed(model, model._detector_fn, frames)
    boxes, conf, cls, valid = (np.asarray(_host(a)) for a in dets)
    person = valid & (cls <= 1) & (conf >= model.detector_conf)
    det_box_metrics = detection_metrics(boxes, person, gt_boxes, gt_box_valid)
    # bottom-center point metrics at pixel thresholds (the reference's YOLO
    # "metrics" are point distances)
    bc_pred = np.stack([(boxes[..., 0] + boxes[..., 2]) / 2, boxes[..., 3]], -1)
    bc_gt = np.stack([(gt_boxes[..., 0] + gt_boxes[..., 2]) / 2, gt_boxes[..., 3]], -1)
    det_pt_metrics = point_metrics(bc_pred, person, bc_gt, gt_box_valid, labeled=False)

    return {
        "YOLO": {
            "metrics": det_pt_metrics["metrics"],
            "classification": det_pt_metrics["classification"],
            "boxes": det_box_metrics,
            "time": det_time,
        },
        "HRNet": {
            "metrics": kp_metrics["metrics"],
            "classification": kp_metrics["classification"],
            "time": kp_time,
        },
    }


def main(argv=None) -> dict:
    p = ArgumentParser(description="Score the keypoint model and the detector -> results.json (PyTorch port)")
    p.add_argument("--keypoint_weights", default=None)
    p.add_argument("--detector_weights", default=None)
    p.add_argument("--video", default=None, help="clip to evaluate (else synthetic)")
    p.add_argument("--labels", default=None, help="ground-truth JSON for --video")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--out", default="results.json")
    p.add_argument("--device", default=None, help='"cpu" for the plain CPU path; default the card')
    args = p.parse_args(argv)
    if args.video is not None and args.labels is None:
        p.error("--video needs --labels")

    model = CoordinateModel(
        keypoint_checkpoint=args.keypoint_weights,
        detector_checkpoint=args.detector_weights,
        device=args.device,
    )
    if args.video is None:
        from eagle_tpu_torch.utils.synthetic import make_scene

        h, w = SYNTHETIC_HW
        scene = make_scene(num_frames=args.frames, width=w, height=h, num_players=10)
        frames = scene.frames
        truth = synthetic_truth(scene)
    else:
        from eagle_tpu_torch.io.video import read_video_array

        frames, _ = read_video_array(args.video, fps=25)
        frames = frames[: args.frames]
        truth = read_labels(args.labels, len(frames))

    results = run(model, frames, *truth)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
