# Frozen copy of eagle_tpu_torch/utils/oracles.py (the scene's truth as the
# rows a perfect detector and keypoint model would return), so that the
# yardstick does not move with the program; only the import of ``pitch``
# points at the copy beside this file.
"""Perfect model outputs from a synthetic scene's truth: what trained
keypoint and detector models would return on
:func:`eagle_tpu_torch.utils.synthetic.make_scene` frames (the port's copy
of ``tests/oracles.py``'s ``oracle_keypoint_fn`` and
``oracle_detections_at``, the rows the JAX package's bench injects).
"""

from __future__ import annotations

import numpy as np

from benchmark.frozen import pitch


def oracle_keypoint_fn(scene):
    """A keypoint runner for a still camera: (B, H, W, 3) frames -> ((B,
    57, 3) [x, y, score], (B, 57) valid), every frame the scene's
    landmarks truncated to integer pixels, score 0.9, valid when on the
    pitch plane and at least 5 px inside the image."""
    kp_img = scene.keypoints_image  # static camera
    h, w = scene.frames.shape[1:3]
    valid = (
        (kp_img[:, 0] >= 5)
        & (kp_img[:, 0] < w - 5)
        & (kp_img[:, 1] >= 5)
        & (kp_img[:, 1] < h - 5)
        & pitch.ON_PLANE_MASK
    )

    def fn(frames_batch):
        b = len(frames_batch)
        kp = np.zeros((b, 57, 3), np.float32)
        kp[:, :, 0] = np.trunc(kp_img[:, 0])
        kp[:, :, 1] = np.trunc(kp_img[:, 1])
        kp[:, :, 2] = 0.9
        return kp, np.tile(valid, (b, 1))

    return fn


def oracle_detections_at(scene, t, max_det=128, drop=()):
    """Perfect single-frame detection arrays for scene frame ``t``: (boxes
    (max_det, 4) float32, conf (max_det,) float32, cls (max_det,) int32,
    valid (max_det,) bool) -- every player not in ``drop`` (class 0,
    confidence 0.9), then the ball (class 2, 0.8), front-compacted."""
    boxes = np.zeros((max_det, 4), np.float32)
    conf = np.zeros((max_det,), np.float32)
    cls = np.zeros((max_det,), np.int32)
    valid = np.zeros((max_det,), bool)
    slot = 0
    for p in range(scene.player_boxes.shape[1]):
        if p in drop:
            continue
        boxes[slot] = scene.player_boxes[t, p]
        conf[slot] = 0.9
        cls[slot] = 0
        valid[slot] = True
        slot += 1
    bx, by = scene.ball_image[t]
    boxes[slot] = [bx - 5, by - 10, bx + 5, by]
    conf[slot] = 0.8
    cls[slot] = 2
    valid[slot] = True
    return boxes, conf, cls, valid
