"""Annotated-video rendering, the reference CLI's drawing loop: an ellipse
per player in its team's colour, its id, a triangle over the ball, black
dots on the detected keypoints.  Drawing is OpenCV's; it is imported only
when a frame is drawn."""

from __future__ import annotations

import math

import numpy as np

from eagle_tpu_torch.io.video import require_cv2
from eagle_tpu_torch.pipeline.processor import CORNER_COLS

TEAM_COLORS = {0: (0, 0, 255), 1: (255, 0, 0)}  # BGR: red / blue
GK_COLOR = (0, 255, 0)
BALL_COLOR = (0, 255, 0)


def render_annotated_frames(table, frames, coordinates: dict, team_mapping: dict):
    """Yield an annotated BGR frame for every row of the processed
    :class:`~eagle_tpu_torch.pipeline.processor.Table`."""
    cols = [c for c in table.columns if "video" in c and c not in CORNER_COLS]
    if table.empty:
        return
    cv2 = require_cv2()
    for r, i in enumerate(table.index):
        frame = np.asarray(frames[int(i)]).copy()
        for col in cols:
            val = table[col][r]
            if isinstance(val, float) and math.isnan(val):
                continue
            x, y = val
            if "Ball" in col:
                pts = np.array(
                    [(int(x), int(y) - 20), (int(x) - 5, int(y) - 30), (int(x) + 5, int(y) - 30)]
                ).reshape(-1, 1, 2)
                cv2.drawContours(frame, [pts], 0, BALL_COLOR, -1)
                continue
            oid = int(col.split("_")[1])
            if "Goalkeeper" in col:
                color = GK_COLOR
            else:
                if oid not in team_mapping:
                    continue
                color = TEAM_COLORS[team_mapping[oid]]
            cv2.ellipse(frame, (int(x), int(y)), (35, 18), 0, -45, 235, color, 1)
            cv2.putText(frame, str(oid), (int(x) - 3, int(y)), cv2.FONT_HERSHEY_SIMPLEX, 0.7, color, 2)

        for kx, ky in coordinates[int(i)]["Keypoints"].values():
            cv2.circle(frame, (int(kx), int(ky)), 6, (0, 0, 0), -1)
        yield frame
