"""Video decode and encode on the host, through OpenCV (FFmpeg) as in the
JAX package's ``eagle_tpu/io/video.py`` and the reference.  OpenCV is
imported only inside these functions: the rest of the port runs without
it, from frames in memory.  Frames are BGR uint8."""

from __future__ import annotations

import os

import numpy as np


def require_cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the .mp4 input and output (read_video, write_video, annotated.mp4) need OpenCV "
            "(cv2), which is not installed; the pipeline itself runs on frames in memory without it"
        ) from e
    return cv2


def read_video(path: str, fps: int = 24) -> tuple[list[np.ndarray], int]:
    """Decode ``path`` keeping every ``native_fps // fps``-th frame.
    Returns (frames, fps) with the requested fps, as the reference does."""
    arr, fps = read_video_array(path, fps)
    return list(arr), fps


def read_video_array(path: str, fps: int = 24) -> tuple[np.ndarray, int]:
    """Like :func:`read_video`, stacked: (N, H, W, 3) uint8."""
    cv2 = require_cv2()
    if not os.path.exists(path):
        raise FileNotFoundError(f"File not found: {path}")
    cap = cv2.VideoCapture(path)
    native_fps = cap.get(cv2.CAP_PROP_FPS)
    skip = max(1, int(native_fps // fps)) if native_fps > 0 else 1
    frames = []
    frame_count = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if frame_count % skip == 0:
            frames.append(frame)
        frame_count += 1
    cap.release()
    if not frames:
        return np.zeros((0, 0, 0, 3), dtype=np.uint8), fps
    return np.stack(frames), fps


def write_video(frames, path: str, fps: int = 24, is_rgb: bool = False) -> str:
    """Encode ``frames`` (a list, an (N, H, W, 3) array or an iterable,
    consumed lazily) to mp4 with the mp4v fourcc, as the reference does."""
    cv2 = require_cv2()
    it = iter(frames)
    try:
        first = np.asarray(next(it))
    except StopIteration:
        raise ValueError("write_video needs at least one frame")
    height, width = first.shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))

    def emit(frame):
        frame = np.asarray(frame)
        if is_rgb:
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        out.write(np.ascontiguousarray(frame))

    try:
        emit(first)
        for frame in it:
            emit(frame)
    finally:
        out.release()
    return path
