"""Video decode and encode on the host, through OpenCV (FFmpeg) as in the
JAX package's ``eagle_tpu/io/video.py`` and the reference.  OpenCV is
imported only inside these functions: the rest of the port runs without
it, from frames in memory.  Frames are BGR uint8.

Whole clips: :func:`read_video_array`.  Whole matches, in bounded memory:
:func:`iter_video` streams the sampled frames in segments (for
``CoordinateModel.stream_coordinates``), and :class:`VideoFrameSource`
decodes them on demand by index (for the Processor's crops and the
annotated render)."""

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
    skip = _sampling(cap, cv2, fps)
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


def _sampling(cap, cv2, fps: int) -> int:
    """Keep every ``native_fps // fps``-th frame, as the reference does."""
    native_fps = cap.get(cv2.CAP_PROP_FPS)
    return max(1, int(native_fps // fps)) if native_fps > 0 else 1


def iter_video(path: str, fps: int = 24, segment_frames: int = 512):
    """Stream ``path`` as (N <= segment_frames, H, W, 3) uint8 BGR segments
    of the frames :func:`read_video_array` keeps, holding at most
    ``segment_frames`` decoded frames at a time."""
    cv2 = require_cv2()
    if not os.path.exists(path):
        raise FileNotFoundError(f"File not found: {path}")
    if segment_frames < 1:
        raise ValueError("segment_frames must be >= 1")
    cap = cv2.VideoCapture(path)
    skip = _sampling(cap, cv2, fps)
    frames = []
    frame_count = 0
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            if frame_count % skip == 0:
                frames.append(frame)
                if len(frames) == segment_frames:
                    yield np.stack(frames)
                    frames = []
            frame_count += 1
    finally:
        cap.release()
    if frames:
        yield np.stack(frames)


class VideoFrameSource:
    """Random access by index to the frames :func:`read_video_array` keeps,
    decoded on demand instead of held in memory.  Indices taken in
    ascending order decode sequentially; a step back reopens the file and
    decodes forward (OpenCV's seeking is codec-dependent and inexact).
    ``source[i]`` equals ``read_video_array(path, fps)[0][i]``.  ``length``
    pins the frame count where the container's count is unreliable (pass
    the count a streamed pass over the file saw)."""

    def __init__(self, path: str, fps: int = 24, length: int | None = None):
        cv2 = require_cv2()
        if not os.path.exists(path):
            raise FileNotFoundError(f"File not found: {path}")
        self.path = path
        cap = cv2.VideoCapture(path)
        self.skip = _sampling(cap, cv2, fps)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        self._len = length if length is not None else max(0, -(-total // self.skip))
        self._cap = None
        self._next_raw = 0  # the raw index the open decoder returns next
        self._cache_idx = -1
        self._cache = None

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        if i == self._cache_idx:
            return self._cache
        target = i * self.skip
        if self._cap is None or target < self._next_raw:
            self.close()
            self._cap = require_cv2().VideoCapture(self.path)
            self._next_raw = 0
        while self._next_raw < target:  # grab() skips the colour conversion
            if not self._cap.grab():
                raise IndexError(f"decode ended before sampled index {i}")
            self._next_raw += 1
        ret, frame = self._cap.read()
        self._next_raw += 1
        if not ret:
            raise IndexError(f"decode ended before sampled index {i}")
        self._cache_idx, self._cache = i, frame
        return frame

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None


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
