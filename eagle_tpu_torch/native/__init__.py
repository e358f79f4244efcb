"""Host-side C++ (``prescale.cpp``), built with ``g++`` at first use and
bound with ``ctypes``: the BGR -> packed I420 letterbox and the team-vote
crop resize.

``prescale.cpp`` started as a copy of the JAX package's ``eagle_tpu/
native/prescale.cpp`` (byte-identical clones of cv2's BGR->I420
conversion and INTER_LINEAR plane resize) and adds the 3-channel crop
resize that stands in for ``cv2.resize`` in the team votes.  The shared
library is built into ``build/eagle_tpu_torch/`` at the repository root
(git-ignored), never next to the sources.  Builds hold a file lock, so
concurrent processes build a library once and never load a half-written
one.  There is no fallback: a missing toolchain raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Callable

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "eagle_tpu_torch")
_PRESCALE_SRC = os.path.join(_DIR, "prescale.cpp")
_PRESCALE_LIB = os.path.join(BUILD_DIR, "libprescale.so")

_lock = threading.Lock()
_prescale_lib = None

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


@contextlib.contextmanager
def _file_lock(path: str):
    """Exclusive inter-process lock on ``path`` (created if missing)."""
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_library(lib: str, src: str, command: Callable[[str], list[str]]) -> str:
    """Build ``lib`` from ``src`` unless it exists and is newer than the
    source.  ``command(out_path)`` is the compiler's argument list.  The
    check and the build run under a file lock beside ``lib``, and the
    compiler writes a temporary file that is renamed into place, so
    concurrent processes and threads build once and never see a partial
    library.  Returns the compiler's output ('' when nothing was built);
    raises with it when the compiler fails."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with _file_lock(f"{lib}.lock"):
        if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
            return ""
        tmp = f"{lib}.{os.getpid()}.tmp"
        r = subprocess.run(command(tmp), capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, lib)
        return r.stdout + r.stderr


def _load_prescale():
    global _prescale_lib
    with _lock:
        if _prescale_lib is not None:
            return _prescale_lib
        # -march=native is safe: the library is built per machine
        build_library(
            _PRESCALE_LIB,
            _PRESCALE_SRC,
            lambda out: ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
                         "-march=native", _PRESCALE_SRC, "-o", out],
        )
        lib = ctypes.CDLL(_PRESCALE_LIB)
        lib.letterbox_i420.restype = None
        lib.letterbox_i420.argtypes = [_u8, _u8] + [ctypes.c_int32] * 12
        lib.crops_linear_u8c3.restype = None
        lib.crops_linear_u8c3.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, _i32, _i32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8, ctypes.c_int32,
        ]
        _prescale_lib = lib
        return lib


def _default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def letterbox_i420(
    frames_bgr: np.ndarray,
    geom,
    y_pad: int,
    uv_pad: int,
    threads: int | None = None,
) -> np.ndarray:
    """Fused convert + letterbox: BGR uint8 (N, H, W, 3) -> packed I420
    working canvas (N, canvas_h*3/2, canvas_w), byte-identical to cv2's
    convert-then-resize composition under the gate the caller checks
    (downscale, img_w % 32 == 0 -- see prescale.cpp for why the tail
    rounding needs 16-wide rows)."""
    lib = _load_prescale()
    frames_bgr = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    n, h, w, c = frames_bgr.shape
    assert c == 3
    out = np.empty((n, geom.canvas_h * 3 // 2, geom.canvas_w), np.uint8)
    lib.letterbox_i420(
        frames_bgr,
        out,
        n,
        h,
        w,
        geom.img_h,
        geom.img_w,
        geom.pad_y,
        geom.pad_x,
        geom.canvas_h,
        geom.canvas_w,
        y_pad,
        uv_pad,
        threads or _default_threads(),
    )
    return out


def crops_linear_u8c3(frames, frame_idx: np.ndarray, boxes: np.ndarray, grid_hw) -> np.ndarray:
    """Integer-box crops resized to ``grid_hw`` (gh, gw) exactly as
    ``cv2.resize(frame[y1:y2, x1:x2], (gw, gh), INTER_LINEAR)`` gives them:
    ``frames`` a sequence (or (F, H, W, 3) stack) of equal-size uint8 BGR
    frames, ``frame_idx`` (B,), ``boxes`` (B, 4) integer x1, y1, x2, y2
    inside the frame with x2 > x1, y2 > y1.  Returns (B, gh, gw, 3)
    uint8."""
    lib = _load_prescale()
    gh, gw = grid_hw
    fi = np.ascontiguousarray(frame_idx, np.int32)
    ib = np.ascontiguousarray(boxes, np.int32).reshape(-1, 4)
    first = np.asarray(frames[0])
    h, w = first.shape[:2]
    if not (
        ((ib[:, 0] >= 0) & (ib[:, 1] >= 0) & (ib[:, 2] <= w) & (ib[:, 3] <= h)).all()
        and ((ib[:, 2] > ib[:, 0]) & (ib[:, 3] > ib[:, 1])).all()
        and len(fi) == len(ib)
        and (fi >= 0).all()
    ):
        raise ValueError("crops_linear_u8c3 needs one frame index >= 0 and one non-empty box inside the frame a crop")
    # only the frames a crop reads are made contiguous; `used` keeps them alive
    used = {int(f): np.ascontiguousarray(frames[int(f)], np.uint8) for f in np.unique(fi)}
    for f in used.values():
        if f.shape != (h, w, 3):
            raise ValueError(f"crops_linear_u8c3 needs (H, W, 3) frames of one size, got {f.shape}")
    ptrs = (ctypes.c_void_p * (int(fi.max(initial=-1)) + 1))()
    for i, f in used.items():
        ptrs[i] = f.ctypes.data
    out = np.empty((len(ib), gh, gw, 3), np.uint8)
    if len(ib):
        lib.crops_linear_u8c3(ptrs, w, fi, ib, len(ib), gh, gw, out, _default_threads())
    return out
