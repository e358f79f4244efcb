"""Host-side C++, built with ``g++`` at first use and bound with
``ctypes``: ``prescale.cpp`` (the BGR -> packed I420 conversion, the
letterboxes onto the working canvas (4:2:0 planes or BGR, any geometry),
and the team-vote crop resize) and ``lapjv.cpp`` (the float64
Jonker-Volgenant solver, :func:`lapjv`, a copy of the JAX package's
``eagle_tpu/native/lapjv.cpp``: the optimum oracle of the card's float32
solver and an offline solver).

``prescale.cpp`` started as a copy of the JAX package's ``eagle_tpu/
native/prescale.cpp`` (byte-identical clones of cv2's BGR->I420
conversion and INTER_LINEAR plane resize) and adds a general
``cv2.resize`` INTER_LINEAR clone (any scale, 1 or 3 channels) behind the
team-vote crops and the letterboxes outside the fused kernel's envelope.  The shared
libraries are built into ``build/eagle_tpu_torch/`` at the repository root
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
_LAPJV_SRC = os.path.join(_DIR, "lapjv.cpp")
_LAPJV_LIB = os.path.join(BUILD_DIR, "liblapjv.so")

_lock = threading.Lock()
_prescale_lib = None
_lapjv_lib = None

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


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


def prescale_available() -> bool:
    """Whether the native prescale library builds and loads here (the JAX
    package's ``prescale_available``); the prescale paths themselves raise
    when it does not."""
    try:
        _load_prescale()
    except (OSError, RuntimeError):
        return False
    return True


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
        lib.letterbox_i420_general.restype = None
        lib.letterbox_i420_general.argtypes = [_u8, _u8] + [ctypes.c_int32] * 12
        lib.letterbox_bgr.restype = None
        lib.letterbox_bgr.argtypes = [_u8, _u8] + [ctypes.c_int32] * 11
        lib.bgr_to_i420.restype = None
        lib.bgr_to_i420.argtypes = [_u8, _u8] + [ctypes.c_int32] * 4
        lib.crops_linear_u8c3.restype = None
        lib.crops_linear_u8c3.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, _i32, _i32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8, ctypes.c_int32,
        ]
        _prescale_lib = lib
        return lib


def _load_lapjv():
    global _lapjv_lib
    with _lock:
        if _lapjv_lib is not None:
            return _lapjv_lib
        build_library(
            _LAPJV_LIB,
            _LAPJV_SRC,
            lambda out: ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _LAPJV_SRC, "-o", out],
        )
        lib = ctypes.CDLL(_LAPJV_LIB)
        lib.lapjv_solve.restype = ctypes.c_double
        lib.lapjv_solve.argtypes = [ctypes.c_int32, _f64, _i32]
        lib.lapjv_solve_batch.restype = None
        lib.lapjv_solve_batch.argtypes = [ctypes.c_int32, ctypes.c_int32, _f64, _i32, _f64]
        _lapjv_lib = lib
        return lib


def lapjv_available() -> bool:
    """Whether the host JV solver builds and loads here (``g++``)."""
    try:
        _load_lapjv()
    except (OSError, RuntimeError):
        return False
    return True


def _host_f64(costs) -> np.ndarray:
    """A contiguous float64 host copy of an array or tensor."""
    if hasattr(costs, "detach"):
        costs = costs.detach().cpu().numpy()
    return np.ascontiguousarray(costs, dtype=np.float64)


def lapjv(cost) -> tuple[np.ndarray, float]:
    """Minimum-cost perfect matching of a square (n, n) matrix (array or
    tensor) in float64 on the host: (row_to_col (n,) int32, total cost).
    Raises ``RuntimeError`` when the library does not build."""
    lib = _load_lapjv()
    cost = _host_f64(cost)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"lapjv takes a square matrix, got {cost.shape}")
    out = np.empty(n, dtype=np.int32)
    total = lib.lapjv_solve(n, cost, out)
    return out, float(total)


def lapjv_batch(costs) -> tuple[np.ndarray, np.ndarray]:
    """m independent square problems: (m, n, n) -> (row_to_col (m, n)
    int32, totals (m,) float64)."""
    lib = _load_lapjv()
    costs = _host_f64(costs)
    if costs.ndim != 3 or costs.shape[1] != costs.shape[2]:
        raise ValueError(f"lapjv_batch takes (m, n, n) matrices, got {costs.shape}")
    m, n, _ = costs.shape
    out = np.empty((m, n), dtype=np.int32)
    totals = np.empty(m, dtype=np.float64)
    lib.lapjv_solve_batch(m, n, costs, out, totals)
    return out, totals


def _default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def letterbox_i420(
    frames_bgr: np.ndarray,
    geom,
    y_pad: int,
    uv_pad: int,
    threads: int | None = None,
    general: bool = False,
) -> np.ndarray:
    """Convert + letterbox: BGR uint8 (N, H, W, 3) -> packed I420 working
    canvas (N, canvas_h*3/2, canvas_w), byte-identical to cv2's
    convert-then-resize composition.  The fused kernel needs the gate the
    caller checks (downscale, img_w % 32 == 0 -- see prescale.cpp for why
    the tail rounding needs 16-wide rows); ``general=True`` runs the
    unfused one, which takes any geometry with the 4:2:0 placement
    parity."""
    lib = _load_prescale()
    frames_bgr = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    n, h, w, c = frames_bgr.shape
    assert c == 3
    out = np.empty((n, geom.canvas_h * 3 // 2, geom.canvas_w), np.uint8)
    fn = lib.letterbox_i420_general if general else lib.letterbox_i420
    fn(
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


def letterbox_bgr(frames_bgr: np.ndarray, geom, pad: int = 114, threads: int | None = None) -> np.ndarray:
    """BGR uint8 (N, H, W, 3) -> the BGR working canvas (N, canvas_h,
    canvas_w, 3): each frame ``cv2.resize``d (INTER_LINEAR) to img_h x
    img_w at (pad_y, pad_x) on ``pad`` gray, byte-identical to OpenCV, for
    any geometry."""
    lib = _load_prescale()
    frames_bgr = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    n, h, w, _ = frames_bgr.shape
    out = np.empty((n, geom.canvas_h, geom.canvas_w, 3), np.uint8)
    lib.letterbox_bgr(
        frames_bgr, out, n, h, w, geom.img_h, geom.img_w, geom.pad_y, geom.pad_x, geom.canvas_h, geom.canvas_w,
        pad, threads or _default_threads(),
    )
    return out


def bgr_to_i420(frames_bgr: np.ndarray, threads: int | None = None) -> np.ndarray:
    """BGR uint8 (N, H, W, 3) -> packed I420 planes (N, H*3/2, W),
    byte-identical to ``cv2.cvtColor(COLOR_BGR2YUV_I420)`` (even H, W)."""
    lib = _load_prescale()
    frames_bgr = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    n, h, w, _ = frames_bgr.shape
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    lib.bgr_to_i420(frames_bgr, out, n, h, w, threads or _default_threads())
    return out


#: frames a crop call holds at once (:func:`crops_linear_u8c3`)
CROP_FRAME_GROUP = 64


def crops_linear_u8c3(frames, frame_idx: np.ndarray, boxes: np.ndarray, grid_hw) -> np.ndarray:
    """Integer-box crops resized to ``grid_hw`` (gh, gw) exactly as
    ``cv2.resize(frame[y1:y2, x1:x2], (gw, gh), INTER_LINEAR)`` gives them:
    ``frames`` a sequence (or (F, H, W, 3) stack) of equal-size uint8 BGR
    frames, ``frame_idx`` (B,), ``boxes`` (B, 4) integer x1, y1, x2, y2
    inside the frame with x2 > x1, y2 > y1.  Returns (B, gh, gw, 3)
    uint8.

    The frames the crops read are taken in ascending order, at most
    ``CROP_FRAME_GROUP`` of them alive at a time, so a lazy frame source
    over a whole match (:class:`eagle_tpu_torch.io.video.VideoFrameSource`)
    decodes forward and holds one group."""
    lib = _load_prescale()
    gh, gw = grid_hw
    fi = np.ascontiguousarray(frame_idx, np.int32)
    ib = np.ascontiguousarray(boxes, np.int32).reshape(-1, 4)
    first = np.asarray(frames[int(fi.min()) if len(fi) else 0])  # the first frame read: no step back
    h, w = first.shape[:2]
    if not (
        ((ib[:, 0] >= 0) & (ib[:, 1] >= 0) & (ib[:, 2] <= w) & (ib[:, 3] <= h)).all()
        and ((ib[:, 2] > ib[:, 0]) & (ib[:, 3] > ib[:, 1])).all()
        and len(fi) == len(ib)
        and (fi >= 0).all()
    ):
        raise ValueError("crops_linear_u8c3 needs one frame index >= 0 and one non-empty box inside the frame a crop")
    del first
    out = np.empty((len(ib), gh, gw, 3), np.uint8)
    frame_ids = np.unique(fi)
    for g in range(0, len(frame_ids), CROP_FRAME_GROUP):
        group = frame_ids[g : g + CROP_FRAME_GROUP]
        # only the frames a crop reads are made contiguous; `used` keeps them alive
        used = [np.ascontiguousarray(frames[int(f)], np.uint8) for f in group]
        shapes = {f.shape for f in used} - {(h, w, 3)}
        if shapes:
            raise ValueError(f"crops_linear_u8c3 needs (H, W, 3) frames of one size, got {shapes.pop()}")
        ptrs = (ctypes.c_void_p * len(used))(*(f.ctypes.data for f in used))
        sel = np.flatnonzero((fi >= group[0]) & (fi <= group[-1]))
        local = np.searchsorted(group, fi[sel]).astype(np.int32)
        part = np.empty((len(sel), gh, gw, 3), np.uint8)
        lib.crops_linear_u8c3(ptrs, w, local, np.ascontiguousarray(ib[sel]), len(sel), gh, gw, part, _default_threads())
        out[sel] = part
        del used, ptrs
    return out
