"""Host-side frame prescale in C++ (BGR -> packed I420 letterbox), built
with ``g++`` at first use and bound with ``ctypes``.

``prescale.cpp`` is a copy of the JAX package's ``eagle_tpu/native/
prescale.cpp``: byte-identical clones of cv2's BGR->I420 conversion and
INTER_LINEAR plane resize.  The shared library is built into
``build/eagle_tpu_torch/`` at the repository root (git-ignored), never
next to the sources.  There is no fallback: a missing toolchain raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "eagle_tpu_torch")
_PRESCALE_SRC = os.path.join(_DIR, "prescale.cpp")
_PRESCALE_LIB = os.path.join(BUILD_DIR, "libprescale.so")

_lock = threading.Lock()
_prescale_lib = None

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _load_prescale():
    global _prescale_lib
    with _lock:
        if _prescale_lib is not None:
            return _prescale_lib
        if not os.path.exists(_PRESCALE_LIB) or os.path.getmtime(
            _PRESCALE_LIB
        ) < os.path.getmtime(_PRESCALE_SRC):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_PRESCALE_LIB}.{os.getpid()}.tmp"
            # -march=native is safe: the library is built per machine
            r = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
                 "-march=native", _PRESCALE_SRC, "-o", tmp],
                capture_output=True,
                text=True,
            )
            if r.returncode != 0:
                raise RuntimeError(f"building {_PRESCALE_SRC} failed:\n{r.stderr}")
            os.replace(tmp, _PRESCALE_LIB)
        lib = ctypes.CDLL(_PRESCALE_LIB)
        lib.letterbox_i420.restype = None
        lib.letterbox_i420.argtypes = [_u8, _u8] + [ctypes.c_int32] * 12
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
