"""Pyramidal Lucas-Kanade sparse optical flow (cv2 calcOpticalFlowPyrLK
semantics: window 15, maxLevel 2, 10 iterations, eps 0.03).

PyTorch counterpart of ``eagle_tpu/ops/optical_flow.py::lk_flow``, whose
per-level engine the JAX package also runs as the Pallas kernel
``eagle_tpu/ops/pallas_flow2.py::lk_flow_pallas2``.  Here the whole flow
step is the hand-written CUDA kernel ``csrc/lk_flow.cu``:

- :func:`lk_flow` is the flow step.  On CUDA tensors it is one launch of
  the kernel (:func:`lk_flow_cuda`): uint8 frames and points in, tracked
  points and status out; the ROIs, their gray pyramids and the Newton
  steps stay in the block's shared memory.  It raises if the kernel does
  not build or launch.  On CPU tensors it is :func:`lk_flow_plain`.
- :func:`lk_flow_clips` is the flow step of C clips at once (a frame pair
  and K points of each): one launch of the same kernel over a (K, C)
  grid on CUDA tensors, :func:`lk_flow_plain` clip by clip on CPU ones.
- :func:`lk_flow_plain` is the kernel's plain version on any device, a
  transcription of the JAX ``lk_flow``: each point's 192-px gray ROI pair
  and its pyramid (:func:`roi_pyramids`), then the per-point engine
  (:func:`engine_plain`: bilinear sampling as hat-weight products, the ROI
  clamp, the cv2 TERM_CRITERIA_EPS freeze).

Numerical conventions follow OpenCV: cv2-rounded gray, 5-tap Gaussian
pyrDown with reflect-101 borders, Scharr /32 derivatives on the sampled
17x17 patch, bilinear subpixel sampling, the guess carried down the
pyramid with x2 rescaling.  The pyramid values are exact in float32
(multiples of 2^-16 below 256), so any summation order gives the same
pyramid.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from eagle_tpu_torch.native import build_library
from eagle_tpu_torch.ops import launch_counts

# cv2 BGR -> gray coefficients (their float32 values)
_GRAY_W = tuple(float(np.float32(v)) for v in (0.114, 0.587, 0.299))

#: per-point ROI side at full resolution; level-l ROI side = ROI_SIDE / 2**l
ROI_SIDE = 192


def bgr_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (..., 3) -> float32 gray (...), rounded to integers.

    The dot product rounds like the JAX package's float32 ``x @ w`` on the
    CPU, a fused multiply-add chain ``fma(r, w2, fma(g, w1, b * w0))``:
    each step is computed exactly in float64 (8-bit values times float32
    weights) and rounded once to float32, so the gray is bit-equal on
    every device."""
    x = frames.to(torch.float64)
    acc = (x[..., 0] * _GRAY_W[0]).to(torch.float32).to(torch.float64)
    acc = (acc + x[..., 1] * _GRAY_W[1]).to(torch.float32).to(torch.float64)
    acc = (acc + x[..., 2] * _GRAY_W[2]).to(torch.float32)
    return torch.round(acc)


def pyr_down(img: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """cv2.pyrDown of (K, H, W): 5-tap [1,4,6,4,1]/16 Gaussian with
    reflect-101 borders, stride-2 decimation, output ((H+1)//2, (W+1)//2),
    written into ``out`` when given."""

    def one_axis(x, dim, dst=None):
        n = x.shape[dim]
        size = (n + 1) // 2
        pad = [0, 0, 0, 0]
        pad[2 * (x.dim() - 1 - dim) if dim != 0 else 0] = 2
        pad[2 * (x.dim() - 1 - dim) + 1 if dim != 0 else 1] = 2
        xp = F.pad(x, pad[: 2 * (x.dim() - 1)], mode="reflect")
        taps = [xp.narrow(dim, t, 2 * size - 1)[(slice(None),) * dim + (slice(None, None, 2),)]
                for t in range(5)]
        acc = taps[0] + 4.0 * taps[1] + 6.0 * taps[2] + 4.0 * taps[3] + taps[4]
        return torch.div(acc, 16.0, out=dst)

    return one_axis(one_axis(img, 2), 1, out)


def roi_origins(pts: torch.Tensor, h: int, w: int, side: int, levels: int) -> torch.Tensor:
    """(K, 2) int64 ROI origins (x, y): centred on the point, clipped
    inside the frame, aligned down to a multiple of 2**levels."""
    factor = 2**levels

    def align(v, limit):
        a = torch.clamp(v - side // 2, 0, max(0, limit - side))
        return (a // factor) * factor

    fl = torch.floor(pts).to(torch.int64)
    return torch.stack([align(fl[:, 0], w), align(fl[:, 1], h)], dim=-1)


def level_sizes(side: int, levels: int) -> list[int]:
    """ROI side of each pyramid level, finest first."""
    sizes = [side]
    for _ in range(levels):
        sizes.append((sizes[-1] + 1) // 2)
    return sizes


def pyramid_levels(pyr: torch.Tensor, k: int, side: int, levels: int) -> list[torch.Tensor]:
    """Views of a packed pyramid (:func:`roi_pyramids`): level l is the
    (2, K, s_l, s_l) block [prev ROIs; curr ROIs] that follows the blocks
    of the finer levels."""
    views, off = [], 0
    for s in level_sizes(side, levels):
        n = 2 * k * s * s
        views.append(pyr[off : off + n].view(2, k, s, s))
        off += n
    return views


def roi_pyramids(
    prev_bgr: torch.Tensor, curr_bgr: torch.Tensor, origin: torch.Tensor, side: int, levels: int
) -> torch.Tensor:
    """Gray ROI pair (K, side, side) at the shared origins and their
    ``levels`` pyrDown levels, written straight into one flat float32
    tensor in the layout :func:`engine_plain` reads (see
    :func:`pyramid_levels`)."""
    k = origin.shape[0]
    gray = torch.stack([bgr_to_gray(prev_bgr), bgr_to_gray(curr_bgr)])  # (2, H, W)
    h, w = gray.shape[1:]
    sizes = level_sizes(side, levels)
    pyr = torch.empty(2 * k * sum(s * s for s in sizes), dtype=torch.float32, device=gray.device)
    views = pyramid_levels(pyr, k, side, levels)
    ar = torch.arange(side, device=gray.device)
    rows = origin[:, 1, None] + ar[None, :]  # (K, side)
    cols = origin[:, 0, None] + ar[None, :]
    idx = (rows[:, :, None] * w + cols[:, None, :]).reshape(-1)
    torch.index_select(gray.reshape(2, h * w), 1, idx, out=views[0].view(2, -1))
    for lvl in range(levels):
        s, s_next = sizes[lvl], sizes[lvl + 1]
        pyr_down(views[lvl].view(2 * k, s, s), out=views[lvl + 1].view(2 * k, s_next, s_next))
    return pyr


def _interp_weights(start: torch.Tensor, taps: int, size: int) -> torch.Tensor:
    """(K,) continuous start positions -> (K, taps, size) linear
    interpolation (hat-function) weights, edge-clamped."""
    ar = torch.arange(taps, dtype=torch.float32, device=start.device)
    pos = torch.clamp(start[:, None] + ar[None, :], 0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=start.device)
    return torch.clamp(1.0 - torch.abs(pos[:, :, None] - grid[None, None, :]), min=0.0)


def _sample_patches(rois: torch.Tensor, tl: torch.Tensor, taps: int) -> torch.Tensor:
    """Bilinear-sample (K, taps, taps) patches at continuous in-ROI
    top-left positions ``tl`` (K, 2) (rows first, then columns)."""
    size = rois.shape[-1]
    wy = _interp_weights(tl[:, 1], taps, size)
    wx = _interp_weights(tl[:, 0], taps, size)
    tmp = torch.einsum("kir,krc->kic", wy, rois)
    return torch.einsum("kic,kjc->kij", tmp, wx)


def _patch_grads(p_ext: torch.Tensor, window: int):
    """(K, ext, ext) patches -> interior values + Scharr gradients, in the
    JAX package's summation order."""
    sm = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)
    dv = (-0.5, 0.0, 0.5)

    def sep(k1, axis1, k2, axis2):
        out = 0.0
        for a in range(3):
            row = 0.0
            for b in range(3):
                sl = [slice(None), slice(1, -1), slice(1, -1)]
                sl[1 + axis1] = slice(a, a + window)
                sl[1 + axis2] = slice(b, b + window)
                row = row + k2[b] * p_ext[tuple(sl)]
            out = out + k1[a] * row
        return out

    return p_ext[:, 1:-1, 1:-1], sep(sm, 0, dv, 1), sep(dv, 0, sm, 1)


def engine_plain(pyr, origin, pts, side, levels, window=15, iterations=10, epsilon=0.03, record=None):
    """Plain per-level engine on a packed pyramid (:func:`roi_pyramids`):
    returns (g (K, 2), ok (K,) bool = det > 1e-6 at every level).
    ``record``, when a list, receives ``(level, "prev", top_left, None)``
    for each previous patch and ``(level, "curr", top_left, live)`` for
    each Newton iteration's current patch (in-ROI (K, 2) x, y positions;
    ``live`` marks the points that take the step): the pyramid taps and the
    work this input needs, for roofline bounds."""
    k = pts.shape[0]
    views = pyramid_levels(pyr, k, side, levels)
    half = (window - 1) / 2.0
    ext = window + 2
    origin_f = origin.to(torch.float32)
    g = pts / (2.0**levels)
    ok = torch.ones(k, dtype=torch.bool, device=pts.device)
    eps_sq = torch.tensor(epsilon, dtype=torch.float32) ** 2
    for lvl in range(levels, -1, -1):
        if lvl < levels:
            g = g * 2.0
        o_lvl = origin_f / (2.0**lvl)
        p_lvl = pts / (2.0**lvl)

        prev_tl = p_lvl - o_lvl - (half + 1.0)
        if record is not None:
            record.append((lvl, "prev", prev_tl, None))
        p_ext = _sample_patches(views[lvl][0], prev_tl, ext)
        patch_i, gx, gy = _patch_grads(p_ext, window)
        g11 = torch.sum(gx * gx, dim=(1, 2))
        g12 = torch.sum(gx * gy, dim=(1, 2))
        g22 = torch.sum(gy * gy, dim=(1, 2))
        det = g11 * g22 - g12 * g12
        invertible = det > 1e-6
        safe_det = torch.where(invertible, det, torch.ones_like(det))

        curr_lvl = views[lvl][1]
        done = torch.zeros(k, dtype=torch.bool, device=pts.device)
        for _ in range(iterations):
            curr_tl = g - o_lvl - half
            patch_j = _sample_patches(curr_lvl, curr_tl, window)
            diff = patch_j - patch_i
            b1 = torch.sum(diff * gx, dim=(1, 2))
            b2 = torch.sum(diff * gy, dim=(1, 2))
            dx = -(g22 * b1 - g12 * b2) / safe_det
            dy = -(-g12 * b1 + g11 * b2) / safe_det
            live = invertible & ~done
            if record is not None:
                record.append((lvl, "curr", curr_tl, live))
            step = torch.where(live[:, None], torch.stack([dx, dy], -1), torch.zeros_like(g))
            # cv2 TERM_CRITERIA_EPS: apply the step, then stop iterating once
            # its squared norm falls below epsilon^2
            done = done | (torch.sum(step * step, dim=-1) <= eps_sq.to(step.device))
            g = g + step
        ok = ok & invertible
    return g, ok


def roi_side(h: int, w: int) -> int:
    """Full-resolution ROI side for an (h, w) frame."""
    return min(ROI_SIDE, h - h % 4, w - w % 4)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/lk_flow.cu), built with nvcc at first use
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CU_SRC = os.path.join(_PKG, "csrc", "lk_flow.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "eagle_tpu_torch")
_CU_LIB = os.path.join(BUILD_DIR, "liblk_flow.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no a*b+c contraction: the sampling, Scharr and step arithmetic round
    # like the plain version's separate operations
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_build_lock = threading.Lock()
_lib = None
#: the kernel's launches count in :mod:`launch_counts` as ``"lk_flow"``,
#: with details by point count K (``"lk_flow/k=57"``: 57 keypoints, 240
#: corners) and by clips C and points K (``"lk_flow/C=1,K=57"``: C = 1 for
#: :func:`lk_flow`, the batch for :func:`lk_flow_clips`); the frames copied
#: into a pitched buffer before a launch (:func:`_pitched`) as
#: ``"lk_flow/staged"``


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build(verbose: bool = False) -> str:
    """Compile ``csrc/lk_flow.cu`` for sm_90a into the build directory
    (when missing or older than the source; under the build directory's
    file lock, see :func:`eagle_tpu_torch.native.build_library`) and return
    the library path; raises with the compiler's output on failure."""
    out = build_library(
        _CU_LIB,
        _CU_SRC,
        lambda tmp: [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, _CU_SRC],
    )
    if verbose and out:
        print(out)
    return _CU_LIB


def _load():
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.lk_flow_smem_bytes.restype = ctypes.c_int
            lib.lk_flow_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.lk_flow_fused_launch.restype = ctypes.c_int
            lib.lk_flow_fused_launch.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
                + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
            )
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"lk_flow kernel: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def _check_frame(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    """A uint8 (H, W, 3) frame whose rows are dense (strides (pitch, 3, 1)
    with pitch >= 3W): contiguous, or a view of a row-padded buffer."""
    dense = t.dim() == 3 and t.stride(2) == 1 and t.stride(1) == 3 and t.stride(0) >= 3 * t.shape[1]
    if t.device != device or t.dtype != torch.uint8 or tuple(t.shape) != shape or not dense:
        raise ValueError(
            f"lk_flow kernel: {name} must be a uint8 tensor of shape {shape} with dense rows on "
            f"{device}; got {t.dtype} {tuple(t.shape)} with strides {t.stride()} on {t.device}"
        )


#: the C function's own error codes (csrc/lk_flow.cu), beside cudaError_t
_ERR_NO_ENCODE, _ERR_SMEM, _ERR_ENCODE = -1, -2, -1000


def _pitch(w: int) -> int:
    """A frame row's 3W bytes rounded up to the 16 bytes TMA needs."""
    return -(-3 * w // 16) * 16


def alloc_frames(n: int, h: int, w: int, device) -> torch.Tensor:
    """An uninitialised (N, H, W, 3) uint8 frame buffer on ``device``.  On
    a CUDA device its rows are padded to :func:`_pitch` bytes when 3W is
    not a multiple of 16 (the (N, H, W, 3) view of an (N, H, pitch) buffer
    is returned), so that the kernel reads every frame in place
    (:func:`_pitched`) instead of staging a copy each flow step."""
    dev = torch.device(device)
    if dev.type != "cuda" or (3 * w) % 16 == 0:
        return torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    buf = torch.empty((n, h, _pitch(w)), dtype=torch.uint8, device=dev)
    return buf[:, :, : 3 * w].view(n, h, w, 3)


def upload_frames(frames: np.ndarray, device) -> torch.Tensor:
    """(N, H, W, 3) uint8 host frames on ``device``, in the layout of
    :func:`alloc_frames`."""
    x = torch.from_numpy(np.ascontiguousarray(frames))
    n, h, w, _ = x.shape
    if torch.device(device).type != "cuda" or (3 * w) % 16 == 0:
        return x.to(device)
    out = alloc_frames(n, h, w, device)
    out.copy_(x)
    return out


def carry_frame(frame: torch.Tensor) -> torch.Tensor:
    """A copy of an (H, W, 3) uint8 frame in a buffer of its own with the
    frame's row stride.  A frame kept after its clip's buffer is dropped
    (the previous frame a stream hands to its next block) is then read in
    place as that buffer's frames were (:func:`_pitched`), and the buffer
    itself can be freed."""
    h, w, _ = frame.shape
    buf = torch.empty((h, frame.stride(0)), dtype=torch.uint8, device=frame.device)
    rows = buf[:, : 3 * w].view(h, w, 3)
    rows.copy_(frame)
    return rows


def _pitched(frame: torch.Tensor, pitch: int | None = None) -> tuple[torch.Tensor, int]:
    """(rows, pitch): the (H, W, 3) uint8 frame itself when its row stride
    and base address are multiples of 16 bytes (a contiguous frame whose 3W
    is, or a frame of :func:`upload_frames` or :func:`carry_frame`) and the
    stride is ``pitch`` where one is asked for; else a copy in a fresh
    (H, pitch) buffer, ``pitch`` defaulting to :func:`_pitch` (the
    allocator's blocks are 512-byte aligned), counted as ``"lk_flow/staged"``."""
    h, w = frame.shape[:2]
    stride = frame.stride(0)
    if stride % 16 == 0 and frame.data_ptr() % 16 == 0 and pitch in (None, stride):
        return frame, stride
    launch_counts.add(frame.device, "lk_flow/staged")
    pitch = pitch or _pitch(w)
    rows = torch.empty((h, pitch), dtype=torch.uint8, device=frame.device)
    rows[:, : 3 * w].view(h, w, 3).copy_(frame)
    return rows, pitch


def _check_flow_args(levels: int, window: int) -> None:
    if not 0 <= levels <= 3:
        raise ValueError(f"lk_flow kernel supports 0-3 pyramid levels above the base, got {levels}")
    if window % 2 != 1 or window > 31:
        raise ValueError(f"lk_flow kernel needs an odd window of at most 31, got {window}")


def _launch(prev, curr, h, w, pitch, clip_stride, clips, pts, valid, out_g, status, levels, window, iterations,
            epsilon) -> None:
    """One launch of the kernel over ``clips`` frame pairs and their K
    points (the wrappers checked every argument); raises on a refused
    launch, else counts it."""
    k = pts.shape[-2]
    side = roi_side(h, w)
    lib = _load()
    dev = pts.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lk_flow_fused_launch(
            prev.data_ptr(), curr.data_ptr(), h, w, pitch, clip_stride, clips, pts.data_ptr(), valid.data_ptr(),
            out_g.data_ptr(), status.data_ptr(), k, side, levels, window, iterations, float(epsilon), stream,
        )
    if err == _ERR_SMEM:
        raise ValueError(
            f"lk_flow kernel: side {side}, window {window} needs "
            f"{lib.lk_flow_smem_bytes(side, levels, window)} B of shared memory a block, more than the card allows"
        )
    if err != 0:
        what = "cuTensorMapEncodeTiled is not available from libcuda" if err == _ERR_NO_ENCODE else (
            f"tensor map refused, CUresult {_ERR_ENCODE - err}" if err <= _ERR_ENCODE else f"cudaError {err}"
        )
        raise RuntimeError(f"lk_flow kernel launch failed: {what}")
    launch_counts.add(dev, "lk_flow", f"lk_flow/k={k}", f"lk_flow/C={clips},K={k}")


def lk_flow_cuda(
    prev_bgr: torch.Tensor,
    curr_bgr: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 15,
    levels: int = 2,
    iterations: int = 10,
    epsilon: float = 0.03,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The flow step as one launch of the CUDA kernel: (new_pts (K, 2)
    float32, status (K,) bool), as :func:`lk_flow_plain` computes them.
    Takes CUDA tensors: two (H, W, 3) uint8 frames with dense rows
    (contiguous, or views of a row-padded buffer), contiguous ``pts``
    (K, 2) float32 and ``valid`` (K,) bool; raises ``ValueError`` on
    anything else, before launching.  TMA needs 16-byte aligned rows of one
    stride: a frame whose row stride or base address is not a multiple of
    16 bytes (or whose stride differs from the other frame's) is first
    copied into a buffer with rows padded to the next multiple of 16
    (:func:`_pitched`); frames of :func:`upload_frames` need no copy.  The
    kernel's tensor map takes the row stride."""
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"lk_flow kernel needs CUDA tensors, got {dev}")
    if prev_bgr.dim() != 3:
        raise ValueError(f"lk_flow kernel: frames must be (H, W, 3), got {tuple(prev_bgr.shape)}")
    h, w = prev_bgr.shape[:2]
    k = pts.shape[0] if pts.dim() else 0
    _check_frame(prev_bgr, "prev_bgr", (h, w, 3), dev)
    _check_frame(curr_bgr, "curr_bgr", (h, w, 3), dev)
    _check(pts, "pts", torch.float32, (k, 2), dev)
    _check(valid, "valid", torch.bool, (k,), dev)
    _check_flow_args(levels, window)
    prev_rows, pitch = _pitched(prev_bgr)
    curr_rows, _ = _pitched(curr_bgr, pitch)
    out_g = torch.empty((k, 2), dtype=torch.float32, device=dev)
    status = torch.empty((k,), dtype=torch.bool, device=dev)
    if k:
        _launch(prev_rows, curr_rows, h, w, pitch, h * pitch, 1, pts, valid, out_g, status, levels, window,
                iterations, epsilon)
    return out_g, status


def lk_flow_clips_cuda(
    prev_bgr: torch.Tensor,
    curr_bgr: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 15,
    levels: int = 2,
    iterations: int = 10,
    epsilon: float = 0.03,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The flow step of C clips as one launch of the CUDA kernel over a
    (K, C) grid: (new_pts (C, K, 2) float32, status (C, K) bool), clip c's
    rows exactly what :func:`lk_flow_cuda` gives for its pair.  Takes CUDA
    tensors: frames (C, H, W, 3) uint8 whose rows are dense and 16-byte
    aligned, with strides (clip stride, pitch, 3, 1), the pitch and the
    clip stride multiples of 16 and the same in both (frame t of every clip
    of one :func:`alloc_frames` buffer of C clips of L frames, viewed as
    (C, L, H, W, 3), is such a tensor); contiguous ``pts`` (C, K, 2)
    float32 and ``valid`` (C, K) bool.  Raises ``ValueError`` on anything
    else, before launching: nothing is staged."""
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"lk_flow kernel needs CUDA tensors, got {dev}")
    if prev_bgr.dim() != 4 or prev_bgr.shape[-1] != 3:
        raise ValueError(f"lk_flow_clips: frames must be (C, H, W, 3), got {tuple(prev_bgr.shape)}")
    c, h, w, _ = prev_bgr.shape
    k = pts.shape[1] if pts.dim() == 3 else 0
    _check(pts, "pts", torch.float32, (c, k, 2), dev)
    _check(valid, "valid", torch.bool, (c, k), dev)
    _check_flow_args(levels, window)
    cs, pitch = prev_bgr.stride(0), prev_bgr.stride(1)
    for name, t in (("prev_bgr", prev_bgr), ("curr_bgr", curr_bgr)):
        if (
            t.device != dev or t.dtype != torch.uint8 or tuple(t.shape) != (c, h, w, 3)
            or t.stride() != (cs, pitch, 3, 1) or pitch % 16 or pitch < 3 * w or t.data_ptr() % 16
            or (c > 1 and (cs % 16 or cs < h * pitch))
        ):
            raise ValueError(
                f"lk_flow_clips: {name} must be a uint8 (C, H, W, 3) = {(c, h, w, 3)} tensor on {dev} with "
                f"strides (clip stride, pitch, 3, 1), pitch and clip stride multiples of 16 (clip stride >= H "
                f"* pitch), a 16-byte aligned base, and the strides of prev_bgr {(cs, pitch, 3, 1)}; got "
                f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device} at {t.data_ptr() % 16} mod 16"
            )
    out_g = torch.empty((c, k, 2), dtype=torch.float32, device=dev)
    status = torch.empty((c, k), dtype=torch.bool, device=dev)
    if c and k:
        _launch(prev_bgr, curr_bgr, h, w, pitch, cs, c, pts, valid, out_g, status, levels, window, iterations,
                epsilon)
    return out_g, status


# ---------------------------------------------------------------------------
# the flow step
# ---------------------------------------------------------------------------


def lk_flow(
    prev_bgr: torch.Tensor,
    curr_bgr: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 15,
    levels: int = 2,
    iterations: int = 10,
    epsilon: float = 0.03,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track ``pts`` (K, 2) from ``prev_bgr`` to ``curr_bgr`` ((H, W, 3)
    uint8).  Returns (new_pts (K, 2), status (K,)): one launch of the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = lk_flow_cuda if pts.device.type == "cuda" else lk_flow_plain
    return fn(prev_bgr, curr_bgr, pts, valid, window, levels, iterations, epsilon)


def lk_flow_plain(
    prev_bgr: torch.Tensor,
    curr_bgr: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 15,
    levels: int = 2,
    iterations: int = 10,
    epsilon: float = 0.03,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version, on any device: the ROI
    pyramids (:func:`roi_pyramids`), then :func:`engine_plain` and the
    inside test."""
    h, w, _ = prev_bgr.shape
    side = roi_side(h, w)
    origin = roi_origins(pts, h, w, side, levels)
    pyr = roi_pyramids(prev_bgr, curr_bgr, origin, side, levels)
    g, ok = engine_plain(pyr, origin, pts, side, levels, window, iterations, epsilon)
    inside = (g[:, 0] >= 0) & (g[:, 0] <= w - 1) & (g[:, 1] >= 0) & (g[:, 1] <= h - 1)
    return g, ok & inside & valid


def lk_flow_clips(
    prev_bgr: torch.Tensor,
    curr_bgr: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 15,
    levels: int = 2,
    iterations: int = 10,
    epsilon: float = 0.03,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track ``pts`` (C, K, 2) from ``prev_bgr`` to ``curr_bgr`` ((C, H, W,
    3) uint8), clip by clip.  Returns (new_pts (C, K, 2), status (C, K)):
    one launch of the CUDA kernel for all C clips for CUDA tensors
    (:func:`lk_flow_clips_cuda`), :func:`lk_flow_plain` on each clip for
    CPU tensors."""
    if pts.device.type == "cuda":
        return lk_flow_clips_cuda(prev_bgr, curr_bgr, pts, valid, window, levels, iterations, epsilon)
    outs = [lk_flow_plain(p, c, q, v, window, levels, iterations, epsilon)
            for p, c, q, v in zip(prev_bgr, curr_bgr, pts, valid)]
    return torch.stack([g for g, _ in outs]), torch.stack([s for _, s in outs])
