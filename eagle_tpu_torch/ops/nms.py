"""Class-aware non-maximum suppression with fixed output slots (PyTorch
counterpart of ``eagle_tpu/ops/nms.py``).

Confidence top-K pre-selection (a stable descending sort, so equal
confidences keep the lower anchor first, as ``jax.lax.top_k`` does), greedy
suppression (:func:`suppress`), and compaction of the kept boxes into
score-descending slots.  The tracker's slot order depends on this order.

The suppression is the JAX package's fixed point (a ``lax.while_loop``, one
device program).  On CUDA tensors it is one launch of the hand-written
kernel ``csrc/nms.cu`` at any number of candidates (the overlap bits of
every pair spread over the card, then the fixed point of each image in one
block; no host sync); on CPU tensors it is :func:`suppress_plain`, one
dense IoU block and the loop, whose exit test syncs once a pass.  Both
give the same keep mask, bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from eagle_tpu_torch.native import build_library
from eagle_tpu_torch.ops.optical_flow import BUILD_DIR, NVCC_FLAGS, _nvcc

MAX_WH = 7680.0  # class-separation offset (ultralytics convention)

_CU_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "nms.cu")
_CU_LIB = os.path.join(BUILD_DIR, "libnms.so")
_build_lock = threading.Lock()
_lib = None
#: launches of the NMS kernel (one per :func:`suppress` call on a CUDA tensor)
launches = 0


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def suppress_plain(shifted: torch.Tensor, top_valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The kernel's plain version: greedy suppression of score-sorted
    candidates as a fixed point.  ``shifted`` (B, k, 4) class-offset xyxy
    boxes, ``top_valid`` (B, k) bool; returns keep (B, k) bool."""
    k = shifted.shape[1]
    iou = box_iou_matrix(shifted, shifted)
    ar = torch.arange(k, device=shifted.device)
    tri_overlap = (
        (iou > iou_threshold)
        & (ar[:, None] < ar[None, :])
        & top_valid[:, :, None]
        & top_valid[:, None, :]
    )  # (b, i, j): kept i would suppress j

    # greedy suppression as a fixed-point iteration: keep[j] iff no kept
    # higher-scored i overlaps it; the fixed point is unique (it is fixed
    # by induction over j) and is reached within k passes
    keep = top_valid
    for _ in range(k):
        suppressed = (tri_overlap & keep[:, :, None]).any(dim=1)
        new = top_valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _check(shifted: torch.Tensor, top_valid: torch.Tensor) -> None:
    if (
        shifted.dtype != torch.float32
        or shifted.dim() != 3
        or shifted.shape[-1] != 4
        or not shifted.is_contiguous()
        or top_valid.dtype != torch.bool
        or tuple(top_valid.shape) != tuple(shifted.shape[:2])
        or not top_valid.is_contiguous()
        or top_valid.device != shifted.device
    ):
        raise ValueError(
            f"suppress takes contiguous float32 boxes (B, k, 4) and a contiguous bool (B, k) valid mask on one "
            f"device; got {shifted.dtype} {tuple(shifted.shape)} (contiguous={shifted.is_contiguous()}) and "
            f"{top_valid.dtype} {tuple(top_valid.shape)} on {shifted.device} / {top_valid.device}"
        )


def build(verbose: bool = False) -> str:
    """Compile ``csrc/nms.cu`` for sm_90a into the build directory (when
    missing or older than the source, under the build directory's file
    lock) and return the library path; raises with the compiler's output
    on failure."""
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
            lib.nms_workspace_words.restype = ctypes.c_longlong
            lib.nms_workspace_words.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.nms_launch.restype = ctypes.c_int
            lib.nms_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


def suppress_cuda(shifted: torch.Tensor, top_valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """One launch of the NMS kernel over CUDA tensors as
    :func:`suppress_plain` takes them, any k: keep (B, k) bool, what the
    plain version gives, left on the card (the overlap words go to a
    workspace of ``torch.empty``).  Raises ``ValueError`` on any other
    input and ``RuntimeError`` when the kernel does not build or
    launch."""
    global launches
    _check(shifted, top_valid)
    if shifted.device.type != "cuda":
        raise ValueError(f"the NMS kernel needs CUDA tensors, got {shifted.device}")
    nb, k = top_valid.shape
    keep = torch.empty((nb, k), dtype=torch.bool, device=shifted.device)
    if nb == 0 or k == 0:
        return keep
    lib = _load()
    work = torch.empty(lib.nms_workspace_words(nb, k), dtype=torch.int32, device=shifted.device)
    with torch.cuda.device(shifted.device):
        stream = torch.cuda.current_stream(shifted.device).cuda_stream
        err = lib.nms_launch(shifted.data_ptr(), top_valid.data_ptr(), nb, k, float(np.float32(iou_threshold)),
                             keep.data_ptr(), work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed at B = {nb}, k = {k}: cudaError {err}")
    launches += 1
    return keep


def suppress(shifted: torch.Tensor, top_valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy suppression of each image's score-sorted candidates:
    ``shifted`` (B, k, 4) float32 class-offset xyxy boxes, ``top_valid``
    (B, k) bool, both contiguous; keep (B, k) bool, candidate j kept iff it
    is valid and no kept higher-scored candidate overlaps it by IoU >
    ``iou_threshold``.  One launch of the NMS kernel on CUDA tensors,
    :func:`suppress_plain` on CPU tensors; never reads a device value on
    the host."""
    _check(shifted, top_valid)
    if shifted.device.type == "cpu":
        return suppress_plain(shifted, top_valid, iou_threshold)
    return suppress_cuda(shifted, top_valid, iou_threshold)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    conf_threshold: float = 0.15,
    iou_threshold: float = 0.7,
    max_det: int = 128,
    pre_topk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image class-aware NMS over a batch.

    boxes (B, A, 4) xyxy; scores (B, A, nc), class = argmax, conf = max.
    Returns boxes (B, max_det, 4), scores (B, max_det), cls (B, max_det)
    int32, valid (B, max_det) bool, score-descending."""
    nb, na, _ = boxes.shape
    dev = boxes.device
    conf, cls = scores.max(dim=-1)
    cls = torch.argmax(scores, dim=-1).to(torch.int32)  # first maximum on ties
    cand = conf > conf_threshold
    k = min(pre_topk, na)
    masked = torch.where(cand, conf, torch.full_like(conf, -torch.inf))
    top_conf, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_conf, order = top_conf[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(nb, k, 4))
    top_cls = torch.gather(cls, 1, order)
    top_valid = torch.isfinite(top_conf)

    shifted = top_boxes + top_cls.to(boxes.dtype)[..., None] * MAX_WH
    keep = suppress(shifted.contiguous(), top_valid.contiguous(), iou_threshold)

    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    slot = torch.where(keep & (pos < max_det), pos, torch.full_like(pos, max_det))
    out_boxes = torch.zeros(nb, max_det + 1, 4, dtype=boxes.dtype, device=dev)
    out_boxes.scatter_(1, slot[..., None].expand(nb, k, 4), top_boxes)
    out_scores = torch.zeros(nb, max_det + 1, dtype=conf.dtype, device=dev)
    out_scores.scatter_(1, slot, top_conf)
    out_cls = torch.zeros(nb, max_det + 1, dtype=torch.int32, device=dev)
    out_cls.scatter_(1, slot, top_cls)
    n_kept = torch.clamp(keep.sum(dim=-1), max=max_det)
    out_valid = torch.arange(max_det, device=dev)[None, :] < n_kept[:, None]
    return out_boxes[:, :max_det], out_scores[:, :max_det], out_cls[:, :max_det], out_valid
