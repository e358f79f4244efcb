"""The DLT's eigen solve: the eigenvector of the smallest eigenvalue of
each symmetric 9x9 matrix of a batch (the JAX package's
``jnp.linalg.eigh`` in ``eagle_tpu/ops/homography.py::dlt_homography``).

- :func:`smallest_eigenvector` is the solve.  On a CUDA tensor it is one
  launch of the hand-written kernel ``csrc/eigh9.cu`` (cyclic Jacobi in
  float64, a warp a matrix), which reads nothing back to the host, so a
  captured CUDA graph can hold it; ``torch.linalg.eigh`` on the card reads
  cuSOLVER's status back after every call.  It raises if the kernel does
  not build or launch.  On a CPU tensor it is
  :func:`smallest_eigenvector_plain`.
- :func:`smallest_eigenvector_plain` is the kernel's plain version:
  ``torch.linalg.eigh`` (the lower triangle) and the eigenvector of the
  first of its ascending eigenvalues.

The two agree to rounding up to the eigenvector's sign, which a DLT
divides out (``H / H[2, 2]``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from eagle_tpu_torch.ops import launch_counts

#: the kernel's launches (one per :func:`smallest_eigenvector` call on a
#: CUDA tensor) count in :mod:`launch_counts` as ``"eigh9"``

_lock = threading.Lock()
_lib = None


def smallest_eigenvector_plain(a: torch.Tensor) -> torch.Tensor:
    """(..., 9, 9) symmetric float32 -> (..., 9): ``torch.linalg.eigh``'s
    eigenvector of the smallest eigenvalue."""
    return torch.linalg.eigh(a)[1][..., :, 0]


def build(verbose: bool = False) -> str:
    """Compile ``csrc/eigh9.cu`` for sm_90a into the build directory (when
    missing or older than the source, under the build directory's file
    lock) and return the library path; raises with the compiler's output on
    failure."""
    from eagle_tpu_torch.native import build_library
    from eagle_tpu_torch.ops.optical_flow import BUILD_DIR, NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "eigh9.cu")
    lib = os.path.join(BUILD_DIR, "libeigh9.so")
    out = build_library(
        lib, src, lambda tmp: [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, src]
    )
    if verbose and out:
        print(out)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.eigh9_launch.restype = ctypes.c_int
            lib.eigh9_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
    return _lib


def smallest_eigenvector_cuda(a: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel over a float32 (..., 9, 9) CUDA tensor
    (made contiguous; only the lower triangle is read): (..., 9) float32,
    left on the card.  Raises ``ValueError`` on any other input and
    ``RuntimeError`` when the kernel does not build or launch."""
    if a.device.type != "cuda" or a.dtype != torch.float32 or a.dim() < 2 or tuple(a.shape[-2:]) != (9, 9):
        raise ValueError(f"eigh9 kernel takes a float32 (..., 9, 9) CUDA tensor, got {a.dtype} {tuple(a.shape)} on {a.device}")
    a = a.contiguous()
    batch = a.numel() // 81
    out = torch.empty((*a.shape[:-2], 9), dtype=torch.float32, device=a.device)
    if batch == 0:
        return out
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.eigh9_launch(a.data_ptr(), batch, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"eigh9 kernel launch failed at batch {batch}: cudaError {err}")
    launch_counts.add(a.device, "eigh9")
    return out


def smallest_eigenvector(a: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of each symmetric 9x9
    float32 matrix of ``a`` (..., 9, 9): one launch of the kernel on a CUDA
    tensor, :func:`smallest_eigenvector_plain` on a CPU tensor."""
    fn = smallest_eigenvector_cuda if a.device.type == "cuda" else smallest_eigenvector_plain
    return fn(a)
