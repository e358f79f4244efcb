"""The JAX package's random stream, reproduced bit for bit in numpy.

The reference pipeline draws RANSAC minimal sets from
``jax.random.gumbel(jax.random.fold_in(jax.random.key(seed), t), (iters,
57))`` + ``top_k`` (``eagle_tpu/ops/homography.py`` and
``eagle_tpu/pipeline/temporal.py``).  The draw does not depend on the
data, so the port reproduces it on the host: the threefry2x32 hash, JAX's
``fold_in``, its partitionable random-bits layout (the default since JAX
0.5: ``jax_threefry_partitionable``) and its uniform -> gumbel transform
in float32.  Pinned bit-equal against ``jax.random.gumbel`` by
``tests/test_torch_homography.py``.

:func:`ransac_keys` is the same draw made on the device from a device
scalar ``t``, as integer keys (one launch of ``csrc/threefry.cu`` on the
card): what a captured temporal step draws.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from eagle_tpu_torch.ops import launch_counts

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(
    key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under
    ``key``; uint32 in, uint32 out, elementwise."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a 32-bit seed: (0, seed mod 2**32)."""
    return (0, int(seed) & 0xFFFFFFFF)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    y0, y1 = threefry2x32(k, np.array([0], np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return int(y0[0]), int(y1[0])


def random_bits(k: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """32-bit random bits in JAX's partitionable layout: element i (flat)
    is y0 ^ y1 of the hash of the 64-bit counter i split (hi, lo)."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(k, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(k: tuple[int, int], shape: tuple[int, ...], minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus one, scaled into [minval, maxval)."""
    bits = random_bits(k, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)


def gumbel(k: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.gumbel`` (float32, the default "low" mode)."""
    tiny = np.finfo(np.float32).tiny
    u = uniform(k, shape, tiny, 1.0)
    return -np.log(-np.log(u))


# ---------------------------------------------------------------------------
# the RANSAC keys of a step on the device (csrc/threefry.cu)
# ---------------------------------------------------------------------------
#
# RANSAC uses the draw only to order each hypothesis's points (the Gumbel
# top 4).  ``gumbel`` is a strictly increasing map of the 23-bit integer
# ``random_bits >> 9``, so those integers fix the same minimal sets, ties
# included: the keys are the draw a device step makes, in exact integer
# arithmetic with no transcendental function.

_MASK = 0xFFFFFFFF
#: the keys kernel's launches (one per :func:`ransac_keys` call on a CUDA
#: tensor) count in :mod:`launch_counts` as ``"ransac_keys"``

_lock = threading.Lock()
_lib = None


def _rotl_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32_torch(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors holding uint32 values (keys
    may be tensors or ints): the same hash, in torch."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def ransac_keys_plain(seed: int, t: torch.Tensor, iters: int, n: int) -> torch.Tensor:
    """The kernel's plain version: (iters, n) int32 ``random_bits(fold_in(
    key(seed), t), (iters, n)) >> 9`` for a 0-d integer tensor ``t`` (the
    frame index), on its device, with no host read of ``t``."""
    dev = t.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    f0, f1 = threefry2x32_torch(0, int(seed) & _MASK, zero, t.to(torch.int64) & _MASK)
    idx = torch.arange(iters * n, dtype=torch.int64, device=dev)
    y0, y1 = threefry2x32_torch(f0, f1, idx >> 32, idx & _MASK)
    return ((y0 ^ y1) >> 9).to(torch.int32).reshape(iters, n)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/threefry.cu`` for sm_90a into the build directory
    (when missing or older than the source, under the build directory's
    file lock) and return the library path; raises with the compiler's
    output on failure."""
    from eagle_tpu_torch.native import build_library
    from eagle_tpu_torch.ops.optical_flow import BUILD_DIR, NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "threefry.cu")
    lib = os.path.join(BUILD_DIR, "libthreefry.so")
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
            lib.ransac_keys_launch.restype = ctypes.c_int
            lib.ransac_keys_launch.argtypes = [
                ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


def ransac_keys_cuda(seed: int, t: torch.Tensor, iters: int, n: int) -> torch.Tensor:
    """One launch of the keys kernel: what :func:`ransac_keys_plain` gives,
    for a 0-d int64 CUDA tensor ``t``, left on the card.  Raises
    ``ValueError`` on any other ``t`` and ``RuntimeError`` when the kernel
    does not build or launch."""
    if t.device.type != "cuda" or t.dtype != torch.int64 or t.dim() != 0:
        raise ValueError(f"ransac_keys kernel takes a 0-d int64 CUDA tensor t, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if iters < 0 or n < 0:
        raise ValueError(f"ransac_keys: iters and n must be >= 0, got {iters}, {n}")
    out = torch.empty((iters, n), dtype=torch.int32, device=t.device)
    lib = _load()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.ransac_keys_launch(int(seed) & _MASK, t.data_ptr(), iters * n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ransac_keys kernel launch failed: cudaError {err}")
    launch_counts.add(t.device, "ransac_keys")
    return out


def ransac_keys(seed: int, t: torch.Tensor, iters: int, n: int) -> torch.Tensor:
    """Frame ``t``'s RANSAC keys under ``seed``: (iters, n) int32, ordered
    as the JAX package's Gumbel draw orders them
    (:func:`eagle_tpu_torch.ops.homography.sample_minimal_sets` takes
    either).  One launch of the keys kernel for a CUDA ``t`` (raises if it
    does not build or launch), :func:`ransac_keys_plain` for a CPU one.
    Never reads ``t`` on the host."""
    fn = ransac_keys_cuda if t.device.type == "cuda" else ransac_keys_plain
    return fn(seed, t, iters, n)
