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
"""

from __future__ import annotations

import numpy as np

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
