"""PyTorch port, homography: the host reproduction of JAX's random stream
(threefry2x32, fold_in, partitionable random bits, uniform -> gumbel),
the RANSAC minimal sets it yields, and DLT / RANSAC against the JAX
package on the same sets.

Tolerances: keys, random bits and uniforms bit-equal; gumbel floats
within 1e-6 (numpy's float32 log and XLA's differ in the last bits; the
transform is monotone, so the sets are unaffected) and minimal sets
bit-equal; inlier masks and ok flags bit-equal, and the two homographies
project the image points to within 5 mm of each other on the pitch (both
are float32 fits; entries near zero differ relatively more)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu import pitch
from eagle_tpu.ops import homography as jh
from eagle_tpu_torch.ops import homography as th
from eagle_tpu_torch.ops import prng

from .torch_parity import n, t

torch.set_num_threads(2)

CASES = [(0, 0), (0, 7), (3, 123), (11, 99999)]


@pytest.mark.parametrize("seed,step", CASES)
def test_random_stream_bit_equal(seed, step):
    key = jax.random.fold_in(jax.random.key(seed), step)
    mine = prng.fold_in(prng.key(seed), step)
    assert tuple(np.asarray(jax.random.key_data(key)).tolist()) == mine
    shape = (512, 57)
    np.testing.assert_array_equal(prng.random_bits(mine, shape), np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(
        prng.uniform(mine, shape, tiny, 1.0), np.asarray(jax.random.uniform(key, shape, minval=tiny, maxval=1.0))
    )
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(mine, shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,step", CASES)
def test_minimal_sets_bit_equal(seed, step):
    valid = np.random.default_rng(step).uniform(size=57) < 0.6
    key = jax.random.fold_in(jax.random.key(seed), step)
    want = np.asarray(jh._sample_minimal_sets(key, jnp.asarray(valid), 512))
    got = n(th.sample_minimal_sets(prng.ransac_keys(seed, torch.tensor(step), 512, 57), t(valid)))
    np.testing.assert_array_equal(got, want)


def _correspondences(rng, outliers: int, n_valid: int):
    """Image points of the pitch landmarks under a broadcast-like camera,
    pixel noise, a few gross outliers."""
    H = np.array([[9.0, 1.5, 120.0], [0.2, -6.0, 600.0], [0.0005, 0.004, 1.0]])
    world = pitch.WORLD_XY.astype(np.float64)
    img = world @ H[:, :2].T + H[:, 2]
    img = img[:, :2] / img[:, 2:]
    img += rng.normal(0, 0.7, img.shape)
    bad = rng.choice(57, outliers, replace=False)
    img[bad] += rng.uniform(-80, 80, (outliers, 2))
    valid = np.zeros(57, bool)
    valid[rng.choice(np.flatnonzero(pitch.ON_PLANE_MASK), n_valid, replace=False)] = True
    return np.trunc(img).astype(np.float32), pitch.WORLD_XY.astype(np.float32), valid


@pytest.mark.parametrize("seed,outliers,n_valid", [(0, 3, 20), (1, 6, 12), (2, 0, 5), (3, 2, 3)])
def test_ransac_matches_jax_on_same_sets(seed, outliers, n_valid):
    src, dst, valid = _correspondences(np.random.default_rng(seed), outliers, n_valid)
    key = jax.random.fold_in(jax.random.key(0), seed)
    Hj, inl_j, ok_j = (np.asarray(a) for a in jh.ransac_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key))
    sets = th.sample_minimal_sets(prng.ransac_keys(0, torch.tensor(seed), 512, 57), t(valid))
    Ht, inl_t, ok_t = (n(a) for a in th.ransac_homography(t(src), t(dst), t(valid), sets))
    assert bool(ok_t) == bool(ok_j)
    np.testing.assert_array_equal(inl_t, inl_j)
    proj = lambda H: np.asarray(jh.perspective_transform(jnp.asarray(H), jnp.asarray(src)))
    np.testing.assert_allclose(proj(Ht)[valid], proj(Hj)[valid], atol=5e-3)


def test_dlt_and_errors_match_jax():
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 900, (4, 2)).astype(np.float32)
    dst = rng.uniform(0, 100, (4, 2)).astype(np.float32)
    w = np.ones(4, np.float32)
    Hj = np.asarray(jh.dlt_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    Ht = n(th.dlt_homography(t(src), t(dst), t(w)))
    np.testing.assert_allclose(Ht, Hj, rtol=1e-4, atol=1e-6)
    pts = rng.uniform(0, 900, (9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        n(th.perspective_transform(t(Hj), t(pts))), np.asarray(jh.perspective_transform(jnp.asarray(Hj), jnp.asarray(pts))), rtol=1e-6
    )
