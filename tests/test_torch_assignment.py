"""PyTorch port, the exact assignment solver: ``solve_lap_plain`` (what the
``lap_jv`` CUDA kernel computes) and ``masked_assignment`` against the JAX
package's ``solve_lap`` / ``masked_assignment``, and the port's host
``native.lapjv`` against the JAX package's and scipy's optimum.

Tolerances: row -> column indices, ``match`` and ``matched_col``
bit-equal to the JAX solver's (the same float32 arithmetic and tie order);
the host solvers' indices equal and their totals within 1e-12 relative
(both float64).  The sizes are few on purpose: each n is one XLA compile of
the JAX ``solve_lap``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from eagle_tpu import native as jnative
from eagle_tpu.ops.assignment import BIG as JBIG
from eagle_tpu.ops.assignment import masked_assignment as jmasked
from eagle_tpu.ops.assignment import solve_lap as jsolve
from eagle_tpu_torch import native
from eagle_tpu_torch.ops import assignment
from eagle_tpu_torch.ops.assignment import BIG, masked_assignment, solve_lap, solve_lap_plain
from eagle_tpu_torch.utils.lap_bench import lap_costs

from .torch_parity import n as np_of
from .torch_parity import t

torch.set_num_threads(2)


def _random(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, n)).astype(np.float32)


def _ties(n, seed):
    """Small integer costs: most rows hold several equal minima."""
    return np.random.default_rng(seed).integers(0, 4, (n, n)).astype(np.float32)


def _with_big(n, seed):
    """Random costs with BIG (infeasible) pairs, a perfect matching left."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n, n)).astype(np.float32)
    c[rng.uniform(size=(n, n)) < 0.6] = BIG
    c[np.arange(n), rng.permutation(n)] = rng.uniform(0, 1, n).astype(np.float32)
    return c


@pytest.mark.parametrize(
    "make,n",
    [(_random, 1), (_random, 5), (_random, 24), (_random, 56), (_ties, 5), (_ties, 24), (_ties, 56),
     (_with_big, 24), (_with_big, 56)],
)
def test_solve_lap_plain_bit_equal_to_jax(make, n):
    cost = make(n, seed=n)
    want = np.asarray(jsolve(jnp.asarray(cost)))
    got = solve_lap_plain(t(cost))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_of(got), want)
    assert sorted(want.tolist()) == list(range(n))


@pytest.mark.parametrize(
    "kind,n,seed",
    [("tracking", 192, 192), ("tracking", 192, 193), ("signed_zeros", 24, 24), ("signed_zeros", 56, 56)],
)
def test_solve_lap_plain_bit_equal_to_jax_on_the_kernels_cases(kind, n, seed):
    """The plain version the card compares the kernel against, pinned to
    the JAX solver at the main path's n = 192 on the tracker's extended
    matrices (~10,000 augmenting steps of ties) and on matrices whose
    -0.0 and +0.0 entries tie (the lower column wins)."""
    cost = lap_costs(n, kind, seed)
    if kind == "signed_zeros":
        assert (np.signbit(cost) & (cost == 0)).any() and (~np.signbit(cost) & (cost == 0)).any()
    want = np.asarray(jsolve(jnp.asarray(cost)))
    got = solve_lap_plain(t(cost))
    np.testing.assert_array_equal(np_of(got), want)
    assert sorted(want.tolist()) == list(range(n))


def test_solve_lap_on_the_cpu_is_the_plain_version_batched():
    costs = np.stack([_ties(24, 1), _random(24, 2), _with_big(24, 3)])
    launches = assignment.launches
    got = solve_lap(t(costs))
    assert assignment.launches == launches  # no kernel on a CPU tensor
    assert got.shape == (3, 24) and got.dtype == torch.int32
    for b in range(3):
        np.testing.assert_array_equal(np_of(got[b]), np.asarray(jsolve(jnp.asarray(costs[b]))))
    assert BIG == JBIG


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros(5, 5, dtype=torch.float64),
        torch.zeros(5, 6),
        torch.zeros(5),
        torch.zeros(2, 2, 5, 5),
        torch.zeros(6, 6)[::2, ::2],
    ],
)
def test_solve_lap_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError, match="solve_lap takes"):
        solve_lap(bad)


def test_plain_version_refuses_non_finite_costs():
    cost = torch.full((3, 3), float("inf"))
    with pytest.raises(ValueError, match="finite"):
        solve_lap_plain(cost)


def _gated(seed, r=24, c=32, rows=0.7, cols=0.7, iou_like=False, gate=0.8):
    rng = np.random.default_rng(seed)
    if iou_like:
        # 1 - IoU: most pairs do not overlap (exactly 1.0), a few do
        cost = np.ones((r, c), np.float32)
        near = rng.uniform(size=(r, c)) < 0.12
        cost[near] = rng.uniform(0.05, 0.95, near.sum()).astype(np.float32)
    else:
        cost = rng.uniform(0, 1.2, (r, c)).astype(np.float32)
    cost[rng.uniform(size=(r, c)) < 0.1] = np.float32(gate)  # exactly at the gate: feasible
    return cost, rng.uniform(size=r) < rows, rng.uniform(size=c) < cols


@pytest.mark.parametrize(
    "seed,kw",
    [
        (0, {}),
        (1, dict(iou_like=True)),
        (2, dict(iou_like=True, gate=0.5)),
        (3, dict(iou_like=True, gate=0.7, rows=0.3)),
        (4, dict(rows=0.0)),  # all rows invalid
        (5, dict(cols=0.0)),  # all columns invalid
        (6, dict(rows=1.0, cols=1.0, gate=1.0)),  # 1.0 distances exactly at the gate
    ],
)
def test_masked_assignment_bit_equal_to_jax(seed, kw):
    gate = kw.pop("gate", 0.8)
    cost, rows, cols = _gated(seed, gate=gate, **kw)
    jm, jc = jmasked(jnp.asarray(cost), jnp.asarray(rows), jnp.asarray(cols), gate)
    m, c = masked_assignment(t(cost), t(rows), t(cols), gate)
    np.testing.assert_array_equal(np_of(m), np.asarray(jm))
    np.testing.assert_array_equal(np_of(c), np.asarray(jc))
    if kw.get("rows") == 0.0 or kw.get("cols") == 0.0:
        assert (np_of(m) == -1).all() and not np_of(c).any()
    else:
        assert (np_of(m) >= 0).sum() >= 3, "the case must match some pairs"


def test_masked_assignment_keeps_lapjv_cost_limit_tradeoff():
    """lapjv(cost_limit=g) leaves a row unmatched where the limit's
    penalty is cheaper than a match (maximum cardinality is not the aim)."""
    cost = t(np.array([[0.79, 0.10], [2.0, 0.15]], np.float32))
    ones = torch.ones(2, dtype=torch.bool)
    match, used = masked_assignment(cost, ones, ones, 0.8)
    assert match.tolist() == [1, -1] and used.tolist() == [False, True]


def test_host_lapjv_matches_the_jax_package_and_scipy():
    rng = np.random.default_rng(123)
    for n in (4, 16, 64):
        cost = rng.uniform(0, 1, (n, n))
        got, total = native.lapjv(cost)
        want, want_total = jnative.lapjv(cost)
        np.testing.assert_array_equal(got, want)
        assert total == want_total
        ri, ci = linear_sum_assignment(cost)
        np.testing.assert_allclose(total, cost[ri, ci].sum(), rtol=1e-12)
    # a float32 tensor goes in as float64 on the host
    c32 = _ties(24, 7)
    got, total = native.lapjv(t(c32))
    ri, ci = linear_sum_assignment(c32.astype(np.float64))
    np.testing.assert_allclose(total, c32.astype(np.float64)[ri, ci].sum(), rtol=1e-12)
    assert native.lapjv_available()


def test_host_lapjv_batch_matches_the_jax_package_and_scipy():
    costs = np.random.default_rng(5).uniform(0, 1, (6, 12, 12))
    got, totals = native.lapjv_batch(costs)
    want, want_totals = jnative.lapjv_batch(costs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(totals, want_totals)
    for k in range(6):
        ri, ci = linear_sum_assignment(costs[k])
        np.testing.assert_allclose(totals[k], costs[k][ri, ci].sum(), rtol=1e-12)
    with pytest.raises(ValueError):
        native.lapjv_batch(costs[0])


def test_plain_optimum_equals_the_host_solvers():
    """The float32 JV and the float64 host solver reach the same optimum
    (the total within float32 rounding of the costs' sums)."""
    for make in (_random, _ties, _with_big):
        cost = make(56, seed=11)
        r2c = np_of(solve_lap_plain(t(cost)))
        c64 = cost.astype(np.float64)
        _, total = native.lapjv(c64)
        np.testing.assert_allclose(c64[np.arange(56), r2c].sum(), total, rtol=1e-5)
