"""PyTorch port, the auction's rounds and NMS's suppression fixed point,
the two loops the port runs on the card as hand-written kernels
(``csrc/auction.cu``, ``csrc/nms.cu``): their plain versions
(``auction_rounds_plain``, ``suppress_plain``, what the kernels compute)
through ``masked_auction`` / ``auction_assignment`` / ``batched_nms``
against the JAX package's functions, the round counts against the cap,
the batched plain auction against single matrices, and the wrappers'
input checks, which refuse what the kernels do not take before any
launch and never load a kernel for a CPU tensor.

Tolerances: matches, ``matched_col``, keep masks and the NMS slots
(boxes, scores, classes, valid) bit-equal (the same float32 arithmetic
and tie order).  The shapes are few on purpose: each shape and each
``iterations`` is one XLA compile of the JAX function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops.assignment import auction_assignment as jauction_assignment
from eagle_tpu.ops.assignment import masked_auction as jmasked_auction
from eagle_tpu.ops.nms import batched_nms as jbatched_nms
from eagle_tpu_torch.ops import assignment, nms
from eagle_tpu_torch.ops.assignment import (
    auction_assignment,
    auction_benefit,
    auction_rounds,
    auction_rounds_cuda,
    auction_rounds_plain,
    masked_auction,
)
from eagle_tpu_torch.ops.nms import batched_nms, suppress, suppress_cuda, suppress_plain
from eagle_tpu_torch.utils.kernel_cases import AUCTION_KINDS, CHAIN, NMS_KINDS, auction_case, nms_cases

from .torch_parity import n, t

torch.set_num_threads(2)

NMS_KW = dict(conf_threshold=0.15, iou_threshold=0.7, max_det=128, pre_topk=512)


@pytest.fixture
def no_kernels(monkeypatch):
    """Fails any test that would load a kernel library."""

    def refuse():
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(assignment, "_load_auction", refuse)
    monkeypatch.setattr(nms, "_load", refuse)


def _masked_pair(kind, r, c, seed, iterations=512):
    cost, rows, cols, gate = auction_case(kind, r, c, seed)
    want = [np.asarray(a) for a in jmasked_auction(jnp.asarray(cost), jnp.asarray(rows), jnp.asarray(cols), gate,
                                                   iterations=iterations)]
    got = [n(a) for a in masked_auction(t(cost), t(rows), t(cols), gate, iterations=iterations)]
    return got, want


@pytest.mark.parametrize("kind", AUCTION_KINDS)
@pytest.mark.parametrize("r,c", [(12, 20), (20, 12)])
def test_masked_auction_bit_equal_to_jax(no_kernels, kind, r, c):
    """R < C and R > C, each kind: sparse tracking-like costs, random,
    grid-valued ties, a tied block (a price war up to the 512-round cap)
    and rows with no feasible pair."""
    (mt, ut), (mj, uj) = _masked_pair(kind, r, c, seed=r * 7 + c)
    assert mt.dtype == np.int64
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(ut, uj)
    if kind != "infeasible":
        assert (mt >= 0).sum() >= 3


def test_masked_auction_at_the_main_path_size_bit_equal_to_jax(no_kernels):
    """The tracker's 64 track slots against 128 detection slots."""
    (mt, ut), (mj, uj) = _masked_pair("tracking", 64, 128, seed=4)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(ut, uj)
    assert (mt >= 0).sum() >= 10


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("kind", ["tied_block", "ties"])
def test_masked_auction_at_the_round_cap_bit_equal_to_jax(no_kernels, kind, iterations):
    (mt, ut), (mj, uj) = _masked_pair(kind, 20, 12, seed=3, iterations=iterations)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(ut, uj)


@pytest.mark.parametrize("max_cardinality", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties", "infeasible"])
def test_auction_assignment_bit_equal_to_jax(no_kernels, kind, max_cardinality):
    cost, rows, cols, gate = auction_case(kind, 16, 24, seed=9)
    feas = rows[:, None] & cols[None, :] & (cost <= gate)
    want = np.asarray(jauction_assignment(jnp.asarray(cost), jnp.asarray(feas), unmatched_cost=gate,
                                          max_cardinality=max_cardinality))
    got = n(auction_assignment(t(cost), t(feas), unmatched_cost=gate, max_cardinality=max_cardinality))
    np.testing.assert_array_equal(got, want)


def _benefit(kind, r, c, seed):
    cost, rows, cols, gate = auction_case(kind, r, c, seed)
    feas = t(rows[:, None] & cols[None, :] & (cost <= gate))
    return auction_benefit(t(cost), feas, gate, max_cardinality=False)


@pytest.mark.parametrize("kind", AUCTION_KINDS)
def test_round_counts_and_the_cap(kind):
    """The plain version counts the bidding rounds it runs: a capped run
    stops at min(cap, the free run's rounds), and a run capped at exactly
    the free run's rounds gives its matches.  The tied block needs more
    than 512 rounds."""
    benefit, row_ok = _benefit(kind, 20, 12, seed=11)
    c = 12
    before = assignment.rounds
    free, free_rounds = auction_rounds_plain(benefit, row_ok, c)
    full = int(free_rounds)
    assert free_rounds.dtype == torch.int32 and assignment.rounds == before + full
    assert full == 512 if kind == "tied_block" else 1 <= full
    for cap in (0, 1, 2, 3, full):
        m, done = auction_rounds(benefit, row_ok, c, iterations=cap)
        assert int(done) == min(cap, full)
    assert torch.equal(auction_rounds_plain(benefit, row_ok, c, iterations=full)[0], free)
    record: list = []
    auction_rounds_plain(benefit, row_ok, c, record=record)
    assert len(record) == full and record[0] == int(row_ok.sum()) and min(record) >= 1


def test_batched_plain_equals_single_matrices():
    cases = [_benefit(kind, 16, 10, seed=s) for s, kind in enumerate(["tracking", "ties", "tied_block", "random"])]
    benefit = torch.stack([b for b, _ in cases])
    row_ok = torch.stack([o for _, o in cases])
    match, done = auction_rounds(benefit, row_ok, 10, iterations=40)
    assert match.shape == (4, 16) and done.shape == (4,) and done.dtype == torch.int32
    for k, (b, o) in enumerate(cases):
        m1, d1 = auction_rounds(b, o, 10, iterations=40)
        assert torch.equal(match[k], m1) and int(done[k]) == int(d1)


def test_auction_with_nothing_to_match(no_kernels):
    for r, c in ((0, 5), (5, 0), (0, 0)):
        m, used = masked_auction(torch.zeros(r, c), torch.ones(r, dtype=torch.bool), torch.ones(c, dtype=torch.bool),
                                 0.8)
        assert m.tolist() == [-1] * r and used.tolist() == [False] * c
    # no column and max_cardinality: every row -1 (the JAX package's jnp.min of nothing raises)
    assert auction_assignment(torch.zeros(3, 0), torch.zeros(3, 0, dtype=torch.bool)).tolist() == [-1] * 3
    m, done = auction_rounds(torch.zeros(0, 3), torch.zeros(0, dtype=torch.bool), 3)
    assert m.shape == (0,) and int(done) == 0
    m, done = auction_rounds(torch.zeros(0, 4, 6), torch.zeros(0, 4, dtype=torch.bool), 2)
    assert m.shape == (0, 4) and done.shape == (0,)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_slots_bit_equal_to_jax(no_kernels, seed):
    """One image of each kind: clusters, IoU exactly at the threshold and
    one float32 step above, a 12-link chain, nothing above the floor, more
    kept boxes than max_det."""
    boxes, scores = nms_cases(seed)
    want = [np.asarray(a) for a in jbatched_nms(jnp.asarray(boxes), jnp.asarray(scores), **NMS_KW)]
    got = [n(a) for a in batched_nms(t(boxes), t(scores), **NMS_KW)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    kept = dict(zip(NMS_KINDS, got[3].sum(1)))
    assert kept["empty"] == 0 and kept["overflow"] == 128 and kept["clusters"] >= 20
    b_thr = got[0][NMS_KINDS.index("threshold")]
    np.testing.assert_array_equal(b_thr[:3], boxes[NMS_KINDS.index("threshold"), :3])  # at the threshold: kept
    b_chain = got[0][NMS_KINDS.index("chain")]
    np.testing.assert_array_equal(b_chain[: CHAIN // 2], boxes[NMS_KINDS.index("chain"), :CHAIN:2])


def test_suppress_plain_runs_the_chain_to_its_fixed_point():
    """The chain needs 12 passes; a brute greedy loop agrees."""
    boxes, _ = nms_cases(0)
    chain = t(boxes[NMS_KINDS.index("chain"), :CHAIN])[None].contiguous()
    valid = torch.ones(1, CHAIN, dtype=torch.bool)
    keep = suppress(chain, valid, 0.7)
    assert keep[0].tolist() == [m % 2 == 0 for m in range(CHAIN)]
    iou = nms.box_iou_matrix(chain[0], chain[0])
    greedy = []
    for j in range(CHAIN):
        greedy.append(not any(greedy[i] and iou[i, j] > 0.7 for i in range(j)))
    assert keep[0].tolist() == greedy
    assert torch.equal(suppress_plain(chain, valid, 0.7), keep)


def test_wrappers_refuse_what_the_kernels_do_not_take(no_kernels):
    b = torch.zeros(2, 4, 7)
    ok = torch.ones(2, 4, dtype=torch.bool)
    bad_auction = [
        (b.double(), ok, 3),
        (b[0, 0], ok[0, 0], 3),  # rank 1
        (torch.zeros(2, 2, 4, 7), ok, 3),  # rank 4
        (b.transpose(1, 2).contiguous().transpose(1, 2), ok, 3),  # not contiguous
        (b, ok.int(), 3),
        (b, ok[:, :3], 3),
        (b, ok, 4),  # C + R != columns
        (b, ok, -1),
    ]
    for fn in (auction_rounds, auction_rounds_cuda):
        for args in bad_auction:
            with pytest.raises(ValueError, match="auction_rounds takes"):
                fn(*args)
        with pytest.raises(ValueError, match="iterations"):
            fn(b, ok, 3, iterations=-1)
    with pytest.raises(ValueError, match="needs CUDA"):
        auction_rounds_cuda(b, ok, 3)

    s = torch.zeros(2, 8, 4)
    v = torch.ones(2, 8, dtype=torch.bool)
    bad_nms = [(s.double(), v), (s[0], v[0]), (s[..., :3].contiguous(), v), (s.transpose(0, 1).contiguous()
               .transpose(0, 1), v), (s, v.int()), (s, v[:, :5]), (s, v.t().contiguous().t())]
    for fn in (suppress, suppress_cuda):
        for args in bad_nms:
            with pytest.raises(ValueError, match="suppress takes"):
                fn(*args, 0.7)
    with pytest.raises(ValueError, match="needs CUDA"):  # any k on the card; a CPU tensor is refused
        suppress_cuda(torch.zeros(1, 1025, 4), torch.ones(1, 1025, dtype=torch.bool), 0.7)
    with pytest.raises(ValueError, match="needs CUDA"):
        suppress_cuda(s, v, 0.7)
    assert assignment.auction_launches == 0 and nms.launches == 0


def test_cpu_tensors_never_load_a_kernel(no_kernels):
    """The main path's calls on CPU tensors, at the main path's shapes."""
    cost, rows, cols, gate = auction_case("tracking", 64, 128, seed=2)
    masked_auction(t(cost), t(rows), t(cols), gate)
    boxes, scores = nms_cases(1)
    batched_nms(t(boxes), t(scores), **NMS_KW)
    suppress(torch.zeros(1, 1100, 4), torch.zeros(1, 1100, dtype=torch.bool), 0.7)  # k > 1024: plain on the CPU
