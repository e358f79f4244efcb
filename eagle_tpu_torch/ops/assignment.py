"""Gated linear assignment by a synchronous (Jacobi) auction, the
tracker's default solver (PyTorch counterpart of
``eagle_tpu/ops/assignment.py::{auction_assignment, masked_auction}``).

Every round is one dense pass over the (R, C) matrix.  Ties resolve as in
the JAX package: a row's best and second-best columns are its first and
second maxima by lower index (``jax.lax.top_k``), and a column takes the
first highest bid (``argmax``).  The loop stops once no row is bidding,
which is bit-identical to running every round.
"""

from __future__ import annotations

import torch

#: auction rounds run; each ends in one host sync, the loop's exit test
rounds = 0


def auction_assignment(
    cost: torch.Tensor,
    feasible: torch.Tensor,
    iterations: int = 512,
    eps: float = 1e-3,
    unmatched_cost: float | None = None,
    max_cardinality: bool = True,
) -> torch.Tensor:
    """Near-optimal assignment; returns (R,) int64 column per row, -1 if
    unassigned.  ``unmatched_cost`` with ``max_cardinality=False`` is the
    lapjv cost-limit objective (a row prefers staying unmatched over any
    pair costing more)."""
    r, c = cost.shape
    dev = cost.device
    ninf = torch.tensor(-torch.inf, dtype=cost.dtype, device=dev)
    real_benefit = torch.where(feasible, -cost, ninf)
    row_ok = feasible.any(dim=1)
    if max_cardinality or unmatched_cost is None:
        dummy_b = torch.min(torch.where(feasible, -cost, -ninf)) - 1.0
        dummy_b = torch.where(torch.isfinite(dummy_b), dummy_b, torch.full_like(dummy_b, -2.0))
    else:
        dummy_b = torch.tensor(-float(unmatched_cost), dtype=cost.dtype, device=dev)
    eye = torch.eye(r, dtype=torch.bool, device=dev)
    dummy = torch.where(eye, torch.where(row_ok, dummy_b, ninf)[:, None], ninf)
    benefit = torch.cat([real_benefit, dummy], dim=1)  # (R, C+R)
    ctot = c + r
    row_ids = torch.arange(r, device=dev)
    col_ids = torch.arange(ctot, device=dev)

    prices = torch.zeros(ctot, dtype=cost.dtype, device=dev)
    owner = torch.full((ctot,), -1, dtype=torch.int64, device=dev)
    global rounds
    for _ in range(iterations):
        rounds += 1
        assigned = (owner[None, :] == row_ids[:, None]).any(dim=1)
        bidding = row_ok & ~assigned
        if not bool(bidding.any()):
            break
        value = benefit - prices[None, :]
        best_j = torch.argmax(value, dim=1)  # first maximum
        best_onehot = best_j[:, None] == col_ids[None, :]
        top1 = value.gather(1, best_j[:, None])[:, 0]
        top2 = torch.where(best_onehot, ninf, value).max(dim=1).values
        gap = torch.where(torch.isfinite(top2), top1 - top2, torch.ones_like(top1))
        price_best = torch.where(best_onehot, prices[None, :], torch.zeros_like(value)).sum(1)
        bid_amount = price_best + gap + eps
        bid_amount = torch.where(torch.isfinite(top1) & bidding, bid_amount, ninf)
        bids = torch.where(best_onehot, bid_amount[:, None], ninf)
        col_best = bids.max(dim=0).values
        col_winner = torch.argmax(bids, dim=0)
        took = col_best > ninf
        owner = torch.where(took, col_winner, owner)
        prices = torch.where(took, col_best, prices)

    owned = owner[None, :] == row_ids[:, None]
    match = torch.where(owned.any(1), torch.argmax(owned.to(torch.int8), dim=1), torch.full((r,), -1, device=dev))
    return torch.where(match >= c, torch.full_like(match, -1), match)


def masked_auction(
    cost: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    gate: float,
    iterations: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated auction with the lapjv cost-limit objective: invalid rows or
    columns and pairs costing more than ``gate`` never match.  Returns
    (match (R,) column per row or -1, matched_col (C,) bool)."""
    c = cost.shape[1]
    feas = row_valid[:, None] & col_valid[None, :] & (cost <= gate)
    match = auction_assignment(
        cost, feas, iterations=iterations, unmatched_cost=gate, max_cardinality=False
    )
    matched_col = (match[:, None] == torch.arange(c, device=cost.device)[None, :]).any(0)
    return match, matched_col
