"""Gated linear assignment, the tracker's two solvers (PyTorch
counterpart of ``eagle_tpu/ops/assignment.py``).

- The synchronous (Jacobi) auction, the default
  (:func:`auction_assignment`, :func:`masked_auction`).  Every round is one
  dense pass over the (R, C) matrix.  Ties resolve as in the JAX package: a
  row's best and second-best columns are its first and second maxima by
  lower index (``jax.lax.top_k``), and a column takes the first highest bid
  (``argmax``).  The loop stops once no row is bidding, which is
  bit-identical to running every round.  The set-up is tensor code; the
  rounds (:func:`auction_rounds`) are one launch of the hand-written
  kernel ``csrc/auction.cu`` on CUDA tensors (one block a matrix, every
  round inside it, no host sync) and :func:`auction_rounds_plain` on CPU
  tensors, whose exit test syncs once a round.  Both give the same matches
  and round counts, bit for bit.
- The exact Jonker-Volgenant solver behind ``TrackerConfig.assignment=
  "exact"`` (:func:`solve_lap`, :func:`masked_assignment`, lapjv's
  cost-limit objective).  On CUDA tensors a solve is one launch of the
  hand-written kernel ``csrc/lap_jv.cu`` (one warp a matrix, the whole
  solve inside it, no host sync); on CPU tensors it is
  :func:`solve_lap_plain`, a step-by-step transcription of the JAX
  ``solve_lap``.  Both give indices bit-equal to the JAX solver's.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from eagle_tpu_torch.native import build_library
from eagle_tpu_torch.ops.optical_flow import BUILD_DIR, NVCC_FLAGS, _nvcc

#: bidding rounds run by :func:`auction_rounds_plain` (CPU tensors); the
#: kernel's rounds go to a device-side tally (:func:`device_rounds`)
rounds = 0
#: launches of the auction kernel (one per :func:`auction_rounds` call on
#: CUDA tensors)
auction_launches = 0
#: the same launches by path: the rows kept in registers (R <= 128, C + R <=
#: 256), or the benefit read from global memory (a larger matrix)
auction_launches_by_path = {"registers": 0, "global": 0}
#: the kernel's rounds, one int64 tally a device, added on the card
_round_tally: dict = {}

_AUCTION_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "auction.cu")
_AUCTION_LIB = os.path.join(BUILD_DIR, "libauction.so")
_auction_lock = threading.Lock()
_auction_lib = None


def build_auction(verbose: bool = False) -> str:
    """Compile ``csrc/auction.cu`` for sm_90a into the build directory
    (when missing or older than the source, under the build directory's
    file lock) and return the library path; raises with the compiler's
    output on failure."""
    out = build_library(
        _AUCTION_LIB,
        _AUCTION_SRC,
        lambda tmp: [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, _AUCTION_SRC],
    )
    if verbose and out:
        print(out)
    return _AUCTION_LIB


def _load_auction():
    global _auction_lib
    with _auction_lock:
        if _auction_lib is None:
            lib = ctypes.CDLL(build_auction())
            lib.auction_path.restype = ctypes.c_int
            lib.auction_path.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.auction_launch.restype = ctypes.c_int
            lib.auction_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
            ]
            _auction_lib = lib
    return _auction_lib


def auction_path(r: int, ctot: int, device=None) -> str:
    """The path an auction launch over (R, C + R) matrices takes on
    ``device`` (default: the current CUDA device): "registers" when the
    block keeps the rows in registers (R <= 128, C + R <= 256), else
    "global"; raises where the vectors alone do not fit in a block's
    shared memory."""
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        code = _load_auction().auction_path(r, ctot)
    if code < 0:
        raise RuntimeError(f"auction kernel: cudaError {-code} choosing the path for R = {r}, C + R = {ctot}")
    return "registers" if code == 1 else "global"


def device_rounds() -> int:
    """The auction kernel's bidding rounds since the last
    :func:`reset_rounds`, over every device (reads the tallies: a host
    sync)."""
    return sum(int(t.item()) for t in _round_tally.values())


def reset_rounds() -> None:
    """Zero :data:`rounds` and the kernel's device-side tallies."""
    global rounds
    rounds = 0
    for t in _round_tally.values():
        t.zero_()


def auction_rounds_plain(
    benefit: torch.Tensor,
    row_ok: torch.Tensor,
    c: int,
    iterations: int = 512,
    eps: float = 1e-3,
    record: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: the auction's rounds on each (R, C + R)
    benefit matrix (the C real columns, then a dummy column a row) of an
    (R, C + R) or (B, R, C + R) tensor, rows with ``row_ok`` false never
    bidding.  Returns (match (R,) or (B, R) int64, the real column of each
    row or -1; rounds () or (B,) int32, the bidding rounds run).  With
    ``record`` a list, appends the bidding rows of each round run."""
    global rounds
    if benefit.dim() == 3:
        dev = benefit.device
        out = [auction_rounds_plain(benefit[b], row_ok[b], c, iterations, eps, record) for b in range(benefit.shape[0])]
        if not out:
            return torch.empty((0, benefit.shape[1]), dtype=torch.int64, device=dev), torch.empty(
                (0,), dtype=torch.int32, device=dev)
        return torch.stack([m for m, _ in out]), torch.stack([n for _, n in out])
    r, ctot = benefit.shape
    dev = benefit.device
    ninf = torch.full((), -torch.inf, dtype=benefit.dtype, device=dev)
    row_ids = torch.arange(r, device=dev)
    col_ids = torch.arange(ctot, device=dev)

    prices = torch.zeros(ctot, dtype=benefit.dtype, device=dev)
    owner = torch.full((ctot,), -1, dtype=torch.int64, device=dev)
    done = 0
    for _ in range(iterations):
        assigned = (owner[None, :] == row_ids[:, None]).any(dim=1)
        bidding = row_ok & ~assigned
        if not bool(bidding.any()):
            break
        done += 1
        if record is not None:
            record.append(int(bidding.sum()))
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
    rounds += done

    owned = owner[None, :] == row_ids[:, None]
    match = torch.where(owned.any(1), torch.argmax(owned.to(torch.int8), dim=1), torch.full((r,), -1, device=dev))
    match = torch.where(match >= c, torch.full_like(match, -1), match)
    return match, torch.tensor(done, dtype=torch.int32, device=dev)


def _check_auction(benefit: torch.Tensor, row_ok: torch.Tensor, c: int, iterations: int) -> None:
    ok = (
        benefit.dtype == torch.float32
        and benefit.dim() in (2, 3)
        and benefit.is_contiguous()
        and row_ok.dtype == torch.bool
        and tuple(row_ok.shape) == tuple(benefit.shape[:-1])
        and row_ok.is_contiguous()
        and row_ok.device == benefit.device
        and c >= 0
        and benefit.shape[-1] == c + benefit.shape[-2]
        and iterations >= 0
    )
    if not ok:
        raise ValueError(
            f"auction_rounds takes a contiguous float32 (R, C + R) or (B, R, C + R) benefit, a contiguous bool "
            f"row_ok of its leading shape on its device, C >= 0 and iterations >= 0; got {benefit.dtype} "
            f"{tuple(benefit.shape)} (contiguous={benefit.is_contiguous()}) on {benefit.device}, {row_ok.dtype} "
            f"{tuple(row_ok.shape)} on {row_ok.device}, C = {c}, iterations = {iterations}"
        )


def auction_rounds_cuda(
    benefit: torch.Tensor, row_ok: torch.Tensor, c: int, iterations: int = 512, eps: float = 1e-3
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the auction kernel over CUDA tensors as
    :func:`auction_rounds_plain` takes them: (match, rounds), what the
    plain version gives, left on the card; the rounds are also added to
    the device's tally.  Raises ``ValueError`` on any other input and
    ``RuntimeError`` when the kernel does not build or launch (the vectors
    of more than ~14,000 columns do not fit in a block)."""
    global auction_launches
    _check_auction(benefit, row_ok, c, iterations)
    if benefit.device.type != "cuda":
        raise ValueError(f"the auction kernel needs CUDA tensors, got {benefit.device}")
    batched = benefit.dim() == 3
    b = benefit.shape[0] if batched else 1
    r = benefit.shape[-2]
    dev = benefit.device
    match = torch.empty(benefit.shape[:-1], dtype=torch.int64, device=dev)
    done = torch.empty((b,) if batched else (), dtype=torch.int32, device=dev)
    if b == 0 or r == 0:
        return match, done.zero_()
    lib = _load_auction()
    tally = _round_tally.get(dev)
    if tally is None:
        tally = _round_tally[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    taken = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.auction_launch(
            benefit.data_ptr(), row_ok.data_ptr(), b, r, benefit.shape[-1], c, iterations,
            float(np.float32(eps)), match.data_ptr(), done.data_ptr(), tally.data_ptr(), stream,
            ctypes.byref(taken),
        )
    if err != 0:
        raise RuntimeError(f"auction kernel launch failed at B = {b}, R = {r}, C = {c}: cudaError {err}")
    auction_launches += 1
    auction_launches_by_path["registers" if taken.value == 1 else "global"] += 1
    return match, done


def auction_rounds(
    benefit: torch.Tensor, row_ok: torch.Tensor, c: int, iterations: int = 512, eps: float = 1e-3
) -> tuple[torch.Tensor, torch.Tensor]:
    """The auction's rounds on each (R, C + R) float32 benefit matrix of a
    contiguous (R, C + R) or (B, R, C + R) tensor (C real columns, then a
    dummy column a row; no NaN), rows with ``row_ok`` false never bidding,
    at most ``iterations`` rounds: (match (R,) or (B, R) int64, the real
    column of each row or -1; rounds () or (B,) int32).  One launch of the
    auction kernel on CUDA tensors (raises if it does not build or
    launch), :func:`auction_rounds_plain` on CPU tensors.  Never reads a
    device value on the host."""
    _check_auction(benefit, row_ok, c, iterations)
    if benefit.device.type == "cpu":
        return auction_rounds_plain(benefit, row_ok, c, iterations, eps)
    return auction_rounds_cuda(benefit, row_ok, c, iterations, eps)


def auction_benefit(
    cost: torch.Tensor,
    feasible: torch.Tensor,
    unmatched_cost: float | None = None,
    max_cardinality: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The auction's set-up, tensor code with no host sync: (benefit (R, C +
    R), the feasible pairs' -cost (else -inf) and a dummy column a row, the
    price of staying unassigned; row_ok (R,) bool, the rows with a feasible
    pair).  The dummy lies below every feasible benefit for a
    maximum-cardinality matching, or at ``-unmatched_cost`` (lapjv's
    cost-limit objective)."""
    r, c = cost.shape
    dev = cost.device
    ninf = torch.full((), -torch.inf, dtype=cost.dtype, device=dev)
    real_benefit = torch.where(feasible, -cost, ninf)
    row_ok = feasible.any(dim=1)
    if max_cardinality or unmatched_cost is None:
        dummy_b = torch.min(torch.where(feasible, -cost, -ninf)) - 1.0
        dummy_b = torch.where(torch.isfinite(dummy_b), dummy_b, torch.full_like(dummy_b, -2.0))
    else:
        dummy_b = torch.full((), -float(unmatched_cost), dtype=cost.dtype, device=dev)
    eye = torch.eye(r, dtype=torch.bool, device=dev)
    dummy = torch.where(eye, torch.where(row_ok, dummy_b, ninf)[:, None], ninf)
    return torch.cat([real_benefit, dummy], dim=1), row_ok


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
    pair costing more).  :func:`auction_benefit`, then
    :func:`auction_rounds`."""
    r, c = cost.shape
    if r == 0 or c == 0:  # nothing to match: no round, no launch
        return torch.full((r,), -1, dtype=torch.int64, device=cost.device)
    benefit, row_ok = auction_benefit(cost, feasible, unmatched_cost, max_cardinality)
    return auction_rounds(benefit, row_ok, c, iterations, eps)[0]


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


# ---------------------------------------------------------------------------
# the exact solver: Jonker-Volgenant shortest augmenting paths
# ---------------------------------------------------------------------------

#: infeasible-pair cost for direct :func:`solve_lap` use (the JAX package's:
#: small enough that float32 dual updates keep ~1e-3 granularity)
BIG = 1e4

_CU_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "lap_jv.cu")
_CU_LIB = os.path.join(BUILD_DIR, "liblap_jv.so")
_build_lock = threading.Lock()
_lib = None
#: launches of the JV kernel (one per :func:`solve_lap` call on a CUDA tensor)
launches = 0
#: the same launches by the kernel's path: the cost matrix staged in shared
#: memory, or read from global memory (a matrix too large for the block)
launches_by_path = {"shared": 0, "global": 0}


def jv_plain(cost: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The JV solve of one (n, n) float32 matrix as the JAX ``solve_lap``
    computes it, step by step: (row_to_col (n,) int32, the augmenting steps
    taken).  The 1-indexed layout with a sentinel column 0; ``minv`` starts
    at inf with ``minv[0] = -inf``; ``cur = (a[i0] - u[i0]) - v``; a column
    improves on a strict ``cur < minv``; ``j1`` is the first minimum of
    ``minv`` over the unused columns; then the dual updates and the
    backtrack.  Raises ``ValueError`` where a step finds no finite unused
    column (a non-finite cost; the JAX solver loops forever there)."""
    n = cost.shape[0]
    a = F.pad(cost, (1, 0, 1, 0))  # (n+1, n+1), row and column 0 unused
    dev = cost.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    u = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    way = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    # column -> row, as a list for the loop's scalar reads and as a tensor
    # for the dual update's scatter (p changes only in the backtrack)
    p = [0] * (n + 1)
    p_t = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    steps = 0
    for i in range(1, n + 1):
        p[0] = i
        p_t[0] = i
        minv = torch.full((n + 1,), float("inf"), dtype=torch.float32, device=dev)
        minv[0] = -float("inf")
        free = torch.ones(n + 1, dtype=torch.bool, device=dev)  # ~used
        j0 = 0
        while True:
            steps += 1
            free[j0] = False
            i0 = p[j0]
            cur = (a[i0] - u[i0]) - v
            better = (cur < minv) & free
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(free, minv, inf)
            j1 = int(torch.argmin(masked))  # the first minimum
            delta = masked[j1]
            if not float(delta) < float("inf"):
                raise ValueError("solve_lap needs finite costs: a step found no finite unused column")
            # u[p[j]] += delta for used j (distinct rows), + 0.0 elsewhere
            u.index_add_(0, p_t, torch.where(free, zero, delta))
            v = torch.where(free, v, v - delta)
            minv = torch.where(free, minv - delta, minv)
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:  # the augmenting path
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
        p_t = torch.tensor(p, dtype=torch.int64, device=dev)
    row_to_col = torch.empty(n, dtype=torch.int32, device=dev)
    row_to_col[p_t[1:] - 1] = torch.arange(n, dtype=torch.int32, device=dev)
    return row_to_col, steps


def solve_lap_plain(cost: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: :func:`jv_plain` on each (n, n) matrix of
    an (n, n) or (B, n, n) float32 tensor; row_to_col (n,) or (B, n)
    int32."""
    if cost.dim() == 2:
        return jv_plain(cost)[0]
    out = torch.empty(cost.shape[:-1], dtype=torch.int32, device=cost.device)
    for b in range(cost.shape[0]):
        out[b] = jv_plain(cost[b])[0]
    return out


def _check_lap(cost: torch.Tensor) -> None:
    if (
        cost.dtype != torch.float32
        or cost.dim() not in (2, 3)
        or cost.shape[-1] != cost.shape[-2]
        or not cost.is_contiguous()
    ):
        raise ValueError(
            f"solve_lap takes a contiguous float32 (n, n) or (B, n, n) tensor; got {cost.dtype} "
            f"{tuple(cost.shape)} (contiguous={cost.is_contiguous()})"
        )


def build(verbose: bool = False) -> str:
    """Compile ``csrc/lap_jv.cu`` for sm_90a into the build directory (when
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
            for fn in (lib.lap_jv_path, lib.lap_jv_columns):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int]
            lib.lap_jv_launch.restype = ctypes.c_int
            lib.lap_jv_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
    return _lib


def _ask(fn: str, n: int, device) -> int:
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        code = getattr(_load(), fn)(n)
    if code < 0:
        raise RuntimeError(f"lap_jv kernel: cudaError {-code} choosing the instantiation for n = {n}")
    return code


def kernel_path(n: int, device=None) -> str:
    """The path a launch at size n takes on ``device`` (default: the
    current CUDA device): "shared" when the (n, n) cost matrix and the
    vectors kept in shared memory fit in a block's shared memory, else
    "global"."""
    return "shared" if _ask("lap_jv_path", n, device) == 1 else "global"


def kernel_columns(n: int, device=None) -> int:
    """The columns a lane keeps in registers in the kernel's instantiation
    a launch at size n takes (its template K, at least ceil(n / 32): the
    sentinel column 0 is kept apart), or 0 for the kernel that keeps the
    column vectors in shared memory (more than 32 columns a lane, n >
    1024)."""
    return _ask("lap_jv_columns", n, device)


def solve_lap_cuda(cost: torch.Tensor) -> torch.Tensor:
    """One launch of the JV kernel over a contiguous float32 (n, n) or
    (B, n, n) CUDA tensor, on the path :func:`kernel_path` picks:
    row_to_col (n,) or (B, n) int32, what :func:`solve_lap_plain` gives,
    left on the card.  Raises ``ValueError`` on any other input and
    ``RuntimeError`` when the kernel does not build or launch."""
    global launches
    if cost.device.type != "cuda":
        raise ValueError(f"lap_jv kernel needs a CUDA tensor, got {cost.device}")
    _check_lap(cost)
    n = cost.shape[-1]
    b = cost.shape[0] if cost.dim() == 3 else 1
    out = torch.empty(cost.shape[:-1], dtype=torch.int32, device=cost.device)
    if b == 0 or n == 0:
        return out
    lib = _load()
    taken = ctypes.c_int(0)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = lib.lap_jv_launch(cost.data_ptr(), b, n, out.data_ptr(), stream, ctypes.byref(taken))
    if err != 0:
        raise RuntimeError(f"lap_jv kernel launch failed at B = {b}, n = {n}: cudaError {err}")
    launches += 1
    launches_by_path["shared" if taken.value == 1 else "global"] += 1
    return out


def solve_lap(cost: torch.Tensor) -> torch.Tensor:
    """Minimum-cost perfect matching of each square matrix of a contiguous
    float32 (n, n) or (B, n, n) tensor (use ``BIG`` for infeasible pairs;
    the costs must be finite): row_to_col (n,) or (B, n) int32, the column
    of each row.  One launch of the JV kernel on a CUDA tensor (raises if
    it does not build or launch), :func:`solve_lap_plain` on a CPU tensor.
    Never reads a device value on the host."""
    _check_lap(cost)
    if cost.device.type == "cpu":
        return solve_lap_plain(cost)
    return solve_lap_cuda(cost)


def extended_cost(
    cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, gate: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """lapjv's extended square matrix of a gated (R, C) float32 problem
    (``extend_cost=True, cost_limit=gate``): (sq (R + C, R + C) float32,
    feas (R, C) bool).  The real block holds the feasible costs (a pair is
    feasible when its row and column are valid and it costs at most
    ``gate``) and ``gate + 1`` elsewhere; the two opposite blocks hold
    ``gate / 2``, the price of leaving a row or a column unmatched; the
    corner is 0.  float32 arithmetic as the JAX package's."""
    r, c = cost.shape
    n = r + c
    feas = row_valid[:, None] & col_valid[None, :] & (cost <= gate)
    g = np.float32(gate)
    sq = torch.full((n, n), float(g / np.float32(2.0)), dtype=torch.float32, device=cost.device)
    sq[r:, c:] = 0.0
    sq[:r, :c] = torch.where(feas, cost, torch.full_like(cost, float(g + np.float32(1.0))))
    return sq, feas


def masked_assignment(
    cost: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    gate: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated rectangular assignment with lapjv's cost-limit semantics
    (``lap.lapjv(cost, extend_cost=True, cost_limit=gate)``, the call boxmot
    makes): the total matched cost plus ``gate / 2`` per unmatched row and
    column is minimal, so a feasible pair is left unmatched when that is
    globally cheaper.  Invalid rows or columns and pairs costing more than
    ``gate`` never match.  ``cost`` (R, C) float32; returns (match (R,)
    int64 column per row or -1, matched_col (C,) bool), computed with tensor
    operations on the device of the inputs: one :func:`solve_lap` of the
    :func:`extended_cost` matrix, no host sync on a CUDA device."""
    r, c = cost.shape
    sq, feas = extended_cost(cost, row_valid, col_valid, gate)
    row_to_col = solve_lap(sq)[:r].long()
    ok = row_to_col < c
    if c:
        ok = ok & feas.gather(1, row_to_col.clamp(0, c - 1)[:, None])[:, 0]
    match = torch.where(ok, row_to_col, -1)
    matched_col = (match[:, None] == torch.arange(c, device=cost.device)[None, :]).any(0)
    return match, matched_col
