"""Times versions of the device loops' kernels, the auction ``csrc/auction.cu``
and NMS's suppression ``csrc/nms.cu``, against each other on the card, on the
same inputs in one process.

    python -m eagle_tpu_torch.utils.loop_bench [--other LABEL=DIR ...] [--reps 10] [--json out.json]

Builds this checkout's two sources (label ``this``) and those in each other
directory given (another version of the files, for example a parent
commit's ``eagle_tpu_torch/csrc`` unpacked with ``git archive``) with the
kernels' nvcc flags into the build directory.  The auction's C interface
(``auction_launch``) is the same in every version; an NMS source without
``nms_workspace_words`` is the one-block design, whose ``nms_launch``
takes no workspace and refuses more than 1024 candidates (reported as
refused).  The cases:

- the auction at 64 x 192 on ``kernel_cases.auction_round_case``'s
  problems, whose auctions run 0, 1, 4 and 11 rounds (matches and round
  counts checked bit-equal to ``auction_rounds_plain`` on a CPU copy);
- NMS on ``kernel_cases.nms_wide_case`` detector outputs through
  ``batched_nms``'s set-up: 16 images of 512 candidates (the main path's
  batch shape), then one image of 1025, 2048, 4096 and 10,710 (keep
  checked bit-equal to ``suppress_plain`` on the same CUDA tensors).

A sample is ``--launches`` launches enqueued back to back behind a
``torch.cuda._sleep`` (so the host's enqueueing stays off the clock),
timed by CUDA events: the device time a launch, the gaps between a
call's kernels included.  The builds take turns forward and backward (A,
B, B, A, ...) so a drift of the card's clock falls on all alike.  Prints
the card's name and power limit and one line a case and build (mean and
least ms a launch over the samples), and with ``--json`` writes the rows.
The launches go through no counter of ``ops``: they are a comparison, not
the main path.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os

import numpy as np
import torch

from eagle_tpu_torch.native import build_library
from eagle_tpu_torch.ops import assignment, nms
from eagle_tpu_torch.ops.optical_flow import BUILD_DIR, NVCC_FLAGS, _nvcc
from eagle_tpu_torch.utils.kernel_cases import (
    ANCHORS,
    ROUND_CASES,
    auction_round_case,
    nms_wide_case,
    suppress_inputs,
)
from eagle_tpu_torch.utils.lap_bench import card

THIS = os.path.dirname(assignment._AUCTION_SRC)
#: NMS cases: (images, candidates an image)
NMS_SHAPES = ((16, 512), (1, 1025), (1, 2048), (1, 4096), (1, ANCHORS))


def _build(src: str) -> ctypes.CDLL:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    lib_path = os.path.join(BUILD_DIR, "loop_bench", f"lib{stem}_{digest}.so")
    build_library(lib_path, src, lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src])
    return ctypes.CDLL(lib_path)


class Build:
    """One version's two kernels, loaded, behind one call each."""

    def __init__(self, label: str, root: str):
        self.label = label
        self.auction = _build(os.path.join(root, "auction.cu"))
        self.auction.auction_launch.restype = ctypes.c_int
        self.auction.auction_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
        ]
        self.nms = _build(os.path.join(root, "nms.cu"))
        self.workspace = hasattr(self.nms, "nms_workspace_words")
        self.nms.nms_launch.restype = ctypes.c_int
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        if self.workspace:
            self.nms.nms_workspace_words.restype = ctypes.c_longlong
            self.nms.nms_workspace_words.argtypes = [ctypes.c_int, ctypes.c_int]
            args.append(ctypes.c_void_p)
        self.nms.nms_launch.argtypes = [*args, ctypes.c_void_p]

    def auction_call(self, benefit, row_ok, c, match, rounds, tally):
        taken = ctypes.c_int(0)
        r, ctot = benefit.shape

        def call():
            code = self.auction.auction_launch(benefit.data_ptr(), row_ok.data_ptr(), 1, r, ctot, c, 512,
                                               float(np.float32(1e-3)), match.data_ptr(), rounds.data_ptr(),
                                               tally.data_ptr(), torch.cuda.current_stream().cuda_stream,
                                               ctypes.byref(taken))
            if code != 0:
                raise RuntimeError(f"{self.label} auction launch: cudaError {code}")

        return call

    def nms_call(self, shifted, valid, keep):
        """The call, or None where this version refuses the shape.  The
        call holds its workspace for as long as it lives."""
        b, k = valid.shape
        stream = torch.cuda.current_stream().cuda_stream
        work = None
        if self.workspace:
            work = torch.empty(self.nms.nms_workspace_words(b, k), dtype=torch.int32, device=shifted.device)

        def launch():
            extra = (work.data_ptr(),) if work is not None else ()
            return self.nms.nms_launch(shifted.data_ptr(), valid.data_ptr(), b, k, float(np.float32(0.7)),
                                       keep.data_ptr(), *extra, stream)

        if launch() != 0:
            return None

        def call():
            code = launch()
            if code != 0:
                raise RuntimeError(f"{self.label} nms launch: cudaError {code}")

        return call


def timed(calls: dict, reps: int, launches: int) -> dict:
    """{label: [ms a launch of each sample]}, the labels taking turns."""
    names = list(calls)
    for name in names:
        calls[name]()
    torch.cuda.synchronize()
    out = {name: [] for name in names}
    for r in range(reps):
        for name in names if r % 2 == 0 else reversed(names):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            for _ in range(launches):
                calls[name]()
            stop.record()
            stop.synchronize()
            out[name].append(start.elapsed_time(stop) / launches)
    return out


def _row(kernel: str, case: str, label: str, ms: list | None, **extra) -> dict:
    row = {"kernel": kernel, "case": case, "build": label, **extra}
    if ms is None:
        row.update(ms=None, least_ms=None)
        print(f"loop_bench {kernel} {case} {label}: refused", flush=True)
    else:
        row.update(ms=float(np.mean(ms)), least_ms=float(np.min(ms)), samples=len(ms))
        print(f"loop_bench {kernel} {case} {label}: {row['ms']:.5f} ms a launch (least {row['least_ms']:.5f}), "
              f"== plain", flush=True)
    return row


def run(builds: list[Build], reps: int, launches: int) -> list[dict]:
    rows = []
    dev = torch.device("cuda")
    tally = torch.zeros(1, dtype=torch.int64, device=dev)
    for n in sorted(ROUND_CASES):
        cost, rows_ok, cols, gate = auction_round_case(n)
        feas = torch.from_numpy(rows_ok[:, None] & cols[None, :] & (cost <= gate))
        ben, ok = assignment.auction_benefit(torch.from_numpy(cost), feas, gate, max_cardinality=False)
        want_m, want_r = assignment.auction_rounds_plain(ben, ok, cost.shape[1])
        ben, ok = ben.to(dev), ok.to(dev)
        calls = {}
        for bd in builds:
            match = torch.empty(ben.shape[0], dtype=torch.int64, device=dev)
            done = torch.empty((1,), dtype=torch.int32, device=dev)
            calls[bd.label] = bd.auction_call(ben, ok, cost.shape[1], match, done, tally)
            calls[bd.label]()
            torch.cuda.synchronize()
            if not torch.equal(match.cpu(), want_m) or int(done) != int(want_r):
                raise SystemExit(f"loop_bench: {bd.label}'s auction differs from the plain version at {n} rounds")
        for label, ms in timed(calls, reps, launches).items():
            rows.append(_row("auction", f"64x{ben.shape[1]} {n} rounds", label, ms, rounds=n))
    for b, k in NMS_SHAPES:
        shifted, valid = suppress_inputs(*nms_wide_case(k, b=b, seed=k), k, device=dev)
        want = nms.suppress_plain(shifted, valid, 0.7)
        calls, refused = {}, []
        for bd in builds:
            keep = torch.empty((b, k), dtype=torch.bool, device=dev)
            call = bd.nms_call(shifted, valid, keep)
            if call is None:
                refused.append(bd.label)
                continue
            torch.cuda.synchronize()
            if not torch.equal(keep, want):
                raise SystemExit(f"loop_bench: {bd.label}'s NMS differs from the plain version at {b} x {k}")
            calls[bd.label] = call
        case = f"{b}x{k} ({int(valid.sum())} valid, {int(want.sum())} kept)"
        for label, ms in timed(calls, reps, launches).items():
            rows.append(_row("nms", case, label, ms))
        for label in refused:
            rows.append(_row("nms", case, label, None))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], help="LABEL=directory holding auction.cu and nms.cu")
    ap.add_argument("--reps", type=int, default=10, help="samples a case and build")
    ap.add_argument("--launches", type=int, default=20, help="launches a sample")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loop_bench: no CUDA device")
    roots = {"this": THIS}
    for item in args.other:
        label, _, path = item.partition("=")
        roots[label] = path
    builds = [Build(label, root) for label, root in roots.items()]
    device = card()
    print(f"loop_bench card: {device}", flush=True)
    rows = run(builds, args.reps, args.launches)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": device, "sources": roots, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
