"""Times versions of the JV kernel ``csrc/lap_jv.cu`` against each other on
the card, on the same matrices in one process.

    python -m eagle_tpu_torch.utils.lap_bench [--other LABEL=path/to/lap_jv.cu ...]
        [--cases 192:tracking,1025:random] [--reps 10] [--json out.json]

Builds this checkout's ``csrc/lap_jv.cu`` (label ``this``) and each other
source given (another version of the file with the same C interface
``lap_jv_launch``, ``lap_jv_path``: for example a parent commit's, unpacked
with ``git archive``) with the same nvcc flags into the build directory.
On each case, a (n, n) matrix from :func:`lap_costs` with a fixed seed, it
checks every build's indices bit-equal to ``solve_lap_plain`` (which also
gives the augmenting steps), then times each build's launch by CUDA events,
the builds interleaved forward and backward in turn (A, B, B, A, ...) so a
drift of the card's clock falls on all alike.  Prints the card's name and
power limit, one line a case and build (ms a launch, ns a step, the path),
and with ``--json`` writes the rows.  The launches go through no counter of
``ops.assignment``: they are a comparison, not the main path.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess

import numpy as np
import torch

from eagle_tpu_torch.native import build_library
from eagle_tpu_torch.ops.assignment import _CU_SRC, jv_plain
from eagle_tpu_torch.ops.optical_flow import BUILD_DIR, NVCC_FLAGS, _nvcc

DEFAULT_CASES = "192:tracking,192:random,300:tracking,300:random,1024:random,1025:random,2000:random"


def lap_costs(n: int, kind: str, seed: int = 0) -> np.ndarray:
    """(n, n) float32 costs for the exact solver's tests and timings.

    - ``"random"``: uniform on [0, 1);
    - ``"tracking"``: the tracker's extended square matrix (lapjv's
      cost-limit layout as ``masked_assignment`` builds it, gate 0.8) of
      R = n // 3 track slots against C = n - R detection slots holding
      mostly 1.0 IoU distances, a few valid rows and columns;
    - ``"signed_zeros"``: mostly zeros of either sign (-0.0 and +0.0 tie
      under ``<``, so the first minimum must not prefer -0.0) and a few
      0.25, 0.5 and 1.0.
    """
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(0, 1, (n, n)).astype(np.float32)
    if kind == "signed_zeros":
        vals = np.array([-0.0, 0.0, 0.25, 0.5, 1.0], np.float32)
        return vals[rng.choice(5, size=(n, n), p=[0.3, 0.3, 0.15, 0.15, 0.1])]
    r = n // 3
    c = n - r
    cost = np.ones((r, c), np.float32)
    near = rng.uniform(size=(r, c)) < 0.1
    cost[near] = rng.uniform(0.05, 0.95, near.sum())
    feas = (rng.uniform(size=r) < 0.4)[:, None] & (rng.uniform(size=c) < 0.3)[None, :] & (cost <= 0.8)
    sq = np.full((n, n), np.float32(0.8) / np.float32(2), np.float32)
    sq[r:, c:] = 0.0
    sq[:r, :c] = np.where(feas, cost, np.float32(0.8) + np.float32(1))
    return sq


def load(src: str) -> ctypes.CDLL:
    """Build ``src`` (nvcc, the kernel's flags) into the build directory
    under a name of its contents' hash, and load it."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, "lap_bench", f"liblap_jv_{digest}.so")
    build_library(lib_path, src, lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src])
    lib = ctypes.CDLL(lib_path)
    lib.lap_jv_path.restype = ctypes.c_int
    lib.lap_jv_path.argtypes = [ctypes.c_int]
    lib.lap_jv_launch.restype = ctypes.c_int
    lib.lap_jv_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int)]
    return lib


def launch(lib: ctypes.CDLL, cost: torch.Tensor, out: torch.Tensor) -> None:
    taken = ctypes.c_int(0)
    code = lib.lap_jv_launch(cost.data_ptr(), 1, cost.shape[-1], out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream, ctypes.byref(taken))
    if code != 0:
        raise RuntimeError(f"lap_jv launch: cudaError {code}")


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "nvidia-smi: not read"


def run(builds: dict[str, ctypes.CDLL], cases: list[tuple[int, str]], reps: int) -> list[dict]:
    rows = []
    names = list(builds)
    for n, kind in cases:
        cpu = torch.from_numpy(lap_costs(n, kind, seed=n))
        want, steps = jv_plain(cpu)
        cost = cpu.cuda()
        outs = {name: torch.empty(n, dtype=torch.int32, device="cuda") for name in names}
        for name, lib in builds.items():
            launch(lib, cost, outs[name])
            torch.cuda.synchronize()
            if not torch.equal(outs[name].cpu(), want):
                raise SystemExit(f"lap_bench: build {name} differs from solve_lap_plain at n = {n} ({kind})")
        times = {name: [] for name in names}
        for r in range(reps):
            for name in names if r % 2 == 0 else reversed(names):
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                launch(builds[name], cost, outs[name])
                stop.record()
                stop.synchronize()
                times[name].append(start.elapsed_time(stop))
        for name in names:
            ms = float(np.mean(times[name]))
            path = {1: "shared", 2: "global"}.get(builds[name].lap_jv_path(n), "error")
            row = {"n": n, "kind": kind, "build": name, "ms": ms, "steps": steps, "ns_per_step": ms * 1e6 / steps,
                   "path": path, "reps": reps, "bit_equal_to_plain": True}
            print(f"lap_bench n={n} {kind} {name}: {ms:.4f} ms a launch, {steps} steps, "
                  f"{row['ns_per_step']:.1f} ns a step, {path} path, == plain", flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], help="LABEL=path of another lap_jv.cu")
    ap.add_argument("--cases", default=DEFAULT_CASES, help="n:kind,... (kind: random, tracking, signed_zeros)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lap_bench: no CUDA device")
    sources = {"this": _CU_SRC}
    for item in args.other:
        label, _, path = item.partition("=")
        sources[label] = path
    builds = {label: load(path) for label, path in sources.items()}
    cases = [(int(c.split(":")[0]), c.split(":")[1]) for c in args.cases.split(",")]
    device = card()
    print(f"lap_bench card: {device}", flush=True)
    rows = run(builds, cases, args.reps)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": device, "sources": sources, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
