"""Run one cell of the benchmark of the PyTorch and CUDA port, once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names
a configuration (``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``), and the traffic file names the driver
(``benchmark/drivers/<driver>.py``) that offers it; each per-layer metric
is read by ``benchmark/metrics/<metric>.py``.  A run:

1. draws both networks' weights from ``--seed`` on the card in their
   published layouts, saves them under ``TMPDIR`` and hands the files to
   the program's loaders (``load_detector_params`` /
   ``load_keypoint_params`` through ``CoordinateModel``), as a user with
   trained weights would;
2. renders the traffic's scenes from the seed, warms up the cell's own
   shapes and measures for ``--seconds``;
3. judges what the window produced against the plain reference
   (:mod:`benchmark.reference.judge`) once the window has closed;
4. prints the numbers compared beside their limits on standard error, then
   one JSON line on standard output: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the end-to-end metrics with ``--trace 0``, the per-layer
   ones with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``,
   and last ``checks``.

It exits 2 with no result when no card (or too few) is there, and 1 when
the JAX package or JAX is loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
#: caches of kernels the program or PyTorch may build, at fixed paths inside
#: the checkout (the program's own nvcc builds go to build/eagle_tpu_torch)
CACHES = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
          "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions")}
#: modules whose presence after the window fails the run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "eagle_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec_of(workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the configuration file, the
    traffic file) of ``workload``."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return bench, cell, load_json(ROOT, conf["file"]), load_json(HERE, "traffic", f"{cell['traffic']}.json")


def metrics_of(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The cell's metrics of the run's kind: end-to-end ones without a
    ``workloads`` key or listing the cell; per-layer ones listing the cell
    (every per-layer metric lists its cells)."""
    name = cell["name"]
    if not trace:
        return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return [m for m in bench["per_layer"] if name in m["workloads"]]


def reader(metric: str):
    """``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = v
    os.environ["USE_FLAX"] = "0"
    bench, cell, config, traffic = spec_of(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from benchmark import common

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = common.Run(args, cell, config, traffic, torch.device("cuda", 0), T_START)
    common.diag(f"card: {power_limit()}; torch {torch.__version__} CUDA {torch.version.cuda}")
    result = driver.run(run)
    # the program's state goes before the reference runs; the peak is read first
    device = device_info(torch, cell["chips"])
    run.free_program()
    gc.collect()
    torch.cuda.empty_cache()
    checks = run.judge(result)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the process: {found}", file=sys.stderr)
        return 1
    metrics = {}
    ctx = result.context
    for m in metrics_of(bench, cell, bool(args.trace)):
        value = result.e2e.get(m["name"]) if not args.trace else reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": result.attempted, "failed": result.failed, "metrics": metrics, "device": device}
    if args.trace and ctx.stretch is not None:
        line["device"].update({"busy_s": ctx.stretch.busy_s(), "window_s": ctx.stretch.window_s})
        line["breakdown"] = ctx.stretch.breakdown()
        from benchmark.trace import BENCHMARK

        common.diag(f"the benchmark's own device work in the traced stretch (the judge's samples): "
                    f"{ctx.stretch.busy_s(BENCHMARK)} s of {ctx.stretch.window_s} s")
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
