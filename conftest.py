"""Build the repository's native libraries once, before the test workers
start.

Both packages build their host C++ at first use: the JAX package's
``eagle_tpu/native/{_lapjv,_prescale}.so`` next to its sources, the
port's ``build/eagle_tpu_torch/{libprescale,liblapjv}.so`` under a file lock.  The
JAX package's build writes the library in place, so under pytest-xdist a
worker that loads it while another worker is still writing it gets a
truncated file and skips the native tests.  Building here, in the
controlling process (or the only one, without xdist), leaves the workers
only loading.  Imports no JAX: the JAX package's ``native`` module is
loaded by path, without its package."""

from __future__ import annotations

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def _build_native() -> None:
    spec = importlib.util.spec_from_file_location(
        "_eagle_tpu_native_build", os.path.join(ROOT, "eagle_tpu", "native", "__init__.py")
    )
    jax_native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_native)
    jax_native._load()
    jax_native._load_prescale()
    from eagle_tpu_torch import native

    native._load_prescale()
    native._load_lapjv()


def pytest_configure(config) -> None:
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built them
        return
    try:
        _build_native()
    except Exception as e:  # the tests that need a library report it themselves
        print(f"conftest: building the native libraries failed: {e}", file=sys.stderr)
