"""Tracing and timing helpers (PyTorch counterpart of
``eagle_tpu/utils/profiling.py``).

- :class:`StageTimer` (defined in ``pipeline/coordinate_model.py``, where
  ``get_coordinates`` takes it): wall seconds per pipeline stage, each span
  also a ``torch.profiler`` range ``stage:<name>``.
- :func:`device_trace`: a ``torch.profiler`` scope over the host and the
  card that writes a Chrome trace (the JAX package's ``jax.profiler``
  trace scope).
- :func:`block`: wait for the device work behind the tensors of a nested
  structure (the JAX package's ``block_until_ready`` helper).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

__all__ = ["StageTimer", "block", "device_trace"]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block (host operations, and the card's kernels
    and copies when CUDA is available) and write its Chrome trace to
    ``log_dir/trace_<time>.json`` on exit (open it in chrome://tracing or
    Perfetto).  Yields the ``torch.profiler.profile`` object."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Synchronise every CUDA device that holds a tensor of ``tree`` (nested
    dicts, lists, tuples and named tuples of tensors and other leaves) and
    return ``tree``: in a timed region, the device work is then done."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree
