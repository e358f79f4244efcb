"""The live cell's name for ``device_idle_share``: the same reader."""

from benchmark.metrics.device_idle_share import read  # noqa: F401
