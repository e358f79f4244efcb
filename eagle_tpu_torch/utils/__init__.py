"""Shared host-side helpers."""

import os


def available_cpus() -> int:
    """CPU cores this process may run on, not the machine's total.

    The ``prefetch`` / ``overlap`` "auto" settings start worker threads only
    when a spare core exists; on an affinity- or cgroup-restricted host
    ``os.cpu_count()`` counts the machine's cores and would start threads
    that contend with the main thread for the GIL."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # no sched_getaffinity (not Linux)
        return os.cpu_count() or 1


_DEVICE_CONSTANTS: dict = {}


def device_constant(key, make):
    """``make()`` made once under ``key`` (which names the device) and kept:
    a step that re-uploads host constants makes a blocking copy each time,
    which a captured CUDA graph refuses."""
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = make()
    return _DEVICE_CONSTANTS[key]
