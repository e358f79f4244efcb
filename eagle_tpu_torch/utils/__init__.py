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
