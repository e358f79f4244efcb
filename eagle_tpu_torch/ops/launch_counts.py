"""The hand-written kernels' launch counts: one registry that every
kernel's wrapper counts through, where it launches its kernel.

A count has a name (``"lk_flow"``) and, where a kernel has several paths
or shapes, details under it (``"lk_flow/k=57"``, ``"auction/registers"``).
Outside a CUDA graph capture a launch is counted on the host, on any
thread, always.  Inside a capture a launch counts only in the counting
scope (:func:`counting`, open in any thread of the process while the step
is captured): there :func:`add` enqueues ``+1`` on a device counter in the
capturing stream, beside the kernel's launch, so the graph holds the
increment and every replay adds one as it runs the kernel, with no Python
running.  Outside the scope a capture holds no increment, and its replays
run only the program's kernels and count nothing: the main path's default.
A device counter must exist before the capture (the first launch outside a
capture makes it); :func:`add` raises in a counted capture when it does
not.

A kernel may also add into a device counter itself (:func:`counter`):
the auction kernel adds its bidding rounds there.  Under :func:`paused`
nothing counts (a captured graph's warm-up step).

Reading a count (:func:`get`) reads the device counters: a host sync.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["add", "counter", "counting", "details", "get", "paused", "reset", "restore", "snapshot"]

_lock = threading.Lock()
_host: dict[str, int] = {}
_device: dict[tuple[str, torch.device], torch.Tensor] = {}
_scratch: dict[tuple[str, torch.device], torch.Tensor] = {}
_local = threading.local()
#: the counting scopes open in the process (:func:`counting`)
_scopes = 0


def _under(name: str, prefixes: tuple[str, ...]) -> bool:
    return not prefixes or any(name == p or name.startswith(p + "/") for p in prefixes)


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _made(name: str, device: torch.device, store: dict) -> torch.Tensor:
    key = (name, torch.device(device))
    with _lock:
        t = store.get(key)
    if t is None:
        if _capturing(key[1]):
            raise RuntimeError(f"no device counter {name!r} on {device}: launch once outside the capture first")
        t = torch.zeros((), dtype=torch.int64, device=device)
        with _lock:
            t = store.setdefault(key, t)
    return t


def counter(name: str, device: torch.device) -> torch.Tensor:
    """The 0-d int64 device counter of ``name`` on ``device`` that a kernel
    adds into itself, made (zero) on first use outside a capture; under
    :func:`paused`, a scratch counter that nothing reads."""
    t = _made(name, device, _device)
    return _made(name, device, _scratch) if getattr(_local, "paused", False) else t


def add(device: torch.device, *names: str) -> None:
    """Count one launch of a kernel on ``device`` under each of ``names``
    (see the module's docstring); nothing under :func:`paused`, nothing in
    a capture outside :func:`counting`."""
    if not _scopes and _capturing(torch.device(device)):
        return
    counters = [_made(n, device, _device) for n in names]
    if getattr(_local, "paused", False):
        return
    if _capturing(torch.device(device)):
        for t in counters:
            t.add_(1)
        return
    with _lock:
        for n in names:
            _host[n] = _host.get(n, 0) + 1


@contextlib.contextmanager
def counting():
    """The counting scope: a step captured inside it counts its launches on
    the device (see the module's docstring).  Scopes nest; the scope is the
    process's, read when a launch is captured."""
    global _scopes
    with _lock:
        _scopes += 1
    try:
        yield
    finally:
        with _lock:
            _scopes -= 1


@contextlib.contextmanager
def paused():
    """Launches in this thread count nothing inside the block, and a kernel
    that adds into a device counter itself adds into a scratch one; the
    device counters are made all the same, ready for a capture."""
    was = getattr(_local, "paused", False)
    _local.paused = True
    try:
        yield
    finally:
        _local.paused = was


def get(name: str) -> int:
    """The launches counted under ``name``: the host's count and every
    device's counter."""
    with _lock:
        host = _host.get(name, 0)
        dev = [t for (n, _), t in _device.items() if n == name]
    return host + sum(int(t.item()) for t in dev)


def details(name: str) -> dict[str, int]:
    """The counts under ``name``'s details: {detail: count}, those counted."""
    with _lock:
        names = {n for n in _host if n.startswith(name + "/")} | {n for n, _ in _device if n.startswith(name + "/")}
    return {n[len(name) + 1:]: c for n in sorted(names) if (c := get(n))}


def reset(*prefixes: str) -> None:
    """Zero the counts of ``prefixes`` and their details (every count when
    none is given).  Device counters are zeroed in place: a captured graph
    keeps writing the same ones."""
    with _lock:
        for n in [n for n in _host if _under(n, prefixes)]:
            del _host[n]
        dev = [t for (n, _), t in _device.items() if _under(n, prefixes)]
    for t in dev:
        t.zero_()


def snapshot() -> tuple[dict, dict]:
    """Every count as it stands (the device counters copied on the
    device)."""
    with _lock:
        return dict(_host), {k: t.clone() for k, t in _device.items()}


def restore(snap: tuple[dict, dict]) -> None:
    """Put every count back to ``snap`` (:func:`snapshot`); a device counter
    made since then goes back to zero."""
    host, dev = snap
    with _lock:
        _host.clear()
        _host.update(host)
        items = list(_device.items())
    for k, t in items:
        if k in dev:
            t.copy_(dev[k])
        else:
            t.zero_()
