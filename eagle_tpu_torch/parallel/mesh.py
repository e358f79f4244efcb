"""The rank mesh and batch sharding over torch.distributed (counterpart of
``eagle_tpu/parallel/mesh.py``).

The JAX package builds one program over a mesh of devices and lets XLA
insert the collectives.  Here every rank is a process of its own (SPMD,
the torch idiom: ``torch.multiprocessing.spawn`` or ``torchrun``), which
calls ``torch.distributed.init_process_group`` and then
:func:`make_mesh`.  Every rank runs the same code on its own block of the
batch; :func:`gather_batch` and :func:`gather_objects` rebuild the global
result on every rank.  NCCL carries CUDA tensors between cards; gloo
carries the CPU processes of the tests (and, for its point-to-point
messages, host copies of CUDA tensors).  An error of either backend
raises: nothing falls back.

The JAX package's ``replicated`` sharding has no counterpart beyond "every
rank holds it": a replicated value is one each rank computes or receives
itself.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from eagle_tpu_torch.config import MeshConfig


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh.

    ``order`` lists the group's ranks in mesh order (host-major on a
    ``(dcn, data)`` mesh), ``index`` is this rank's place in it -- the block
    of the batch it holds -- and ``shape`` the grid of ``axis_names``.
    ``group`` is None for a mesh of one rank without a process group."""

    group: object | None
    backend: str | None
    rank: int
    index: int
    size: int
    order: tuple[int, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device


def _rank_device(device, devices, rank: int) -> torch.device:
    if device is not None:
        dev = torch.device(device)
    elif devices is not None:
        dev = torch.device(devices[rank])
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places each rank on a CUDA card by default and none is available; pass "
                'device="cpu" to run the ranks on the CPU'
            )
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: {dev} asked for and no CUDA card is available")
    return same_device(dev)


def same_device(dev) -> torch.device:
    """``dev`` with its index made explicit ("cuda" -> the current card),
    so that two names of one device compare equal."""
    dev = torch.device(dev)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None, device=None) -> Mesh:
    """This rank's mesh over the initialised default process group: 1-D
    ``(data,)``, or with ``cfg.hosts > 1`` a ``(dcn, data)`` grid whose rows
    are hosts (ranks grouped by host, in order of their first rank, as the
    JAX package groups devices by ``process_index``; the same checks hold).

    The rank's device is ``cuda:(LOCAL_RANK % device_count)`` (LOCAL_RANK
    as ``torchrun`` sets it, else the rank) unless ``device`` (e.g. "cpu")
    or ``devices`` (one per rank) says otherwise; CUDA devices become the
    process's current device, as NCCL's object collectives need.

    Without a process group: a mesh of one rank on ``device`` (or the one
    entry of ``devices``); more than one device raises, since each rank of
    a larger mesh is a process of its own.  With no card and no explicit
    CPU it raises."""
    if devices is not None:
        devices = list(devices)
    if not (dist.is_available() and dist.is_initialized()):
        if devices is not None and len(devices) > 1:
            raise ValueError(
                f"a mesh of {len(devices)} devices is {len(devices)} processes, one a rank: start them with "
                "torch.multiprocessing.spawn or torchrun, call torch.distributed.init_process_group in each, "
                "then make_mesh"
            )
        n = cfg.data_parallel or 1
        if n != 1 or cfg.hosts != 1:
            raise ValueError(f"MeshConfig asks for {n} ranks on {cfg.hosts} hosts and no process group is initialised")
        dev = _rank_device(device, devices, 0)
        return Mesh(None, None, 0, 0, 1, (0,), (1,), (cfg.data_axis,), dev)

    size, rank = dist.get_world_size(), dist.get_rank()
    n = cfg.data_parallel or size
    if n != size:
        raise ValueError(f"MeshConfig.data_parallel={n}, but the process group has {size} ranks: a mesh spans the group")
    if devices is not None and len(devices) != size:
        raise ValueError(f"devices: {len(devices)} given for {size} ranks (one a rank)")
    backend = dist.get_backend()
    dev = _rank_device(device, devices, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL carries CUDA tensors; rank {rank} is on {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    order: list[int] = list(range(size))
    shape: tuple[int, ...] = (size,)
    axes: tuple[str, ...] = (cfg.data_axis,)
    if cfg.hosts > 1:
        if n % cfg.hosts:
            raise ValueError(f"{n} devices do not tile {cfg.hosts} hosts")
        hosts = [None] * size
        dist.all_gather_object(hosts, socket.gethostname())
        first = {h: hosts.index(h) for h in hosts}
        order = sorted(range(size), key=lambda r: first[hosts[r]])  # stable: in-host rank order kept
        grid = np.array(order).reshape(cfg.hosts, n // cfg.hosts)
        procs = [{hosts[r] for r in row} for row in grid]
        if len(first) > 1 and any(len(p) > 1 for p in procs):
            raise ValueError(f"devices do not tile {cfg.hosts} hosts evenly: rows span hosts {procs}")
        shape, axes = grid.shape, (cfg.dcn_axis, cfg.data_axis)
    return Mesh(dist.group.WORLD, backend, rank, order.index(rank), size, tuple(order), tuple(shape), axes, dev)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Pad ``axis`` up to a multiple (edge-repeat) so it shards evenly.
    Returns (padded, original_size)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge"), n


def block(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's contiguous block [lo, hi) of ``n`` items split as
    :func:`pad_to_multiple` pads them: blocks of ceil(n / size), the last
    ranks' cut short (or empty) where the pad items would be."""
    b = -(-n // mesh.size)
    return min(mesh.index * b, n), min((mesh.index + 1) * b, n)


def shard_batch(x, mesh: Mesh):
    """This rank's contiguous block of the leading axis (a numpy array or a
    tensor, whose leading axis the mesh size divides; see
    :func:`pad_to_multiple`)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not shard over {mesh.size} ranks; pad_to_multiple first")
    b = n // mesh.size
    return x[mesh.index * b : (mesh.index + 1) * b]


def _transport(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective of the mesh's backend takes: NCCL's on the
    rank's card."""
    return t.to(mesh.device) if mesh.backend == "nccl" else t


def gather_batch(x, mesh: Mesh):
    """The inverse of :func:`shard_batch`: every rank's block, concatenated
    in mesh order along axis 0 (``all_gather``; the blocks share a shape).
    A numpy array comes back as numpy, a tensor on its own device.  Without
    a process group (one rank) ``x`` itself."""
    if mesh.group is None:
        return x
    host = isinstance(x, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(x)) if host else x.contiguous()
    src = _transport(t, mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat([parts[r] for r in mesh.order]).to(t.device)
    return out.numpy() if host else out


def gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` (any picklable value), in mesh order
    (``all_gather_object``; without a process group ``[obj]``)."""
    if mesh.group is None:
        return [obj]
    parts = [None] * mesh.size
    dist.all_gather_object(parts, obj, group=mesh.group)
    return [parts[r] for r in mesh.order]


def shift_right(tensors: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The ring shift of ``jax.lax.ppermute`` with the permutation i -> i + 1
    (mod size) in mesh order: each tensor goes to the next rank, and the
    previous rank's comes back (its own at size 1: no message).  One
    ``batch_isend_irecv``; under gloo, which sends no CUDA tensor, through
    host copies.  The NCCL path at size > 1 (CUDA tensors sent directly)
    has not been run yet: it needs two cards (``ROADMAP.md``)."""
    if mesh.size == 1:
        return [t.clone() for t in tensors]
    nxt = mesh.order[(mesh.index + 1) % mesh.size]
    prv = mesh.order[(mesh.index - 1) % mesh.size]
    host = mesh.backend != "nccl"
    send = [(t.cpu() if host else _transport(t, mesh)).contiguous() for t in tensors]
    recv = [torch.empty_like(s) for s in send]
    ops = [dist.P2POp(dist.isend, s, nxt, group=mesh.group) for s in send]
    ops += [dist.P2POp(dist.irecv, r, prv, group=mesh.group) for r in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]
