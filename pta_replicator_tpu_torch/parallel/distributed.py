"""Multi-process runs: the process group, the topology, each process's
shards and per-process seeds.

Counterpart of ``pta_replicator_tpu/parallel/distributed.py``, on
``torch.distributed``. The realization engine needs no collective (every
shard of ``parallel/mesh.py`` computes from the replicated seed alone), so
the process group, on gloo, coordinates the hosts only: the join, the
device counts each process brings, and a check that every process lays
out the same local mesh. Each process holds a mesh over its own devices;
the global mesh lays the processes out on the 'real' axis, (process,
local device), so process ``p`` computes realizations ``[p * nreal / P,
(p + 1) * nreal / P)`` and persists its own block::

    from pta_replicator_tpu_torch.parallel import distributed, sharded_realize
    distributed.initialize()                       # env://, as torchrun sets it
    mesh = distributed.global_mesh(2, 1)           # this process's 2 devices
    res = sharded_realize(seed, batch, recipe, nreal, mesh=mesh)
    local = distributed.local_realizations(res)    # this process's rows

Single-process (no group and nothing in the environment) every helper
answers for one process.
"""
from __future__ import annotations

import datetime
import hashlib
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, fetch_shard_blocks, make_mesh, visible_devices

#: the variables ``env://`` reads (``torchrun`` sets them)
_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


class _Joined:
    """What this process learned at :func:`initialize`: its local devices
    and every process's device count (process-wide, as the process group
    itself is)."""

    devices: Optional[list] = None
    counts: Optional[list] = None


def _default_devices() -> list:
    return visible_devices() if torch.cuda.is_available() else visible_devices("cpu")


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, devices: Optional[Sequence] = None,
               timeout_s: Optional[float] = None) -> dict:
    """Join (or create) the process group on gloo and return
    :func:`topology`.

    With ``init_method`` (e.g. ``"tcp://127.0.0.1:29500"``), ``rank`` or a
    ``world_size`` above 1 the join is explicit, and a failed explicit
    join raises: carrying on as one process would duplicate the whole
    workload on every host. Without them the group joins from the
    environment (``env://``) when ``torchrun``'s variables are set, and
    otherwise this is one process. Calling it again returns the current
    topology. ``devices`` are the devices this process brings (default:
    its visible cards, or the host); ``timeout_s`` bounds the join."""
    explicit = (init_method is not None or rank is not None
                or (world_size is not None and world_size > 1))
    if not dist.is_initialized():
        from_env = all(k in os.environ for k in _ENV_KEYS)
        if explicit or from_env:
            kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
            try:
                if explicit:
                    dist.init_process_group("gloo", init_method=init_method or "env://",
                                            world_size=-1 if world_size is None else world_size,
                                            rank=-1 if rank is None else rank, **kwargs)
                else:
                    dist.init_process_group("gloo", init_method="env://", **kwargs)
            except (RuntimeError, ValueError):
                # only an implicit join may fail quietly (a stale
                # environment of one process)
                if explicit:
                    raise
        _Joined.devices = [torch.device(d) for d in (devices or _default_devices())]
        _Joined.counts = None
        if dist.is_initialized():
            counts = [None] * dist.get_world_size()
            dist.all_gather_object(counts, len(_Joined.devices))
            _Joined.counts = counts
    return topology()


def shutdown() -> None:
    """Leave the process group (a no-op in one process)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _Joined.devices = _Joined.counts = None


def topology() -> dict:
    """This process's index and the process count, its device count and
    the whole run's."""
    joined = dist.is_initialized()
    local = len(_Joined.devices) if _Joined.devices is not None else len(_default_devices())
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_device_count": local,
        "global_device_count": sum(_Joined.counts) if joined and _Joined.counts else local,
    }


def global_mesh(n_real: Optional[int] = None, n_psr: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """This process's part of the global mesh: an ``(n_real, n_psr)`` mesh
    over its devices (default: those given to :func:`initialize`), placed
    at row ``process_index * n_real`` of a global 'real' axis of
    ``process_count * n_real``. Every process calls it with the same
    shape (checked across the group)."""
    topo = topology()
    if devices is None:
        devices = _Joined.devices if _Joined.devices is not None else _default_devices()
    local = make_mesh(n_real, n_psr, devices=devices)
    if dist.is_initialized():
        shapes = [None] * topo["process_count"]
        dist.all_gather_object(shapes, tuple(local.devices.shape))
        if len(set(shapes)) != 1:
            raise ValueError(f"every process must lay out the same local mesh, got {shapes}")
    return Mesh(local.devices, process_index=topo["process_index"],
                process_count=topo["process_count"])


def local_realizations(arr) -> np.ndarray:
    """This process's shards of a sharded realization array as one numpy
    block: replicas once, pulsar windows of a realization block joined
    along the pulsar axis, realization blocks stacked in order. The other
    processes' rows never move; each process persists its own."""
    block = fetch_shard_blocks(arr)
    if isinstance(block, np.ndarray):
        return block
    rows = {}
    for index, piece in sorted(block.shards, key=lambda s: s[0]):
        rows.setdefault(index[0], []).append(piece)
    return np.concatenate([r[0] if len(r) == 1 else np.concatenate(r, axis=1)
                           for _, r in sorted(rows.items())], axis=0)


def process_seed(seed: int, process_index: Optional[int] = None) -> int:
    """A per-process seed for what a process draws on its own (the
    sharded engine needs none: its shards share the one seed): a fixed
    hash of ``(seed, process_index)`` (63 bits), as the sweep's
    ``chunk_seed`` is."""
    if process_index is None:
        process_index = topology()["process_index"]
    digest = hashlib.sha256(
        f"pta_replicator_tpu_torch.process:{int(seed)}:{int(process_index)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") & ((1 << 63) - 1)
