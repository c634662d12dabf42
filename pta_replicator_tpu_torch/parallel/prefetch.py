"""Host-to-device tile prefetch and the on-disk plane-tile cache.

Counterpart of ``pta_replicator_tpu/parallel/prefetch.py`` on one device.
The streamed CW catalog (``models/batched.py::cw_stream_response``) never
holds the whole catalog: a host generator emits plane tiles, and
:func:`prefetch_to_device` builds and stages tile ``k+1`` on a worker
thread while the consumer computes on tile ``k``. It is a declaration
over the stage-graph executor (``stages.py``, generator mode).

Window (``depth``): a slot is taken before a tile is built and released
when the consumer comes back for the next one, so at most ``depth`` tiles
exist past the generator: 2 is double buffering, 1 the serial loop.

Staging on the card: the worker copies each tile into a pinned host
buffer (a ring of ``depth + 1``, a buffer reused only after its last copy
finished) and starts the host-to-device copy on a copy stream, then hands
the consumer the device tensors with the copy's event. The consumer makes
its current (compute) stream wait on that event and records the tensors
on it (``record_stream``), so the allocator does not reuse their memory
while its kernels still read them. Only copies run on the side stream.
The generator's numpy work holds the GIL for part of each tile; how much
of the host build overlaps the consumer is measured, not assumed
(``stats``).

Failures mirror the sweep executor: a build or staging exception
re-raises on the consumer's thread unchanged after every earlier tile was
yielded; a transient staging failure (:func:`..faults.retry.is_transient`)
is retried once in place; a staging call wedged past ``stall_timeout_s``
raises :class:`DrainTimeout`.

The cache (:func:`save_plane_tiles` / :func:`load_plane_tiles`) writes a
tile stream into one ``np.load``-compatible archive, member by member,
stamped with a workload fingerprint, in the reference's format.

Telemetry: a ``cw_stream_stage`` span per tile (its build and staging, on
the worker, nested under the consumer's span), the
``cw_stream.bytes_staged`` counter, the ``cw_stream.stage_retries``
counter with a ``faults.retry`` event per absorbed retry, and the
``cw_stream.prefetch_stall_s`` gauge: the consumer's cumulative wait for a
tile, i.e. how far the host build (not the card) holds the stream back.

The fault site ``cw_stream_stage`` (``faults/inject.py``) fires inside each
staging attempt, so an injected transient fault on a tile is absorbed by
the in-place retry. Not ported here: ``prefetch_to_mesh`` (ROADMAP.md
item A.17b).
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..faults import inject as faults
from ..faults.retry import is_transient, retry_event
from ..obs import counter, names
from .stages import DrainTimeout, Stage, StageGraph  # noqa: F401 — DrainTimeout re-exported


def _leaves(tile):
    """A tile's arrays and whether it was a tuple/list of them."""
    if isinstance(tile, (tuple, list)):
        return [np.ascontiguousarray(x) for x in tile], True
    return [np.ascontiguousarray(tile)], False


def _host_place(tile):
    """CPU staging: the tile's arrays as tensors (copies, so a generator
    may reuse its arrays)."""
    leaves, seq = _leaves(tile)
    out = [torch.from_numpy(x.copy()) for x in leaves]
    return tuple(out) if seq else out[0]


class _CudaStager:
    """Pinned ring + copy stream of :func:`prefetch_to_device` on a CUDA
    device (see the module docstring)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device=device)
        self.ring = [[None, None] for _ in range(slots)]  # [pinned buffer, last copy event]
        self.nbytes = 0

    def stage(self, i: int, tile):
        leaves, seq = _leaves(tile)
        nbytes = sum(x.nbytes for x in leaves)
        slot = self.ring[i % len(self.ring)]
        if slot[1] is not None:
            slot[1].synchronize()  # its last copy has read the buffer
        if slot[0] is None or slot[0].numel() < nbytes:
            slot[0] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        out, pos = [], 0
        with torch.cuda.stream(self.copy_stream):
            for x in leaves:
                src = torch.from_numpy(x)
                pinned = slot[0][pos:pos + x.nbytes].view(src.dtype).view(src.shape)
                pinned.copy_(src)
                dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dev.copy_(pinned, non_blocking=True)
                out.append(dev)
                pos += x.nbytes
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        slot[1] = event
        self.nbytes += nbytes
        return (tuple(out) if seq else out[0]), event


def _stage_with_retry(stage_once: Callable, tile: int):
    """One staging operation; a transient failure is retried once in
    place (counted in ``cw_stream.stage_retries``, with a ``faults.retry``
    event), a second failure or a fatal one re-raises unchanged."""
    try:
        return stage_once()
    except BaseException as exc:  # noqa: BLE001 — classified, then re-raised
        if not is_transient(exc):
            raise
        counter(names.CW_STREAM_STAGE_RETRIES).inc()
        retry_event("prefetch", exc, tile=tile, attempt=1)
        return stage_once()


def prefetch_to_device(tiles: Iterable, *, depth: int = 2, device="cuda",
                       place: Optional[Callable] = None,
                       stall_timeout_s: Optional[float] = 900.0,
                       stats: Optional[dict] = None) -> Iterator:
    """Yield each host tile (an array or a tuple of arrays) as tensors on
    ``device``, building and staging up to ``depth`` tiles ahead on a
    worker thread, strictly in input order.

    ``tiles`` is any iterable; its ``next()`` runs on the worker, so the
    host build of a tile overlaps the consumer. ``device`` is the card
    unless the caller asks for the CPU (``device="cpu"`` yields CPU
    tensors); on a CUDA device the tiles stage through pinned buffers on a
    copy stream, and each yielded tensor is ready on the consumer's
    current stream. ``place`` (a callable ``tile -> staged``) replaces the
    staging. ``stats``, when given, receives the executor's stats (the
    worker's busy seconds under ``stage_busy_s["cw_stream_stage"]``, the
    consumer's wait ``stall_s``) and ``bytes_staged`` when the generator
    ends."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1 (got {depth})")
    device = resolve_device(device)
    stager = None
    if place is None:
        if device.type == "cuda":
            stager = _CudaStager(device, depth + 1)
            place = lambda i, tile: stager.stage(i, tile)
        else:
            place = lambda i, tile: _host_place(tile)
    else:
        user_place = place
        place = lambda i, tile: user_place(tile)

    def stage(i, tile, sp):
        nbytes = sum(int(getattr(x, "nbytes", 0))
                     for x in (tile if isinstance(tile, (tuple, list)) else (tile,)))
        def stage_once():
            faults.fire(faults.SITE_PREFETCH_STAGE, tile=i)
            return place(i, tile)

        staged = _stage_with_retry(stage_once, i)
        sp["nbytes"] = nbytes
        counter(names.CW_STREAM_BYTES_STAGED).inc(nbytes)
        return staged

    graph = StageGraph(
        [Stage("cw_stream_stage", fn=stage, span=names.SPAN_CW_STREAM_STAGE,
               index_attr="tile", heartbeat_label="host->device tile staging",
               # the staging busy seconds as occupancy.busy_s, the JAX metric
               busy_gauge=True,
               context=(lambda: torch.cuda.device(device)) if device.type == "cuda" else None,
               thread_name="cw-stream-prefetch")],
        window=depth, drain_timeout_s=stall_timeout_s,
        stall_gauge=names.CW_STREAM_PREFETCH_STALL_S,
        stall_what="host->device tile staging", name="cw-stream",
    )
    staged = graph.iterate(tiles)

    def consume():
        try:
            if stager is None:
                yield from staged
                return
            for tensors, event in staged:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in (tensors if isinstance(tensors, tuple) else (tensors,)):
                    t.record_stream(stream)
                yield tensors
        finally:
            staged.close()  # an abandoned stream stops and joins the worker
            if stats is not None:
                stats.update(graph.stats)
                stats["bytes_staged"] = stager.nbytes if stager is not None else None

    return consume()


# ------------------------------------------------------------ tile cache

#: the archive member carrying the cache's metadata, written last: a
#: truncated archive has none, and the loader refuses it
_META_MEMBER = "meta"


def _tile_members(i: int):
    return f"src{i:06d}.npy", f"psr{i:06d}.npy"


def save_plane_tiles(path: str, tiles: Iterable, fingerprint: str,
                     meta: Optional[dict] = None, durable: bool = False) -> int:
    """Write a plane-tile stream into one ``np.load``-compatible archive at
    ``path``, one tile at a time (members ``src000000.npy``,
    ``psr000000.npy``, ..., ZIP_STORED, exact ``np.save`` bytes), built
    under ``path + ".tmp"`` and renamed into place when complete
    (``durable`` adds the fsyncs of the sweep's checkpoints). Returns the
    tile count. ``fingerprint`` names the workload the tiles belong to;
    :func:`load_plane_tiles` refuses a mismatch."""
    from ..utils.sweep import durable_replace, npy_bytes

    tmp = path + ".tmp"
    ntiles = 0
    zf = zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True)
    try:
        for src, psr in tiles:
            for name, arr in zip(_tile_members(ntiles), (src, psr)):
                with zf.open(name, "w", force_zip64=True) as fh:
                    fh.write(npy_bytes(np.asarray(arr)))
            ntiles += 1
        full_meta = dict(meta or {})
        full_meta["fingerprint"] = str(fingerprint)
        full_meta["ntiles"] = ntiles
        with zf.open(_META_MEMBER + ".npy", "w") as fh:
            fh.write(npy_bytes(np.array(json.dumps(full_meta))))
        zf.close()
        durable_replace(tmp, path, durable)
    except BaseException:
        try:
            zf.close()
        except Exception:  # noqa: BLE001 — best effort; the original error re-raises
            pass
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return ntiles


def load_plane_tiles_meta(path: str) -> dict:
    """The archive's metadata (fingerprint, ntiles, and what the writer
    stamped)."""
    with np.load(path) as z:
        if _META_MEMBER not in z.files:
            raise ValueError(
                f"{path}: no '{_META_MEMBER}' member — truncated or not a plane-tile cache"
            )
        return json.loads(str(z[_META_MEMBER]))


def load_plane_tiles(path: str, expect_fingerprint: Optional[str] = None):
    """Open a tile cache: ``(meta, tile_iterator)``. The iterator reads the
    ``(src, psr)`` tiles lazily, member by member. ``expect_fingerprint``
    refuses a cache written for another workload."""
    meta = load_plane_tiles_meta(path)
    if expect_fingerprint is not None and meta.get("fingerprint") != str(expect_fingerprint):
        raise ValueError(
            f"{path}: plane-tile cache fingerprint {meta.get('fingerprint')!r} != "
            f"expected {str(expect_fingerprint)!r} — rebuild the cache for this workload"
        )

    def _iter():
        with np.load(path) as z:
            for i in range(int(meta["ntiles"])):
                sname, pname = _tile_members(i)
                yield z[sname], z[pname]

    return meta, _iter()
