"""Pipelined chunk executor: the card computes chunk ``i+1`` while chunk
``i`` is read back and written.

Counterpart of ``pta_replicator_tpu/parallel/pipeline.py``, declared over
the stage-graph executor (``stages.py``): the caller's thread dispatches
chunks back to back (PyTorch launches asynchronously, so ``dispatch(i)``
returns a tensor the card is still computing); one reader thread fetches
the results to the host in dispatch order; one writer thread runs
``write(i, block)`` strictly in chunk order, so a chunk file always lands
before the sidecar that marks it done, and chunk ``i`` before ``i+1``.
The window (``depth``, default 2) bounds the chunks in flight; a wedged
readback or write raises :class:`DrainTimeout`. The executor changes when
results are fetched and written, never what is computed.

**Readback on the card** (:class:`PinnedReadback`). A ``.cpu()`` on the
reader thread would run on that thread's current stream, the default
stream, and wait behind chunk ``i+1``'s kernels: the overlap would be
lost. Instead the dispatching thread records an event on its (compute)
stream right after chunk ``i`` (:meth:`PinnedReadback.mark`); the reader
makes a dedicated copy stream wait on that event, copies the result into
a pinned host buffer with ``non_blocking=True`` and waits only for that
copy. ``record_stream`` keeps the caching allocator from handing the
result's memory to a later chunk while the copy still reads it. The
pinned buffers form a ring of ``depth + 1``; a buffer returns to the ring
(:meth:`PinnedReadback.release`) only after the writer has serialized it.

Telemetry: ``dispatch`` / ``drain`` / ``io_write`` spans per chunk (the
worker spans nest under the span that started the pipeline), the
``sweep.inflight_chunks`` and ``sweep.last_dispatched_chunk`` gauges and
the ``pipeline.drain_timeouts`` counter. The dispatch span measures the
launch (kernels run asynchronously); the drain span closes after the
readback's own wait. Each stage's fault site (``dispatch``, ``drain``,
``io_write``; ``faults/inject.py``) fires inside its span.

**Causal tracing**: every chunk gets a deterministic trace context from
``(trace_scope, chunk index)`` (``obs.trace.chunk_trace_context``). The
dispatch span opens under it on the caller's thread, and the context rides
the queues, so the reader's ``drain`` span and the writer's ``io_write``
span (and any ``faults.fired`` event inside them) carry the same trace id:
one chunk's life is one trace in ``events.jsonl``. ``trace_scope``
defaults to a per-call counter; the sweep passes its checkpoint path, so a
supervised retry (a fresh call resuming from the sidecar) re-derives the
same ids and a retried chunk's attempts land in one trace.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..faults import inject as faults
from ..obs import gauge, names
from .stages import DrainTimeout, Stage, StageGraph  # noqa: F401 — DrainTimeout re-exported

#: the default trace scope of each run_pipelined call
_RUN_COUNT = itertools.count()


def _mark_chunk(exc: BaseException, chunk: int) -> None:
    """Attach the failing chunk's index to a stage's exception (types that
    refuse attributes are skipped). The sweep's supervised retry reads it
    back with :func:`failed_chunk`."""
    try:
        exc.pta_chunk = int(chunk)
    except (AttributeError, TypeError):
        pass


def failed_chunk(exc: BaseException) -> Optional[int]:
    """The chunk index a stage attached to ``exc``; None when the failure
    named none (e.g. before the first dispatch)."""
    chunk = getattr(exc, "pta_chunk", None)
    return None if chunk is None else int(chunk)


def host_copy(out) -> np.ndarray:
    """The plain readback of a result: a numpy copy on the host (for a CUDA
    tensor, a copy on the calling thread's current stream)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class PinnedReadback:
    """Device-to-host readback of one chunk result at a time, off the
    compute stream: see the module docstring. ``slots`` pinned buffers
    (``depth + 1`` for a window of ``depth``); :attr:`d2h_ms` collects each
    copy's device time (CUDA events on the copy stream)."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"PinnedReadback reads back CUDA results, not {self.device}")
        self.copy_stream = torch.cuda.Stream(device=self.device)
        self.slots = int(slots)
        self._free: queue.Queue = queue.Queue()
        self._made = 0
        self._lock = threading.Lock()
        self._owner = {}  # id(host array) -> pinned buffer
        self._closed = threading.Event()
        self.d2h_ms: list = []

    def mark(self, out: torch.Tensor):
        """On the dispatching thread, right after ``out`` was launched:
        record an event on the current (compute) stream. Returns what
        :meth:`fetch` takes."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return out, event

    def _buffer(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            make = self._made < self.slots and self._free.empty()
            if make:
                self._made += 1
        if make:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        while True:
            try:
                buf = self._free.get(timeout=0.1)
                break
            except queue.Empty:
                if self._closed.is_set():
                    raise RuntimeError("readback closed while waiting for a pinned buffer")
        if buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def fetch(self, pending) -> np.ndarray:
        """On the reader thread: copy the marked result into a pinned
        buffer on the copy stream, after the compute stream's event, and
        wait for the copy alone. Returns a numpy view of the buffer, valid
        until :meth:`release`."""
        return self.wait(self.issue(pending))

    def issue(self, pending):
        """The first half of :meth:`fetch`: the copy, issued and not waited
        for (a sharded chunk issues every shard's copy first)."""
        out, event = pending
        nbytes = out.numel() * out.element_size()
        buf = self._buffer(nbytes)
        host = buf[:nbytes].view(out.dtype).view(out.shape)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(event)
            start.record(self.copy_stream)
            host.copy_(out, non_blocking=True)
            end.record(self.copy_stream)
        out.record_stream(self.copy_stream)
        return host, buf, start, end

    def wait(self, issued) -> np.ndarray:
        """The second half of :meth:`fetch`: wait for the copy alone."""
        host, buf, start, end = issued
        end.synchronize()
        self.d2h_ms.append(start.elapsed_time(end))
        arr = host.numpy()
        with self._lock:
            self._owner[id(arr)] = buf
        return arr

    def release(self, arr: np.ndarray) -> None:
        """On the writer thread, once ``arr`` is serialized: its buffer
        returns to the ring."""
        with self._lock:
            buf = self._owner.pop(id(arr), None)
        if buf is not None:
            self._free.put(buf)

    def close(self) -> None:
        """Wake a reader waiting for a buffer (the run is over or failed)."""
        self._closed.set()


def dispatch_on_done(i, _out) -> None:
    """How far ahead of the drained and written chunks the dispatcher
    runs."""
    gauge(names.SWEEP_LAST_DISPATCHED_CHUNK).set(i)


def dispatch_stage(dispatch: Callable[[int], object]) -> Stage:
    """The dispatching stage, on the caller's thread (so outside the
    deadline scan: a wedged caller has no observer)."""
    return Stage("dispatch", fn=lambda i, _p, sp: dispatch(i), span=names.SPAN_DISPATCH,
                 fault_site=faults.SITE_DISPATCH, on_done=dispatch_on_done, heartbeat=False)


def drain_stage(fetch: Callable, depth: int) -> Stage:
    """The host-readback stage: waits for the result, frees the window
    slot, feeds the writer through a depth-bounded edge."""
    return Stage("drain", fn=lambda i, dev, sp: fetch(dev), span=names.SPAN_DRAIN,
                 fault_site=faults.SITE_DRAIN, releases_window=True, out_maxsize=depth, heartbeat_label="host readback",
                 thread_name="sweep-drain")


def io_write_stage(write: Callable, release: Optional[Callable] = None) -> Stage:
    """The checkpoint writer, strictly in chunk order; ``release(block)``
    after each write hands a readback buffer back to its ring."""

    def fn(i, block, sp):
        try:
            write(i, block)
        finally:
            if release is not None:
                release(block)

    return Stage("io_write", fn=fn, span=names.SPAN_IO_WRITE,
                 span_attrs=lambda i, block: {"nbytes": int(block.nbytes)},
                 fault_site=faults.SITE_IO_WRITE,
                 heartbeat_label="checkpoint write", thread_name="sweep-io")


def pipeline_stats(g: dict) -> dict:
    """The graph's stats under the sweep pipeline's names (the reference's
    keys; the sweep stamps them into its ``sweep_pipeline`` span)."""
    return {
        "chunks": g["items"],
        "max_inflight": g["max_inflight"],
        "drain_wait_s": g["window_wait_s"],
        "wall_s": g["wall_s"],
        "stage_busy_s": g["stage_busy_s"],
        "occupancy": g["occupancy"],
    }


def run_pipelined(indices: Iterable[int], dispatch: Callable[[int], object],
                  write: Callable[[int, np.ndarray], None], *, depth: int = 2,
                  fetch: Callable = host_copy, release: Optional[Callable] = None,
                  drain_timeout_s: Optional[float] = 900.0,
                  trace_scope: Optional[str] = None) -> dict:
    """Run ``dispatch -> fetch -> write`` over ``indices`` with at most
    ``depth`` chunks in flight.

    ``dispatch(i)`` returns an unfetched result (on the card, pass it
    through :meth:`PinnedReadback.mark`); ``fetch`` brings it to the host
    on the reader thread (:meth:`PinnedReadback.fetch`, or
    :func:`host_copy`); ``write(i, block)`` runs on the writer thread in
    ``indices`` order, then ``release(block)``. Returns the stats
    (``chunks``, ``wall_s``, ``max_inflight``, ``drain_wait_s``: the time
    the dispatcher waited on the full window, ``stage_busy_s``,
    ``occupancy``).

    A failing stage stops the pipeline and its exception re-raises here
    unchanged; a fetch or write past ``drain_timeout_s`` raises
    :class:`DrainTimeout` (None: no deadline). Files written before an
    error are valid completed chunks. Each chunk's stages run under its
    trace context from ``(trace_scope, i)``; ``trace_scope`` defaults to a
    per-call counter."""
    if depth < 2:
        raise ValueError(
            f"pipeline depth must be >= 2 (got {depth}); depth 1 is the "
            "synchronous loop — run it inline, there is nothing to overlap"
        )
    scope = trace_scope if trace_scope is not None else f"pipeline:{next(_RUN_COUNT)}"
    graph = StageGraph(
        [dispatch_stage(dispatch), drain_stage(fetch, depth), io_write_stage(write, release)],
        window=depth, drain_timeout_s=drain_timeout_s, trace_scope=scope,
        timeout_counter=names.PIPELINE_DRAIN_TIMEOUTS,
        inflight_gauge=names.SWEEP_INFLIGHT_CHUNKS, mark_item=_mark_chunk,
        name="sweep",
    )
    return pipeline_stats(graph.run(indices))
