"""Request-batched likelihood serving over a realization bank.

Counterpart of ``pta_replicator_tpu/likelihood/serve.py``. A bank of
residual realizations is projected once through the fixed-noise
:class:`~.gp.ReducedGP` precompute (the only pass over the TOA axis);
after that one request costs a small Cholesky per pulsar, so requests
are coalesced: concurrent requests queue, a worker collects them until a
batch of ``max_batch`` fills or ``max_delay_s`` passes since the oldest,
pads the point block to ``max_batch``, evaluates the whole block against
every realization at once, and resolves each request's future with its
own (R,) log-likelihood row.

Admission control: a bounded queue (``max_queue``) refuses a request
with :class:`ServerSaturated` instead of growing, and a request still
queued past its deadline raises :class:`DeadlineExpired` instead of
being served late. A transient failure of the engine call (the fault
site ``likelihood_batch``, ``faults/inject.py``) is retried once in
place, so one flapped call does not fail ``max_batch`` futures; a fatal
one fails them at once. The bank's projection runs under the
``likelihood_project`` span.

Telemetry, name for name the reference's: the worker runs under a
``likelihood_serve`` span and each coalesced evaluation under a
``likelihood_batch`` span; the ``likelihood.requests``, ``.batches``,
``.batch_size``, ``.evals``, ``.coalesce_efficiency``, ``.queue_depth``,
``.rejected`` and ``.deadline_expired`` metrics, the
``likelihood.rejected`` and ``likelihood.deadline_expired`` events and the
``trace.open_requests`` gauge. Every request gets a
:class:`~..obs.trace.TraceContext` at submit (``future.trace_id``): the
``likelihood_submit`` span on the client's thread, the
``likelihood_queue_wait`` and ``likelihood_resolve`` spans recorded on the
worker, and the ``likelihood_batch`` span that served it (its ``links``)
share that trace id, and an unresolved request stays in the open-request
registry a postmortem flushes. Request latencies and batch fills feed the
streaming P-squared estimators of ``obs/series.py``, so :meth:`stats`
keeps fixed memory however long the server runs. None of it waits for the
card beyond the readback the answer needs.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import PulsarBatch
from ..device import resolve_device
from ..faults import inject as faults
from ..faults.retry import RetryPolicy, is_transient, retry_call
from ..models.batched import Recipe
from ..obs import TRACER, counter, event, gauge, names, span
from ..obs.series import SpanQuantiles
from ..obs.trace import (
    adopt,
    new_trace_context,
    open_request_count,
    register_open_request,
    resolve_open_request,
)
from . import gp
from .infer import _check_axes, _reduced_points, _reducible

_STOP = object()

#: one in-place retry of a transient engine failure (it costs
#: milliseconds); fatal errors fail every future of the batch at once
_ENGINE_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.05, max_delay_s=1.0)


class ServerSaturated(RuntimeError):
    """Admission control refused the request: the bounded queue is at
    ``max_queue``. Back off and resubmit."""


class DeadlineExpired(TimeoutError):
    """The request's deadline passed while it was still queued; it is
    not evaluated late."""


class RealizationBank:
    """Host-side handle on an (R, Np, Nt) residual bank, as a list of chunk
    loaders (each returns an array or tensor of whole realizations), so
    one chunk at a time is resident."""

    def __init__(self, chunks: Sequence, shape: Tuple[int, ...], dtype,
                 lengths: Optional[Sequence[int]] = None):
        self._chunks = list(chunks)
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        #: realizations per chunk (row access loads one chunk); None =
        #: unknown until iterated
        self._lengths = None if lengths is None else [int(n) for n in lengths]
        if len(self.shape) != 3:
            raise ValueError(
                f"realization banks are (R, Np, Nt) residual cubes; got shape {self.shape}"
            )

    @property
    def nreal(self) -> int:
        return self.shape[0]

    def row(self, i: int):
        """One (Np, Nt) realization, loading only its containing chunk."""
        if not 0 <= i < self.nreal:
            raise IndexError(f"row {i} out of range (nreal={self.nreal})")
        lo = 0
        if self._lengths is not None:
            for k, n in enumerate(self._lengths):
                if i < lo + n:
                    return self._chunks[k]()[i - lo]
                lo += n
        for block in self.iter_chunks():
            if i < lo + block.shape[0]:
                return block[i - lo]
            lo += block.shape[0]
        raise IndexError(f"row {i} beyond the bank's chunks")

    @classmethod
    def from_array(cls, arr, chunk: int = 256) -> "RealizationBank":
        """A bank over an in-memory (R, Np, Nt) numpy array or tensor (on
        any device), in chunks of ``chunk`` realizations."""
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        starts = range(0, arr.shape[0], chunk)
        return cls([(lambda lo=lo: arr[lo:lo + chunk]) for lo in starts], arr.shape,
                   arr.dtype, lengths=[min(chunk, arr.shape[0] - lo) for lo in starts])

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str) -> "RealizationBank":
        """A bank over a sweep checkpoint of either package (the
        consolidated npz, or the chunk files of a sweep in progress): sized
        from the chunks' headers alone, each chunk loaded when it is
        read."""
        from ..utils.sweep import iter_checkpoint_chunk_infos, load_checkpoint_chunk

        probe = list(iter_checkpoint_chunk_infos(checkpoint_path))
        if not probe:
            raise FileNotFoundError(
                f"no completed sweep chunks at {checkpoint_path} "
                "(neither a consolidated archive nor chunk files)"
            )
        nreal = sum(shape[0] for _i, shape, _d in probe)
        _, shape0, dtype0 = probe[0]
        loaders = [(lambda i=i: load_checkpoint_chunk(checkpoint_path, i)) for i, _s, _d in probe]
        return cls(loaders, (nreal,) + tuple(shape0[1:]), dtype0,
                   lengths=[s[0] for _i, s, _d in probe])

    def iter_chunks(self):
        for load in self._chunks:
            yield load()

    def load(self):
        blocks = list(self.iter_chunks())
        if isinstance(blocks[0], torch.Tensor):
            return torch.cat(blocks)
        return np.concatenate(blocks, axis=0)


def project_bank(bank: RealizationBank, reduced: gp.ReducedGP, batch: PulsarBatch,
                 prefetch_depth: int = 2) -> gp.GPProjection:
    """Project a whole bank through the ReducedGP precompute:
    ((R, Np), (R, Np, Q)) on the batch's device, under the
    ``likelihood_project`` span. The chunks stream through the prefetch
    layer (``parallel/prefetch.py::prefetch_to_device``): the next chunk
    loads from disk and stages to the card on a worker thread while the
    current one projects, at most ``prefetch_depth`` chunks ahead. A bank
    of tensors is handed over as it is, and moved here."""
    from ..parallel.prefetch import prefetch_to_device

    place = (lambda block: block) if isinstance(bank.dtype, torch.dtype) else None
    parts = []
    with span(names.SPAN_LIKELIHOOD_PROJECT, nreal=bank.nreal) as sp:
        for block in prefetch_to_device(bank.iter_chunks(), depth=prefetch_depth,
                                        device=batch.device, place=place):
            block = block.to(device=batch.device, dtype=reduced.TNT.dtype)
            parts.append(reduced.project(block, batch))
        sp["chunks"] = len(parts)
    return gp.GPProjection(rNr=torch.cat([p.rNr for p in parts]),
                           d=torch.cat([p.d for p in parts]))


@dataclass
class _Request:
    theta: np.ndarray
    future: Future
    t_submit: float  # monotonic
    t_submit_wall: float  # wall clock, the queue-wait span's t0
    ctx: object  # the request's TraceContext
    deadline: Optional[float] = None  # monotonic; None = no deadline


class LikelihoodServer:
    """Request-batched likelihood evaluation over a realization bank.

    ``axes``: the Recipe hyperparameter fields a request supplies (phi-only
    axes: GP amplitudes/slopes of blocks the recipe enables). Each
    :meth:`submit` returns a ``Future`` resolving to the (R,) total log L
    of every realization at that point. ``start()`` spawns the coalescing
    worker; ``stop()`` serves what is queued and joins it. The bank is
    projected at construction, on ``device``."""

    def __init__(self, bank: RealizationBank, batch: PulsarBatch,
                 recipe: Recipe, axes: Sequence[str], design=None,
                 max_batch: int = 8, max_delay_s: float = 0.005,
                 max_queue: Optional[int] = None,
                 request_deadline_s: Optional[float] = None, device="cuda"):
        self.axes = tuple(sorted(axes))
        _check_axes(self.axes)
        if not _reducible(self.axes, recipe):
            raise ValueError(
                f"serving axes {self.axes} must be phi-only hyperparameters (GP "
                "amplitudes/slopes of blocks the base recipe enables)"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue})")
        device = resolve_device(device)
        self.batch, self.recipe = batch.to(device), recipe.to(device)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.request_deadline_s = (
            None if request_deadline_s is None else float(request_deadline_s)
        )
        self.nreal = bank.nreal
        self._reduced = gp.ReducedGP.build(self.batch, self.recipe, design=design)
        self._proj = project_bank(bank, self._reduced, self.batch)
        self._queue: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._closing = False
        self._lock = threading.Lock()
        self._pending = 0  # admitted, not yet picked up by the worker
        self.reset_stats()

    # ------------------------------------------------------- lifecycle

    def start(self) -> "LikelihoodServer":
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._closing = False
        self._started_at = time.monotonic()
        self._worker = threading.Thread(target=self._run, name="likelihood-serve",
                                        daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Serve what is queued, then join the worker. ``submit`` raises
        once the shutdown begins. With a finite ``timeout`` a worker still
        draining raises instead of being abandoned."""
        if self._worker is None:
            return
        with self._lock:
            self._closing = True
        self._queue.put(_STOP)
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            raise RuntimeError(
                f"likelihood-serve worker still draining after {timeout}s — the "
                "server is NOT stopped (retry stop() with a longer/None timeout)"
            )
        self._worker = None

    def __enter__(self) -> "LikelihoodServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------- clients

    def submit(self, deadline_s: Optional[float] = None, **params) -> Future:
        """Queue one hyperparameter point; returns a Future of the (R,)
        per-realization total log L. A request still queued ``deadline_s``
        (default: the server's ``request_deadline_s``) after submission
        raises :class:`DeadlineExpired`. Raises :class:`ServerSaturated`,
        without queueing, when ``max_queue`` requests are waiting."""
        if set(params) != set(self.axes):
            raise ValueError(
                f"request must supply exactly {self.axes}, got {tuple(sorted(params))}"
            )
        theta = np.asarray([float(params[k]) for k in self.axes])
        fut: Future = Future()
        ctx = new_trace_context()
        fut.trace_id = ctx.trace_id
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.request_deadline_s
        deadline = None if deadline_s is None else now + float(deadline_s)
        # the enqueue is atomic with the closing check and the admission
        # count: stop() flips _closing under this lock before posting the
        # sentinel, so every admitted request precedes it in the queue. The
        # submit span wraps the admission, so a refused request leaves a
        # span with its trace id too
        with adopt(ctx), span(names.SPAN_LIKELIHOOD_SUBMIT) as sp:
            with self._lock:
                if self._worker is None or self._closing:
                    raise RuntimeError("server not started (or stopping)")
                rejected = self.max_queue is not None and self._pending >= self.max_queue
                if rejected:
                    self._rejected += 1
                else:
                    self._pending += 1
                    # registered before it is queued: the worker cannot
                    # resolve a request before its registration
                    register_open_request(ctx, kind="likelihood_request",
                                          params={k: float(params[k]) for k in self.axes})
                    self._queue.put(_Request(theta, fut, now, time.time(), ctx, deadline))
            # telemetry outside the admission lock: under saturation every
            # submit lands here, and the event is a write to the sink
            if rejected:
                counter(names.LIKELIHOOD_REJECTED).inc()
                sp["rejected"] = True
                event(names.EVENT_LIKELIHOOD_REJECTED, max_queue=self.max_queue)
                raise ServerSaturated(
                    f"request queue at max_queue={self.max_queue} — load shed; "
                    f"back off and resubmit (trace {ctx.trace_id})"
                )
        gauge(names.TRACE_OPEN_REQUESTS).set(open_request_count())
        counter(names.LIKELIHOOD_REQUESTS).inc()
        gauge(names.LIKELIHOOD_QUEUE_DEPTH).set(self._queue.qsize())
        return fut

    def evaluate(self, **params) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(**params).result()

    # ---------------------------------------------------------- worker

    def _run(self) -> None:
        with span(names.SPAN_LIKELIHOOD_SERVE, max_batch=self.max_batch,
                  max_delay_s=self.max_delay_s):
            stopping = False
            while not stopping:
                item = self._queue.get()
                if item is _STOP:
                    break
                reqs = [item]
                deadline = item.t_submit + self.max_delay_s
                while len(reqs) < self.max_batch:
                    # queued backlog coalesces unconditionally; the deadline
                    # bounds only the wait for requests not yet arrived
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            nxt = self._queue.get(timeout=remaining)
                        except queue.Empty:
                            break
                    if nxt is _STOP:
                        stopping = True
                        break
                    reqs.append(nxt)
                self._serve_batch(reqs)

    def _expire(self, reqs) -> list:
        """Fail the requests whose deadline passed while queued (their
        trace closes with the queue-wait span and an expiry event); return
        the others."""
        now = time.monotonic()
        live = [r for r in reqs if r.deadline is None or now <= r.deadline]
        expired = [r for r in reqs if r.deadline is not None and now > r.deadline]
        if not expired:
            return live
        with self._lock:
            self._deadline_expired += len(expired)
        counter(names.LIKELIHOOD_DEADLINE_EXPIRED).inc(len(expired))
        for r in expired:
            with adopt(r.ctx):
                TRACER.record_span(names.SPAN_LIKELIHOOD_QUEUE_WAIT, r.t_submit_wall,
                                   now - r.t_submit, expired=True)
                event(names.EVENT_LIKELIHOOD_DEADLINE_EXPIRED,
                      waited_s=round(now - r.t_submit, 6))
            resolve_open_request(r.ctx)
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(DeadlineExpired(
                    f"request expired after {now - r.t_submit:.3f}s in the queue "
                    f"(deadline {r.deadline - r.t_submit:.3f}s) (trace {r.ctx.trace_id})"
                ))
        gauge(names.TRACE_OPEN_REQUESTS).set(open_request_count())
        return live

    def _serve_batch(self, reqs) -> None:
        with self._lock:
            self._pending -= len(reqs)
        reqs = self._expire(reqs)
        if not reqs:
            gauge(names.LIKELIHOOD_QUEUE_DEPTH).set(self._queue.qsize())
            return
        nb = len(reqs)
        # each request's queue residence ends at the dequeue (recorded
        # here: its two ends lie on two threads)
        t_deq = time.monotonic()
        for r in reqs:
            with adopt(r.ctx):
                TRACER.record_span(names.SPAN_LIKELIHOOD_QUEUE_WAIT, r.t_submit_wall,
                                   max(0.0, t_deq - r.t_submit))
        theta = np.stack([r.theta for r in reqs])
        # pad to the fixed batch: the padding rows repeat the last request
        theta = np.concatenate([theta, np.repeat(theta[-1:], self.max_batch - nb, axis=0)])
        t0 = time.monotonic()

        def _eval():
            faults.fire(faults.SITE_SERVER_ENGINE, requests=nb)
            return _reduced_points(
                torch.as_tensor(theta, dtype=self.batch.dtype, device=self.batch.device),
                self.axes, self._reduced, self._proj, self.batch, self.recipe,
            ).cpu().numpy()

        try:
            # links: the one batch span names the trace of every request it
            # serves
            with span(names.SPAN_LIKELIHOOD_BATCH, links=[r.ctx.trace_id for r in reqs],
                      requests=nb, capacity=self.max_batch):
                out = retry_call(_eval, policy=_ENGINE_RETRY, classify=is_transient,
                                 scope="serve")
        except Exception as exc:  # delivered to every future of the batch
            fail_wall = time.time()
            for r in reqs:
                # the trace closes on the failure path too
                with adopt(r.ctx):
                    TRACER.record_span(names.SPAN_LIKELIHOOD_RESOLVE, fail_wall, 0.0,
                                       error=repr(exc)[:200])
                resolve_open_request(r.ctx)
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
            gauge(names.TRACE_OPEN_REQUESTS).set(open_request_count())
            return
        done = time.monotonic()
        with self._lock:
            self._requests += nb
            self._batches += 1
            self._busy_s += done - t0
            self._batch_fill.observe(nb)
            for r in reqs:
                self._latency.observe(done - r.t_submit)
            eff = self._requests / (self._batches * self.max_batch)
        counter(names.LIKELIHOOD_BATCHES).inc()
        counter(names.LIKELIHOOD_EVALS).inc(nb * self.nreal)
        gauge(names.LIKELIHOOD_BATCH_SIZE).set(nb)
        gauge(names.LIKELIHOOD_COALESCE_EFFICIENCY).set(round(eff, 6))
        gauge(names.LIKELIHOOD_QUEUE_DEPTH).set(self._queue.qsize())
        done_wall = time.time()
        for k, r in enumerate(reqs):
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(out[k])
            # the resolution closes the trace: from the engine's end to
            # this future's result
            with adopt(r.ctx):
                TRACER.record_span(names.SPAN_LIKELIHOOD_RESOLVE, done_wall,
                                   max(0.0, time.monotonic() - done),
                                   latency_s=round(done - r.t_submit, 6))
            resolve_open_request(r.ctx)
        gauge(names.TRACE_OPEN_REQUESTS).set(open_request_count())

    # ------------------------------------------------------------ SLOs

    def reset_stats(self) -> None:
        """Zero the counts, the percentile estimators and the throughput
        clock (so a measurement can leave out the warm-up)."""
        with self._lock:
            self._latency = SpanQuantiles()
            self._batch_fill = SpanQuantiles()
            self._requests = 0
            self._batches = 0
            self._busy_s = 0.0
            self._rejected = 0
            self._deadline_expired = 0
            self._started_at = time.monotonic()

    def stats(self) -> dict:
        """The SLO block, with the JAX package's keys: request and batch
        counts, coalescing efficiency, throughput since the last reset,
        and the latency and batch-fill summaries (count, min, max and the
        streaming p50/p95/p99 since the reset)."""
        with self._lock:
            requests, batches = self._requests, self._batches
            latency = self._latency.summary()
            fill = self._batch_fill.summary()
            busy_s, rejected = self._busy_s, self._rejected
            expired = self._deadline_expired
            elapsed = time.monotonic() - self._started_at
        evals = requests * self.nreal
        return {
            "requests": requests,
            "batches": batches,
            "nreal": self.nreal,
            "max_batch": self.max_batch,
            "max_delay_s": self.max_delay_s,
            "coalesce_efficiency": requests / (batches * self.max_batch) if batches else 0.0,
            "batch_fill_mean": requests / batches if batches else 0.0,
            "evals": evals,
            "evals_per_s": evals / elapsed if elapsed > 0 else 0.0,
            "requests_per_s": requests / elapsed if elapsed > 0 else 0.0,
            "device_busy_s": round(busy_s, 6),
            "rejected": rejected,
            "deadline_expired": expired,
            "max_queue": self.max_queue,
            "request_deadline_s": self.request_deadline_s,
            "latency": _finite(latency),
            "batch_fill": _finite(fill),
        }


def _finite(summary: dict) -> dict:
    """A :meth:`SpanQuantiles.summary` less its empty entries (no value
    yet, or the infinite min/max of an empty estimator)."""
    return {k: v for k, v in summary.items() if v is not None and np.isfinite(v)}
