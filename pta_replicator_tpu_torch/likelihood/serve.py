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
being served late. The bank's projection runs under the
``likelihood_project`` span; the reference's request spans, trace hops,
``likelihood.*`` SLO counters and engine retry belong to ROADMAP A.16.4.
"""
from __future__ import annotations

import collections
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
from ..models.batched import Recipe
from . import gp
from .infer import _check_axes, _reduced_points, _reducible

_STOP = object()

#: request latencies and batch fills kept for the summaries of
#: :meth:`LikelihoodServer.stats`
LATENCY_WINDOW = 10_000


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
    from ..obs import names, span
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
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.request_deadline_s
        deadline = None if deadline_s is None else now + float(deadline_s)
        # the enqueue is atomic with the closing check and the admission
        # count: stop() flips _closing under this lock before posting the
        # sentinel, so every admitted request precedes it in the queue
        with self._lock:
            if self._worker is None or self._closing:
                raise RuntimeError("server not started (or stopping)")
            if self.max_queue is not None and self._pending >= self.max_queue:
                self._rejected += 1
                raise ServerSaturated(
                    f"request queue at max_queue={self.max_queue} — load shed; "
                    "back off and resubmit"
                )
            self._pending += 1
            self._queue.put(_Request(theta, fut, now, deadline))
        return fut

    def evaluate(self, **params) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(**params).result()

    # ---------------------------------------------------------- worker

    def _run(self) -> None:
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
        """Fail the requests whose deadline passed while queued; return
        the others."""
        now = time.monotonic()
        live = [r for r in reqs if r.deadline is None or now <= r.deadline]
        expired = [r for r in reqs if r.deadline is not None and now > r.deadline]
        with self._lock:
            self._deadline_expired += len(expired)
        for r in expired:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(DeadlineExpired(
                    f"request expired after {now - r.t_submit:.3f}s in the queue "
                    f"(deadline {r.deadline - r.t_submit:.3f}s)"
                ))
        return live

    def _serve_batch(self, reqs) -> None:
        with self._lock:
            self._pending -= len(reqs)
        reqs = self._expire(reqs)
        if not reqs:
            return
        nb = len(reqs)
        theta = np.stack([r.theta for r in reqs])
        # pad to the fixed batch: the padding rows repeat the last request
        theta = np.concatenate([theta, np.repeat(theta[-1:], self.max_batch - nb, axis=0)])
        t0 = time.monotonic()
        try:
            out = _reduced_points(
                torch.as_tensor(theta, dtype=self.batch.dtype, device=self.batch.device),
                self.axes, self._reduced, self._proj, self.batch, self.recipe,
            ).cpu().numpy()
        except Exception as exc:  # delivered to every future of the batch
            for r in reqs:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
            return
        done = time.monotonic()
        with self._lock:
            self._requests += nb
            self._batches += 1
            self._busy_s += done - t0
            self._latency.extend(done - r.t_submit for r in reqs)
            self._batch_fill.append(nb)
        for k, r in enumerate(reqs):
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(out[k])

    # ------------------------------------------------------------ SLOs

    def reset_stats(self) -> None:
        """Zero the counts, the latency window and the throughput clock
        (so a measurement can leave out the warm-up)."""
        with self._lock:
            self._latency = collections.deque(maxlen=LATENCY_WINDOW)
            self._batch_fill = collections.deque(maxlen=LATENCY_WINDOW)
            self._requests = 0
            self._batches = 0
            self._busy_s = 0.0
            self._rejected = 0
            self._deadline_expired = 0
            self._started_at = time.monotonic()

    def stats(self) -> dict:
        """The SLO block, with the JAX package's keys: request and batch
        counts, coalescing efficiency, throughput since the last reset,
        and the latency and batch-fill summaries (count since the reset;
        min, max and percentiles over the last :data:`LATENCY_WINDOW`
        requests and batches)."""
        with self._lock:
            requests, batches = self._requests, self._batches
            latency = np.asarray(self._latency)
            fill = np.asarray(self._batch_fill, np.float64)
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
            "device_busy_s": busy_s,
            "rejected": rejected,
            "deadline_expired": expired,
            "max_queue": self.max_queue,
            "request_deadline_s": self.request_deadline_s,
            "latency": _summary(latency, requests),
            "batch_fill": _summary(fill, batches),
        }


def _summary(values: np.ndarray, count: int) -> dict:
    """count, min, max, p50, p95 and p99 of ``values`` (the count alone
    when there are none)."""
    if values.size == 0:
        return {"count": count}
    out = {"count": count, "min": float(values.min()), "max": float(values.max())}
    out.update({f"p{q}": float(np.percentile(values, q)) for q in (50, 95, 99)})
    return out
