"""Nested span tracer: the host-side timing backbone of the port's telemetry.

Counterpart of ``pta_replicator_tpu/obs/trace.py``, with the same record
schema and exports. Spans are thread-local nested timing scopes
(``with span("freeze"): ...``) recording wall and CPU time plus free-form
attributes. Every completed span is

* aggregated in-process (per-path call counts and totals, always on), and
* appended as one JSON line to ``<telemetry_dir>/events.jsonl`` when a
  sink directory is configured (``configure(dir)``), so a crashed run
  still leaves its partial trace on disk.

Without a sink the records go to a bounded in-memory buffer
(:attr:`Tracer.IDLE_MAX_EVENTS`). Durations come from
``time.perf_counter``, which is monotonic: a backwards step of the wall
clock cannot make one negative. Work handed to another thread nests under
the span that dispatched it through :meth:`Tracer.inherit`.

The JSONL stream is the contract read by :mod:`.report` and by either
package's schema checker; its schema is :data:`EVENT_SCHEMA`. A
Perfetto/``chrome://tracing`` view of the same spans is
:meth:`Tracer.chrome_trace`.

A span measures the host: on the card, kernel launches are asynchronous,
so a span around a launch measures its enqueue, and a span that must
cover the device work closes after the fence its caller already has (a
readback, an event's wait). Nothing here synchronizes the device.

Causal identity is layered on top of span timing: a propagable
:class:`TraceContext` (128-bit trace_id + span_id + parent_id, carried by
a contextvar and handed across threads with :func:`carry` /
:func:`adopt`) stamps every span/event recorded while it is live, and a
coalescing span links the traces it serves through the ``links`` field.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .occupancy import STAGE_SORT_ORDER

SCHEMA_VERSION = 1

#: Required fields (and their JSON types) of each record kind in
#: events.jsonl. ``scripts/check_telemetry_schema.py`` validates captured
#: streams against this table — extend it when adding record kinds.
EVENT_SCHEMA = {
    "span": {
        "type": str,      # literal "span"
        "name": str,      # leaf name
        "path": str,      # "/"-joined ancestry incl. name
        "t0": float,      # start, seconds since epoch
        "wall_s": float,  # wall-clock duration
        "cpu_s": float,   # process CPU time consumed
        "tid": int,       # thread id
        "seq": int,       # process-wide monotonic sequence number
        "attrs": dict,    # free-form JSON-safe attributes
    },
    "event": {
        "type": str, "name": str, "t0": float, "tid": int, "seq": int,
        "attrs": dict,
    },
    "meta": {"type": str, "schema": int, "t0": float},
}

#: OPTIONAL trace-context fields a span/event record may carry when a
#: :class:`TraceContext` was live at record time (and the ``links``
#: fan-in field of a coalescing span). Not part of the required
#: EVENT_SCHEMA — a record without a trace is still valid — but when
#: present the fields must have exactly these shapes, which
#: ``scripts/check_telemetry_schema.py`` validates:
#: ``trace_id`` 32 lowercase hex chars (128-bit), ``span_id`` /
#: ``parent_id`` 16 hex chars (64-bit), ``links`` a list of trace_ids.
TRACE_FIELDS = {
    "trace_id": str,
    "span_id": str,
    "parent_id": str,
    "links": list,
}

#: hex lengths of the id fields (the schema checker's shape contract)
TRACE_ID_HEX = 32
SPAN_ID_HEX = 16



# ---------------------------------------------------------------------
# Trace context: request/chunk-level causal identity across threads.
#
# Span *nesting* is thread-local (the ancestry stacks above); causal
# identity is NOT — one request's life crosses the submitting client
# thread, the coalescing worker, and the engine batch that served N
# requests at once. A TraceContext is the propagable identity:
# a 128-bit trace_id naming the causal chain, a 64-bit span_id naming
# the current hop, and the parent hop's id. It rides a contextvar
# (automatic within a thread), and crosses threads only by EXPLICIT
# handoff: the dispatching side snapshots with carry(), the worker
# wraps its stage in adopt().
#
# Ids are allocated from a seeded counter reset at capture start
# (Tracer.configure), so a replayed run allocates the same ids in the
# same order — captures are diffable. Chunk-shaped work instead derives
# ids purely from content (deterministic_trace_context), so a retried
# sweep chunk's second attempt lands in the SAME trace as its first,
# whatever else ran in between: a multi-attempt trace is one grep.
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Propagable causal identity: ``trace_id`` (128-bit hex) names the
    request/chunk, ``span_id`` (64-bit hex) the current hop,
    ``parent_id`` the hop that caused it (None at the root)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None


#: the live context of the current thread of execution (contextvars:
#: nested spans inherit it automatically; threads need carry()/adopt())
_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("pta_trace_ctx", default=None)
)

# id allocation state: ONE (epoch, counter) tuple swapped atomically —
# the epoch bumps on Tracer.configure so each capture's id stream
# restarts deterministically. Allocators read the tuple in a single
# (GIL-atomic) list access, so a reader racing a reset gets either the
# old pair (whose counter keeps advancing — still unique) or the new
# one, never a fresh counter under a stale epoch (which would re-mint
# epoch-E ids already handed out). next() itself is GIL-atomic — the
# uniqueness the concurrent-submit hammer test pins.
_ID_STATE = [(0, itertools.count())]


def _digest(text: str, nhex: int) -> str:
    return hashlib.blake2b(
        text.encode(), digest_size=nhex // 2
    ).hexdigest()


def reset_trace_ids() -> None:
    """Restart the id stream (new capture epoch). Called by
    ``Tracer.configure``/``reset`` so a capture's ids depend only on
    allocation order within the capture — replays are diffable."""
    with _OPEN_LOCK:
        epoch, _counter = _ID_STATE[0]
        _ID_STATE[0] = (epoch + 1, itertools.count())
        _OPEN_REQUESTS.clear()


def new_trace_context() -> TraceContext:
    """A fresh root context (one per request). Deterministic given the
    capture's allocation order; unique within the process."""
    epoch, counter = _ID_STATE[0]  # one atomic read (see _ID_STATE)
    n = next(counter)
    return TraceContext(
        _digest(f"trace:{epoch}:{n}", TRACE_ID_HEX),
        _digest(f"root:{epoch}:{n}", SPAN_ID_HEX),
    )


def _new_span_id() -> str:
    epoch, counter = _ID_STATE[0]  # one atomic read (see _ID_STATE)
    return _digest(f"span:{epoch}:{next(counter)}", SPAN_ID_HEX)


def deterministic_trace_context(*parts) -> TraceContext:
    """A root context derived purely from ``parts`` — the same parts
    always name the same trace, independent of allocation order. This
    is what makes a retried sweep chunk's second attempt land in the
    SAME trace as its first (a multi-attempt trace), and a resumed
    sweep's chunk lineage survive the process boundary."""
    base = ":".join(str(p) for p in parts)
    return TraceContext(
        _digest(f"trace:{base}", TRACE_ID_HEX),
        _digest(f"root:{base}", SPAN_ID_HEX),
    )


def chunk_trace_context(scope, i: int) -> TraceContext:
    """The canonical chunk trace: ``scope`` is the sweep's identity
    (utils.sweep passes the checkpoint path, so retries AND resumes of
    the same sweep stitch into the same per-chunk traces), ``i`` the
    chunk index."""
    return deterministic_trace_context("chunk", scope, int(i))


def current_trace() -> Optional[TraceContext]:
    """The live context of this thread of execution (None untraced)."""
    return _CTX.get()


def carry() -> Optional[TraceContext]:
    """Snapshot the live context for handoff to another thread — the
    dispatching half of the carry()/adopt() pair. (An alias of
    :func:`current_trace`, named for the handoff idiom.)"""
    return _CTX.get()


@contextlib.contextmanager
def adopt(ctx: Optional[TraceContext]):
    """Adopt ``ctx`` as this thread's live trace context for the
    duration — the worker half of the carry()/adopt() handoff. ``None``
    adopts "untraced" (a no-op shield), so workers can adopt whatever
    carry() returned without branching."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


# -- open-request registry ---------------------------------------------
# Requests whose trace is still open (submitted, not yet resolved or
# expired). The likelihood server registers/resolves; the flight
# recorder's postmortem flushes the survivors — so a killed serving
# process names exactly which in-flight requests died with it. Bounded:
# oldest entries drop past the cap (an OrderedDict ring).

_OPEN_LOCK = threading.Lock()
_OPEN_REQUESTS: "collections.OrderedDict[str, dict]" = (
    collections.OrderedDict()
)
OPEN_REQUESTS_CAP = 1024


def register_open_request(ctx: TraceContext, **info) -> None:
    with _OPEN_LOCK:
        if len(_OPEN_REQUESTS) >= OPEN_REQUESTS_CAP:
            _OPEN_REQUESTS.popitem(last=False)
        _OPEN_REQUESTS[ctx.trace_id] = {
            "trace_id": ctx.trace_id,
            "since": time.time(),
            **{k: _json_safe(v) for k, v in info.items()},
        }


def resolve_open_request(ctx: TraceContext) -> None:
    with _OPEN_LOCK:
        _OPEN_REQUESTS.pop(ctx.trace_id, None)


def open_request_count() -> int:
    return len(_OPEN_REQUESTS)


def open_requests(timeout: Optional[float] = None) -> List[dict]:
    """Snapshot of the still-open request traces (oldest first). The
    bounded acquire serves the signal-time postmortem flush, degrading
    to an unlocked best-effort copy — same convention as the tracer."""
    acquired = _OPEN_LOCK.acquire(
        timeout=-1 if timeout is None else timeout
    )
    try:
        try:
            return [dict(v) for v in _OPEN_REQUESTS.values()]
        except RuntimeError:  # torn dict iteration (unlocked read)
            return []
    finally:
        if acquired:
            _OPEN_LOCK.release()


def _json_safe(value):
    """Coerce an attribute value to something json.dumps accepts."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    try:  # numpy scalars
        return float(value)
    except Exception:
        return repr(value)


class Tracer:
    """Span recorder with per-path aggregation and an optional JSONL sink.

    One process-global instance (:data:`TRACER`) serves the whole library;
    construct private instances only in tests.
    """

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = itertools.count()
        self._max_events = max_events
        self._events: list = []
        self._dropped = 0
        self._agg: Dict[str, dict] = {}
        self._dir: Optional[str] = None
        self._sink = None
        self._listeners: list = []
        # tid -> that thread's live span stack (the list _stack() mutates
        # in place), so another thread can snapshot what is open NOW —
        # the flight recorder's heartbeat reads this
        self._thread_stacks: Dict[int, list] = {}
        #: monotonic time of the last span open/close anywhere in the
        #: process — the flight-recorder watchdog's liveness signal
        self.last_activity = time.monotonic()

    # -- configuration -------------------------------------------------
    def configure(self, directory: Optional[str]) -> None:
        """Set (or clear, with None) the on-disk telemetry directory.

        An existing events.jsonl in the directory is truncated: one
        capture dir describes one run (re-running --telemetry into the
        same dir must not merge span streams against a fresh
        metrics.json — the report would double-count every stage).
        Within a run the stream is append-as-you-go, so a crash still
        leaves everything up to the last completed span on disk.
        """
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            self._dir = directory
            if directory is not None:
                # new capture epoch: the trace-id stream restarts so a
                # replayed run allocates the same ids in the same order
                reset_trace_ids()
                os.makedirs(directory, exist_ok=True)
                self._sink = open(
                    os.path.join(directory, "events.jsonl"), "w", buffering=1
                )
                self._sink.write(json.dumps({
                    "type": "meta", "schema": SCHEMA_VERSION,
                    "t0": time.time(), "pid": os.getpid(),
                }) + "\n")

    @property
    def directory(self) -> Optional[str]:
        return self._dir

    # -- recording ------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._thread_stacks[threading.get_ident()] = stack
        return stack

    #: event-buffer cap while NO sink is configured: enough for tests and
    #: ad-hoc chrome_trace() exports, small enough that always-on library
    #: instrumentation can't grow a long-lived process by more than ~MB
    IDLE_MAX_EVENTS = 2000

    def _record(self, rec: dict) -> None:
        if rec["type"] == "span":
            # span completions (not instant events) feed the watchdog's
            # liveness clock — the watchdog's own stall event must not
            # reset the very stall it is reporting
            self.last_activity = time.monotonic()
        # serialize outside the lock (racy sink check is benign: worst
        # case one wasted dumps, or a late serialize under the lock) so
        # concurrent pool-worker spans don't contend on JSON encoding
        line = json.dumps(rec) + "\n" if self._sink is not None else None
        with self._lock:
            cap = (
                self._max_events if self._sink is not None
                else min(self._max_events, self.IDLE_MAX_EVENTS)
            )
            if len(self._events) < cap:
                self._events.append(rec)
            else:
                self._dropped += 1
            if rec["type"] == "span":
                agg = self._agg.get(rec["path"])
                if agg is None:
                    agg = self._agg[rec["path"]] = {
                        "calls": 0, "total_s": 0.0, "cpu_s": 0.0,
                        "max_s": 0.0, "first_seq": rec["seq"],
                    }
                agg["calls"] += 1
                agg["total_s"] += rec["wall_s"]
                agg["cpu_s"] += rec["cpu_s"]
                agg["max_s"] = max(agg["max_s"], rec["wall_s"])
            if self._sink is not None:
                self._sink.write(
                    line if line is not None else json.dumps(rec) + "\n"
                )
            listeners = list(self._listeners)
        # outside the lock: a listener (the flight recorder's ring
        # buffer) may itself take locks or do I/O, and must never be
        # able to deadlock or throw through span recording
        for fn in listeners:
            try:
                fn(rec)
            except Exception:
                pass

    @contextlib.contextmanager
    def span(self, name: str, links=None, **attrs):
        """Time a nested stage. Yields the (mutable) attrs dict so callers
        can attach results computed inside the span::

            with tracer.span("freeze", npsr=n) as sp:
                ...
                sp["ntoa_max"] = nt

        When a :class:`TraceContext` is live (``adopt``/``new_trace_
        context``), the record carries ``trace_id``/``span_id``/
        ``parent_id`` and nested spans chain under this one. ``links``
        is the fan-in field: a coalescing span (one ``likelihood_batch``
        serving N requests) passes the trace_ids of every request it
        served, so each request's trace stitches through the shared
        batch. Untraced spans pay one contextvar read.
        """
        stack = self._stack()
        path = "/".join(stack + [name])
        stack.append(name)
        self.last_activity = time.monotonic()
        attrs = dict(attrs)
        ctx = _CTX.get()
        token = None
        trace_fields = None
        if ctx is not None:
            sid = _new_span_id()
            trace_fields = (ctx.trace_id, sid, ctx.span_id)
            token = _CTX.set(TraceContext(ctx.trace_id, sid, ctx.span_id))
        t0 = time.time()
        w0 = time.perf_counter()
        c0 = time.process_time()
        try:
            yield attrs
        finally:
            if token is not None:
                _CTX.reset(token)
            stack.pop()
            rec = {
                "type": "span",
                "name": name,
                "path": path,
                "t0": t0,
                "wall_s": time.perf_counter() - w0,
                "cpu_s": time.process_time() - c0,
                "tid": threading.get_ident(),
                "seq": next(self._seq),
                "attrs": {k: _json_safe(v) for k, v in attrs.items()},
            }
            if trace_fields is not None:
                rec["trace_id"], rec["span_id"], rec["parent_id"] = (
                    trace_fields
                )
            if links:
                rec["links"] = [str(t) for t in links]
            self._record(rec)

    def record_span(
        self, name: str, t0: float, wall_s: float, *,
        ctx: Optional[TraceContext] = None, links=None, **attrs
    ) -> None:
        """Record a *synthesized* span measured from timestamps instead
        of a live scope — the shape queue-wait and future-resolution
        need: the interval is known only after the fact, from stamps
        taken on two different threads. ``ctx`` (default: the live
        context) supplies the trace identity; the record is otherwise a
        normal span record (``path`` is the bare name — synthesized
        spans have no thread-local ancestry)."""
        rec = {
            "type": "span",
            "name": name,
            "path": name,
            "t0": float(t0),
            "wall_s": float(wall_s),
            "cpu_s": 0.0,
            "tid": threading.get_ident(),
            "seq": next(self._seq),
            "attrs": {k: _json_safe(v) for k, v in attrs.items()},
        }
        ctx = ctx if ctx is not None else _CTX.get()
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["span_id"] = _new_span_id()
            rec["parent_id"] = ctx.span_id
        if links:
            rec["links"] = [str(t) for t in links]
        self._record(rec)

    def current_stack(self) -> tuple:
        """The calling thread's open-span ancestry (for :meth:`inherit`)."""
        return tuple(self._stack())

    def open_spans(self, timeout: float = None) -> Dict[int, list]:
        """Snapshot of every thread's currently-open span stack,
        ``{tid: [name, ...]}``, threads with nothing open omitted. Reads
        live per-thread lists, so a stack may be one push/pop stale —
        fine for the heartbeat it feeds, never for accounting.

        ``timeout`` bounds the lock acquire for the signal-time
        postmortem flush: the interrupted main-thread frame may be
        suspended *inside* ``_record``'s critical section (the sink
        write happens under the lock), in which case the lock can never
        be released while the flush is waited on. The holder being
        parked also makes an unlocked read quiescent — every other
        writer is blocked on the same lock — so on acquire timeout we
        degrade to a best-effort copy instead of deadlocking."""
        alive = {t.ident for t in threading.enumerate()}
        acquired = self._lock.acquire(
            timeout=-1 if timeout is None else timeout
        )
        try:
            if acquired:
                for tid in [
                    t for t, s in self._thread_stacks.items()
                    if not s and t not in alive
                ]:
                    del self._thread_stacks[tid]  # reap exited workers
                items = list(self._thread_stacks.items())
            else:
                try:  # unlocked emergency snapshot (no reaping)
                    items = list(self._thread_stacks.items())
                except RuntimeError:  # torn dict iteration
                    items = []
        finally:
            if acquired:
                self._lock.release()
        try:
            return {tid: list(stack) for tid, stack in items if stack}
        except RuntimeError:
            return {}

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(record)`` to every completed span/event. The
        callback runs on the recording thread, outside the tracer lock;
        exceptions are swallowed."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    @contextlib.contextmanager
    def inherit(self, stack: tuple):
        """Adopt ``stack`` (a :meth:`current_stack` snapshot from another
        thread) as this thread's span ancestry for the duration.

        Span nesting is thread-local, so work handed to a pool would
        otherwise record its spans at the root; wrapping the worker body
        in ``inherit`` keeps e.g. per-file parse spans nested under the
        ingest span that dispatched them.
        """
        saved = getattr(self._local, "stack", None)
        adopted = self._local.stack = list(stack)
        tid = threading.get_ident()
        with self._lock:
            self._thread_stacks[tid] = adopted
        try:
            yield
        finally:
            restored = saved if saved is not None else []
            self._local.stack = restored
            with self._lock:
                self._thread_stacks[tid] = restored

    def event(self, name: str, **attrs) -> None:
        """Record an instant (zero-duration) event. A live
        :class:`TraceContext` stamps the record with ``trace_id`` and
        ``parent_id`` (the enclosing span) — so a ``faults.fired``
        inside a chunk's drain span greps by the chunk's trace id."""
        rec = {
            "type": "event",
            "name": name,
            "t0": time.time(),
            "tid": threading.get_ident(),
            "seq": next(self._seq),
            "attrs": {k: _json_safe(v) for k, v in attrs.items()},
        }
        ctx = _CTX.get()
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["parent_id"] = ctx.span_id
        self._record(rec)

    # -- inspection / export -------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """Per-path aggregates: calls, total/mean/max wall, total CPU."""
        with self._lock:
            out = {}
            for path, agg in self._agg.items():
                out[path] = {
                    "calls": agg["calls"],
                    "total_s": agg["total_s"],
                    "mean_s": agg["total_s"] / agg["calls"],
                    "max_s": agg["max_s"],
                    "cpu_s": agg["cpu_s"],
                    "first_seq": agg["first_seq"],
                }
            return out

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    #: synthetic tid base for the per-stage occupancy tracks (far above
    #: any real thread id modulo — see chrome_trace)
    _STAGE_TID_BASE = 1 << 22

    def chrome_trace(self) -> dict:
        """The buffered spans as a ``chrome://tracing`` / Perfetto JSON
        object (phase-"X" complete events, microsecond timestamps).

        Stage spans of the staged executors (``occupancy.STAGE_SORT_ORDER``:
        dispatch/drain/io_write/cw_stream_stage/...) are
        lifted onto one synthetic, named track per stage — so the
        pipeline's utilization reads as contiguous per-stage lanes
        (gaps = idle) instead of being scattered across whatever worker
        thread ids the executor happened to spawn.

        Each used stage track also carries an explicit
        ``thread_sort_index`` in dataflow order
        (``occupancy.STAGE_SORT_ORDER``: dispatch -> drain -> io_write,
        prefetch staging after), so viewers render the pipeline top to
        bottom in pipeline order rather than dict/tid order."""
        pid = os.getpid()
        stage_order = list(STAGE_SORT_ORDER)
        stage_tid = {
            name: self._STAGE_TID_BASE + i
            for i, name in enumerate(stage_order)
        }
        used_stages = set()
        trace_events = []
        for rec in self.events():
            if rec["type"] != "span":
                continue
            tid = stage_tid.get(rec["name"], rec["tid"])
            if rec["name"] in stage_tid:
                used_stages.add(rec["name"])
            trace_events.append({
                "name": rec["name"],
                "cat": "host",
                "ph": "X",
                "ts": rec["t0"] * 1e6,
                "dur": rec["wall_s"] * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {**rec["attrs"], "path": rec["path"]},
            })
        meta_events = []
        for name in sorted(used_stages, key=stage_order.index):
            meta_events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": stage_tid[name], "args": {"name": f"stage:{name}"},
            })
            meta_events.append({
                "name": "thread_sort_index", "ph": "M", "pid": pid,
                "tid": stage_tid[name],
                "args": {"sort_index": stage_order.index(name)},
            })
        return {
            "traceEvents": meta_events + trace_events,
            "displayTimeUnit": "ms",
        }

    def flush(self, timeout: float = None) -> None:
        """Flush the JSONL sink. ``timeout`` bounds the lock acquire for
        the signal-time postmortem path (see :meth:`open_spans`); on
        timeout the flush is skipped — the sink is line-buffered enough
        in practice that the black box loses at most the final lines."""
        acquired = self._lock.acquire(
            timeout=-1 if timeout is None else timeout
        )
        if not acquired:
            return
        try:
            if self._sink is not None:
                self._sink.flush()
        finally:
            self._lock.release()

    def reset(self) -> None:
        """Drop buffered events and aggregates (sink file is kept open).
        Also restarts the trace-id stream and clears the open-request
        registry — a reset tracer describes a fresh run."""
        with self._lock:
            self._events.clear()
            self._agg.clear()
            self._dropped = 0
        reset_trace_ids()


#: the process-global tracer used by all library instrumentation
TRACER = Tracer()

span = TRACER.span
event = TRACER.event
configure = TRACER.configure
summary = TRACER.summary
reset = TRACER.reset
flush = TRACER.flush


def traced(name: Optional[str] = None):
    """Decorator form of :func:`span`: wrap every call of the function in
    a span named ``name`` (default: the function's ``__name__``)."""
    import functools

    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with TRACER.span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
