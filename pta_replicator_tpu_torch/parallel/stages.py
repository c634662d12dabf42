"""Bounded-window stage-graph executor.

Counterpart of ``pta_replicator_tpu/parallel/stages.py``. A graph is a
chain of named :class:`Stage` s, each a callable per item, on its own
worker thread or inline on the previous stage's thread, joined by bounded
FIFO queues. The executor provides, once for every graph:

* **a bounded in-flight window**: a slot is taken before the acquiring
  stage (default: the source) processes an item and released when the
  releasing stage (or, in generator mode, the consumer) is done with it,
  so memory is bounded by ``window`` items however far a stage could run
  ahead;
* **FIFO order per edge**: one thread per stage and FIFO queues, so a
  sink runs strictly in item order (the checkpoint's crash-safety
  contract) and a consumer receives items in input order;
* **a deadline on wedged stages** (:class:`DrainTimeout`): every worker
  stage keeps a heartbeat (the start of the operation in flight), and
  every blocked waiter polls the heartbeats and fails fast instead of
  hanging (workers are daemons, so process exit is never held);
* **exceptions re-raised unchanged** on the caller's thread, in order,
  with the failing item attached through ``mark_item`` (caller mode);
* **stop and drain without stranded items**, and a bounded quiesce of the
  sink before an error re-raises (a retry must not race a live writer);
* **per-stage busy seconds and occupancy** in the stats: each stage
  accumulates the wall seconds of its operations, and the run's stats
  carry ``obs.occupancy.overlap_stats`` of them (duty cycles, overlap
  efficiency and the bottleneck verdict) as ``occupancy``;
* **telemetry**: a stage that declares ``span`` runs each operation under
  that span (``index_attr`` carries the item index), and the executor
  keeps the ``stages.busy_s{stage=}`` and ``stages.edge_inflight{edge=}``
  gauges (items queued per edge) and bumps ``stages.drain_timeouts``.
  Worker threads take the caller's span ancestry (``TRACER.inherit``), so
  their spans nest under the span that started the graph;
* **trace handoff across every thread boundary**: in caller mode a
  ``trace_scope`` gives each item its deterministic
  ``obs.trace.chunk_trace_context(scope, i)``, carried through every edge
  and adopted by every stage of that item, so one chunk's spans and events
  share one trace id (a retried or resumed sweep re-derives the same ids);
  in generator mode the consumer's live context is carried onto the worker
  (``carry()`` / ``adopt()``). Neither launches anything on the card. A
  declaration
  may keep its own metric names (``timeout_counter``, ``inflight_gauge``,
  ``stall_gauge``); gauges are set from host numbers only.

On the card, PyTorch's current stream and device are per thread. A stage
whose worker thread must compute on a given stream declares ``context``
(a zero-argument callable returning a context manager, e.g. one that
sets the device and enters ``torch.cuda.stream(s)``); the worker enters
it once around its loop.

Two modes: :meth:`StageGraph.run` (caller mode: the caller's thread runs
the source stage over ``items`` and the chain ends in a sink; returns
the stats) and :meth:`StageGraph.iterate` (generator mode: the source
group runs on a worker thread, which pulls the ``items`` iterator, and
the caller consumes the results in order).

**Fault sites**: a stage that declares ``fault_site`` fires
``faults.fire(site, <index_attr>=i)`` inside its span, before ``fn``, so
a chaos schedule's fault is attributed to the stage it perturbs
(``faults/inject.py``; one ``None`` check while disarmed).

:func:`fan_out` runs an in-stage parallel part (the sharded-archive
writer's per-shard writes) on a bounded worker set with the same thread
boundary guarantees. Not ported here: the per-device ``replicas`` fan-out
stage (ROADMAP A.17b).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

from ..faults import inject as faults
from ..obs import TRACER, counter, gauge, names, occupancy, span
from ..obs.trace import adopt, carry, chunk_trace_context

_STOP = object()  # queue sentinel: no more items


class DrainTimeout(RuntimeError):
    """A stage operation stalled past the graph's deadline: the device or
    the filesystem is wedged mid-operation."""


def stop_aware_put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded-queue put that stays responsive to ``stop``; False when the
    graph is stopping."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def stage_overdue(started_box: list, timeout_s: Optional[float]) -> bool:
    """True when the heartbeat ``started_box[0]`` (the monotonic start of
    the operation in flight, None between items) is older than
    ``timeout_s``."""
    if timeout_s is None:
        return False
    t0 = started_box[0]
    return t0 is not None and time.monotonic() - t0 > timeout_s


@dataclass
class Stage:
    """One named stage of a :class:`StageGraph`.

    ``fn(i, payload, sp)`` processes item ``i``: ``payload`` is the
    previous stage's result (for a source stage, the item pulled from the
    input), ``sp`` the stage span's attribute dict (a plain dict when
    ``span`` is None), so a stage can stamp measurements
    (``sp["nbytes"] = ...``) without owning the span."""

    name: str
    fn: Callable
    #: span opened around each operation (None: the fn opens its own)
    span: Optional[str] = None
    #: extra span attributes from the item: ``(i, payload) -> dict``
    span_attrs: Optional[Callable] = None
    #: the span and fault attribute carrying the item index (``chunk``, ``tile``)
    index_attr: str = "chunk"
    #: ``faults.fire`` site fired inside the span, before ``fn``
    fault_site: Optional[str] = None
    #: "thread" (its own worker thread and input queue) or "inline" (runs
    #: on the previous stage's thread, in its loop step)
    placement: str = "thread"
    #: bound of the outgoing edge queue (0: unbounded)
    out_maxsize: int = 0
    #: this stage takes the window slot before processing an item
    #: (caller mode; default: the source stage)
    acquires_window: bool = False
    #: finishing an item here frees its window slot (caller mode)
    releases_window: bool = False
    #: takes part in the DrainTimeout deadline scan
    heartbeat: bool = True
    #: mirror the cumulative busy seconds to ``occupancy.busy_s{stage=}``
    #: (the prefetch's contract; the run's stats carry them either way)
    busy_gauge: bool = False
    #: what the DrainTimeout message calls this stage ("host readback")
    heartbeat_label: Optional[str] = None
    #: zero-argument callable returning a context manager that the stage's
    #: worker thread enters around its loop (the thread's CUDA device and
    #: stream); only for the head stage of a thread group
    context: Optional[Callable] = None
    #: worker thread name (default "<graph name>-<stage name>")
    thread_name: Optional[str] = None
    #: hook ``(i, result) -> None`` after the span closed and the busy time
    #: was counted (counters, progress gauges)
    on_done: Optional[Callable] = None

    @property
    def what(self) -> str:
        return self.heartbeat_label or f"stage {self.name!r}"


class _Abandoned:
    """The item was dropped because the graph is stopping."""


_ABANDONED = _Abandoned()


class StageGraph:
    """A declared chain of stages over bounded FIFO edges. One-shot: build
    a graph per run.

    ``window`` bounds the items in flight between the acquiring stage and
    the releasing stage (caller mode) or the consumer (generator mode).
    ``trace_scope`` derives each item's deterministic
    :func:`~..obs.trace.chunk_trace_context`, carried through every edge and
    adopted by every stage of that item (caller mode); generator mode
    carries the consumer's live context onto its worker instead.
    ``mark_item(exc, i)`` attaches the failing item's index to a stage's
    exception (caller mode). ``timeout_counter``, ``inflight_gauge`` and
    ``stall_gauge`` keep a declaration's own metric names beside the
    executor's ``stages.*`` ones."""

    def __init__(self, stages: Sequence[Stage], *, window: Optional[int] = None,
                 drain_timeout_s: Optional[float] = 900.0,
                 trace_scope: Optional[str] = None,
                 timeout_counter: Optional[str] = None,
                 inflight_gauge: Optional[str] = None,
                 stall_gauge: Optional[str] = None,
                 stall_what: str = "staging", mark_item: Optional[Callable] = None,
                 name: str = "stage_graph"):
        if not stages:
            raise ValueError("a stage graph needs at least one stage")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
        acquirers = [s for s in stages if s.acquires_window]
        if len(acquirers) > 1:
            raise ValueError("at most one stage may acquire the window")
        self._stages = list(stages)
        self._acquirer = acquirers[0] if acquirers else stages[0]
        self.window = window
        self.drain_timeout_s = drain_timeout_s
        self.trace_scope = trace_scope
        self.timeout_counter = timeout_counter
        self.inflight_gauge = inflight_gauge
        self.stall_gauge = stall_gauge
        self.stall_what = stall_what
        self.mark_item = mark_item
        self.name = name
        self.stats: dict = {}
        self._stop = threading.Event()
        self._errors: list = []  # [(stage name, exc)]: the first wins
        self._lock = threading.Lock()
        self._window = threading.Semaphore(window) if window is not None else None
        self._inflight = 0
        self._timeout_fired = False  # the deadline counters count once a graph
        self._busy = {s.name: 0.0 for s in self._stages}
        self._beats: List[Tuple[Stage, list]] = []
        self._stats = {"items": 0, "max_inflight": 0, "window_wait_s": 0.0, "stall_s": 0.0}

    # ------------------------------------------------------- internals

    def _groups(self) -> List[List[Stage]]:
        """One thread's worth of stages each: a head (the source or a
        thread-placed stage) and its trailing inline stages."""
        groups: List[List[Stage]] = [[self._stages[0]]]
        for st in self._stages[1:]:
            if st.placement == "inline":
                groups[-1].append(st)
            elif st.placement == "thread":
                groups.append([st])
            else:
                raise ValueError(
                    f"stage {st.name!r}: unknown placement {st.placement!r} (thread | inline)"
                )
        return groups

    def _fail(self, stage_name: str, exc: BaseException, item=None) -> None:
        if item is not None and self.mark_item is not None:
            self.mark_item(exc, item)
        with self._lock:
            self._errors.append((stage_name, exc))
        self._stop.set()

    def _bump(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta
            self._stats["max_inflight"] = max(self._stats["max_inflight"], self._inflight)
            if self.inflight_gauge:
                gauge(self.inflight_gauge).set(self._inflight)

    def _new_beat(self, stage: Stage) -> list:
        box = [None]
        if stage.heartbeat:
            with self._lock:
                self._beats.append((stage, box))
        return box

    def _bump_timeout_counters(self) -> bool:
        """Count one deadline episode: True for the one waiter that claims
        it (several blocked waiters poll the heartbeats at once)."""
        with self._lock:
            if self._timeout_fired:
                return False
            self._timeout_fired = True
        counter(names.STAGES_DRAIN_TIMEOUTS).inc()
        if self.timeout_counter:
            counter(self.timeout_counter).inc()
        return True

    def _check_deadline(self) -> None:
        """Caller mode: fail the graph on the first overdue heartbeat."""
        if self._stop.is_set():
            return
        with self._lock:
            beats = list(self._beats)
        for stage, box in beats:
            if stage_overdue(box, self.drain_timeout_s):
                if not self._bump_timeout_counters():
                    return  # a concurrent waiter claimed it
                self._fail(stage.name, DrainTimeout(
                    f"{stage.what} exceeded {self.drain_timeout_s:.0f}s — device or "
                    "filesystem wedged"))
                return

    def _overdue_any(self) -> bool:
        with self._lock:
            beats = list(self._beats)
        return any(stage_overdue(box, self.drain_timeout_s) for _s, box in beats)

    def _forward(self, q: queue.Queue, item) -> bool:
        """Stop-aware put that polls the deadline while blocked on a full
        edge: when this edge's consumer is wedged, the producer blocked
        here may be its only live observer."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                self._check_deadline()
        return False

    @staticmethod
    def _edge_gauge(label: str, q: queue.Queue) -> None:
        gauge(names.STAGES_EDGE_INFLIGHT, edge=label).set(q.qsize())

    def _account(self, stage: Stage, dt: float) -> None:
        with self._lock:
            self._busy[stage.name] += dt
            busy = self._busy[stage.name]
        gauge(names.STAGES_BUSY_S, stage=stage.name).set(round(busy, 6))
        if stage.busy_gauge:
            gauge(names.OCCUPANCY_BUSY_S, stage=stage.name).set(round(busy, 6))

    @staticmethod
    def _call(stage: Stage, i, payload, attrs: dict) -> Any:
        """``stage.fn`` under the stage's span (when it declares one)."""
        if stage.span_attrs is not None:
            attrs.update(stage.span_attrs(i, payload))
        if stage.span is None:
            if stage.fault_site:
                faults.fire(stage.fault_site, **{stage.index_attr: i})
            return stage.fn(i, payload, attrs)
        with span(stage.span, **attrs) as sp:
            if stage.fault_site:
                faults.fire(stage.fault_site, **{stage.index_attr: i})
            return stage.fn(i, payload, sp)

    def _execute(self, stage: Stage, i, payload, ctx, box) -> Any:
        """One stage operation: heartbeat, the item's trace context
        (``ctx``, None: the thread's own), span, busy accounting and
        ``on_done``; exceptions clear the heartbeat and re-raise
        unchanged."""
        box[0] = time.monotonic()
        try:
            with adopt(ctx) if ctx is not None else contextlib.nullcontext():
                out = self._call(stage, i, payload, {stage.index_attr: i})
            dt = time.monotonic() - box[0]
        finally:
            box[0] = None
        self._account(stage, dt)
        if stage.on_done is not None:
            stage.on_done(i, out)
        return out

    def _run_windowed(self, stage: Stage, i, payload, ctx, box) -> Any:
        """One stage with its window ceremony; ``_ABANDONED`` when the
        graph stopped under the operation."""
        if self._window is not None and stage is self._acquirer:
            t_wait = time.monotonic()
            while not self._window.acquire(timeout=0.1):
                self._check_deadline()
                if self._stop.is_set():
                    break
            with self._lock:
                self._stats["window_wait_s"] += time.monotonic() - t_wait
            if self._stop.is_set():
                return _ABANDONED
        out = self._execute(stage, i, payload, ctx, box)
        if self._window is not None and stage is self._acquirer:
            self._bump(+1)
        if stage.releases_window and self._window is not None:
            if self._stop.is_set():
                # an abandoned run: a retry may be live, so a late
                # operation must not touch the window under its feet
                return _ABANDONED
            self._bump(-1)
            self._window.release()
        return out

    @staticmethod
    def _context(stage: Stage):
        return stage.context() if stage.context is not None else contextlib.nullcontext()

    # ------------------------------------------------------ caller mode

    def run(self, items: Iterable) -> dict:
        """Caller mode: the caller's thread runs the source group over
        ``items``; each thread-placed stage drains its input queue on its
        own daemon thread; the last stage is the sink. Returns the stats
        (also on ``self.stats``): ``items``, ``wall_s``, ``max_inflight``,
        ``window_wait_s``, ``stall_s``, ``stage_busy_s``, ``occupancy``.

        A failing stage stops the graph and its exception re-raises
        unchanged here; an operation wedged past ``drain_timeout_s``
        raises :class:`DrainTimeout`. On error the sink is quiesced
        (bounded) before the raise."""
        groups = self._groups()
        queues = [queue.Queue(maxsize=groups[g][-1].out_maxsize)
                  for g in range(len(groups) - 1)]
        edges = [f"{groups[g][-1].name}->{groups[g + 1][0].name}"
                 for g in range(len(groups) - 1)]
        stop = self._stop
        stack = TRACER.current_stack()  # worker spans nest under the caller's
        boxes = {id(st): self._new_beat(st) for grp in groups for st in grp}
        # the caller runs the source group itself: a wedged source is a
        # wedged caller, which nothing downstream can observe
        with self._lock:
            self._beats = [(st, box) for st, box in self._beats
                           if not any(st is s for s in groups[0])]

        def thread_main(g: int) -> None:
            in_q = queues[g - 1]
            sink = g == len(groups) - 1
            with TRACER.inherit(stack), self._context(groups[g][0]):
                while True:
                    item = in_q.get()
                    if item is _STOP or stop.is_set():
                        break
                    i, payload, ctx = item
                    self._edge_gauge(edges[g - 1], in_q)
                    failed = False
                    for st in groups[g]:
                        try:
                            payload = self._run_windowed(st, i, payload, ctx, boxes[id(st)])
                        except BaseException as exc:  # noqa: BLE001 — re-raised on the caller
                            self._fail(st.name, exc, item=i)
                            failed = True
                            break
                        if payload is _ABANDONED:
                            failed = True
                            break
                    if failed:
                        break
                    if sink:
                        with self._lock:
                            self._stats["items"] += 1
                    elif not self._forward(queues[g], (i, payload, ctx)):
                        break
                    else:
                        self._edge_gauge(edges[g], queues[g])
            if not sink:
                stop_aware_put(queues[g], _STOP, stop)
                if stop.is_set():  # wake a downstream stage parked on get()
                    try:
                        queues[g].put_nowait(_STOP)
                    except queue.Full:
                        pass

        threads = [
            threading.Thread(target=thread_main, args=(g,), daemon=True,
                             name=groups[g][0].thread_name or f"{self.name}-{groups[g][0].name}")
            for g in range(1, len(groups))
        ]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        try:
            for i in items:
                if stop.is_set():
                    break
                ctx = (chunk_trace_context(self.trace_scope, i)
                       if self.trace_scope is not None else None)
                payload: Any = i
                failed = False
                for st in groups[0]:
                    try:
                        payload = self._run_windowed(st, i, payload, ctx, boxes[id(st)])
                    except BaseException as exc:  # noqa: BLE001 — re-raised below
                        self._fail(st.name, exc, item=i)
                        failed = True
                        break
                    if payload is _ABANDONED:
                        failed = True
                        break
                if failed or stop.is_set():
                    break
                if queues:
                    if not self._forward(queues[0], (i, payload, ctx)):
                        break
                    self._edge_gauge(edges[0], queues[0])
                else:
                    with self._lock:
                        self._stats["items"] += 1
        finally:
            def emergency_sentinels() -> None:
                # a wedged stage never forwards its sentinel: wake every
                # queue (a full one has items, and its stage re-checks stop)
                for q in queues:
                    try:
                        q.put_nowait(_STOP)
                    except queue.Full:
                        pass

            if queues:
                stop_aware_put(queues[0], _STOP, stop)
            sentinels_sent = stop.is_set()
            if sentinels_sent:
                emergency_sentinels()
            # join with the deadline still polled; the sink quiesces before
            # an error re-raises, bounded against a wedged syscall
            quiesce_deadline = None
            sink_thread = threads[-1] if threads else None
            while any(t.is_alive() for t in threads):
                for t in threads:
                    t.join(timeout=0.2)
                self._check_deadline()
                if stop.is_set() and not sentinels_sent:
                    sentinels_sent = True
                    emergency_sentinels()
                if stop.is_set() and self._errors:
                    if sink_thread is None or not sink_thread.is_alive():
                        break
                    if quiesce_deadline is None:
                        quiesce_deadline = time.monotonic() + (
                            self.drain_timeout_s if self.drain_timeout_s is not None else 900.0)
                    elif time.monotonic() > quiesce_deadline:
                        break
            if self.inflight_gauge:
                gauge(self.inflight_gauge).set(0)
        if self._errors:
            raise self._errors[0][1]
        return self._finish_stats(time.monotonic() - t_start)

    # --------------------------------------------------- generator mode

    def iterate(self, items: Iterable) -> Iterator:
        """Generator mode: the source group runs on a worker thread (the
        ``items`` iterator is pulled there, so building an item overlaps
        the consumer) and the results are yielded in input order. The
        window slot is taken before an item is built and released when
        the consumer comes back after the yield, so at most ``window``
        items exist past the input iterator.

        A stage exception re-raises unchanged here after every earlier
        item was yielded; a stage wedged past ``drain_timeout_s`` raises
        :class:`DrainTimeout`. Abandoning the iterator stops and joins the
        worker promptly. The consumer's live trace context is carried onto
        the worker (``carry()`` / ``adopt()``)."""
        groups = self._groups()
        if len(groups) != 1:
            raise ValueError(
                "generator mode runs every stage on the source worker — declare "
                "them placement='inline'"
            )
        stop = self._stop
        stack = TRACER.current_stack()  # worker spans nest under the consumer's
        tctx = carry()  # None: untraced, and adopt(None) shields as a no-op
        src_group = groups[0]
        head = src_group[0]
        out_edge = f"{src_group[-1].name}->consumer"
        boxes = {id(st): self._new_beat(st) for st in src_group}
        # unbounded: the window bounds it, and the end-of-stream sentinel
        # can always be delivered, even while stopping
        out_q: queue.Queue = queue.Queue()

        def source_main() -> None:
            box = boxes[id(head)]
            with TRACER.inherit(stack), adopt(tctx), self._context(head):
                it = iter(items)
                i = 0
                while not stop.is_set():
                    if self._window is not None:
                        while not self._window.acquire(timeout=0.1):
                            if stop.is_set():
                                break
                        if stop.is_set():
                            break
                    eos = False

                    def pull_and_run(sp):
                        """Pulling the item is the source stage's work (the
                        host build of a tile), so it runs under its
                        heartbeat and inside its span."""
                        nonlocal eos
                        try:
                            raw = next(it)
                        except StopIteration:
                            if head.span is not None:
                                sp["eos"] = True
                            eos = True
                            return None
                        if head.span_attrs is not None:
                            sp.update(head.span_attrs(i, raw))
                        if head.fault_site:
                            faults.fire(head.fault_site, **{head.index_attr: i})
                        return head.fn(i, raw, sp)

                    try:
                        box[0] = time.monotonic()
                        if head.span is not None:
                            with span(head.span, **{head.index_attr: i}) as sp:
                                out = pull_and_run(sp)
                        else:
                            out = pull_and_run({head.index_attr: i})
                        if eos:
                            box[0] = None
                            break
                        dt = time.monotonic() - box[0]
                        box[0] = None
                        self._account(head, dt)
                        if head.on_done is not None:
                            head.on_done(i, out)
                        for st in src_group[1:]:
                            out = self._execute(st, i, out, None, boxes[id(st)])
                    except BaseException as exc:  # noqa: BLE001 — re-raised on the consumer
                        box[0] = None
                        self._fail(head.name, exc, item=i)
                        break
                    if not stop_aware_put(out_q, (i, out), stop):
                        break
                    self._edge_gauge(out_edge, out_q)
                    i += 1
            out_q.put_nowait(_STOP)  # the consumer may be parked on get()

        worker = threading.Thread(target=source_main, daemon=True,
                                  name=head.thread_name or f"{self.name}-{head.name}")
        t_start = time.monotonic()
        worker.start()

        def poll_get():
            while True:
                try:
                    return out_q.get(timeout=0.1)
                except queue.Empty:
                    if self._overdue_any():
                        self._bump_timeout_counters()
                        raise DrainTimeout(
                            f"{self.stall_what} exceeded {self.drain_timeout_s:.0f}s — "
                            "device wedged"
                        )

        try:
            while True:
                t_wait = time.monotonic()
                item = poll_get()
                if item is _STOP:
                    break
                with self._lock:
                    self._stats["stall_s"] += time.monotonic() - t_wait
                    stall = self._stats["stall_s"]
                if self.stall_gauge:
                    gauge(self.stall_gauge).set(round(stall, 6))
                yield item[1]
                if self._window is not None:
                    self._window.release()
                with self._lock:
                    self._stats["items"] += 1
        finally:
            stop.set()
            worker.join(timeout=5.0)
            self._finish_stats(time.monotonic() - t_start)
        if self._errors:
            raise self._errors[0][1]

    # ------------------------------------------------------------ stats

    def _finish_stats(self, wall_s: float) -> dict:
        stats = dict(self._stats)
        stats["wall_s"] = wall_s
        stats["window_wait_s"] = round(stats["window_wait_s"], 6)
        stats["stall_s"] = round(stats["stall_s"], 6)
        with self._lock:
            busy = dict(self._busy)
        stats["stage_busy_s"] = {k: round(v, 6) for k, v in busy.items()}
        # this run's measured occupancy: duty cycles, overlap efficiency
        # and the bottleneck verdict (the sweep stamps them into its span)
        stats["occupancy"] = occupancy.overlap_stats(busy, wall_s)
        self.stats = stats
        return stats


def fan_out(tasks: Sequence[Callable[[], Any]], *, workers: Optional[int] = None,
            name: str = "fan-out", busy_gauge: Optional[str] = None) -> list:
    """Run ``tasks`` (zero-argument callables) on at most ``workers``
    threads (default: one a task) and return their results in task order.

    The in-stage fan-out primitive: a stage whose one operation is itself
    parallel (the sharded-archive writer's per-shard writes,
    ``utils/sweep.py::write_shard_archive``, which stay inside the
    ``io_write`` stage so that the atomic-write and fault-site contract
    holds per archive) runs its parallel part here. Each worker takes the
    caller's span ancestry and live trace context (``TRACER.inherit``,
    ``carry``/``adopt``), so its spans nest under the enclosing stage span
    and keep the item's trace id. The first task exception re-raises on
    the caller only after every worker is quiet (a failed shard never
    races its peers' writes). ``busy_gauge`` mirrors the count of busy
    workers. With one task or ``workers=1`` everything runs on the
    caller's thread: the same results, exceptions and gauge movements."""
    tasks = list(tasks)
    if not tasks:
        return []
    n = max(1, min(len(tasks), workers) if workers is not None else len(tasks))
    lock = threading.Lock()
    busy = [0]

    def track(delta: int) -> None:
        if busy_gauge:
            with lock:
                busy[0] += delta
                gauge(busy_gauge).set(busy[0])

    if n == 1:
        results = []
        for task in tasks:
            track(+1)
            try:
                results.append(task())
            finally:
                track(-1)
        return results

    results: list = [None] * len(tasks)
    errors: list = []  # the first entry is the one re-raised
    next_idx = [0]
    stack = TRACER.current_stack()
    ctx = carry()

    def worker() -> None:
        with TRACER.inherit(stack), adopt(ctx):
            while True:
                with lock:
                    if errors or next_idx[0] >= len(tasks):
                        return
                    j = next_idx[0]
                    next_idx[0] += 1
                track(+1)
                try:
                    results[j] = tasks[j]()
                except BaseException as exc:  # noqa: BLE001 — re-raised on the caller
                    with lock:
                        errors.append(exc)
                    return
                finally:
                    track(-1)

    pool = [threading.Thread(target=worker, name=f"{name}-{w}", daemon=True) for w in range(n)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    if errors:
        raise errors[0]
    return results
