"""Flight recorder: live run health and a black box for long captures.

Counterpart of ``pta_replicator_tpu/obs/flightrec.py``, with its
``progress.json`` and ``postmortem.json`` schemas (:data:`PROGRESS_SCHEMA`
v5, :data:`POSTMORTEM_SCHEMA`) key for key, so either package's ``watch``,
``report`` and ``postmortem`` read either package's files. For the life of
a capture a daemon sampler thread keeps:

* **heartbeat**: ``<dir>/progress.json``, replaced atomically every
  ``interval_s``: every thread's open span stack, the sweep's chunk
  progress and ETA (from the ``sweep.chunks_*`` gauges, rate smoothed by
  an EWMA), stage occupancy over a rolling window with its bottleneck
  verdict, series trends, the SLO verdict, the numerics observatory's
  block, the card's memory and the watchdog's stall count. ``python -m
  pta_replicator_tpu_torch watch DIR`` tails it.
* **ring**: the last ``ring_size`` span and event records (a tracer
  listener), so the black box holds the run's final moments.
* **watchdog**: no span opened or closed for ``stall_timeout_s`` warns
  with :class:`StallWarning`, bumps ``flightrec.stalls`` and records a
  ``flightrec.stall`` event, once an episode; it never kills anything.
* **postmortem**: on SIGTERM or SIGINT, an unhandled exception, or
  :meth:`FlightRecorder.write_postmortem`, ``<dir>/postmortem.json``: the
  ring, the final heartbeat, the metrics and the open request traces.

Nothing the sampler reads waits for the card. The card's memory comes from
the caching allocator's counters (``torch.cuda.memory_allocated`` and
``max_memory_allocated`` a device, host-side reads, read only once the
process has initialized CUDA): no synchronization, no ``cudaMemGetInfo``.
The heartbeat's ``jax`` block stays in the schema, which requires it, and
is empty: the port emits no ``jax.*`` metric.

The signal and excepthook installation chains the handlers that were
there before (:func:`install_crash_hooks`, main thread only), which always
run after the flush; :func:`uninstall_crash_hooks` puts them back, and
``finish_capture`` calls it, so a capture leaves no handler behind.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
import traceback
import warnings
from typing import Optional

from . import names, numerics as numerics_mod, occupancy
from . import series as series_mod, slo as slo_mod
from . import trace as trace_mod
from .metrics import REGISTRY
from .trace import TRACER

#: v2 added the "occupancy" block (per-stage duty cycle over the rolling
#: window + bottleneck verdict); v3 adds the "trends" block (per-series
#: latest value, rate/s, and rising/falling/flat direction over the
#: trailing window, derived from the obs.series ring recorder the
#: sampler now drives); v4 adds the "slo" block (per-objective error
#: budget + burn rates from the obs.slo engine; empty objectives when
#: no SLO is configured) and the postmortem's "open_traces" list
#: (request traces submitted but never resolved — the in-flight
#: requests a killed serving process took with it); v5 adds the
#: "numerics" block (the numerics observatory's compact health rollup:
#: armed flag, total non-finite elements, active non-finite episodes,
#: worst per-site overflow headroom in bits — obs/numerics.py). Readers
#: stay tolerant of older files.
PROGRESS_SCHEMA_VERSION = 5

#: Required fields (and JSON types) of progress.json — the heartbeat
#: contract consumed by the ``watch`` subcommand and validated by
#: scripts/check_telemetry_schema.py. Extend together with _heartbeat().
PROGRESS_SCHEMA = {
    "schema": int,          # PROGRESS_SCHEMA_VERSION
    "pid": int,
    "written_at": str,      # UTC ISO-8601
    "uptime_s": float,      # since recorder start
    "last_span_age_s": float,  # seconds since any span opened/closed
    "open_spans": dict,     # {tid: ["realize", "compute", ...]}
    "sweep": dict,          # chunks_done/chunks_total/inflight/rate/eta_s
    "occupancy": dict,      # {"stages": {name: duty}, "bottleneck": ...}
    "trends": dict,         # {series: {latest, rate_per_s, trend}}
    "slo": dict,            # {"objectives": {...}, "breached": [...]}
    "numerics": dict,       # armed/nonfinite/episodes_active/headroom
    "jax": dict,            # empty in the port (no jax.* metric)
    "stalls": float,        # flightrec.stalls counter
    "finished": bool,       # True only in the final heartbeat
}

POSTMORTEM_SCHEMA = {
    "schema": int,
    "reason": str,          # "SIGTERM" | "SIGINT" | "exception" | caller's
    "written_at": str,
    "heartbeat": dict,      # final heartbeat (PROGRESS_SCHEMA shape)
    "ring": list,           # last N span/event records (EVENT_SCHEMA)
    "metrics": dict,        # MetricsRegistry.to_json() snapshot
    "open_traces": list,    # unresolved request traces (obs.trace)
}


class StallWarning(UserWarning):
    """No span opened or closed within the flight recorder's deadline —
    the run is likely wedged (hung backend, deadlocked host stage), or
    legitimately inside one very long uninstrumented computation."""


def device_memory_snapshot() -> list:
    """One entry per visible CUDA device with the JAX snapshot's keys:
    ``device``, ``platform``, ``bytes_in_use`` and ``peak_bytes_in_use``,
    from the caching allocator's counters (host-side reads). ``[]`` where
    torch has no card, was never imported, or has not initialized CUDA:
    the sampler thread never initializes it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        # memory_allocated / max_memory_allocated, read from one snapshot,
        # nested as the allocator gives it (memory_stats flattens all of
        # its counters in Python on every tick)
        stats = torch.cuda.memory_stats_as_nested_dict(i).get("allocated_bytes", {}).get("all", {})
        out.append({
            "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            "platform": "gpu",
            "bytes_in_use": int(stats.get("current", 0)),
            "peak_bytes_in_use": int(stats.get("peak", 0)),
        })
    return out


def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a temp file and a rename, so a
    concurrent reader (the watch CLI, a shell watcher) never sees a torn
    file, in four system calls: open, write, close, rename. The sampler
    writes progress.json every tick and three scrape artifacts every
    LIVE_ARTIFACT_EVERY ticks; where file operations are slow (1-2 ms
    each through ``tempfile.mkstemp`` and a text wrapper on an H100's
    host, PERF.md), they are most of the tick. The temp name is unique
    to the process and thread, so two writers never share one."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_CLOEXEC, 0o600)
        try:
            data = memoryview(text.encode("utf-8"))
            while data:
                data = data[os.write(fd, data):]
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _atomic_json(path: str, payload: dict, indent: Optional[int] = 1) -> None:
    """Write ``payload`` as JSON via temp-file + rename (:func:`_atomic_write`).

    ``indent=None`` writes compactly on the C encoder's fast path: the
    document is encoded whole by ``json.dumps`` (``json.dump`` to a file
    streams through the pure-Python encoder), then written once. The
    per-tick heartbeat uses it: every moment the sampler holds the
    interpreter lock is taken from the thread dispatching the card's
    work. One-shot artifacts (postmortem) keep the human-friendly
    indent."""
    _atomic_write(path, json.dumps(payload, indent=indent, sort_keys=indent is not None,
                                   default=repr))


def _atomic_text(path: str, text: str) -> None:
    """Atomic-replace write of a plain-text artifact (metrics.prom —
    same torn-read guarantee as the JSON heartbeat)."""
    _atomic_write(path, text)


def _utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class FlightRecorder:
    """Daemon sampler writing heartbeats and crash black boxes.

    One instance per capture; :func:`obs.start_capture` manages the
    process-wide one (:func:`active`). Constructing does nothing until
    :meth:`start`.
    """

    def __init__(
        self,
        directory: str,
        *,
        interval_s: float = 1.0,
        ring_size: int = 256,
        stall_timeout_s: Optional[float] = 300.0,
        slo_objectives=None,
    ):
        self.directory = directory
        self.interval_s = float(interval_s)
        self.stall_timeout_s = (
            None if stall_timeout_s is None else float(stall_timeout_s)
        )
        self.ring = collections.deque(maxlen=int(ring_size))
        #: live per-stage duty over a rolling window, fed by the same
        #: tracer listener as the ring; its snapshot (duty cycles + a
        #: bottleneck verdict) is the heartbeat's "occupancy" block
        self.occupancy = occupancy.StageOccupancy()
        #: bounded-ring time-series recorder (obs/series.py): the
        #: sampler tick snapshots matching counters/gauges into its
        #: rings, the same tracer listener feeds its span-duration
        #: percentiles, and the heartbeat's "trends" block (schema v3)
        #: is its rate/trend derivation. Persisted as series.jsonl on
        #: stop, and as the live series.json window every tick.
        self.series = series_mod.SeriesRecorder()
        #: SLO engine (obs/slo.py): objectives from the constructor,
        #: else the PTA_SLO env var, else none (every hook is then a
        #: no-op). Scored from the same tracer listener + sampler tick;
        #: verdict lands in the heartbeat's "slo" block and the
        #: slo.json live artifact (the /slo and /readyz surface).
        self.slo = slo_mod.SLOEngine(
            slo_objectives if slo_objectives is not None
            else slo_mod.from_env()
        )
        self._thread: Optional[threading.Thread] = None
        self._lifecycle_lock = threading.Lock()
        self._stop = threading.Event()
        self._t_start = time.monotonic()
        self._stalled = False  # current episode already warned
        self._postmortem_written = False
        self._pm_lock = threading.Lock()
        # chunk-rate EWMA state: (monotonic time, chunks_done) at the
        # last sample that saw progress
        self._rate_ewma: Optional[float] = None
        self._last_progress: Optional[tuple] = None
        # stages whose duty gauge has ever been mirrored: a stage that
        # leaves the rolling window must be zeroed, not left stale.
        # Guarded by its own lock: the sampler thread and a postmortem
        # flush (crashing thread / signal path) can both build a
        # heartbeat, and an unsynchronized read-modify-write could lose
        # the zeroing of a stage that just went idle
        self._mirror_lock = threading.Lock()
        self._mirrored_stages: set = set()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "FlightRecorder":
        with self._lifecycle_lock:
            if self._thread is not None:
                return self
            thread = self._thread = threading.Thread(
                target=self._run, name="flightrec", daemon=True
            )
        os.makedirs(self.directory, exist_ok=True)
        self._t_start = time.monotonic()
        TRACER.add_listener(self._on_record)
        _set_active(self)
        self._stop.clear()
        thread.start()
        return self

    def stop(self, finished: bool = True) -> None:
        """Stop sampling and write the final heartbeat (``finished``
        marks a run that completed rather than one being abandoned).
        Safe under concurrent calls — a SIGTERM flush thread can race
        ``finish_capture``'s teardown; exactly one joins the sampler."""
        with self._lifecycle_lock:
            thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop.set()
        try:
            thread.join(timeout=max(2.0, 2 * self.interval_s))
        except RuntimeError:
            pass  # lost a microsecond race with start(): never started
        TRACER.remove_listener(self._on_record)
        _clear_active(self)
        try:
            self.write_heartbeat(finished=finished)
            # the full decimated history outlives the run as a capture
            # artifact (report/timeline render from it), and the scrape
            # surface gets one final refresh so a post-run reader sees
            # the closing state; best-effort — a missing series.jsonl
            # degrades those sections, nothing else
            self.series.write_jsonl(
                os.path.join(self.directory, "series.jsonl")
            )
            self._write_live_artifacts()
        except OSError:
            pass  # capture dir deleted under us — nothing to record into

    # -- tracer listener ------------------------------------------------
    def _on_record(self, rec: dict) -> None:
        self.ring.append(rec)
        self.occupancy.observe(rec)
        self.series.observe_span(rec)
        self.slo.observe_span(rec)

    #: live scrape artifacts refresh every Nth sampler tick: at the 1 s
    #: default cadence the endpoint's worst-case staleness is N seconds,
    #: and the tick's budget stays dominated by the heartbeat it always
    #: owed rather than by JSON encoding of series windows
    LIVE_ARTIFACT_EVERY = 5

    #: telemetry duty-cycle budget: the sampler stretches its own
    #: interval so that (smoothed tick CPU cost) / interval stays at or
    #: under this fraction of one core. On an idle host a tick costs a
    #: few ms and the configured cadence holds; on a starved host (a
    #: 2-core box mid measure-loop, every cache cold) the same tick can
    #: cost 20-50x more — self-regulation keeps "watching the run" from
    #: becoming a measurable tax on the run being watched. Backoff only
    #: engages at production cadences (interval >= 0.5 s): sub-second
    #: intervals are deliberate test/debug choices.
    OVERHEAD_TARGET = 0.005
    #: ceiling on the stretched interval — the heartbeat never goes
    #: quieter than this no matter how starved the host is
    MAX_INTERVAL_S = 30.0

    # -- sampler --------------------------------------------------------
    def _run(self) -> None:
        # telemetry self-accounting: the sampler thread does NOTHING but
        # telemetry ticks (the wait consumes no CPU), so its cumulative
        # THREAD CPU time is exactly the capacity the temporal layer
        # steals from the workload — exported as the obs.overhead_s
        # counter (itself a sampled series), the <1%-of-wall evidence.
        # Thread CPU, not wall: while a measure loop saturates every
        # core, the tick's wall time is dominated by scheduler
        # contention — capacity the workload keeps. Cumulative, not
        # per-tick deltas: CLOCK_THREAD_CPUTIME_ID reads are ~10 ms
        # granular on older kernels, so per-tick deltas of ~5 ms ticks
        # would quantize to zero forever; differencing one cumulative
        # accumulator never loses what the kernel has already charged.
        # GC pauses are EXCLUDED: CPython charges a whole collection to
        # whichever thread's allocation trips the threshold, and while
        # the workload sits inside native code the sampler is often the
        # only Python allocator — so it gets billed for sweeping the
        # workload's multi-GB heap, a whole-process cost that would be
        # paid regardless and that made the overhead number noise
        # (0.8%-5% run to run) instead of measurement.
        import gc

        my_ident = threading.get_ident()
        gc_state = [0.0, 0.0]  # [t0 of an in-flight collection, total]

        def _gc_cb(phase, _info):
            # runs on the TRIGGERING thread; only meter our own
            if threading.get_ident() != my_ident:
                return
            if phase == "start":
                gc_state[0] = time.thread_time()
            else:
                gc_state[1] += time.thread_time() - gc_state[0]

        gc.callbacks.append(_gc_cb)
        cpu_last = time.thread_time()
        gc_last = 0.0
        tick = 0
        wait_s = self.interval_s
        cpu_ewma = 0.0
        try:
            while not self._stop.wait(wait_s):
                try:
                    self.series.sample()
                    self.slo.sample()
                    self.write_heartbeat()
                    if tick % self.LIVE_ARTIFACT_EVERY == 0:
                        self._write_live_artifacts()
                except OSError:
                    pass  # transient (dir deleted mid-run); keep going
                cpu_now, gc_now = time.thread_time(), gc_state[1]
                tick_cpu = max(
                    0.0, (cpu_now - cpu_last) - (gc_now - gc_last)
                )
                REGISTRY.counter(names.OBS_OVERHEAD_S).inc(tick_cpu)
                cpu_last, gc_last = cpu_now, gc_now
                tick += 1
                # duty-cycle self-regulation (see OVERHEAD_TARGET);
                # EWMA-smoothed so one quantized/cold-cache outlier
                # tick doesn't swing the cadence
                cpu_ewma = 0.4 * tick_cpu + 0.6 * cpu_ewma
                if self.interval_s >= 0.5:
                    wait_s = min(
                        max(self.interval_s,
                            cpu_ewma / self.OVERHEAD_TARGET),
                        max(self.interval_s, self.MAX_INTERVAL_S),
                    )
                self._check_watchdog()
        finally:
            try:
                gc.callbacks.remove(_gc_cb)
            except ValueError:
                pass

    def _write_live_artifacts(self) -> None:
        """Scrape surface for ``watch --serve`` (obs/serve.py): the
        recent series window and the Prometheus exposition, both
        atomic-replace so a concurrent HTTP read can never see a torn
        document. Compact JSON on purpose: the machine-read artifact
        takes the C encoder's fast path (indent forces the pure-Python
        encoder — measured ~10x slower at bench-scale registries)."""
        _atomic_text(
            os.path.join(self.directory, "series.json"),
            json.dumps(self.series.snapshot(), default=repr),
        )
        _atomic_text(
            os.path.join(self.directory, "metrics.prom"),
            REGISTRY.to_prometheus(),
        )
        if self.slo.armed:
            # the /slo scrape + /readyz verdict surface; absent when no
            # objectives are configured (the route then 404s honestly)
            _atomic_text(
                os.path.join(self.directory, "slo.json"),
                json.dumps(self.slo.status(), default=repr),
            )
        if numerics_mod.is_armed():
            # the precision ledger's live surface (/numerics scrape +
            # the /readyz non-finite rung + `numerics report`); absent
            # when the observatory never armed, same honesty contract
            numerics_mod.write(self.directory)

    def _sweep_block(self, metrics=None) -> dict:
        snap = {}
        for name, key in (
            (names.SWEEP_CHUNKS_DONE, "chunks_done"),
            (names.SWEEP_CHUNKS_TOTAL, "chunks_total"),
            (names.SWEEP_INFLIGHT_CHUNKS, "inflight"),
            (names.SWEEP_LAST_DISPATCHED_CHUNK, "last_dispatched"),
            (names.SWEEP_REALIZATIONS, "realizations"),
            (names.PIPELINE_DRAIN_TIMEOUTS, "drain_timeouts"),
        ):
            val = _metric_value(name, metrics=metrics)
            if val is not None:
                snap[key] = val
        done, total = snap.get("chunks_done"), snap.get("chunks_total")
        if done is not None:
            now = time.monotonic()
            if self._last_progress is None:
                self._last_progress = (now, done)
            else:
                t_prev, d_prev = self._last_progress
                if done > d_prev and now > t_prev:
                    inst = (done - d_prev) / (now - t_prev)
                    # EWMA over completions, not ticks: idle ticks carry
                    # no rate information, they just widen the gap the
                    # next completed chunk is averaged over
                    self._rate_ewma = (
                        inst if self._rate_ewma is None
                        else 0.3 * inst + 0.7 * self._rate_ewma
                    )
                    self._last_progress = (now, done)
            if self._rate_ewma:
                snap["chunk_rate_per_s"] = round(self._rate_ewma, 4)
                if total and total > done:
                    snap["eta_s"] = round(
                        (total - done) / self._rate_ewma, 1
                    )
        return snap

    def _last_activity(self) -> float:
        # clamp to recorder start: a process that imported the library
        # long before capturing must not read as "quiet for an hour"
        # (and instantly trip the watchdog) before its first span
        return max(TRACER.last_activity, self._t_start)

    def _occupancy_block(self, emergency: bool = False) -> dict:
        occ = self.occupancy.snapshot(timeout=1.0 if emergency else None)
        if emergency:
            # the postmortem embeds this block directly; skip the gauge
            # mirroring — REGISTRY.gauge() and _mirror_lock are more
            # locks the suspended main thread could be parked inside
            return occ
        # mirror the live duties into gauges so metrics.json / the
        # report carry the final window's utilization after the run —
        # including zeroing stages that went idle (dropped out of the
        # window), or a long-finished stage would keep reporting the
        # saturated duty of a window minutes in the past
        stages = occ["stages"]
        with self._mirror_lock:
            for stage in self._mirrored_stages - set(stages):
                REGISTRY.gauge(
                    names.OCCUPANCY_DUTY_CYCLE, stage=stage
                ).set(0.0)
            for stage, duty in stages.items():
                REGISTRY.gauge(
                    names.OCCUPANCY_DUTY_CYCLE, stage=stage
                ).set(duty)
            # track only the currently-busy stages: an idle stage is
            # zeroed exactly once, not re-written on every later tick
            self._mirrored_stages = set(stages)
        return occ

    def _heartbeat(self, finished: bool = False,
                   emergency: bool = False) -> dict:
        # one bounded registry acquire shared by every metric lookup
        # below — a wedged registry lock costs a single timeout
        ms = REGISTRY.metrics(timeout=1.0 if emergency else None)
        hb = {
            "schema": PROGRESS_SCHEMA_VERSION,
            "pid": os.getpid(),
            "written_at": _utc_now(),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "last_span_age_s": round(
                time.monotonic() - self._last_activity(), 3
            ),
            "open_spans": {
                str(tid): stack
                for tid, stack in TRACER.open_spans(
                    timeout=1.0 if emergency else None
                ).items()
            },
            "sweep": self._sweep_block(metrics=ms),
            "occupancy": self._occupancy_block(emergency=emergency),
            "trends": self.series.trends(
                timeout=1.0 if emergency else None
            ),
            "slo": self.slo.heartbeat_block(
                timeout=1.0 if emergency else None
            ),
            "numerics": numerics_mod.heartbeat_block(),
            "jax": {},
            "stalls": _metric_value(
                names.FLIGHTREC_STALLS, metrics=ms
            ) or 0.0,
            "finished": bool(finished),
        }
        mem = device_memory_snapshot()
        watermark = [
            {k: m[k] for k in ("device", "bytes_in_use", "peak_bytes_in_use")
             if k in m}
            for m in mem if "bytes_in_use" in m
        ]
        if watermark:
            hb["device_memory"] = watermark
        return hb

    def write_heartbeat(self, finished: bool = False) -> dict:
        hb = self._heartbeat(finished=finished)
        _atomic_json(os.path.join(self.directory, "progress.json"), hb,
                     indent=None)
        return hb

    def _check_watchdog(self) -> None:
        if self.stall_timeout_s is None:
            return
        age = time.monotonic() - self._last_activity()
        if age <= self.stall_timeout_s:
            self._stalled = False  # activity resumed: re-arm
            return
        if self._stalled:
            return  # already warned for this episode
        self._stalled = True
        REGISTRY.counter(names.FLIGHTREC_STALLS).inc()
        open_now = TRACER.open_spans()
        desc = "; ".join(
            "/".join(stack) for stack in open_now.values()
        ) or "(no open spans)"
        # the event feeds events.jsonl AND the ring buffer, so the
        # stall is visible in the postmortem of a later kill
        TRACER.event(
            names.EVENT_FLIGHTREC_STALL, age_s=round(age, 1), open=desc,
        )
        warnings.warn(
            f"no span opened or closed for {age:.1f}s "
            f"(deadline {self.stall_timeout_s:.1f}s); open: {desc}",
            StallWarning,
            stacklevel=2,
        )

    # -- postmortem -----------------------------------------------------
    def write_postmortem(self, reason: str, exc: BaseException = None,
                         emergency: bool = False) -> str:
        """Flush the black box. Idempotent per recorder: only the first
        call writes (a SIGTERM racing the excepthook must not overwrite
        the more specific report with the less specific one).

        ``emergency`` marks a flush racing a suspended main thread (the
        signal-handler path): tracer-, registry-, and occupancy-lock
        acquires are all bounded and degrade to best-effort snapshots,
        because the interrupted frame may hold any of them and can
        never release it while the handler waits on this flush."""
        with self._pm_lock:
            if self._postmortem_written:
                return os.path.join(self.directory, "postmortem.json")
            self._postmortem_written = True
        pm = {
            "schema": PROGRESS_SCHEMA_VERSION,
            "reason": reason,
            "written_at": _utc_now(),
            "heartbeat": self._heartbeat(finished=False,
                                         emergency=emergency),
            "ring": list(self.ring),
            "metrics": REGISTRY.to_json(
                timeout=1.0 if emergency else None
            ),
            # request traces submitted but never resolved: the
            # in-flight requests this process is taking with it (the
            # likelihood server registers/resolves; obs.trace owns the
            # bounded registry). Bounded lock in an emergency.
            "open_traces": trace_mod.open_requests(
                timeout=1.0 if emergency else None
            ),
        }
        if exc is not None:
            pm["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__
                ),
            }
        path = os.path.join(self.directory, "postmortem.json")
        os.makedirs(self.directory, exist_ok=True)
        _atomic_json(path, pm)
        try:
            # the black box keeps its history too: a killed multi-hour
            # sweep's throughput decay is exactly the evidence a
            # postmortem reader wants. Bounded locks in an emergency —
            # the suspended main thread may hold the series lock.
            self.series.write_jsonl(
                os.path.join(self.directory, "series.jsonl"),
                timeout=1.0 if emergency else None,
            )
        except OSError:
            pass
        # events.jsonl should be complete alongside it; in an emergency
        # the suspended main thread may hold the sink lock forever, so
        # bound the wait — the sink already carries everything up to the
        # interrupted write
        TRACER.flush(timeout=1.0 if emergency else None)
        return path


# -- process-global active recorder + crash hook chain -----------------
_active_lock = threading.Lock()
_ACTIVE: Optional[FlightRecorder] = None
_hooks_installed = False
_prev_handlers: dict = {}
_prev_excepthook = None


def active() -> Optional[FlightRecorder]:
    """The recorder currently sampling (None outside a capture)."""
    return _ACTIVE


def _set_active(rec: FlightRecorder) -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = rec


def _clear_active(rec: FlightRecorder) -> None:
    global _ACTIVE
    with _active_lock:
        if _ACTIVE is rec:
            _ACTIVE = None


def _metric_value(name: str, metrics=None) -> Optional[float]:
    """Current value of a plain (unlabeled) counter/gauge, or None if it
    was never registered — reading must not CREATE the metric, or the
    heartbeat would pollute every later metrics.json snapshot.
    ``metrics`` is an already-fetched ``REGISTRY.metrics()`` list: the
    emergency heartbeat takes ONE bounded registry-lock acquire and
    shares the result across every lookup, so a wedged lock costs one
    timeout, not one per metric."""
    for m in REGISTRY.metrics() if metrics is None else metrics:
        if m.name == name and not m.labels and hasattr(m, "value"):
            return m.value
    return None


def _flush_from_signal(rec: FlightRecorder, reason: str,
                       deadline_s: float = 5.0) -> None:
    """Write the postmortem from a signal handler WITHOUT deadlocking.

    The handler runs on the main thread between bytecodes — the
    interrupted frame may be holding the tracer/registry locks (e.g.
    mid-``Tracer._record``, whose critical section includes the sink
    write), and ``write_postmortem`` needs those same non-reentrant
    locks for its snapshots. Acquiring them directly in the handler
    would deadlock the process exactly when the feature matters (a busy
    sweep being SIGTERMed). So the flush runs on a side thread in
    ``emergency`` mode: tracer-lock acquires are bounded and fall back
    to unlocked best-effort snapshots when the suspended frame IS the
    holder (it is parked until this handler returns, so the structures
    are quiescent). ``done`` is set the moment ``postmortem.json`` is
    on disk — the trailing ``stop()`` (sampler join + listener removal,
    which may also need the held tracer lock) continues on the daemon
    thread and must not delay the kill; ``deadline_s`` remains the
    last-resort bound."""
    done = threading.Event()

    def flush():
        try:
            rec.write_postmortem(reason, emergency=True)
        except Exception:  # dying-process flush: raising would lose the re-delivery
            pass
        finally:
            done.set()
        try:
            rec.stop(finished=False)
        except Exception:  # stop() must not block the re-delivery
            pass

    threading.Thread(target=flush, name="flightrec-flush",
                     daemon=True).start()
    done.wait(deadline_s)


def _signal_handler(signum, frame):
    rec = _ACTIVE
    if rec is not None:
        try:
            _flush_from_signal(rec, signal.Signals(signum).name)
        except Exception:  # the re-delivery below must still run
            pass
    prev = _prev_handlers.get(signum, signal.SIG_DFL)
    if callable(prev):
        prev(signum, frame)
    elif prev != signal.SIG_IGN:
        # SIG_DFL — and also None, which getsignal() returns for a
        # handler installed from C: we cannot re-install what we cannot
        # see, but swallowing the signal would leave the process
        # undead under a supervisor's graceful shutdown, so re-deliver
        # with the default disposition (correct kill wait status)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
    # SIG_IGN: swallow, matching the pre-existing disposition


def _excepthook(exc_type, exc, tb):
    rec = _ACTIVE
    if rec is not None:
        try:
            exc = exc if isinstance(exc, BaseException) else exc_type(exc)
            exc.__traceback__ = tb
            rec.write_postmortem("exception", exc=exc)
        except Exception:  # the original exception goes on to the chained hook
            pass
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def install_crash_hooks() -> bool:
    """Chain SIGTERM/SIGINT handlers and ``sys.excepthook`` through the
    active recorder (idempotent, once per process; previous handlers
    always run after the postmortem flush). Returns False off the main
    thread, where CPython forbids signal installation — captures started
    from worker threads still heartbeat, they just rely on
    ``finish_capture``'s exception path instead of signal coverage."""
    global _hooks_installed, _prev_excepthook
    with _active_lock:
        if _hooks_installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        installed = []
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                _prev_handlers[signum] = signal.getsignal(signum)
                signal.signal(signum, _signal_handler)
                installed.append(signum)
            except (ValueError, OSError):  # embedded interpreter quirks
                # roll back: a half-installed chain would later record
                # OUR handler as the "previous" one and recurse on it
                for done in installed:
                    signal.signal(done, _prev_handlers.pop(done))
                _prev_handlers.pop(signum, None)
                return False
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        _hooks_installed = True
        return True


def uninstall_crash_hooks() -> bool:
    """Put back the SIGTERM/SIGINT handlers and ``sys.excepthook`` that
    :func:`install_crash_hooks` chained (each only where ours is still the
    installed one), so the process state is what it was before the
    capture. False off the main thread, where handlers cannot change."""
    global _hooks_installed, _prev_excepthook
    with _active_lock:
        if not _hooks_installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        for signum, prev in list(_prev_handlers.items()):
            if signal.getsignal(signum) is _signal_handler:
                signal.signal(signum, signal.SIG_DFL if prev is None else prev)
                del _prev_handlers[signum]
        if sys.excepthook is _excepthook:
            sys.excepthook = _prev_excepthook or sys.__excepthook__
            _prev_excepthook = None
        _hooks_installed = False
        return True
