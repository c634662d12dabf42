"""Telemetry of the port: spans, metrics, captures and their report, and
the numerics ledger.

Counterpart of ``pta_replicator_tpu/obs/__init__.py``. Library
instrumentation uses exactly these entry points::

    from ..obs import span, counter

    with span("freeze", npsr=npsr) as sp:
        ...
        sp["ntoa_max"] = nt
    counter("io.tim.toas").inc(ntoas)

Capturing a run::

    from pta_replicator_tpu_torch import obs
    obs.start_capture("/tmp/telemetry")   # spans stream to events.jsonl
    ...                                    # run the pipeline
    obs.finish_capture(context={"argv": sys.argv})

then ``python -m pta_replicator_tpu_torch report /tmp/telemetry``. The
CLI's ``--telemetry DIR`` flag does the capture itself. A capture's files
have the JAX package's formats, so either package's ``report`` reads
either package's capture.

A capture runs the flight recorder by default (``obs/flightrec.py``): a
``progress.json`` heartbeat every ``heartbeat_interval_s`` with stage
occupancy, series trends and the SLO verdict, the watchdog, and
``postmortem.json`` when the run is killed or raises; ``watch DIR`` tails
it and ``watch --serve PORT`` serves it (``obs/serve.py``).

Spans and metrics are host-side: nothing here synchronizes the card, and
gauges hold host numbers. ``meta.json`` and the heartbeat record the card's
memory from the caching allocator's counters (``torch.cuda.memory_allocated``
and ``max_memory_allocated``), which read host-side state.

Not ported yet (ROADMAP A.16.4b): the critical path, the merged timeline
and device profiling.
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import flightrec, metrics, names, numerics, occupancy, serve, series, slo, trace
from .flightrec import FlightRecorder, StallWarning, device_memory_snapshot
from .metrics import REGISTRY, counter, gauge, histogram
from .trace import (
    TRACER,
    TraceContext,
    adopt,
    carry,
    configure,
    current_trace,
    event,
    span,
    traced,
)

__all__ = [
    "span", "event", "configure", "traced", "counter", "gauge", "histogram",
    "REGISTRY", "TRACER", "start_capture", "finish_capture",
    "telemetry_summary", "reset_all", "device_memory_snapshot", "metrics",
    "trace", "names", "TraceContext", "adopt", "carry", "current_trace",
    "flightrec", "FlightRecorder", "StallWarning", "numerics", "occupancy",
    "serve", "series", "slo",
]

#: artifacts of an earlier run that a new capture into the same directory
#: removes (the JAX package's list): one capture directory describes one run
STALE_ARTIFACTS = ("progress.json", "postmortem.json", "series.json", "series.jsonl",
                   "timeline.json", "metrics.prom", "slo.json", "critpath.json",
                   "numerics.json")


def start_capture(
    directory: str,
    *,
    flight_recorder: bool = True,
    heartbeat_interval_s: float = 1.0,
    stall_timeout_s: float = 300.0,
    crash_hooks: bool = True,
    slo: object = None,
) -> None:
    """Begin streaming telemetry to ``directory``.

    The capture starts from a clean slate: a flight recorder still
    sampling from an earlier capture is stopped, the tracer's buffers and
    the metrics registry are reset, ``events.jsonl`` is truncated
    (``configure``) and an earlier run's artifacts are removed, so the
    directory describes exactly one run. ``PTA_NUMERICS=1`` arms the
    numerics observatory for the capture, sampling drift on one chunk in
    ``PTA_NUMERICS_DRIFT_EVERY`` (default 16) from the seeded offset of
    ``PTA_NUMERICS_SEED`` (``obs/numerics.py::arm_from_env``).

    ``flight_recorder`` (default on) starts the sampler of
    ``obs/flightrec.py``: a ``progress.json`` heartbeat every
    ``heartbeat_interval_s``, a :class:`StallWarning` watchdog at
    ``stall_timeout_s`` (None disables it), and, with ``crash_hooks`` on
    the main thread, SIGTERM/SIGINT and excepthook chaining that writes
    ``postmortem.json`` before the process dies. ``slo`` declares the
    capture's objectives (the ``obs/slo.py`` grammar, a list of specs or
    ``Objective`` objects; default: ``PTA_SLO``), scored into the
    heartbeat and ``slo.json``. :func:`finish_capture` stops it."""
    stale = flightrec.active()
    if stale is not None:
        # back-to-back captures: the earlier recorder must not keep
        # heartbeating into the old directory
        stale.stop(finished=False)
    TRACER.reset()
    REGISTRY.reset()
    trace.configure(directory)
    for artifact in STALE_ARTIFACTS:
        try:
            os.remove(os.path.join(directory, artifact))
        except FileNotFoundError:
            pass
    numerics.arm_from_env()
    if flight_recorder:
        FlightRecorder(directory, interval_s=heartbeat_interval_s,
                       stall_timeout_s=stall_timeout_s, slo_objectives=slo).start()
        if crash_hooks:
            flightrec.install_crash_hooks()


def finish_capture(context: dict = None) -> None:
    """Write the remaining artifacts of the configured telemetry directory:
    ``metrics.json``, ``metrics.prom``, ``chrome_trace.json`` and
    ``meta.json``, and ``numerics.json`` when the numerics ledger is armed.
    ``events.jsonl`` was written live; this flushes it.

    The flight recorder stops first with a final heartbeat (``finished``
    true unless an exception is propagating, when ``postmortem.json`` is
    written before it), and the crash hooks are taken down, so the process
    keeps no handler of the capture's. Without a prior
    :func:`start_capture` this is a no-op, so teardown paths may call it
    unconditionally. A write that fails raises."""
    directory = TRACER.directory
    if directory is None:
        return
    rec = flightrec.active()
    if rec is not None:
        exc = sys.exc_info()[1]
        if exc is not None:
            rec.write_postmortem("exception", exc=exc)
        rec.stop(finished=exc is None)
    flightrec.uninstall_crash_hooks()
    TRACER.flush()
    with open(os.path.join(directory, "metrics.json"), "w") as fh:
        json.dump(REGISTRY.to_json(), fh, indent=1, sort_keys=True)
    with open(os.path.join(directory, "metrics.prom"), "w") as fh:
        fh.write(REGISTRY.to_prometheus())
    with open(os.path.join(directory, "chrome_trace.json"), "w") as fh:
        json.dump(TRACER.chrome_trace(), fh)
    meta = {
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "dropped_events": TRACER.dropped,
        "device_memory": device_memory_snapshot(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        meta["torch_version"] = torch.__version__
        meta["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
        if torch.cuda.is_available():
            meta["device"] = torch.cuda.get_device_name(0)
    if numerics.is_armed():
        numerics.write(directory)
    meta.update(context or {})
    with open(os.path.join(directory, "meta.json"), "w") as fh:
        json.dump(meta, fh, indent=1, sort_keys=True, default=repr)


def telemetry_summary() -> dict:
    """In-process snapshot for other evidence artifacts: per-path wall
    times, and the ``jax`` block of the JAX package's summary, empty here
    (the port emits no ``jax.*`` metric)."""
    spans = {
        path: {
            "calls": s["calls"],
            "total_s": round(s["total_s"], 6),
            "mean_s": round(s["mean_s"], 6),
        }
        for path, s in TRACER.summary().items()
    }
    return {"spans": spans, "jax": {}}


def reset_all() -> None:
    """Stop a flight recorder still sampling, take its crash hooks down, and
    clear the global tracer's buffers, the metrics registry and the
    numerics ledger (tests)."""
    rec = flightrec.active()
    if rec is not None:
        rec.stop(finished=False)
    flightrec.uninstall_crash_hooks()
    TRACER.reset()
    REGISTRY.reset()
    numerics.reset()
