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

Spans and metrics are host-side: nothing here synchronizes the card, and
gauges hold host numbers. ``meta.json`` records the card's memory from the
caching allocator's counters (``torch.cuda.memory_allocated`` and
``max_memory_allocated``), which read host-side state.

Not ported yet (ROADMAP A.16.4): the flight recorder (``progress.json``,
``postmortem.json``), the series and SLO modules, stage occupancy, the
critical path, and device profiling.
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import metrics, names, trace
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
]

#: artifacts of an earlier run that a new capture into the same directory
#: removes (the JAX package's list): one capture directory describes one run
STALE_ARTIFACTS = ("progress.json", "postmortem.json", "series.json", "series.jsonl",
                   "timeline.json", "metrics.prom", "slo.json", "critpath.json",
                   "numerics.json")


def start_capture(directory: str) -> None:
    """Begin streaming telemetry to ``directory``.

    The capture starts from a clean slate: the tracer's buffers and the
    metrics registry are reset, ``events.jsonl`` is truncated
    (``configure``) and an earlier run's artifacts are removed, so the
    directory describes exactly one run. ``PTA_NUMERICS=1`` arms the
    numerics observatory for the capture, sampling drift on one chunk in
    ``PTA_NUMERICS_DRIFT_EVERY`` (default 16) from the seeded offset of
    ``PTA_NUMERICS_SEED`` (``obs/numerics.py::arm_from_env``)."""
    from . import numerics

    TRACER.reset()
    REGISTRY.reset()
    trace.configure(directory)
    for stale in STALE_ARTIFACTS:
        try:
            os.remove(os.path.join(directory, stale))
        except FileNotFoundError:
            pass
    numerics.arm_from_env()


def device_memory_snapshot() -> list:
    """One entry per visible CUDA device with the JAX snapshot's keys:
    ``device``, ``platform``, ``bytes_in_use`` and ``peak_bytes_in_use``,
    from the caching allocator's counters. ``[]`` where torch has no card
    (a CPU run) or was never imported."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [{
        "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
        "platform": "gpu",
        "bytes_in_use": int(torch.cuda.memory_allocated(i)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
    } for i in range(torch.cuda.device_count())]


def finish_capture(context: dict = None) -> None:
    """Write the remaining artifacts of the configured telemetry directory:
    ``metrics.json``, ``metrics.prom``, ``chrome_trace.json`` and
    ``meta.json``, and ``numerics.json`` when the numerics ledger is armed.
    ``events.jsonl`` was written live; this flushes it.

    Without a prior :func:`start_capture` this is a no-op, so teardown
    paths may call it unconditionally. A write that fails raises."""
    from . import numerics

    directory = TRACER.directory
    if directory is None:
        return
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
    """Clear the global tracer's buffers, the metrics registry and the
    numerics ledger (tests)."""
    from . import numerics

    TRACER.reset()
    REGISTRY.reset()
    numerics.reset()
