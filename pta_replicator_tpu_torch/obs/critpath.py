"""Critical-path attribution over a finished capture.

Counterpart of ``pta_replicator_tpu/obs/critpath.py``, copied: the
analysis is host Python over ``events.jsonl``, line for line the JAX
module's, so either package's ``critpath`` reads either package's capture
and writes the same document. The occupancy module answers "how busy was
each stage?"; this module answers **where does the next second of wall
time live?** It rebuilds the per-chunk span DAG from a capture's stage
spans (every stage span of the stage graph carries the chunk index in its
attrs and, under a ``trace_scope``, the chunk's deterministic trace id:
``parallel/stages.py``), computes the critical path per chunk and over
the phase window, and gives a ranked bottleneck verdict with an estimated
saving: ``critpath.json``, a report section, the ``critpath DIR``
subcommand and the ``/critpath`` route of ``watch --serve``.

The attribution, precisely:

* **aggregate critical path**: a greedy shadow decomposition of the
  phase window. Stages are ranked by total busy seconds, and each instant
  of the window is attributed to the busiest stage active at that
  instant. A stage's ``critical_s`` is its *exclusive* contribution (the
  seconds that would come off the wall if that stage alone were fully
  overlapped away), so the ranking agrees with the occupancy duty table.
  ``blocked_s`` is the window time where no stage ran, and
  ``attributed_fraction`` = 1 - blocked_s / wall.
* **per-chunk critical path**: each chunk's stage spans in dataflow order
  (static_build -> dispatch -> drain -> io_write) form a chain; gaps
  inside it are **queue-wait** (the item sat in an edge queue), and the
  gap between successive chunks' first-stage spans is
  **blocked-on-window**. A chunk's bottleneck is its longest stage, and
  ``chunk_bottleneck_fraction`` counts how often each stage is it.
* **stragglers**: per-device busy spread from spans carrying a
  ``device`` attr: ``straggler_ratio`` = max / median device busy, and
  devices past :data:`STRAGGLER_THRESHOLD` x the median are named.

Strictly offline: the analyzer runs over the events after a run, wraps
its own work in a ``critpath_analyze`` span and stamps its own
``analyzer.overhead_s``; the instrumented paths pay nothing for it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from . import names, occupancy
from .metrics import gauge
from .trace import TRACER

#: bump when a field keeps its spelling but changes meaning/units —
#: check_telemetry_schema.py and the report renderer refuse newer files
CRITPATH_SCHEMA_VERSION = 1

#: per-chunk pipeline stages in dataflow order — the chain the DAG
#: reconstruction threads per chunk index (fused runs have
#: static_build; stacked runs start at dispatch)
CHUNK_STAGES: Tuple[str, ...] = (
    names.SPAN_STATIC_BUILD,
    names.SPAN_DISPATCH,
    names.SPAN_DRAIN,
    names.SPAN_IO_WRITE,
)

#: a device whose busy time exceeds this multiple of the median device
#: busy time is named a straggler
STRAGGLER_THRESHOLD = 1.2


def _subtract(
    intervals: List[Tuple[float, float]],
    taken: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    """``intervals`` minus ``taken`` (both sorted+disjoint), as a
    sorted disjoint list — the shadow step of the greedy decomposition."""
    out: List[Tuple[float, float]] = []
    for t0, t1 in intervals:
        cur = t0
        for s0, s1 in taken:
            if s1 <= cur or s0 >= t1:
                continue
            if s0 > cur:
                out.append((cur, s0))
            cur = max(cur, s1)
            if cur >= t1:
                break
        if cur < t1:
            out.append((cur, t1))
    return out


def _decompose(
    per_stage: Dict[str, List[Tuple[float, float]]], window: Tuple[float, float]
) -> Tuple[Dict[str, dict], Dict[str, List[Tuple[float, float]]]]:
    """Greedy shadow decomposition of the window: stages ranked by busy
    seconds; each gets the part of its busy intervals no busier stage
    already claimed. Nested stages (occupancy.NESTED_STAGES) are
    excluded when their parent is present — their time is inside the
    parent's and would double-claim the same instants. Returns (per-
    stage stats, per-stage EXCLUSIVE intervals — the annotated timeline
    track's slice set)."""
    clipped = {
        name: c
        for name, iv in per_stage.items()
        if (c := occupancy._clip(occupancy.merge_intervals(iv), *window))
    }
    clipped = {
        k: v for k, v in clipped.items()
        if occupancy.NESTED_STAGES.get(k) not in clipped
    }
    taken: List[Tuple[float, float]] = []
    out: Dict[str, dict] = {}
    exclusive: Dict[str, List[Tuple[float, float]]] = {}
    # name tiebreak: equal-busy stages must rank deterministically or
    # byte-identical reruns could swap exclusive attributions
    order = sorted(
        clipped,
        key=lambda s: (-occupancy.busy_seconds(clipped[s]), s),
    )
    for name in order:
        mine = _subtract(clipped[name], taken)
        exclusive[name] = mine
        out[name] = {
            "busy_s": round(occupancy.busy_seconds(clipped[name]), 6),
            "critical_s": round(occupancy.busy_seconds(mine), 6),
        }
        taken = occupancy.merge_intervals(taken + clipped[name])
    return out, exclusive


def critical_intervals(
    events: Iterable[dict],
    window: Optional[Tuple[float, float]] = None,
) -> Tuple[Optional[Tuple[float, float]], Dict[str, List[Tuple[float, float]]]]:
    """(window, per-stage exclusive critical intervals) for annotation
    consumers (the merged timeline's ``critical path`` track). Empty
    when the events carry no stage spans."""
    events = [e for e in events if e.get("type") == "span"]
    per_stage = occupancy.stage_intervals(events)
    if not per_stage:
        return None, {}
    if window is None:
        window = occupancy._phase_window(events)
    if window is None:
        window = (
            min(t0 for iv in per_stage.values() for t0, _ in iv),
            max(t1 for iv in per_stage.values() for _, t1 in iv),
        )
    _, exclusive = _decompose(per_stage, window)
    return window, exclusive


def _chunk_chains(events: Iterable[dict]) -> Dict[object, dict]:
    """chunk index -> {"stages": {name: [(t0, t1), ...]}, "traces":
    set of trace ids seen} for the per-chunk pipeline stage spans."""
    chains: Dict[object, dict] = {}
    for rec in events:
        if rec.get("type") != "span" or rec.get("name") not in CHUNK_STAGES:
            continue
        attrs = rec.get("attrs") or {}
        if "chunk" not in attrs:
            continue
        c = chains.setdefault(attrs["chunk"], {"stages": {}, "traces": set()})
        t0 = float(rec.get("t0", 0.0))
        c["stages"].setdefault(rec["name"], []).append(
            (t0, t0 + float(rec.get("wall_s", 0.0)))
        )
        if rec.get("trace_id"):
            c["traces"].add(rec["trace_id"])
    return chains


def _chunk_stats(chains: Dict[object, dict]) -> Optional[dict]:
    """Per-chunk chain accounting aggregated: queue-wait inside chains,
    blocked-on-window between successive admissions, per-stage
    chunk-bottleneck fractions, and trace coherence."""
    if not chains:
        return None
    n = len(chains)
    queue_wait: Dict[str, float] = {}
    bottleneck_counts: Dict[str, int] = {}
    admissions: List[Tuple[float, float]] = []  # first-stage (t0, t1)
    coherent = 0
    for c in chains.values():
        stages = c["stages"]
        ordered = [s for s in CHUNK_STAGES if s in stages]
        # a retried chunk has several spans per stage; the chain uses
        # each stage's full extent (first start .. last end)
        extents = {
            s: (min(t0 for t0, _ in stages[s]),
                max(t1 for _, t1 in stages[s]))
            for s in ordered
        }
        for prev, cur in zip(ordered, ordered[1:]):
            gap = extents[cur][0] - extents[prev][1]
            if gap > 0.0:
                queue_wait[cur] = queue_wait.get(cur, 0.0) + gap
        busiest = max(
            ordered,
            key=lambda s: sum(t1 - t0 for t0, t1 in stages[s]),
        )
        bottleneck_counts[busiest] = bottleneck_counts.get(busiest, 0) + 1
        admissions.append(extents[ordered[0]])
        if len(c["traces"]) <= 1:
            coherent += 1
    blocked_on_window = 0.0
    for (_, prev_end), (cur_start, _) in zip(
        sorted(admissions), sorted(admissions)[1:]
    ):
        if cur_start > prev_end:
            blocked_on_window += cur_start - prev_end
    return {
        "count": n,
        "trace_coherent_fraction": round(coherent / n, 3),
        "queue_wait_s": {k: round(v, 6) for k, v in sorted(queue_wait.items())},
        "blocked_on_window_s": round(blocked_on_window, 6),
        "bottleneck_fraction": {
            k: round(v / n, 3) for k, v in sorted(bottleneck_counts.items())
        },
    }


def _device_stats(events: Iterable[dict]) -> Optional[dict]:
    """Per-device busy spread from replica-stage spans carrying a
    ``device`` attr — the mesh straggler detector."""
    per_dev: Dict[str, List[Tuple[float, float]]] = {}
    for rec in events:
        if rec.get("type") != "span":
            continue
        dev = (rec.get("attrs") or {}).get("device")
        if dev is None:
            continue
        t0 = float(rec.get("t0", 0.0))
        per_dev.setdefault(str(dev), []).append(
            (t0, t0 + float(rec.get("wall_s", 0.0)))
        )
    if not per_dev:
        return None
    busy = {
        d: round(occupancy.busy_seconds(iv), 6)
        for d, iv in sorted(per_dev.items())
    }
    vals = sorted(busy.values())
    median = vals[len(vals) // 2] if len(vals) % 2 else (
        0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
    )
    ratio = 1.0 if median <= 0.0 or len(vals) < 2 else max(vals) / median
    stragglers = (
        [d for d, b in busy.items() if b > STRAGGLER_THRESHOLD * median]
        if len(vals) >= 2 and median > 0.0 else []
    )
    return {
        "count": len(busy),
        "busy_s": busy,
        "straggler_ratio": round(ratio, 3),
        "stragglers": stragglers,
    }


def _verdict(
    stages: Dict[str, dict], chunks: Optional[dict], wall: float
) -> dict:
    """Ranked bottleneck verdict with the estimated saving: removing
    (fully overlapping) the top stage saves exactly its exclusive
    critical seconds, after which the bound shifts to the runner-up."""
    ranked = [
        {
            "stage": name,
            "resource": occupancy.STAGES.get(name, name),
            "busy_s": s["busy_s"],
            "critical_s": s["critical_s"],
            "critical_share": round(s["critical_s"] / wall, 3),
        }
        for name, s in sorted(
            stages.items(),
            key=lambda kv: (-kv[1]["critical_s"], kv[0]),
        )
    ]
    if not ranked:
        return {"summary": "no stage spans to attribute", "ranked": []}
    top = ranked[0]
    summary = (
        f"{top['stage']} holds {top['critical_share']:.0%} of the "
        f"critical path -> {top['resource']}-bound; "
        f"est. -{top['critical_s']:.2f}s wall if fully overlapped"
    )
    if len(ranked) > 1:
        summary += f" (bound then shifts to {ranked[1]['stage']})"
    if chunks:
        frac = chunks["bottleneck_fraction"].get(top["stage"], 0.0)
        if 0.0 < frac < 1.0:
            summary += (
                f"; off the per-chunk critical path for "
                f"{1.0 - frac:.0%} of chunks"
            )
    return {
        "bottleneck": top["stage"],
        "resource": top["resource"],
        "est_savings_s": top["critical_s"],
        "summary": summary,
        "ranked": ranked,
    }


def analyze(
    events: Iterable[dict],
    window: Optional[Tuple[float, float]] = None,
) -> Optional[dict]:
    """Critical-path attribution over span records (events.jsonl shape
    or ``TRACER.events()``). Returns None when no stage spans are
    present. ``window`` defaults to the longest phase span (same rule
    as :func:`occupancy.analyze`), else to the stage extent."""
    events = [e for e in events if e.get("type") == "span"]
    per_stage = occupancy.stage_intervals(events)
    if not per_stage:
        return None
    if window is None:
        window = occupancy._phase_window(events)
    if window is None:
        window = (
            min(t0 for iv in per_stage.values() for t0, _ in iv),
            max(t1 for iv in per_stage.values() for _, t1 in iv),
        )
    wall = max(1e-9, window[1] - window[0])
    stages, _ = _decompose(per_stage, window)
    if not stages:
        return None
    chains = {
        c: ch for c, ch in _chunk_chains(events).items()
        # chains entirely outside the window belong to another phase of
        # the same capture (bench A/B arms) and must not dilute this one
        if any(
            t0 < window[1] and t1 > window[0]
            for iv in ch["stages"].values() for t0, t1 in iv
        )
    }
    chunks = _chunk_stats(chains)
    critical = sum(s["critical_s"] for s in stages.values())
    doc = {
        "schema_version": CRITPATH_SCHEMA_VERSION,
        "window": {
            "t0": round(window[0], 6),
            "t1": round(window[1], 6),
            "wall_s": round(wall, 6),
        },
        "critical_path_s": round(critical, 6),
        "blocked_s": round(max(0.0, wall - critical), 6),
        "attributed_fraction": round(min(1.0, critical / wall), 4),
        "stages": {
            name: {
                **s,
                "duty": round(min(1.0, s["busy_s"] / wall), 3),
                "critical_share": round(s["critical_s"] / wall, 3),
                "chunk_bottleneck_fraction": (
                    (chunks or {}).get("bottleneck_fraction", {})
                    .get(name, 0.0)
                ),
            }
            for name, s in sorted(stages.items())
        },
        "chunks": chunks,
        "devices": _device_stats(events),
        "verdict": _verdict(stages, chunks, wall),
    }
    return doc


def analyze_capture(directory: str) -> Optional[dict]:
    """Attribution pass over a capture directory's events.jsonl,
    self-measured: the pass runs inside a ``critpath_analyze`` span,
    stamps ``analyzer.overhead_s`` into the doc, and sets the
    ``critpath.chunks`` / ``critpath.stragglers`` gauges — evidence
    that the attribution layer is offline-only (a capture with zero
    critpath_analyze spans paid zero analysis cost during the run)."""
    from .report import load_events

    path = os.path.join(directory, "events.jsonl")
    if not os.path.exists(path):
        return None
    events = load_events(path)
    # the live tracer may still sink into this very capture (in-process
    # analysis right after finish_capture): appending our own span to
    # the stream we just read would mutate the evidence and break
    # byte-identical reruns — time the pass without the span then
    sink_here = (
        TRACER.directory is not None
        and os.path.abspath(TRACER.directory) == os.path.abspath(directory)
    )
    t0 = time.perf_counter()
    if sink_here:
        doc = analyze(events)
    else:
        with TRACER.span(names.SPAN_CRITPATH_ANALYZE, directory=directory):
            doc = analyze(events)
    if doc is None:
        return None
    doc["analyzer"] = {"overhead_s": round(time.perf_counter() - t0, 6)}
    gauge(names.CRITPATH_CHUNKS).set((doc["chunks"] or {}).get("count", 0))
    gauge(names.CRITPATH_STRAGGLERS).set(
        len((doc["devices"] or {}).get("stragglers", []))
    )
    return doc


def write_critpath(
    directory: str, out: Optional[str] = None, doc: Optional[dict] = None
) -> Optional[str]:
    """Analyze ``directory`` and write ``critpath.json`` next to the
    capture (atomic tmp+replace, like every other live artifact).
    Returns the path, or None when there was nothing to attribute."""
    if doc is None:
        doc = analyze_capture(directory)
    if doc is None:
        return None
    out = out or os.path.join(directory, "critpath.json")
    tmp = out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, out)
    return out


def render_critpath(doc: dict) -> str:
    """The report's critical-path section: per-stage attribution table,
    chunk chain decomposition, straggler spread, ranked verdict."""
    from .report import _fmt_s

    lines = ["critical path (attribution over the phase window):"]
    for name, s in (doc.get("stages") or {}).items():
        lines.append(
            f"  {name:<18} critical {_fmt_s(s['critical_s']):>10} "
            f"({100 * s['critical_share']:5.1f}% of wall)  "
            f"busy {_fmt_s(s['busy_s']):>10}  "
            f"chunk-bottleneck {100 * s['chunk_bottleneck_fraction']:.0f}%"
        )
    lines.append(
        f"  attributed {100 * doc.get('attributed_fraction', 0.0):.1f}% "
        f"of {_fmt_s((doc.get('window') or {}).get('wall_s', 0.0))} wall; "
        f"blocked (no stage running) {_fmt_s(doc.get('blocked_s', 0.0))}"
    )
    chunks = doc.get("chunks")
    if chunks:
        lines.append(
            f"  chunks: {chunks['count']} chains, "
            f"window-blocked {_fmt_s(chunks['blocked_on_window_s'])}, "
            f"queue-wait " + (
                ", ".join(
                    f"{k} {_fmt_s(v)}"
                    for k, v in chunks["queue_wait_s"].items()
                ) or "none"
            )
        )
    devices = doc.get("devices")
    if devices and devices["count"] >= 2:
        line = (
            f"  devices: {devices['count']}, straggler ratio "
            f"{devices['straggler_ratio']:.2f}x"
        )
        if devices["stragglers"]:
            line += " — STRAGGLERS: " + ", ".join(devices["stragglers"])
        lines.append(line)
    verdict = doc.get("verdict") or {}
    if verdict.get("summary"):
        lines.append(f"  verdict: {verdict['summary']}")
    return "\n".join(lines)
