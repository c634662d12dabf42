"""One correlated host and device timeline from a capture directory.

Counterpart of ``pta_replicator_tpu/obs/timeline.py``. A captured run
leaves its evidence on two clocks: host spans in ``events.jsonl``
(wall-clock ``t0`` stamps) and, when a managed
:func:`..obs.devprof.device_trace` ran, a ``torch.profiler`` chrome trace
whose events ride the profiler's own microsecond clock. This module merges
everything into ONE ``chrome://tracing`` / Perfetto file:

* **host spans**: every span record becomes a phase-"X" event, with the
  stage-graph spans lifted onto named ``stage:*`` tracks in dataflow order
  (``occupancy.STAGE_SORT_ORDER``), one track per device for spans that
  carry a ``device`` attr.
* **chunk flow links**: the sweep's ``dispatch`` / ``drain`` /
  ``io_write`` spans carry ``chunk=i``; the merger links each chunk's
  stages with chrome flow events (``s`` / ``t`` / ``f``, one id a chunk).
* **request trace links**: spans stamped with a request's ``trace_id``
  (the likelihood server's submit / queue-wait / resolve hops) chain as
  their own flow arrows, through the ``likelihood_batch`` span that names
  the trace in its ``links``.
* **critical-path track**: a ``critical path`` lane with a
  ``crit:<stage>`` slice for every instant ``obs/critpath.py`` charges to
  that stage, and the ranked verdict as an instant marker.
* **device trace events**: every ``*.trace.json(.gz)`` under the dirs
  ``meta.json``'s ``device_traces`` registers, shifted onto the wall clock
  by the correlation markers of the ``device_trace`` span. Where the trace
  holds the ``device_trace_open`` marker (``obs/devprof.py``), that
  marker is anchored at ``t_wall_open``: the marker is stamped right after
  it, so the anchor does not move by the time the profiler takes to start.
  Without the marker (the JAX package's traces, a synthetic file) the
  trace's earliest event is anchored there, the JAX package's rule. Any
  drift of the profiler's clock across the session is not corrected.

Tolerant: every artifact is optional, a capture without device traces
merges host-only, and a missing ``events.jsonl`` yields an empty timeline
with a problem note.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

from . import names, occupancy
from .devprof import OPEN_MARKER
from .report import load_telemetry

#: synthetic tid base for stage tracks (matches Tracer.chrome_trace)
_STAGE_TID_BASE = 1 << 22
#: pid offset for merged device-trace processes: far above any real pid
_DEVICE_PID_BASE = 1 << 21
#: synthetic tid of the annotated critical-path track (one below the
#: stage-track base so it can never collide with a real or stage tid)
_CRITPATH_TID = _STAGE_TID_BASE - 1


def _stage_order() -> List[str]:
    return list(occupancy.STAGE_SORT_ORDER) + sorted(
        set(occupancy.STAGES) - set(occupancy.STAGE_SORT_ORDER)
    )


class _StageTracks:
    """Allocates one synthetic tid per (stage, device) pair, in dataflow
    order: stage rank majors, device label minors — so per-device
    staging lanes group under their stage, in device order."""

    def __init__(self):
        self.order = _stage_order()
        self._tids: Dict[Tuple[str, str], int] = {}

    def tid(self, stage: str, device: str = "") -> int:
        key = (stage, device)
        if key not in self._tids:
            self._tids[key] = _STAGE_TID_BASE + len(self._tids)
        return self._tids[key]

    def metadata(self, pid: int) -> List[dict]:
        ranked = sorted(
            self._tids.items(),
            key=lambda kv: (self.order.index(kv[0][0]), kv[0][1]),
        )
        out = []
        for sort_index, ((stage, device), tid) in enumerate(ranked):
            label = f"stage:{stage}" + (f":dev{device}" if device else "")
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": label},
            })
            out.append({
                "name": "thread_sort_index", "ph": "M", "pid": pid,
                "tid": tid, "args": {"sort_index": sort_index},
            })
        return out


def _host_events(events: List[dict], pid: int) -> Tuple[list, list]:
    """(trace events, flow events) from the span records. Flow events
    link spans sharing a ``chunk`` attr across the pipeline stages, and
    — since the causal-tracing PR — spans sharing a request-level
    ``trace_id`` (plus the coalesced batch spans that name a trace in
    their ``links`` fan-in field), so one request's submit ->
    queue-wait -> batch -> resolution reads as one arrow chain."""
    tracks = _StageTracks()
    out: List[dict] = []
    # chunk id -> [(stage rank, ts_us, tid)] for flow emission
    chunk_points: Dict[object, List[Tuple[int, float, int]]] = {}
    flow_order = {names.SPAN_DISPATCH: 0, names.SPAN_DRAIN: 1,
                  names.SPAN_IO_WRITE: 2}
    # trace_id -> [(ts_us, tid)] for request-trace flow emission.
    # CHUNK traces are excluded entirely (any trace_id seen on a
    # chunk-stage span, which also covers its nested engine spans), or
    # every chunk would render a second, redundant arrow chain next to
    # the chunk flows that already draw that lineage.
    trace_points: Dict[str, List[Tuple[float, int]]] = {}
    chunk_trace_ids = {
        rec["trace_id"] for rec in events
        if rec.get("type") == "span"
        and isinstance(rec.get("trace_id"), str)
        and rec.get("name") in flow_order
        and "chunk" in (rec.get("attrs") or {})
    }
    for rec in events:
        if rec.get("type") != "span":
            continue
        name = rec.get("name")
        attrs = rec.get("attrs") or {}
        ts = float(rec.get("t0", 0.0)) * 1e6
        dur = float(rec.get("wall_s", 0.0)) * 1e6
        if name in occupancy.STAGES:
            tid = tracks.tid(name, str(attrs.get("device", "")))
        else:
            tid = rec.get("tid", 0)
        out.append({
            "name": name, "cat": "host", "ph": "X",
            "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": {**attrs, "path": rec.get("path", name)},
        })
        is_chunk_stage = name in flow_order and "chunk" in attrs
        if is_chunk_stage:
            chunk_points.setdefault(attrs["chunk"], []).append(
                (flow_order[name], ts + dur / 2.0, tid)
            )
        else:
            point = (ts + dur / 2.0, tid)
            tid_rec = rec.get("trace_id")
            if isinstance(tid_rec, str) and \
                    tid_rec not in chunk_trace_ids:
                trace_points.setdefault(tid_rec, []).append(point)
            for linked in rec.get("links") or []:
                if isinstance(linked, str) and \
                        linked not in chunk_trace_ids:
                    trace_points.setdefault(linked, []).append(point)
    flows: List[dict] = []
    for chunk, points in chunk_points.items():
        points.sort()
        if len(points) < 2:
            continue
        for i, (_rank, ts, tid) in enumerate(points):
            ph = "s" if i == 0 else ("f" if i == len(points) - 1 else "t")
            flow = {
                "name": "chunk", "cat": "chunk", "ph": ph,
                "id": int(chunk) if isinstance(chunk, (int, float))
                else abs(hash(chunk)) % (1 << 31),
                "ts": ts, "pid": pid, "tid": tid,
            }
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            flows.append(flow)
    for trace_id, points in trace_points.items():
        points.sort()
        if len(points) < 2:
            continue
        # 48 bits of the trace id: chrome flow ids must be integers;
        # collisions across distinct request traces are negligible at
        # any realistic request count
        flow_id = int(trace_id[:12], 16)
        for i, (ts, tid) in enumerate(points):
            ph = "s" if i == 0 else ("f" if i == len(points) - 1 else "t")
            flow = {
                "name": "trace", "cat": "trace", "ph": ph,
                "id": flow_id, "ts": ts, "pid": pid, "tid": tid,
                "args": {"trace_id": trace_id},
            }
            if ph == "f":
                flow["bp"] = "e"
            flows.append(flow)
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "host"}},
        {"name": "process_sort_index", "ph": "M", "pid": pid,
         "args": {"sort_index": 0}},
    ] + tracks.metadata(pid)
    return meta + out, flows


def _critpath_track(
    events: List[dict], critpath_doc: Optional[dict], pid: int
) -> List[dict]:
    """The annotated ``critical path`` track: one slice per exclusive
    critical interval (``crit:<stage>`` — the instants the attribution
    engine charges to that stage), plus the ranked verdict as a global
    instant marker at the window start. Scrubbing the merged view, the
    track reads as 'what the run was actually waiting on, instant by
    instant'. Empty when no stage spans exist."""
    from . import critpath

    window, exclusive = critpath.critical_intervals(events)
    if window is None or not any(exclusive.values()):
        return []
    out: List[dict] = [
        {"name": "thread_name", "ph": "M", "pid": pid,
         "tid": _CRITPATH_TID, "args": {"name": "critical path"}},
        {"name": "thread_sort_index", "ph": "M", "pid": pid,
         "tid": _CRITPATH_TID, "args": {"sort_index": -1}},
    ]
    for stage, intervals in sorted(exclusive.items()):
        for t0, t1 in intervals:
            out.append({
                "name": f"crit:{stage}", "cat": "critpath", "ph": "X",
                "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                "pid": pid, "tid": _CRITPATH_TID,
                "args": {"stage": stage},
            })
    summary = ((critpath_doc or {}).get("verdict") or {}).get("summary")
    if summary:
        out.append({
            "name": summary, "cat": "critpath", "ph": "i", "s": "t",
            "ts": window[0] * 1e6, "pid": pid, "tid": _CRITPATH_TID,
        })
    return out


def _correlation_markers(events: List[dict]) -> Dict[str, float]:
    """logdir -> wall-clock open instant, from the ``device_trace``
    span attrs (falling back to the span's own t0 for captures from
    before the markers existed)."""
    out: Dict[str, float] = {}
    for rec in events:
        if rec.get("type") != "span" or \
                rec.get("name") != names.SPAN_DEVICE_TRACE:
            continue
        attrs = rec.get("attrs") or {}
        logdir = attrs.get("logdir")
        if not logdir:
            continue
        out[str(logdir)] = float(
            attrs.get("t_wall_open", rec.get("t0", 0.0))
        )
    return out


def _load_trace_file(path: str) -> Optional[dict]:
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as fh:
                return json.load(fh)
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError, EOFError):
        return None


def _device_events(
    trace_dir: str, wall_open: Optional[float], pid: int
) -> Tuple[List[dict], List[str]]:
    """Merge every ``*.trace.json(.gz)`` under ``trace_dir`` onto the
    wall clock: the ``device_trace_open`` marker, else the file set's
    earliest timestamp, is anchored at ``wall_open`` (no ``wall_open`` ->
    events pass through unshifted, with a problem note). Source pids are
    remapped into a private range so device processes can never collide
    with the host pid."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json*"),
                  recursive=True)
    )
    problems: List[str] = []
    raw_events: List[dict] = []
    for p in paths:
        doc = _load_trace_file(p)
        if doc is None:
            problems.append(f"{p}: unreadable trace file")
            continue
        evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
        if isinstance(evs, list):
            raw_events.extend(e for e in evs if isinstance(e, dict))
    if not raw_events:
        if not paths:
            problems.append(
                f"{trace_dir}: no *.trace.json(.gz) files (profiler "
                "wrote a different format, or the trace is empty)"
            )
        return [], problems
    stamped = [e for e in raw_events
               if isinstance(e.get("ts"), (int, float))]
    offset_us = 0.0
    if wall_open is not None and stamped:
        opened = [e["ts"] for e in stamped if e.get("name") == OPEN_MARKER]
        t_anchor = min(opened) if opened else min(e["ts"] for e in stamped)
        offset_us = wall_open * 1e6 - t_anchor
    elif wall_open is None:
        problems.append(
            f"{trace_dir}: no correlation marker (capture predates "
            "t_wall_open) — device events left on the profiler clock"
        )
    pid_map: Dict[object, int] = {}
    out: List[dict] = []
    for e in raw_events:
        e = dict(e)
        src_pid = e.get("pid", 0)
        if src_pid not in pid_map:
            pid_map[src_pid] = pid + len(pid_map)
        e["pid"] = pid_map[src_pid]
        if isinstance(e.get("ts"), (int, float)):
            e["ts"] = e["ts"] + offset_us
        out.append(e)
    label = os.path.basename(trace_dir.rstrip(os.sep)) or trace_dir
    for src_pid, new_pid in pid_map.items():
        out.append({
            "name": "process_sort_index", "ph": "M", "pid": new_pid,
            "args": {"sort_index": 10 + (new_pid - _DEVICE_PID_BASE)},
        })
        # keep the profiler's own process_name metas (already remapped
        # above) but make the origin unmistakable in the merged view
        out.append({
            "name": "process_labels", "ph": "M", "pid": new_pid,
            "args": {"labels": f"torch.profiler:{label}"},
        })
    return out, problems


def build_timeline(directory: str) -> dict:
    """Merge a capture directory into one chrome-trace object:
    ``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData":
    {...}}``. Never raises on missing/partial artifacts — problems are
    listed under ``otherData.problems``."""
    data = load_telemetry(directory)
    events = data["events"]
    meta = data["meta"] or {}
    pid = 0
    for rec in events:
        if rec.get("type") == "meta" and isinstance(rec.get("pid"), int):
            pid = rec["pid"]
            break
    problems = list(data["problems"])
    host, flows = _host_events(events, pid)
    merged = host + flows

    crit = _critpath_track(events, data.get("critpath"), pid)
    merged.extend(crit)

    markers = _correlation_markers(events)
    n_device = 0
    trace_dirs = meta.get("device_traces") or []
    for k, entry in enumerate(trace_dirs):
        tdir = str(entry)
        if not os.path.isabs(tdir):
            tdir = os.path.join(directory, tdir)
        if not os.path.isdir(tdir):
            problems.append(f"device trace {entry!r} not found")
            continue
        wall_open = None
        for logdir, t in markers.items():
            if os.path.abspath(logdir) == os.path.abspath(tdir) or \
                    os.path.basename(logdir) == os.path.basename(tdir):
                wall_open = t
                break
        dev_events, dev_problems = _device_events(
            tdir, wall_open, _DEVICE_PID_BASE + 1000 * k
        )
        n_device += sum(1 for e in dev_events if e.get("ph") != "M")
        merged.extend(dev_events)
        problems.extend(dev_problems)

    n_spans = sum(1 for e in merged
                  if e.get("ph") == "X" and e.get("cat") == "host")
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": directory,
            "host_spans": n_spans,
            "flow_events": len(flows),
            "trace_flow_events": sum(
                1 for f in flows if f.get("cat") == "trace"
            ),
            "device_events": n_device,
            "device_traces": len(trace_dirs),
            "critpath_slices": sum(
                1 for e in crit if e.get("ph") == "X"
            ),
            "problems": problems,
        },
    }


def write_timeline(directory: str, out: Optional[str] = None,
                   doc: Optional[dict] = None) -> str:
    """The ``timeline DIR`` CLI body: build and write the merged trace
    (default ``<dir>/timeline.json``); returns the path written. Pass
    ``doc`` to write an already-built document (the CLI builds once for
    its summary and delegates the write here)."""
    if doc is None:
        doc = build_timeline(directory)
    path = out or os.path.join(directory, "timeline.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return path
