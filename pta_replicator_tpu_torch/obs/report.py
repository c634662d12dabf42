"""Load a captured telemetry directory and render its report.

Counterpart of ``pta_replicator_tpu/obs/report.py``. A telemetry
directory (written by ``--telemetry DIR`` on the CLI, or by
``obs.start_capture`` / ``obs.finish_capture``) holds:

* ``events.jsonl``      the span/event stream (``obs.trace.EVENT_SCHEMA``)
* ``metrics.json``      ``MetricsRegistry.to_json()``
* ``metrics.prom``      the same registry in the Prometheus text format
* ``chrome_trace.json`` the spans for Perfetto / ``chrome://tracing``
* ``meta.json``         the run's context (argv, torch version, device memory)
* ``numerics.json``     the numerics ledger, when it was armed
* ``progress.json``     the flight recorder's last heartbeat
* ``postmortem.json``   the black box of a killed or crashed run
* ``series.jsonl``      the decimated series and streaming percentiles
* ``slo.json``          the SLO engine's verdict, when objectives were set
* ``critpath.json``     the critical-path attribution (``critpath DIR``)
* ``device_trace/``     a ``--device-trace`` profile, registered in
                        ``meta.json``'s ``device_traces``

The formats are the JAX package's, so this module reads a capture of
either package. Every artifact is optional, and a truncated one loads as
None with a note in ``data["problems"]``: loading never raises on bad data.
The report's sections: the span tree, utilization (stage occupancy from
the events), the critical path (``critpath.json`` when written, else
attributed from the events), SLO, numerics, series sparklines and
percentiles, the roofline (``cuda.roofline.*``, or a JAX capture's
``jax.roofline.*``), the device traces, the card's memory, the metrics,
stalls, an unfinished run's last heartbeat and a postmortem's pointer.
``render_postmortem`` and ``watch_progress`` are the ``postmortem`` and
``watch`` subcommands' bodies.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, TextIO

from . import names, occupancy
from .series import load_series


def load_events(path: str) -> List[dict]:
    """Parse an events.jsonl file (tolerates a truncated final line from
    a crashed run — everything before it is still a valid trace)."""
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                events.append({"type": "corrupt", "raw": line[:80]})
    return events


def load_telemetry(directory: str) -> dict:
    """Read every artifact of a telemetry directory that the port renders.
    Missing artifacts load as None (events: []); a corrupt or truncated
    JSON artifact also loads as None, with a note appended to
    ``["problems"]``."""
    out = {
        "directory": directory, "events": [], "metrics": None,
        "meta": None, "progress": None, "postmortem": None,
        "series": None, "slo": None, "critpath": None, "numerics": None,
        "problems": [],
    }
    if not os.path.isdir(directory):
        out["problems"].append(f"{directory}: not a directory")
        return out
    ev = os.path.join(directory, "events.jsonl")
    if os.path.exists(ev):
        out["events"] = load_events(ev)
    sp = os.path.join(directory, "series.jsonl")
    if os.path.exists(sp):
        try:
            out["series"] = load_series(sp)
        except OSError as exc:
            out["problems"].append(f"series.jsonl: unreadable ({exc})")
    for key, fname in (
        ("metrics", "metrics.json"),
        ("meta", "meta.json"),
        ("progress", "progress.json"),
        ("postmortem", "postmortem.json"),
        ("slo", "slo.json"),
        ("critpath", "critpath.json"),
        ("numerics", "numerics.json"),
    ):
        p = os.path.join(directory, fname)
        if not os.path.exists(p):
            continue
        try:
            with open(p) as fh:
                out[key] = json.load(fh)
        except (json.JSONDecodeError, OSError) as exc:
            out["problems"].append(f"{fname}: unreadable ({exc})")
    return out


def aggregate_spans(events: List[dict]) -> Dict[str, dict]:
    """Per-path aggregates from a span event stream (same shape as
    Tracer.summary(), reconstructed from disk)."""
    agg: Dict[str, dict] = {}
    for rec in events:
        if rec.get("type") != "span":
            continue
        a = agg.get(rec["path"])
        if a is None:
            a = agg[rec["path"]] = {
                "calls": 0, "total_s": 0.0, "cpu_s": 0.0, "max_s": 0.0,
                "first_seq": rec.get("seq", 0),
            }
        a["calls"] += 1
        a["total_s"] += rec.get("wall_s", 0.0)
        a["cpu_s"] += rec.get("cpu_s", 0.0)
        a["max_s"] = max(a["max_s"], rec.get("wall_s", 0.0))
        a["first_seq"] = min(a["first_seq"], rec.get("seq", 0))
    for a in agg.values():
        a["mean_s"] = a["total_s"] / a["calls"]
    return agg


def _tree_order(paths) -> List[str]:
    """Paths sorted so children follow parents, siblings by first use.

    Span records are emitted at *completion*, so a parent's seq is larger
    than its children's; rank each path by the minimum seq anywhere in its
    subtree, per ancestor prefix — that nests children under parents while
    ordering siblings by when their subtree first ran.
    """
    subtree_min: Dict[tuple, float] = {}
    for p, a in paths.items():
        parts = tuple(p.split("/"))
        for i in range(1, len(parts) + 1):
            prefix = parts[:i]
            subtree_min[prefix] = min(
                subtree_min.get(prefix, float("inf")), a["first_seq"]
            )

    def key(p):
        parts = tuple(p.split("/"))
        return tuple(
            subtree_min[parts[:i]] for i in range(1, len(parts) + 1)
        )

    return sorted(paths, key=key)


def render_span_tree(
    agg: Dict[str, dict], min_ms: float = 0.0, indent: str = "  "
) -> str:
    """Indented per-path table: calls, total wall, mean, CPU share."""
    if not agg:
        return "(no spans recorded)"
    lines = [
        f"{'span':<44} {'calls':>6} {'total':>10} {'mean':>10} {'cpu':>8}"
    ]
    for path in _tree_order(agg):
        a = agg[path]
        if a["total_s"] * 1e3 < min_ms:
            continue
        depth = path.count("/")
        label = indent * depth + path.rsplit("/", 1)[-1]
        lines.append(
            f"{label:<44} {a['calls']:>6} {_fmt_s(a['total_s']):>10} "
            f"{_fmt_s(a['mean_s']):>10} {_fmt_s(a['cpu_s']):>8}"
        )
    return "\n".join(lines)


def _fmt_s(seconds: float) -> str:
    if seconds >= 100.0:
        return f"{seconds:.0f} s"
    if seconds >= 0.1:
        return f"{seconds:.2f} s"
    if seconds >= 1e-4:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds * 1e6:.0f} us"


def _metric_rows(metrics: dict) -> List[str]:
    rows = []
    for name in sorted(metrics):
        for inst in metrics[name]:
            labels = inst.get("labels") or {}
            label_str = (
                "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                + "}" if labels else ""
            )
            if inst.get("kind") == "histogram":
                mean = inst.get("mean")
                rows.append(
                    f"  {name}{label_str}: count={inst.get('count')} "
                    f"sum={_fmt_s(inst.get('sum') or 0.0)}"
                    + (f" mean={_fmt_s(mean)}" if mean is not None else "")
                )
            else:
                val = inst.get("value", 0.0)
                val = int(val) if float(val).is_integer() else val
                rows.append(f"  {name}{label_str} = {val}")
    return rows


def render_report(
    directory: str, min_ms: float = 0.0, as_json: bool = False
) -> str:
    """The ``report`` CLI body: span tree, utilization, critical path, SLO,
    numerics, series, roofline, device traces and memory, metrics, stalls
    and the run's end."""
    from . import critpath as _critpath

    data = load_telemetry(directory)
    agg = aggregate_spans(data["events"])
    metrics = data["metrics"] or {}
    util = occupancy.analyze(data["events"])
    # a written critpath.json wins (it carries the analyzer's own overhead
    # stamp); else attribute from the events in hand. A newer writer's
    # document is not misread: re-derived from the events instead
    cp = data["critpath"]
    if cp and cp.get("schema_version", 0) > _critpath.CRITPATH_SCHEMA_VERSION:
        cp = None
    cp = cp or _critpath.analyze(data["events"])

    if as_json:
        return json.dumps(
            {"spans": agg, "metrics": metrics, "meta": data["meta"],
             "progress": data["progress"], "postmortem": data["postmortem"],
             "series": data["series"], "slo": data["slo"],
             "numerics": data["numerics"], "critpath": cp, "utilization": util,
             "problems": data["problems"]},
            indent=1, sort_keys=True,
        )

    parts = [f"telemetry report: {directory}"]
    meta = data["meta"] or {}
    if meta:
        ctx = ", ".join(
            f"{k}={meta[k]}"
            for k in ("backend", "device", "argv", "torch_version", "jax_version")
            if k in meta
        )
        if ctx:
            parts.append(ctx)
    for problem in data["problems"]:
        parts.append(f"  warning: {problem}")
    if not data["events"] and not metrics and not data["progress"] and \
            not data["postmortem"]:
        parts.append("")
        parts.append(
            "no telemetry data: the directory carries no readable "
            "events.jsonl, metrics.json, progress.json or "
            "postmortem.json — either the capture never started "
            "(--telemetry unset?) or the wrong path was given"
        )
        return "\n".join(parts)
    parts.append("")
    parts.append(render_span_tree(agg, min_ms=min_ms))

    if util:
        parts.append("")
        parts.append(render_utilization(util))

    if cp:
        parts.append("")
        parts.append(_critpath.render_critpath(cp))

    for section in (render_slo(data["slo"]) if data["slo"] else "",
                    render_numerics(data["numerics"]) if data["numerics"] else ""):
        if section:
            parts.append("")
            parts.append(section)

    if data["series"]:
        trends = (data["progress"] or {}).get("trends")
        for section in (render_series(data["series"], trends=trends),
                        render_percentiles(data["series"])):
            if section:
                parts.append("")
                parts.append(section)

    # the roofline gauges render once, in their own section below
    roofline_prefixes = (names.JAX_ROOFLINE_PREFIX, names.CUDA_ROOFLINE_PREFIX)
    jax_rows = _metric_rows(
        {k: v for k, v in metrics.items()
         if k.startswith(names.JAX_PREFIX) and not k.startswith(roofline_prefixes)}
    )
    if jax_rows:
        parts.append("")
        parts.append("jax accounting:")
        parts.extend(jax_rows)
    roof_rows = _roofline_rows(metrics)
    if roof_rows:
        parts.append("")
        parts.append("roofline (per kernel label):")
        parts.extend(roof_rows)
    traces = meta.get("device_traces") or []
    if traces:
        parts.append("")
        for trace_dir in traces:
            parts.append(
                f"device trace: {trace_dir} (torch.profiler chrome trace — "
                "merge it with `timeline DIR`, open in Perfetto)"
            )
    mem = meta.get("device_memory") or []
    for snap in mem:
        if "bytes_in_use" in snap:
            parts.append(
                f"  {snap['device']}: {snap['bytes_in_use']} bytes in use"
                + (
                    f" (peak {snap['peak_bytes_in_use']})"
                    if "peak_bytes_in_use" in snap else ""
                )
            )

    other_rows = _metric_rows(
        {k: v for k, v in metrics.items()
         if not k.startswith((names.JAX_PREFIX, *roofline_prefixes))}
    )
    if other_rows:
        parts.append("")
        parts.append("metrics:")
        parts.extend(other_rows)

    stalls = _stall_count(metrics, data["progress"])
    if stalls:
        parts.append("")
        parts.append(
            f"STALLS: the watchdog fired {stalls} time(s) — the run went "
            "quiet past its deadline (see the flightrec.stall events)"
        )
    hb = data["progress"]
    if hb is not None and not hb.get("finished"):
        parts.append("")
        parts.append(
            "run did not finish cleanly — last heartbeat "
            f"({hb.get('written_at', '?')}):"
        )
        parts.append("  " + render_heartbeat(hb))
    if data["postmortem"] is not None:
        pm = data["postmortem"]
        parts.append("")
        parts.append(
            f"POSTMORTEM present (reason: {pm.get('reason', '?')}, "
            f"written {pm.get('written_at', '?')}) — inspect with "
            f"`python -m pta_replicator_tpu_torch postmortem {directory}`"
        )

    nspans = sum(a["calls"] for a in agg.values())
    parts.append("")
    parts.append(f"{len(agg)} distinct stages, {nspans} spans total")
    return "\n".join(parts)


def render_numerics(doc: dict) -> str:
    """The report's numerics section from a loaded ``numerics.json``:
    one row per probe site (non-finites, |max| watermark, overflow
    headroom in bits), worst sampled drift per family, and a loud
    marker for open non-finite episodes. The full per-kernel ladder
    verdict lives in ``numerics report DIR`` (docs/numerics.md)."""
    sites = (doc or {}).get("sites") or {}
    drift = (doc or {}).get("drift") or {}
    if not sites and not drift:
        return ""
    rows = ["numerics (tensor health per probe site):"]
    for site in sorted(sites):
        rec = sites[site]
        hb = rec.get("headroom_bits")
        row = (
            f"  {site:<28} nonfinite {rec.get('nonfinite', 0):>6}  "
            f"max|x| {rec.get('max_abs', 0.0):>10.3g}  "
            + (f"headroom {hb:6.1f}b" if hb is not None
               else "headroom    inf")
        )
        if rec.get("episode_active"):
            row += "  ** NON-FINITE EPISODE OPEN **"
        rows.append(row)
    for family in sorted(drift):
        d = drift[family]
        tol = d.get("tolerance")
        row = (
            f"  drift[{family}] {d.get('worst', 0.0):.3g} worst over "
            f"{d.get('samples', 0)} sample(s)"
        )
        if tol is not None:
            row += (
                f" (tolerance {tol:g}"
                + (", EXCEEDED)" if d.get("worst", 0.0) > tol else ")")
            )
        rows.append(row)
    active = (doc or {}).get("episodes_active") or []
    if active:
        rows.append(
            f"  NON-FINITE EPISODES ACTIVE: {', '.join(active)} — "
            "/readyz serves 503 until they clear (docs/numerics.md)"
        )
    return "\n".join(rows)


#: unicode block ramp for the series sparklines
_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 32) -> str:
    """Fixed-width unicode sparkline of ``values`` (tail-sampled when
    longer than ``width``; flat series render as a low bar)."""
    if not values:
        return ""
    if len(values) > width:
        step = len(values) / width
        values = [values[int(i * step)] for i in range(width)]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK_BLOCKS[0] * len(values)
    scale = (len(_SPARK_BLOCKS) - 1) / (hi - lo)
    return "".join(
        _SPARK_BLOCKS[int((v - lo) * scale)] for v in values
    )


def _fmt_value(v: float) -> str:
    if abs(v) >= 1e5 or (v and abs(v) < 1e-3):
        return f"{v:.3g}"
    return f"{int(v)}" if float(v).is_integer() else f"{v:.4g}"


def render_series(series: dict, trends: Optional[dict] = None,
                  width: int = 32) -> str:
    """The report's series section from a loaded ``series.jsonl``: one
    sparkline per sampled series (whole-run shape at the ring's
    decimated resolution) with the latest value and — when the final
    heartbeat carried them — the trailing-window rate/trend."""
    rows = []
    trends = trends or {}
    for s in sorted(series.get("series") or [],
                    key=lambda s: (s.get("name"), str(s.get("labels")))):
        samples = s.get("samples") or []
        if not samples:
            continue
        name = s["name"]
        labels = s.get("labels") or {}
        flat = name + (
            "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            + "}" if labels else ""
        )
        values = [v for _, v in samples]
        row = (f"  {flat:<40} {sparkline(values, width)}  "
               f"latest {_fmt_value(values[-1])}")
        tr = trends.get(flat) or {}
        if tr.get("rate_per_s"):
            row += f" ({tr['rate_per_s']:+.3g}/s)"
        if tr.get("trend") and tr["trend"] != "flat":
            row += f" [{tr['trend']}]"
        if s.get("stride", 1) > 1:
            row += f" (1:{s['stride']} decimated)"
        rows.append(row)
    if not rows:
        return ""
    return "series (sampled by the flight recorder):\n" + "\n".join(rows)


def render_percentiles(series: dict) -> str:
    """The report's latency-percentile section: p50/p95/p99 per span
    name (streaming P² over every completed span) and per latency
    histogram (bucket-interpolated), from series.jsonl's ``quantiles``
    records."""
    rows = []
    for q in sorted(series.get("quantiles") or [],
                    key=lambda q: (q.get("kind"), q.get("name"))):
        if q.get("p50") is None:
            continue
        rows.append(
            f"  {q.get('name', '?'):<32} "
            f"p50 {_fmt_s(q['p50']):>10}  p95 {_fmt_s(q['p95']):>10}  "
            f"p99 {_fmt_s(q['p99']):>10}  ({q.get('count', 0)} "
            f"{'spans' if q.get('kind') == 'span' else 'obs'})"
        )
    if not rows:
        return ""
    return "latency percentiles (p50/p95/p99, streaming):\n" + \
        "\n".join(rows)


def render_slo(slo: dict) -> str:
    """The report's SLO section from a loaded ``slo.json``: one row per
    objective — SLI vs target, error budget remaining, fast/slow burn
    rates, with a loud BREACH marker (docs/tracing.md)."""
    objectives = (slo or {}).get("objectives") or {}
    if not objectives:
        return ""
    rows = ["slo (error budgets over the rolling window):"]
    for name in sorted(objectives):
        st = objectives[name]
        if not isinstance(st, dict):
            continue
        sli = st.get("sli")
        target = st.get("target")
        budget = st.get("error_budget_remaining")
        row = f"  {name:<18}"
        if sli is not None and target is not None:
            row += f" sli {100 * sli:7.3f}% (target {100 * target:g}%)"
        if budget is not None:
            row += f"  budget {100 * budget:6.1f}%"
        if st.get("burn_rate_fast") is not None:
            row += (f"  burn {st['burn_rate_fast']:.2f}x fast / "
                    f"{st.get('burn_rate_slow', 0.0):.2f}x slow")
        if st.get("breach"):
            row += "  ** BREACH **"
        rows.append(row)
    breached = (slo or {}).get("breached") or []
    if breached:
        rows.append(
            f"  SLO BREACH: {', '.join(breached)} — fast-window burn "
            "past threshold (see docs/tracing.md; /readyz serves 503)"
        )
    return "\n".join(rows)


def render_utilization(util: dict) -> str:
    """The report's utilization section from an :func:`occupancy.analyze`
    result: per-stage duty table, overlap efficiency, bottleneck
    verdict — the measured successor of the old hand-worked
    "sum(drain)+sum(io_write) vs wall" reading."""
    lines = ["utilization (stage occupancy):"]
    for stage, s in (util.get("stages") or {}).items():
        lines.append(
            f"  {stage:<18} duty {100 * s['duty']:5.1f}%  "
            f"busy {_fmt_s(s['busy_s']):>10}  {s['calls']:>5} calls"
        )
    if "overlap_efficiency" in util:
        lines.append(
            f"  overlap efficiency {100 * util['overlap_efficiency']:.0f}% "
            f"(wall {_fmt_s(util['wall_s'])} vs serial "
            f"{_fmt_s(util['serial_s'])}: "
            f"{util['wall_reduction_vs_serial_pct']:.0f}% of the serial "
            "wall overlapped away)"
        )
    if util.get("bottleneck"):
        lines.append(f"  bottleneck: {util['bottleneck']}")
    return "\n".join(lines)


def _roofline_rows(metrics: dict) -> List[str]:
    """Per-label roofline lines from the ``cuda.roofline.*`` gauges (or a
    JAX capture's ``jax.roofline.*``): achieved rate, intensity, and the
    compute- or memory-bound verdict (derived here from the intensity and
    the recorded ridge, so it works from metrics.json alone)."""
    from . import devprof

    per_label: Dict[str, dict] = {}
    for name, insts in metrics.items():
        for prefix in (names.CUDA_ROOFLINE_PREFIX, names.JAX_ROOFLINE_PREFIX):
            if not name.startswith(prefix):
                continue
            key = name[len(prefix):]
            for inst in insts:
                label = (inst.get("labels") or {}).get("label", "?")
                per_label.setdefault(label, {})[key] = inst.get("value")
    rows = []
    for label in sorted(per_label):
        vals = per_label[label]
        flops = vals.get("flops_per_s")
        if not flops:
            continue
        row = f"  {label}: {flops / 1e12:.3f} TFLOP/s"
        if vals.get("bytes_per_s"):
            row += f", {vals['bytes_per_s'] / 1e9:.2f} GB/s"
        if vals.get("intensity_flop_per_byte"):
            row += f", {vals['intensity_flop_per_byte']:.1f} flop/B"
        ridge = vals.get("ridge_intensity")
        if ridge and vals.get("intensity_flop_per_byte"):
            row += " -> " + devprof.classify(vals["intensity_flop_per_byte"], ridge)
            if vals.get("pct_of_roofline") is not None:
                row += f" ({vals['pct_of_roofline']:.1f}% of roofline)"
        elif vals.get("pct_of_peak_flops") is not None:
            row += f" ({vals['pct_of_peak_flops']:.1f}% of peak)"
        rows.append(row)
    return rows


def _stall_count(metrics: dict, progress: Optional[dict]) -> int:
    insts = (metrics or {}).get(names.FLIGHTREC_STALLS) or []
    for inst in insts:
        if inst.get("value"):
            return int(inst["value"])
    if progress and progress.get("stalls"):
        return int(progress["stalls"])
    return 0


def render_heartbeat(hb: dict) -> str:
    """One-line human rendering of a progress.json heartbeat — the
    ``watch`` subcommand prints one of these per tick (tail-friendly:
    append to a log, read with tail -f)."""
    parts = [hb.get("written_at", "?")]
    sweep = hb.get("sweep") or {}
    done, total = sweep.get("chunks_done"), sweep.get("chunks_total")
    if done is not None and total:
        pct = 100.0 * done / total
        parts.append(f"chunks {int(done)}/{int(total)} ({pct:.1f}%)")
        eta = sweep.get("eta_s")
        if eta is not None:
            parts.append(f"eta {_fmt_eta(eta)}")
        rate = sweep.get("chunk_rate_per_s")
        if rate:
            parts.append(f"{rate:.3g} chunk/s")
    if sweep.get("inflight"):
        parts.append(f"inflight {int(sweep['inflight'])}")
    occ = hb.get("occupancy") or {}
    if occ.get("bottleneck"):
        parts.append(occ["bottleneck"])
    slo = hb.get("slo") or {}
    breached = slo.get("breached") or []
    if breached:
        parts.append("SLO BREACH " + ",".join(str(b) for b in breached))
    elif slo.get("objectives"):
        worst = min(
            (o.get("budget_remaining") for o in
             slo["objectives"].values()
             if isinstance(o, dict)
             and o.get("budget_remaining") is not None),
            default=None,
        )
        if worst is not None:
            parts.append(f"slo budget {100 * worst:.0f}%")
    num = hb.get("numerics") or {}
    if num.get("nonfinite"):
        parts.append(
            f"NONFINITE {int(num['nonfinite'])}"
            + (f" ({int(num['episodes_active'])} episode(s) open)"
               if num.get("episodes_active") else "")
        )
    open_spans = hb.get("open_spans") or {}
    if open_spans:
        deepest = max(open_spans.values(), key=len)
        parts.append("in " + "/".join(deepest))
    else:
        parts.append("idle")
    age = hb.get("last_span_age_s")
    if age is not None and age > 30:
        parts.append(f"last span {age:.0f}s ago")
    jx = hb.get("jax") or {}
    if jx.get("compiles"):
        parts.append(f"compiles {int(jx['compiles'])}")
    mem = hb.get("device_memory") or []
    peak = max((m.get("peak_bytes_in_use", m.get("bytes_in_use", 0))
                for m in mem), default=0)
    if peak:
        parts.append(f"mem {peak / 2**30:.2f} GiB")
    if hb.get("stalls"):
        parts.append(f"STALLS {int(hb['stalls'])}")
    if hb.get("finished"):
        parts.append("FINISHED")
    return " | ".join(parts)


def _fmt_eta(seconds: float) -> str:
    seconds = int(seconds)
    if seconds >= 3600:
        return f"{seconds // 3600}h{(seconds % 3600) // 60:02d}m"
    if seconds >= 60:
        return f"{seconds // 60}m{seconds % 60:02d}s"
    return f"{seconds}s"


def render_postmortem(directory: str, last: int = 25) -> str:
    """The ``postmortem`` CLI body: reason, final heartbeat, the tail of
    the ring buffer (in-flight spans were never completed, so the open
    stacks in the heartbeat ARE the in-flight work), key metrics."""
    data = load_telemetry(directory)
    pm = data["postmortem"]
    parts = [f"postmortem: {directory}"]
    for problem in data["problems"]:
        parts.append(f"  warning: {problem}")
    if pm is None:
        parts.append(
            "no postmortem.json — the run either finished cleanly, is "
            "still alive (try `watch`), or died uncatchably (SIGKILL/"
            "OOM-killer: see the last heartbeat below and events.jsonl)"
        )
        if data["progress"] is not None:
            parts.append("")
            parts.append("last heartbeat: " + render_heartbeat(
                data["progress"]))
        return "\n".join(parts)

    parts.append(
        f"reason: {pm.get('reason', '?')}  written: "
        f"{pm.get('written_at', '?')}"
    )
    exc = pm.get("exception")
    if exc:
        parts.append(f"exception: {exc.get('type')}: {exc.get('message')}")
        tb = exc.get("traceback") or []
        parts.extend("  " + line.rstrip() for line in tb[-6:])
    hb = pm.get("heartbeat") or {}
    parts.append("")
    parts.append("final heartbeat: " + render_heartbeat(hb))
    for tid, stack in (hb.get("open_spans") or {}).items():
        parts.append(f"  in flight (tid {tid}): " + "/".join(stack))

    ring = pm.get("ring") or []
    if ring:
        parts.append("")
        parts.append(f"last {min(last, len(ring))} of {len(ring)} "
                     "buffered span/event records (oldest first):")
        t_end = max((r.get("t0", 0.0) for r in ring), default=0.0)
        for rec in ring[-last:]:
            dt = rec.get("t0", 0.0) - t_end
            if rec.get("type") == "span":
                parts.append(
                    f"  {dt:+9.3f}s  {rec.get('path', rec.get('name')):<44} "
                    f"{_fmt_s(rec.get('wall_s', 0.0)):>10}"
                )
            else:
                parts.append(
                    f"  {dt:+9.3f}s  [{rec.get('type')}] "
                    f"{rec.get('name')} {rec.get('attrs', '')}"
                )
    metrics = pm.get("metrics") or {}
    interesting = {
        k: v for k, v in metrics.items()
        if k.startswith((names.SWEEP_PREFIX, names.FLIGHTREC_PREFIX,
                         names.PIPELINE_PREFIX, names.OCCUPANCY_PREFIX))
    }
    rows = _metric_rows(interesting)
    if rows:
        parts.append("")
        parts.append("run counters at death:")
        parts.extend(rows)
    return "\n".join(parts)


def print_postmortem(directory: str, file: Optional[TextIO] = None) -> None:
    print(render_postmortem(directory), file=file)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        # atomic-replace writing means corrupt == mid-crash leftovers,
        # not a torn write; either way the watcher just waits
        return None


def watch_progress(
    directory: str,
    interval: float = 2.0,
    once: bool = False,
    file: Optional[TextIO] = None,
) -> int:
    """The ``watch`` CLI body: tail ``directory/progress.json``, printing
    one :func:`render_heartbeat` line whenever the heartbeat advances
    (tail -f friendly — recovery watchers append this to their logs).

    Returns 0 when the watched run finishes, 2 when a postmortem.json
    appears (the run died — its summary is printed), 3 in ``--once``
    mode when there is nothing to read. Ctrl-C just stops watching.
    """
    import time as _time

    progress_path = os.path.join(directory, "progress.json")
    pm_path = os.path.join(directory, "postmortem.json")
    last_seen = None
    waiting_said = False
    stale_said = False
    t_change = _time.monotonic()
    stale_after = max(30.0, 10 * interval)
    try:
        while True:
            hb = _read_json(progress_path)
            # change detection compares the whole document, NOT
            # written_at: that field has 1-second resolution and the
            # final finished=True heartbeat often lands in the same
            # second as the previous tick — it must still print and
            # terminate the watch
            if hb is not None and hb != last_seen:
                last_seen = hb
                t_change = _time.monotonic()
                stale_said = False
                print(render_heartbeat(hb), file=file, flush=True)
                if hb.get("finished"):
                    return 0
            elif (
                hb is not None and not stale_said
                and _time.monotonic() - t_change > stale_after
            ):
                stale_said = True
                print(
                    f"(heartbeat stale for "
                    f"{_time.monotonic() - t_change:.0f}s — run SIGKILLed "
                    "or host wedged? events.jsonl holds what completed)",
                    file=file, flush=True,
                )
            elif hb is None and (once or not waiting_said):
                waiting_said = True
                print(
                    f"(no progress.json in {directory} yet — run not "
                    "started, or started without a flight recorder)",
                    file=file, flush=True,
                )
            if os.path.exists(pm_path):
                pm = _read_json(pm_path) or {}
                print(
                    f"run died (postmortem reason: {pm.get('reason', '?')})"
                    f" — `python -m pta_replicator_tpu_torch postmortem "
                    f"{directory}` for the black box",
                    file=file, flush=True,
                )
                return 2
            if once:
                return 3 if hb is None else 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def print_report(
    directory: str,
    min_ms: float = 0.0,
    as_json: bool = False,
    file: Optional[TextIO] = None,
) -> None:
    print(render_report(directory, min_ms=min_ms, as_json=as_json), file=file)
