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

The formats are the JAX package's, so this module reads a capture of
either package. Every artifact is optional, and a truncated one loads as
None with a note in ``data["problems"]``: loading never raises on bad data.

The JAX package's captures may also hold ``progress.json``,
``postmortem.json``, ``series.jsonl``, ``slo.json`` and ``critpath.json``
(its flight recorder, series, SLO and critical-path modules). The port
renders none of them yet (ROADMAP A.16.4); the report names the ones a
capture holds on one line instead of skipping them silently.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, TextIO

from . import names

#: capture artifacts of modules the port has not ported (ROADMAP A.16.4)
NOT_RENDERED = ("progress.json", "postmortem.json", "series.jsonl", "slo.json",
                "critpath.json")


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
    ``["problems"]``. ``["not_rendered"]`` lists the artifacts of
    :data:`NOT_RENDERED` the directory holds."""
    out = {
        "directory": directory, "events": [], "metrics": None,
        "meta": None, "numerics": None, "not_rendered": [], "problems": [],
    }
    if not os.path.isdir(directory):
        out["problems"].append(f"{directory}: not a directory")
        return out
    ev = os.path.join(directory, "events.jsonl")
    if os.path.exists(ev):
        out["events"] = load_events(ev)
    for key, fname in (
        ("metrics", "metrics.json"),
        ("meta", "meta.json"),
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
    out["not_rendered"] = [f for f in NOT_RENDERED
                           if os.path.exists(os.path.join(directory, f))]
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
    """The ``report`` CLI body: span tree, numerics, device memory and
    metrics."""
    data = load_telemetry(directory)
    agg = aggregate_spans(data["events"])
    metrics = data["metrics"] or {}

    if as_json:
        return json.dumps(
            {"spans": agg, "metrics": metrics, "meta": data["meta"],
             "numerics": data["numerics"],
             "not_rendered": data["not_rendered"],
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
    if data["not_rendered"]:
        parts.append(
            f"  not rendered by the port (ROADMAP A.16.4): "
            f"{', '.join(data['not_rendered'])}"
        )
    if not data["events"] and not metrics:
        parts.append("")
        parts.append(
            "no telemetry data: the directory carries no readable "
            "events.jsonl or metrics.json — either the capture never "
            "started (--telemetry unset?) or the wrong path was given"
        )
        return "\n".join(parts)
    parts.append("")
    parts.append(render_span_tree(agg, min_ms=min_ms))

    if data["numerics"]:
        section = render_numerics(data["numerics"])
        if section:
            parts.append("")
            parts.append(section)

    jax_rows = _metric_rows(
        {k: v for k, v in metrics.items() if k.startswith(names.JAX_PREFIX)}
    )
    if jax_rows:
        parts.append("")
        parts.append("jax accounting:")
        parts.extend(jax_rows)
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
         if not k.startswith(names.JAX_PREFIX)}
    )
    if other_rows:
        parts.append("")
        parts.append("metrics:")
        parts.extend(other_rows)

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


def print_report(
    directory: str,
    min_ms: float = 0.0,
    as_json: bool = False,
    file: Optional[TextIO] = None,
) -> None:
    print(render_report(directory, min_ms=min_ms, as_json=as_json), file=file)
