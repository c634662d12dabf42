"""Time-series telemetry: bounded ring histories, streaming percentiles,
and rates and trends over the metrics registry.

Counterpart of ``pta_replicator_tpu/obs/series.py``, with its names,
constants and ``series.jsonl`` schema, so either package's loader reads
either package's file.

* :class:`Ring`: a fixed-budget sample ring that decimates on overflow
  (every other sample dropped, the acceptance stride doubled), so it spans
  the whole run at a coarsening resolution in at most ``budget`` samples.
* :class:`P2Quantile`: the P-squared streaming quantile estimator (Jain &
  Chlamtac 1985), five markers, no samples kept; :class:`SpanQuantiles`
  holds p50/p95/p99 of one span name.
* :class:`SeriesRecorder`: attached to a metrics registry, each
  :meth:`~SeriesRecorder.sample` tick copies every counter and gauge whose
  name matches the prefix table into its ring, plus the process RSS
  (``proc.rss_bytes``). The flight recorder's sampler drives the ticks and
  takes the heartbeat's ``trends`` block from :meth:`~SeriesRecorder.trends`.

Rings store the monotonic clock; one wall/monotonic anchor pair taken at
construction converts them to wall time on export, so the series line up
with the spans' ``t0``. :meth:`~SeriesRecorder.write_jsonl` writes the
whole decimated history as ``series.jsonl`` (:data:`SERIES_SCHEMA`);
:meth:`~SeriesRecorder.snapshot` is the recent window behind the live
``series.json`` and ``watch --serve``'s ``/series``. Standard library
only: nothing here touches torch or the card.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import names
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

SERIES_SCHEMA_VERSION = 1

#: Required fields (and JSON types) of each record kind in series.jsonl,
#: the capture artifact written at the end of a recorded run (and
#: best-effort on postmortem). ``scripts/check_telemetry_schema.py``
#: validates captured files against this table.
SERIES_SCHEMA = {
    "series_meta": {"type": str, "schema": int, "t0": float, "pid": int},
    "series": {
        "type": str,      # literal "series"
        "name": str,      # metric name (dotted)
        "labels": dict,   # label key -> value ({} for unlabeled)
        "kind": str,      # "counter" | "gauge"
        "stride": int,    # decimation stride (1 = every sample kept)
        "samples": list,  # [[t_wall, value], ...] oldest first
    },
    "quantiles": {
        "type": str,      # literal "quantiles"
        "name": str,      # span name or histogram metric name
        "kind": str,      # "span" | "histogram"
        "count": int,     # observations folded in
        "p50": float, "p95": float, "p99": float,
    },
}

#: metric-name prefixes sampled by default (the JAX package's table).
#: Opt-in by prefix: ingest counters are one-shot (a flat series wastes
#: the budget), while these families' evolution diagnoses a long run: the
#: sweep's progress, the stage graph's busy and queue gauges, the SLO
#: budgets, the open request traces, the numerics ledger. The ``jax.*``,
#: ``critpath.*`` and ``ledger.*`` entries match nothing the port emits.
DEFAULT_PREFIXES: Tuple[str, ...] = (
    names.SWEEP_PREFIX,
    names.CW_STREAM_PREFIX,
    names.OCCUPANCY_PREFIX,
    names.PIPELINE_PREFIX,
    names.STAGES_PREFIX,
    names.FLIGHTREC_PREFIX,
    "jax.compiles",
    "jax.traces",
    names.JAX_MEMORY_PREFIX,
    names.OBS_PREFIX,
    names.PROC_PREFIX,
    names.SLO_PREFIX,
    names.TRACE_PREFIX,
    names.CRITPATH_PREFIX,
    names.LEDGER_PREFIX,
    names.NUMERICS_PREFIX,
)


class Ring:
    """Fixed-budget sample ring with stride decimation on overflow.

    ``offer(t, v)`` accepts every ``stride``-th offered sample; when the
    retained list reaches ``budget`` it is thinned to every other sample
    and the stride doubles. For a steady sampling cadence this keeps the
    ring spanning the WHOLE history at uniform (coarsening) resolution —
    the first hour of a ten-hour sweep stays visible, unlike a sliding
    window. Bounded by construction: ``len(samples) <= budget`` at every
    instant, so :meth:`nbytes` can never creep.

    Not thread-safe on its own — :class:`SeriesRecorder` serializes all
    access under its lock.
    """

    __slots__ = ("budget", "stride", "_offered", "samples")

    #: conservative per-sample byte estimate for budget accounting: a
    #: 2-list of floats (CPython: list header + 2 float objects + refs)
    SAMPLE_NBYTES = 120

    def __init__(self, budget: int = 512):
        if budget < 4:
            raise ValueError(f"ring budget must be >= 4, got {budget}")
        self.budget = int(budget)
        self.stride = 1
        self._offered = 0
        self.samples: List[Tuple[float, float]] = []

    def offer(self, t: float, value: float) -> None:
        i = self._offered
        self._offered += 1
        if i % self.stride:
            return
        if len(self.samples) >= self.budget:
            # decimate: keep every other sample (oldest-first list, so
            # resolution coarsens uniformly across the whole history)
            del self.samples[1::2]
            self.stride *= 2
        self.samples.append((t, float(value)))

    def __len__(self) -> int:
        return len(self.samples)

    def nbytes(self) -> int:
        """Estimated retained bytes (for the recorder's budget gauge)."""
        return len(self.samples) * self.SAMPLE_NBYTES


class P2Quantile:
    """Streaming quantile estimator (the P² algorithm, Jain & Chlamtac
    1985): five markers track the running ``p`` quantile with O(1)
    memory and O(1) per-observation cost, no sample retention. Accuracy
    is a few percent of the true quantile for smooth distributions —
    exactly the trade a bounded-memory telemetry layer wants."""

    __slots__ = ("p", "count", "_q", "_n", "_np", "_dn")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self.count = 0
        self._q: List[float] = []   # marker heights
        self._n = [0, 1, 2, 3, 4]   # marker positions (0-based)
        self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]  # desired
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]    # increments

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            self._q.append(x)
            self._q.sort()
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or (
                d <= -1 and n[i - 1] - n[i] < -1
            ):
                d = 1 if d > 0 else -1
                qp = self._parabolic(i, d)
                if not q[i - 1] < qp < q[i + 1]:
                    qp = self._linear(i, d)
                q[i] = qp
                n[i] += d

    def _parabolic(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])

    @property
    def value(self) -> Optional[float]:
        """The current quantile estimate (exact below 5 observations)."""
        if not self.count:
            return None
        if self.count <= 5:
            idx = min(len(self._q) - 1,
                      max(0, round(self.p * (len(self._q) - 1))))
            return self._q[int(idx)]
        return self._q[2]


class SpanQuantiles:
    """p50/p95/p99 + count/min/max over one span name's durations —
    three :class:`P2Quantile` markersets, fixed memory per name."""

    __slots__ = ("count", "min", "max", "p50", "p95", "p99")

    def __init__(self):
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")
        self.p50 = P2Quantile(0.50)
        self.p95 = P2Quantile(0.95)
        self.p99 = P2Quantile(0.99)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        self.p50.observe(x)
        self.p95.observe(x)
        self.p99.observe(x)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.p50.value,
            "p95": self.p95.value,
            "p99": self.p99.value,
        }


def quantiles_from_histogram(
    buckets: Tuple[float, ...], counts: List[int],
    qs: Tuple[float, ...] = (0.50, 0.95, 0.99),
) -> Dict[str, float]:
    """p-quantiles interpolated from cumulative histogram buckets
    (Prometheus ``histogram_quantile`` semantics: linear within a
    bucket, the +Inf tail clamps to the last finite bound). ``counts``
    are the per-bucket (non-cumulative) counts including the +Inf
    tail — the shape :class:`..obs.metrics.Histogram` maintains."""
    total = sum(counts)
    out: Dict[str, float] = {}
    if not total:
        return out
    for q in qs:
        rank = q * total
        cum = 0.0
        val = float(buckets[-1]) if buckets else 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(buckets):  # +Inf tail: clamp
                    val = float(buckets[-1]) if buckets else 0.0
                else:
                    lo = float(buckets[i - 1]) if i else 0.0
                    hi = float(buckets[i])
                    frac = ((rank - prev_cum) / c) if c else 1.0
                    val = lo + (hi - lo) * frac
                break
        out[f"p{int(q * 100)}"] = val
    return out


def process_rss_bytes() -> Optional[int]:
    """Resident set size of this process from /proc/self/statm (linux),
    or None where unavailable — the sampler then simply skips the
    ``proc.rss_bytes`` series."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def _series_key(name: str, labels: tuple) -> Tuple[str, tuple]:
    return (name, tuple(labels))


#: newest samples consulted by the per-tick trend derivation — more
#: than any trailing window can hold at the sampler cadence (stride
#: grows once the ring decimates, widening the covered span further)
_TREND_TAIL = 128


class SeriesRecorder:
    """Registry-attached time-series sampler: bounded ring histories for
    matching counters/gauges, streaming span-duration percentiles, and
    the rate/trend derivation the heartbeat embeds.

    One instance per capture, owned by the flight recorder (whose
    sampler thread calls :meth:`sample` each tick and
    :meth:`observe_span` from its tracer listener). All public methods
    are thread-safe; the snapshot paths accept a ``timeout`` bounding
    the lock acquire for the signal-time postmortem flush, degrading to
    a best-effort unlocked read when the suspended main thread holds
    the lock (same convention as the tracer and registry).
    """

    #: hard cap on distinct (name, labels) series — one more bound on
    #: total memory: max_series x ring_budget x Ring.SAMPLE_NBYTES
    MAX_SERIES = 128
    #: hard cap on distinct span names tracked for percentiles (each is
    #: 3 five-marker P2 estimators: tiny, but still bounded)
    MAX_SPAN_NAMES = 64

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        prefixes: Tuple[str, ...] = DEFAULT_PREFIXES,
        ring_budget: int = 512,
        max_series: int = MAX_SERIES,
    ):
        from .metrics import REGISTRY

        self.registry = registry if registry is not None else REGISTRY
        self.prefixes = tuple(prefixes)
        self.ring_budget = int(ring_budget)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._rings: Dict[Tuple[str, tuple], dict] = {}
        self._span_q: Dict[str, SpanQuantiles] = {}
        self._dropped_series = 0
        # wall/monotonic anchor pair: rings store monotonic stamps
        # (arithmetic-safe), export converts via this anchor
        self._anchor_wall = time.time()
        self._anchor_mono = time.monotonic()

    # -- recording ------------------------------------------------------
    def wants(self, name: str) -> bool:
        return name.startswith(self.prefixes)

    def sample(self) -> int:
        """One sampling tick: snapshot every matching counter/gauge into
        its ring (plus the process RSS). Returns the number of series
        sampled. Driven by the flight recorder's sampler thread."""
        now = time.monotonic()
        rss = process_rss_bytes()
        if rss is not None:
            self.registry.gauge(names.PROC_RSS_BYTES).set(rss)
        sampled = 0
        for m in self.registry.metrics():
            if isinstance(m, Histogram) or not self.wants(m.name):
                continue
            key = _series_key(m.name, m.labels)
            with self._lock:
                entry = self._rings.get(key)
                if entry is None:
                    if len(self._rings) >= self.max_series:
                        self._dropped_series += 1
                        continue
                    entry = self._rings[key] = {
                        "ring": Ring(self.ring_budget),
                        "kind": m.kind,
                    }
                entry["ring"].offer(now, m.value)
            sampled += 1
        return sampled

    def observe_span(self, rec: dict) -> None:
        """Fold one completed span record's duration into that span
        name's streaming percentiles (a tracer-listener shape — the
        flight recorder calls this from its existing listener)."""
        if rec.get("type") != "span":
            return
        name = rec.get("name")
        with self._lock:
            sq = self._span_q.get(name)
            if sq is None:
                if len(self._span_q) >= self.MAX_SPAN_NAMES:
                    return
                sq = self._span_q[name] = SpanQuantiles()
            sq.observe(float(rec.get("wall_s", 0.0)))

    # -- derived views ---------------------------------------------------
    def _acquire(self, timeout: Optional[float]) -> bool:
        return self._lock.acquire(timeout=-1 if timeout is None else timeout)

    def nbytes(self) -> int:
        """Estimated retained ring bytes across every series — bounded
        by ``max_series * ring_budget * Ring.SAMPLE_NBYTES``."""
        with self._lock:
            return sum(e["ring"].nbytes() for e in self._rings.values())

    def trends(
        self, window_s: float = 120.0, timeout: Optional[float] = None
    ) -> Dict[str, dict]:
        """Per-series rate/trend over the trailing ``window_s``:
        ``{"name{label=v}": {"latest", "rate_per_s", "trend"}}``.

        ``rate_per_s`` is the window's endpoint slope (for counters: the
        event rate; for gauges: the drift). ``trend`` compares the
        window's first- and second-half means: "rising" / "falling" /
        "flat" (within 2% relative). The heartbeat's v3 ``trends``
        block is exactly this dict."""
        cutoff = time.monotonic() - window_s
        out: Dict[str, dict] = {}
        acquired = self._acquire(timeout)
        try:
            try:
                # tail slice, not the whole ring: this runs on every
                # heartbeat tick, and the window can only ever cover
                # the newest samples (stride >= 1 at the sampler's
                # cadence) — scanning a 512-deep history per series
                # per second is pure tick overhead
                items = [
                    (key, entry["kind"],
                     entry["ring"].samples[-_TREND_TAIL:])
                    for key, entry in self._rings.items()
                ]
            except RuntimeError:  # torn dict iteration (unlocked read)
                return {}
        finally:
            if acquired:
                self._lock.release()
        for (name, labels), kind, samples in items:
            recent = [(t, v) for t, v in samples if t >= cutoff]
            if not recent:
                continue
            latest = recent[-1][1]
            row = {"latest": round(latest, 6)}
            t0, v0 = recent[0]
            t1, v1 = recent[-1]
            if t1 > t0:
                row["rate_per_s"] = round((v1 - v0) / (t1 - t0), 6)
            if len(recent) >= 4:
                half = len(recent) // 2
                a = sum(v for _, v in recent[:half]) / half
                b = sum(v for _, v in recent[half:]) / (len(recent) - half)
                scale = max(abs(a), abs(b), 1e-12)
                if (b - a) / scale > 0.02:
                    row["trend"] = "rising"
                elif (a - b) / scale > 0.02:
                    row["trend"] = "falling"
                else:
                    row["trend"] = "flat"
            out[_flat_name(name, labels)] = row
        return out

    def span_quantiles(self, timeout: Optional[float] = None) -> Dict[str, dict]:
        """{span name: {count, min, max, p50, p95, p99}} snapshots."""
        acquired = self._acquire(timeout)
        try:
            try:
                return {k: v.summary() for k, v in self._span_q.items()}
            except RuntimeError:
                return {}
        finally:
            if acquired:
                self._lock.release()

    def _wall(self, t_mono: float) -> float:
        return self._anchor_wall + (t_mono - self._anchor_mono)

    def snapshot(
        self, recent: int = 60, timeout: Optional[float] = None
    ) -> dict:
        """Bounded recent-window view for the live ``series.json``
        artifact and the scrape endpoint: last ``recent`` samples per
        series (wall-clock stamped), plus the span percentiles."""
        acquired = self._acquire(timeout)
        try:
            try:
                series = [
                    {
                        "name": name,
                        "labels": dict(labels),
                        "kind": entry["kind"],
                        "stride": entry["ring"].stride,
                        "samples": [
                            [round(self._wall(t), 3), v]
                            for t, v in entry["ring"].samples[-recent:]
                        ],
                    }
                    for (name, labels), entry in self._rings.items()
                ]
            except RuntimeError:
                series = []
        finally:
            if acquired:
                self._lock.release()
        return {
            "schema": SERIES_SCHEMA_VERSION,
            "written_at": round(time.time(), 3),
            "series": series,
            "span_quantiles": self.span_quantiles(timeout=timeout),
            "dropped_series": self._dropped_series,
        }

    # -- persistence -----------------------------------------------------
    def write_jsonl(self, path: str, timeout: Optional[float] = None) -> str:
        """Persist the full decimated history as the ``series.jsonl``
        capture artifact (schema :data:`SERIES_SCHEMA`): a meta line,
        one ``series`` line per ring, one ``quantiles`` line per span
        name, and one per latency histogram in the registry (p50/p95/
        p99 interpolated from its buckets). Atomic (temp + replace):
        a reader never sees a torn file."""
        acquired = self._acquire(timeout)
        try:
            try:
                rows = [
                    {
                        "type": "series",
                        "name": name,
                        "labels": dict(labels),
                        "kind": entry["kind"],
                        "stride": entry["ring"].stride,
                        "samples": [
                            [round(self._wall(t), 3), v]
                            for t, v in entry["ring"].samples
                        ],
                    }
                    for (name, labels), entry in self._rings.items()
                ]
            except RuntimeError:
                rows = []
        finally:
            if acquired:
                self._lock.release()
        for name, summary in sorted(self.span_quantiles(
                timeout=timeout).items()):
            if summary["count"] and summary["p50"] is not None:
                rows.append({
                    "type": "quantiles", "name": name, "kind": "span",
                    "count": summary["count"],
                    "min": summary["min"], "max": summary["max"],
                    "p50": summary["p50"], "p95": summary["p95"],
                    "p99": summary["p99"],
                })
        for m in self.registry.metrics(timeout=timeout):
            if not isinstance(m, Histogram) or not m.count:
                continue
            qs = quantiles_from_histogram(m.buckets, list(m._counts))
            if qs:
                rows.append({
                    "type": "quantiles",
                    "name": _flat_name(m.name, m.labels),
                    "kind": "histogram", "count": m.count,
                    **qs,
                })
        # mkstemp, not path+".tmp": the sampler's stop() flush and the
        # signal path's postmortem flush may overlap, and a shared temp
        # name would let them truncate/interleave each other's write
        fd, tmp = tempfile.mkstemp(suffix=".jsonl",
                                   dir=os.path.dirname(path) or ".")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(json.dumps({
                    "type": "series_meta", "schema": SERIES_SCHEMA_VERSION,
                    "t0": self._anchor_wall, "pid": os.getpid(),
                }) + "\n")
                for row in rows:
                    fh.write(json.dumps(row) + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path


def _flat_name(name: str, labels) -> str:
    """``name{k=v,...}`` — the same flat spelling telemetry_summary and
    the report use for labeled metric instances."""
    labels = tuple(labels)
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels)) + "}"


def load_series(path: str) -> dict:
    """Read a ``series.jsonl`` artifact back:
    ``{"meta": ..., "series": [...], "quantiles": [...]}``. Tolerates a
    truncated final line (crashed run) like the events loader."""
    out = {"meta": None, "series": [], "quantiles": []}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            kind = rec.get("type")
            if kind == "series_meta":
                out["meta"] = rec
            elif kind == "series":
                out["series"].append(rec)
            elif kind == "quantiles":
                out["quantiles"].append(rec)
    return out
