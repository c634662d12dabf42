"""Metrics registry: counters, gauges and histograms, exported as JSON and
in the Prometheus text format.

Counterpart of ``pta_replicator_tpu/obs/metrics.py``, with the same
classes, exporters and output, so a ``metrics.json`` of either package
reads the same. Thread-safe and free of torch. One process-global
:data:`REGISTRY` backs the module-level ``counter``/``gauge``/``histogram``
helpers of the library; tests may build private registries.

Names are dotted lower case (``io.tim.toas``), registered in :mod:`.names`;
the Prometheus exporter rewrites characters outside ``[a-zA-Z0-9_:]`` to
``_``. Labels are ``str -> str`` pairs passed as keyword arguments.
"""
from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, Optional, Tuple

#: default histogram bucket upper bounds [s] — log-spaced from 100 us to
#: ~17 min, wide enough for both a par parse and a whole sweep
DEFAULT_BUCKETS = tuple(1e-4 * (10 ** (k / 2.0)) for k in range(15))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"value": self._value}


class Gauge:
    """Last-set value (may go up or down)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"value": self._value}


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative-bucket semantics)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...] = (),
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self, timeout: float = None) -> dict:
        """``timeout`` bounds the lock acquire for the signal-time
        postmortem flush: the interrupted main-thread frame may be
        suspended inside :meth:`observe`'s critical section, in which
        case the lock can never be released while the flush is waited
        on. The holder being parked makes an unlocked read quiescent,
        so on acquire timeout we degrade to a possibly-torn snapshot
        (sum updated, count not) instead of deadlocking."""
        acquired = self._lock.acquire(
            timeout=-1 if timeout is None else timeout
        )
        try:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "mean": (self._sum / self._count) if self._count else None,
                "buckets": {
                    ("+Inf" if i == len(self.buckets) else repr(self.buckets[i])): c
                    for i, c in enumerate(self._counts)
                    if c
                },
            }
        finally:
            if acquired:
                self._lock.release()


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    name = _PROM_NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _prom_labels(labels, extra: str = "") -> str:
    parts = [
        f'{_PROM_LABEL_RE.sub("_", k)}="{v}"' for k, v in labels
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Name+labels -> metric instance store with exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], object] = {}

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[1], **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, buckets: Optional[Tuple[float, ...]] = None, **labels
    ) -> Histogram:
        kwargs = {} if buckets is None else {"buckets": tuple(buckets)}
        return self._get(Histogram, name, labels, **kwargs)

    def metrics(self, timeout: float = None):
        """``timeout`` bounds the lock acquire for the signal-time
        postmortem flush (the interrupted main-thread frame may be
        suspended inside :meth:`_get`'s critical section — sweep-loop
        gauge lookups run every chunk). The holder being parked makes
        an unlocked read quiescent — every other writer is blocked on
        the same lock — so on acquire timeout we degrade to a
        best-effort copy instead of deadlocking."""
        acquired = self._lock.acquire(
            timeout=-1 if timeout is None else timeout
        )
        try:
            if acquired:
                return list(self._metrics.values())
            try:  # unlocked emergency snapshot
                return list(self._metrics.values())
            except RuntimeError:  # torn dict iteration
                return []
        finally:
            if acquired:
                self._lock.release()

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exporters ------------------------------------------------------
    def to_json(self, timeout: float = None) -> dict:
        """{"name": [{"labels": {...}, "kind": ..., **snapshot}, ...]}

        ``timeout`` bounds every lock acquire (registry and per-metric)
        for the signal-time postmortem flush; see :meth:`metrics`."""
        out: Dict[str, list] = {}
        for m in self.metrics(timeout=timeout):
            snap = (m.snapshot(timeout=timeout)
                    if isinstance(m, Histogram) else m.snapshot())
            out.setdefault(m.name, []).append({
                "kind": m.kind,
                "labels": dict(m.labels),
                **snap,
            })
        return out

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus exposition text format (one # TYPE line per family)."""
        lines = []
        typed = set()
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            pname = _prom_name(m.name)
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                snap_counts = m._counts
                for i, ub in enumerate(list(m.buckets) + [math.inf]):
                    cum += snap_counts[i]
                    le = "+Inf" if math.isinf(ub) else repr(ub)
                    le_label = 'le="%s"' % le
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(m.labels, le_label)} {cum}"
                    )
                lines.append(f"{pname}_sum{_prom_labels(m.labels)} {m.sum}")
                lines.append(f"{pname}_count{_prom_labels(m.labels)} {m.count}")
            else:
                lines.append(f"{pname}{_prom_labels(m.labels)} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")


#: the process-global registry used by all library instrumentation
REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
