"""Declarative SLOs: error budgets and burn rates over the telemetry.

Counterpart of ``pta_replicator_tpu/obs/slo.py``: the same objective
grammar, :class:`SLOSpecError` texts, window defaults, 5 s buckets and
``slo.json`` document, so either package's ``report`` and ``/readyz`` read
either package's verdict.

An objective (a latency threshold or an availability target, promised at a
fraction over a rolling window) is scored continuously from what the
capture already records, completed spans for latency objectives and the
registry's counters for availability objectives, into three numbers:

* **SLI**: the good-event fraction over the slow window;
* **error budget remaining**: 1.0 untouched, 0.0 spent, negative blown;
* **burn rate**: the bad fraction over the allowance, over a fast and a
  slow window (1.0 spends the budget at exactly the sustainable rate; a
  fast burn at or above 14.4 is a breach).

Grammar (``;``-separated, :func:`parse_objectives`)::

    name=SPAN:pXX_ms<=T@TARGET%                  latency objective
    name=err(BAD_METRIC/TOTAL_METRIC)@TARGET%    availability objective

for example ``serve=likelihood_batch:p99_ms<=60@99.9%`` ("99.9% of
batches finish within 60 ms"; ``pXX`` is a label, the math is per event)
and ``admit=err(likelihood.rejected/likelihood.requests)@99.5%``. For an
availability objective ``BAD`` is a sub-stream of ``TOTAL``; window deltas
of ``TOTAL - BAD``, clamped at zero, are the good events.

The flight recorder owns one :class:`SLOEngine` a capture (objectives from
``start_capture(slo=...)`` or ``PTA_SLO``): its tracer listener feeds
:meth:`SLOEngine.observe_span`, its sampler ticks :meth:`SLOEngine.sample`,
the heartbeat embeds :meth:`SLOEngine.heartbeat_block`, and ``slo.json``
holds :meth:`SLOEngine.status`, which ``watch --serve`` serves at ``/slo``
and folds into ``/readyz`` (503 on a fast-burn breach). Each breach
episode emits one ``slo.breach`` event and bumps ``slo.breaches``.
Standard library only.
"""
from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import names
from .metrics import REGISTRY

#: rolling-window defaults: the slow window is the budget window, the
#: fast window the page trigger. Deliberately short against the classic
#: 30-day SLO period — this engine scores a RUN, not a quarter.
DEFAULT_WINDOW_S = 300.0
DEFAULT_FAST_WINDOW_S = 60.0
#: fast-burn breach threshold (Google SRE's 14.4x page point)
DEFAULT_FAST_BURN = 14.4
#: good/bad counts aggregate into buckets of this width; the window
#: deques hold at most window_s / bucket_s entries — bounded by
#: construction
BUCKET_S = 5.0

_LATENCY_RE = re.compile(
    r"^(?P<span>[\w.]+):(?P<pct>p\d{2})_ms<=(?P<ms>[0-9.]+)$"
)
#: bare dotted metric names only: labeled instances
#: (``faults.injected{site=...}``) are rejected at parse time —
#: _metric_total sums a counter FAMILY by bare name, so a label suffix
#: would parse fine and then silently score nothing, the exact failure
#: SLOSpecError exists to refuse
_AVAIL_RE = re.compile(
    r"^err\((?P<bad>[\w.]+)/(?P<total>[\w.]+)\)$"
)


class SLOSpecError(ValueError):
    """A malformed objective spec — named field, refused at parse time
    (a typo'd objective must not silently score nothing)."""


@dataclass(frozen=True)
class Objective:
    """One declarative objective (see the module grammar)."""

    name: str
    kind: str                      # "latency" | "availability"
    target: float                  # promised good fraction, e.g. 0.999
    span: Optional[str] = None     # latency: the span name scored
    threshold_s: Optional[float] = None
    percentile: str = "p99"        # operator-facing label from the spec
    bad_metric: Optional[str] = None
    total_metric: Optional[str] = None
    window_s: float = DEFAULT_WINDOW_S
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    fast_burn: float = DEFAULT_FAST_BURN

    def spec_str(self) -> str:
        pct = f"{100 * self.target:g}"
        if self.kind == "latency":
            return (
                f"{self.name}={self.span}:{self.percentile}_ms<="
                f"{1e3 * self.threshold_s:g}@{pct}%"
            )
        return f"{self.name}=err({self.bad_metric}/{self.total_metric})@{pct}%"


def parse_objective(text: str) -> Objective:
    raw = text.strip()
    if "=" not in raw:
        raise SLOSpecError(
            f"bad SLO spec {raw!r}: expected name=sli@target%"
        )
    name, _, rest = raw.partition("=")
    name = name.strip()
    if not name:
        raise SLOSpecError(f"bad SLO spec {raw!r}: empty objective name")
    if "@" not in rest:
        raise SLOSpecError(
            f"bad SLO spec {raw!r}: missing @target% (e.g. @99.9%)"
        )
    sli, _, target_txt = rest.rpartition("@")
    target_txt = target_txt.strip()
    if not target_txt.endswith("%"):
        raise SLOSpecError(
            f"bad SLO spec {raw!r}: target must end with % "
            f"(got {target_txt!r})"
        )
    try:
        target = float(target_txt[:-1]) / 100.0
    except ValueError:
        raise SLOSpecError(
            f"bad SLO spec {raw!r}: unparseable target {target_txt!r}"
        ) from None
    if not 0.0 < target < 1.0:
        raise SLOSpecError(
            f"bad SLO spec {raw!r}: target must be in (0%, 100%) "
            "exclusive — a 100% target has no error budget to burn"
        )
    sli = sli.strip()
    m = _LATENCY_RE.match(sli)
    if m:
        return Objective(
            name=name, kind="latency", target=target,
            span=m.group("span"),
            threshold_s=float(m.group("ms")) / 1e3,
            percentile=m.group("pct"),
        )
    m = _AVAIL_RE.match(sli)
    if m:
        return Objective(
            name=name, kind="availability", target=target,
            bad_metric=m.group("bad"), total_metric=m.group("total"),
        )
    if "{" in sli:
        raise SLOSpecError(
            f"bad SLO spec {raw!r}: labeled metric instances are not "
            "supported — availability objectives sum a counter FAMILY "
            "by bare name (drop the {label=...} suffix)"
        )
    raise SLOSpecError(
        f"bad SLO spec {raw!r}: SLI must be SPAN:pXX_ms<=T or "
        "err(BAD_METRIC/TOTAL_METRIC)"
    )


def parse_objectives(text: str) -> List[Objective]:
    """Parse a ``;``-separated objective list (the ``PTA_SLO`` shape)."""
    out = []
    for part in text.split(";"):
        part = part.strip()
        if part:
            out.append(parse_objective(part))
    seen = set()
    for obj in out:
        if obj.name in seen:
            raise SLOSpecError(
                f"duplicate objective name {obj.name!r} — each "
                "objective needs its own gauge label"
            )
        seen.add(obj.name)
    return out


def from_env(env: str = "PTA_SLO") -> List[Objective]:
    """Objectives from the environment (empty list when unset) — the
    zero-code way to put an SLO on any CLI run."""
    text = os.environ.get(env)
    return parse_objectives(text) if text else []


@dataclass
class _Window:
    """Bucketed good/bad counts over a bounded horizon. Appends land in
    the newest bucket; buckets older than the horizon prune on every
    add/read, so the deque is bounded by horizon/BUCKET_S entries."""

    horizon_s: float
    buckets: List[list] = field(default_factory=list)  # [t0, good, bad]

    def add(self, now: float, good: int, bad: int) -> None:
        t0 = now - (now % BUCKET_S)
        if self.buckets and self.buckets[-1][0] == t0:
            self.buckets[-1][1] += good
            self.buckets[-1][2] += bad
        else:
            self.buckets.append([t0, good, bad])
        self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.horizon_s - BUCKET_S
        while self.buckets and self.buckets[0][0] < cutoff:
            self.buckets.pop(0)

    def counts(self, now: float, window_s: float) -> Tuple[int, int]:
        """Window totals. Deliberately READ-ONLY (pruning happens in
        :meth:`add`, which bounds the deque on every write): the
        signal-time postmortem path reads windows UNLOCKED when the
        lock acquire times out, and a mutating read racing the listener
        thread's add() could tear the shared state. The list() snapshot
        tolerates a concurrent append/pop."""
        cutoff = now - window_s
        good = bad = 0
        for t0, g, b in list(self.buckets):
            if t0 + BUCKET_S >= cutoff:
                good += g
                bad += b
        return good, bad


class SLOEngine:
    """Evaluates a set of objectives continuously; owned by the flight
    recorder (one per capture). Thread-safe: the tracer listener feeds
    :meth:`observe_span` from recording threads while the sampler ticks
    :meth:`sample`. With no objectives every entry point is a cheap
    no-op, so an un-SLO'd capture pays nothing."""

    def __init__(self, objectives: Union[str, Sequence[Objective], None]
                 = None, registry=None):
        if objectives is None:
            objectives = []
        if isinstance(objectives, str):
            objectives = parse_objectives(objectives)
        self.objectives: Tuple[Objective, ...] = tuple(
            parse_objective(o) if isinstance(o, str) else o
            for o in objectives
        )
        # duplicate names are refused on EVERY construction path, not
        # just the string grammar: the windows/breach state below key
        # by name, so two same-named objectives would silently score
        # into one merged stream
        seen = set()
        for o in self.objectives:
            if o.name in seen:
                raise SLOSpecError(
                    f"duplicate objective name {o.name!r} — each "
                    "objective needs its own window and gauge label"
                )
            seen.add(o.name)
        self.registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        horizon = max(
            [max(o.window_s, o.fast_window_s) for o in self.objectives],
            default=DEFAULT_WINDOW_S,
        )
        self._windows: Dict[str, _Window] = {
            o.name: _Window(horizon) for o in self.objectives
        }
        # latency objectives indexed by span name for the listener path
        self._by_span: Dict[str, List[Objective]] = {}
        for o in self.objectives:
            if o.kind == "latency":
                self._by_span.setdefault(o.span, []).append(o)
        # availability objectives difference cumulative counters
        self._last_counts: Dict[str, Tuple[float, float]] = {}
        self._breached: Dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        self._breach_count: Dict[str, int] = {
            o.name: 0 for o in self.objectives
        }

    @property
    def armed(self) -> bool:
        return bool(self.objectives)

    # -- feeds ----------------------------------------------------------
    def observe_span(self, rec: dict) -> None:
        """Tracer-listener shape: score one completed span against the
        latency objectives watching its name."""
        if not self._by_span or rec.get("type") != "span":
            return
        objs = self._by_span.get(rec.get("name"))
        if not objs:
            return
        wall = float(rec.get("wall_s", 0.0))
        now = time.monotonic()
        with self._lock:
            for o in objs:
                good = wall <= o.threshold_s
                self._windows[o.name].add(
                    now, 1 if good else 0, 0 if good else 1
                )

    def _metric_total(self, name: str) -> float:
        """Sum over every labeled instance of a counter family (a
        labeled counter like faults.injected{site=,kind=} scores as one
        stream)."""
        total = 0.0
        for m in self.registry.metrics():
            if getattr(m, "name", None) == name and hasattr(m, "value"):
                total += m.value
        return total

    def sample(self) -> None:
        """One sampler tick: fold availability counter deltas into
        their windows, refresh the per-objective gauges, and fire
        breach transitions (one ``slo.breach`` event per episode)."""
        if not self.armed:
            return
        now = time.monotonic()
        with self._lock:
            for o in self.objectives:
                if o.kind != "availability":
                    continue
                bad = self._metric_total(o.bad_metric)
                total = self._metric_total(o.total_metric)
                last_bad, last_total = self._last_counts.get(
                    o.name, (bad, total)
                )
                d_bad = max(0.0, bad - last_bad)
                d_total = max(0.0, total - last_total)
                self._last_counts[o.name] = (bad, total)
                if d_total or d_bad:
                    # BAD ⊆ TOTAL contract: good = total - bad, clamped
                    # so a mis-paired (disjoint) spec degrades to an
                    # all-bad window instead of a negative SLI
                    self._windows[o.name].add(
                        now, int(round(max(0.0, d_total - d_bad))),
                        int(round(d_bad)),
                    )
        status = self.status()
        from .trace import TRACER

        for name, st in status["objectives"].items():
            self.registry.gauge(
                names.SLO_ERROR_BUDGET_REMAINING, objective=name
            ).set(st["error_budget_remaining"])
            self.registry.gauge(
                names.SLO_BURN_RATE_FAST, objective=name
            ).set(st["burn_rate_fast"])
            self.registry.gauge(
                names.SLO_BURN_RATE_SLOW, objective=name
            ).set(st["burn_rate_slow"])
            with self._lock:
                was = self._breached[name]
                self._breached[name] = st["breach"]
                fire = st["breach"] and not was
                if fire:
                    self._breach_count[name] += 1
            if fire:
                self.registry.counter(
                    names.SLO_BREACHES, objective=name
                ).inc()
                TRACER.event(
                    names.EVENT_SLO_BREACH, objective=name,
                    burn_rate_fast=st["burn_rate_fast"],
                    budget_remaining=st["error_budget_remaining"],
                )

    # -- verdicts -------------------------------------------------------
    def _objective_status(self, o: Objective, now: float) -> dict:
        win = self._windows[o.name]
        good_s, bad_s = win.counts(now, o.window_s)
        good_f, bad_f = win.counts(now, o.fast_window_s)
        allowed = 1.0 - o.target

        def burn(good, bad):
            total = good + bad
            if not total:
                return 0.0
            return (bad / total) / allowed

        burn_slow = burn(good_s, bad_s)
        burn_fast = burn(good_f, bad_f)
        total_s = good_s + bad_s
        return {
            "spec": o.spec_str(),
            "kind": o.kind,
            "target": o.target,
            "window_s": o.window_s,
            "fast_window_s": o.fast_window_s,
            "events": total_s,
            "bad": bad_s,
            "sli": (good_s / total_s) if total_s else 1.0,
            # remaining = 1 - (budget consumed over the slow window):
            # bad_frac / allowed IS the consumed multiple of the
            # window's allowance, so this goes negative when blown
            "error_budget_remaining": round(1.0 - burn_slow, 6),
            "burn_rate_fast": round(burn_fast, 6),
            "burn_rate_slow": round(burn_slow, 6),
            "fast_burn_threshold": o.fast_burn,
            "breach": burn_fast >= o.fast_burn,
            "breaches": self._breach_count[o.name],
        }

    def status(self, timeout: Optional[float] = None) -> dict:
        """The full verdict document (the ``slo.json`` artifact shape).
        ``timeout`` bounds the lock acquire for the signal-time
        postmortem path, degrading to a best-effort snapshot."""
        now = time.monotonic()
        acquired = self._lock.acquire(
            timeout=-1 if timeout is None else timeout
        )
        try:
            try:
                objectives = {
                    o.name: self._objective_status(o, now)
                    for o in self.objectives
                }
            except (RuntimeError, IndexError):
                # torn state on an unlocked (emergency) read
                objectives = {}
        finally:
            if acquired:
                self._lock.release()
        return {
            "written_at": round(time.time(), 3),
            "objectives": objectives,
            "breached": sorted(
                n for n, st in objectives.items() if st["breach"]
            ),
        }

    def heartbeat_block(self, timeout: Optional[float] = None) -> dict:
        """The condensed per-tick block the heartbeat embeds."""
        status = self.status(timeout=timeout)
        return {
            "objectives": {
                name: {
                    "budget_remaining": st["error_budget_remaining"],
                    "burn_fast": st["burn_rate_fast"],
                    "burn_slow": st["burn_rate_slow"],
                    "breach": st["breach"],
                }
                for name, st in status["objectives"].items()
            },
            "breached": status["breached"],
        }


def any_breach(slo_doc: Optional[dict]) -> List[str]:
    """Breached objective names from an ``slo.json``-shaped document
    (tolerant of None/malformed — the /readyz reader's helper)."""
    if not isinstance(slo_doc, dict):
        return []
    breached = slo_doc.get("breached")
    if isinstance(breached, list):
        return [str(b) for b in breached]
    objectives = slo_doc.get("objectives")
    if isinstance(objectives, dict):
        return sorted(
            str(n) for n, st in objectives.items()
            if isinstance(st, dict) and st.get("breach")
        )
    return []
