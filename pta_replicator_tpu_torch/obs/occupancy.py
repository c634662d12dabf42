"""Stage occupancy: duty cycle, overlap efficiency and a bottleneck
verdict for the staged executors.

Counterpart of ``pta_replicator_tpu/obs/occupancy.py``, with its names,
constants and result keys. The stage graph (``parallel/stages.py``: the
pipelined sweep's ``dispatch -> drain -> io_write``, the CW prefetch's
``cw_stream_stage``, the fused sweep's ``static_build``) emits a span per
stage operation; this module turns them into numbers:

* **duty cycle**: the share of the observation window a stage was busy
  (the union of its span intervals over the window);
* **overlap efficiency**: ``(serial - wall) / (serial - longest)``, where
  ``serial`` is the sum of the stages' busy seconds (the synchronous
  counterfactual) and ``longest`` the busiest stage's (ideal pipelining);
  1.0 is perfect overlap, 0.0 fully serial;
* **bottleneck verdict**: one line naming the saturated stage and the
  resource it binds on ("io_write 92% busy -> disk-bound").

Busy seconds are host seconds. On the card ``dispatch`` returns once the
chunk's kernels are queued, and ``drain`` is busy while it waits on the
readback's CUDA event, so a sweep whose card is the bottleneck reads
drain-bound ("readback"), as the JAX package's asynchronous dispatch does.

:func:`analyze` reads span records after the fact (the report);
:class:`StageOccupancy` keeps a rolling window live for the flight
recorder's heartbeat; :func:`overlap_stats` is the shared kernel, which
the stage graph also stamps into its run's stats.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import names

#: stage span name -> the resource that stage binds on when saturated.
#: The verdict string is "<stage> NN% busy -> <resource>-bound".
STAGES: Dict[str, str] = {
    names.SPAN_DISPATCH: "host-dispatch",
    names.SPAN_DRAIN: "readback",
    names.SPAN_IO_WRITE: "disk",
    names.SPAN_SWEEP_CHUNK: "compute",
    names.SPAN_READBACK_FENCE: "readback",
    names.SPAN_CW_STREAM_STAGE: "host-precompute",
    names.SPAN_STATIC_BUILD: "host-precompute",
    names.SPAN_SHARD_WRITE: "disk",
}

#: dataflow order of the stage tracks in chrome-trace exports: the
#: pipelined sweep's dispatch -> drain -> io_write first, the prefetch
#: staging after, then the synchronous loop's stages.
#: ``Tracer.chrome_trace`` stamps ``thread_sort_index`` from this tuple.
STAGE_SORT_ORDER: Tuple[str, ...] = (
    names.SPAN_STATIC_BUILD,
    names.SPAN_DISPATCH,
    names.SPAN_DRAIN,
    names.SPAN_IO_WRITE,
    names.SPAN_SHARD_WRITE,
    names.SPAN_CW_STREAM_STAGE,
    names.SPAN_SWEEP_CHUNK,
    names.SPAN_READBACK_FENCE,
)

#: nested stage -> the enclosing stage whose span contains it. A nested
#: stage's busy time is already inside its parent's, so it must not be
#: double-counted into the serial counterfactual or win the bottleneck
#: verdict over the parent — it stays in the per-stage duty table as
#: the parent's breakdown (the synchronous loop's readback share).
NESTED_STAGES: Dict[str, str] = {
    names.SPAN_READBACK_FENCE: names.SPAN_SWEEP_CHUNK,
    # per-shard writer spans run INSIDE the chunk's io_write span (the
    # parallel archive writer is io_write's internal fan-out): their
    # union is io_write's disk breakdown, never extra serial time
    names.SPAN_SHARD_WRITE: names.SPAN_IO_WRITE,
}

#: span names that bound a whole pipelined phase — when present, the
#: longest one defines the observation window for :func:`analyze`.
#: multichip_sweep encloses sweep_pipeline (it adds the sharded static
#: precompute and consolidation), so a mesh sweep's attribution window
#: covers the H2D staging stages too.
PHASE_SPANS = (
    names.SPAN_MULTICHIP_SWEEP,
    names.SPAN_SWEEP_PIPELINE,
    names.SPAN_CW_STREAM_RESPONSE,
)

#: duty above which a stage is called THE bottleneck, and below which
#: (for every stage) the executor is called idle
BUSY_VERDICT = 0.75
IDLE_VERDICT = 0.20


def merge_intervals(
    intervals: Iterable[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Union of (t0, t1) intervals as a sorted, disjoint list."""
    merged: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total covered seconds of the union of ``intervals`` (overlapping
    calls of the same stage are not double-counted)."""
    return sum(t1 - t0 for t0, t1 in merge_intervals(intervals))


def stage_intervals(
    events: Iterable[dict], stages: Optional[Sequence[str]] = None
) -> Dict[str, List[Tuple[float, float]]]:
    """Per-stage (t0, t1) busy intervals from span records (events.jsonl
    shape). ``stages`` defaults to the :data:`STAGES` table; unknown
    span names are ignored."""
    wanted = set(stages if stages is not None else STAGES)
    out: Dict[str, List[Tuple[float, float]]] = {}
    for rec in events:
        if rec.get("type") != "span":
            continue
        name = rec.get("name")
        if name not in wanted:
            continue
        t0 = float(rec.get("t0", 0.0))
        out.setdefault(name, []).append((t0, t0 + float(rec.get("wall_s", 0.0))))
    return out


def _drop_nested(values: Dict[str, float]) -> Dict[str, float]:
    """Drop stages whose enclosing parent stage is also present — their
    time is contained in the parent's and must not be counted twice."""
    return {
        k: v for k, v in values.items()
        if NESTED_STAGES.get(k) not in values
    }


def verdict(duties: Dict[str, float]) -> Optional[str]:
    """One-line bottleneck diagnosis from per-stage duty cycles, or None
    when there is nothing to diagnose. A nested stage never outranks
    the parent that contains it."""
    duties = _drop_nested(duties)
    if not duties:
        return None
    stage = max(duties, key=lambda s: duties[s])
    duty = duties[stage]
    resource = STAGES.get(stage, stage)
    if duty >= BUSY_VERDICT:
        return f"{stage} {duty:.0%} busy -> {resource}-bound"
    if max(duties.values()) < IDLE_VERDICT:
        return "all stages mostly idle"
    return f"no single bottleneck (busiest: {stage} {duty:.0%})"


def overlap_stats(busy_s: Dict[str, float], wall_s: float) -> dict:
    """Overlap metrics from per-stage busy seconds over a ``wall_s``
    window — the shared kernel behind :func:`analyze`, the pipelined
    executor's stats block, and the tests' hand-computed fixtures.

    ``serial_s`` is the synchronous counterfactual (stages run one after
    the other); ``overlap_efficiency`` is where the measured wall sits
    between fully serial (0.0) and ideal pipelining, wall == longest
    stage (1.0); ``wall_reduction_vs_serial_pct`` is the wall time the
    overlap actually saved relative to that serial counterfactual.
    Stages nested inside another present stage (:data:`NESTED_STAGES`)
    are excluded — their time is already inside the parent's, and
    counting it twice would fabricate overlap for a fully serial run.
    """
    active = _drop_nested({k: v for k, v in busy_s.items() if v > 0.0})
    if not active or wall_s <= 0.0:
        return {}
    serial = sum(active.values())
    longest = max(active.values())
    duties = {k: min(1.0, v / wall_s) for k, v in active.items()}
    out = {
        "wall_s": round(wall_s, 6),
        "serial_s": round(serial, 6),
        "longest_stage_s": round(longest, 6),
        "wall_reduction_vs_serial_pct": round(
            100.0 * (1.0 - wall_s / serial), 1
        ),
        "duty": {k: round(v, 3) for k, v in duties.items()},
        "bottleneck": verdict(duties),
    }
    if serial > longest:
        eff = (serial - wall_s) / (serial - longest)
        out["overlap_efficiency"] = round(min(1.0, max(0.0, eff)), 3)
    return out


def analyze(
    events: Iterable[dict],
    stages: Optional[Sequence[str]] = None,
    window: Optional[Tuple[float, float]] = None,
) -> Optional[dict]:
    """Post-hoc occupancy report over span records.

    Returns None when no stage spans are present (a capture from before
    this module, or a run that never touched a staged executor) — the
    report renderer degrades by omitting its utilization section.

    ``window`` defaults to the longest :data:`PHASE_SPANS` span when one
    was recorded (the pipelined phase itself), else to the extent of the
    stage intervals.
    """
    events = list(events)
    per_stage = stage_intervals(events, stages)
    if not per_stage:
        return None
    if window is None:
        window = _phase_window(events)
    if window is None:
        lo = min(t0 for iv in per_stage.values() for t0, _ in iv)
        hi = max(t1 for iv in per_stage.values() for _, t1 in iv)
        window = (lo, hi)
    wall = max(1e-9, window[1] - window[0])

    # clip every interval to the window and drop stages that never ran
    # inside it: one capture can hold several phases (bench.py's sweep
    # A/B runs the pipelined arm AND the synchronous arm), and a stage
    # busy outside the analyzed phase must not read as busy within it
    per_stage = {
        name: clipped
        for name, iv in per_stage.items()
        if (clipped := _clip(iv, window[0], window[1]))
    }
    if not per_stage:
        return None
    busy = {name: busy_seconds(iv) for name, iv in per_stage.items()}
    out = overlap_stats(busy, wall)
    # the stages table below carries per-stage duty; overlap_stats' flat
    # duty dict would be the same numbers twice in every embedded
    # artifact (and could silently desynchronize from the table)
    out.pop("duty", None)
    out["stages"] = {
        name: {
            "calls": len(iv),
            "busy_s": round(busy[name], 6),
            "duty": round(min(1.0, busy[name] / wall), 3),
        }
        for name, iv in sorted(per_stage.items())
    }
    return out


def _clip(
    intervals: Iterable[Tuple[float, float]], lo: float, hi: float
) -> List[Tuple[float, float]]:
    """Intervals intersected with [lo, hi]; empty intersections drop."""
    out = []
    for t0, t1 in intervals:
        t0c, t1c = max(t0, lo), min(t1, hi)
        if t1c > t0c:
            out.append((t0c, t1c))
    return out


def _phase_window(events: Iterable[dict]) -> Optional[Tuple[float, float]]:
    best = None
    for rec in events:
        if rec.get("type") != "span" or rec.get("name") not in PHASE_SPANS:
            continue
        t0 = float(rec.get("t0", 0.0))
        t1 = t0 + float(rec.get("wall_s", 0.0))
        if best is None or t1 - t0 > best[1] - best[0]:
            best = (t0, t1)
    return best


class StageOccupancy:
    """Live per-stage duty over a rolling window, fed from completed
    span records (a tracer-listener shape: the flight recorder calls
    :meth:`observe` from its existing listener and :meth:`snapshot`
    from the heartbeat sampler).

    Only completed spans count — a drain wedged for minutes shows up as
    *low* duty here but as an open span (and eventually a stall warning)
    in the same heartbeat, which together read correctly as "wedged",
    not "idle". Timing uses the monotonic clock of ``observe`` arrival,
    so a wall-clock step cannot tear the window.
    """

    def __init__(
        self,
        stages: Optional[Dict[str, str]] = None,
        window_s: float = 120.0,
    ):
        self.stages = dict(stages if stages is not None else STAGES)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._done: Dict[str, collections.deque] = {
            # window-pruned: observe() drops samples older than window_s
            name: collections.deque() for name in self.stages
        }

    def observe(self, rec: dict) -> None:
        if rec.get("type") != "span":
            return
        dq = self._done.get(rec.get("name"))
        if dq is None:
            return
        now = time.monotonic()
        cutoff = now - self.window_s
        with self._lock:
            dq.append((now, float(rec.get("wall_s", 0.0))))
            while dq and dq[0][0] < cutoff:
                dq.popleft()

    def snapshot(self, timeout: float = None) -> dict:
        """``{"stages": {name: duty}, "bottleneck": str|None}`` over the
        trailing window (clamped to the recorder's own lifetime, so the
        first seconds of a run don't read as near-zero duty).

        ``timeout`` bounds the lock acquire for the signal-time
        postmortem flush: the interrupted main-thread frame may be
        suspended inside :meth:`observe`'s critical section (the
        pipeline dispatcher records busy intervals on the calling
        thread), so on acquire timeout we degrade to a best-effort
        unlocked read — the parked holder makes it quiescent."""
        now = time.monotonic()
        horizon = max(1e-9, min(self.window_s, now - self._t0))
        cutoff = now - horizon
        duties: Dict[str, float] = {}
        acquired = self._lock.acquire(
            timeout=-1 if timeout is None else timeout
        )
        try:
            for name, dq in list(self._done.items()):
                try:
                    records = list(dq)
                except RuntimeError:  # torn deque iteration (unlocked)
                    continue
                # union, not sum: concurrent same-stage spans (one per
                # device from prefetch_to_mesh's stagers) overlap, and
                # summing them would inflate duty up to N_devices x —
                # same interval math as the post-hoc analyze() path
                ivs = [
                    (max(cutoff, end - dur), end)
                    for end, dur in records
                    if end >= cutoff
                ]
                busy = busy_seconds(ivs)
                if busy > 0.0:
                    duties[name] = min(1.0, busy / horizon)
        except RuntimeError:  # torn dict iteration (unlocked)
            duties = {}
        finally:
            if acquired:
                self._lock.release()
        return {
            "stages": {k: round(v, 3) for k, v in sorted(duties.items())},
            "bottleneck": verdict(duties),
        }
