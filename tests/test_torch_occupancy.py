"""Stage occupancy on the port (``obs/occupancy.py``) against the JAX
package's module on the CPU: the same span sequences (built from a seeded
numpy generator) give the same ``analyze``, ``overlap_stats``, ``verdict``
and live ``StageOccupancy`` snapshot, key for key, floats within 1e-12;
the stage graph's stats carry the occupancy block and the prefetch stage
mirrors its busy seconds to ``occupancy.busy_s``."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.obs import occupancy as jocc
from pta_replicator_tpu_torch import obs
from pta_replicator_tpu_torch.obs import occupancy as tocc
from pta_replicator_tpu_torch.parallel.pipeline import run_pipelined
from pta_replicator_tpu_torch.parallel.prefetch import prefetch_to_device
from pta_replicator_tpu_torch.parallel.stages import Stage, StageGraph

TOL = 1e-12
SEEDS = range(6)


class FakeClock:
    """A settable stand-in for the ``time`` module of the modules under test."""

    def __init__(self, t=5000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


def assert_same(got, want, where="result"):
    """Equal structure, equal keys, equal non-floats; floats within TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=0, abs_tol=TOL), (where, got, want)
    else:
        assert got == want, (where, got, want)


def span_sequence(seed, phase=True, extra_names=("likelihood_batch", "freeze")):
    """Span records of a pipelined phase: every stage of the table (and a
    few other names) busy over random intervals, some overlapping, some
    outside the phase window."""
    rng = np.random.default_rng(seed)
    names = list(jocc.STAGES) + list(extra_names)
    events, seq = [], 0
    t_lo, t_hi = 100.0, 100.0 + rng.uniform(5.0, 20.0)
    if phase:
        events.append({"type": "span", "name": "sweep_pipeline", "path": "sweep_pipeline",
                       "t0": t_lo, "wall_s": t_hi - t_lo, "seq": seq})
        seq += 1
    for name in names:
        if rng.random() < 0.2:
            continue  # a stage that never ran
        for _ in range(int(rng.integers(1, 12))):
            t0 = float(rng.uniform(t_lo - 3.0, t_hi + 1.0))
            events.append({"type": "span", "name": name, "path": f"sweep_pipeline/{name}",
                           "t0": t0, "wall_s": float(rng.exponential(0.8)), "seq": seq})
            seq += 1
    events.append({"type": "event", "name": "faults.retry", "t0": t_lo + 1.0, "seq": seq})
    rng.shuffle(events)
    return events


def test_the_tables_and_thresholds_are_the_jax_packages():
    assert tocc.STAGES == jocc.STAGES
    assert tocc.STAGE_SORT_ORDER == jocc.STAGE_SORT_ORDER
    assert tocc.NESTED_STAGES == jocc.NESTED_STAGES
    assert tocc.PHASE_SPANS == jocc.PHASE_SPANS
    assert (tocc.BUSY_VERDICT, tocc.IDLE_VERDICT) == (jocc.BUSY_VERDICT, jocc.IDLE_VERDICT)
    # the tracer's stage tracks come from the occupancy table
    assert obs.trace.STAGE_SORT_ORDER == jocc.STAGE_SORT_ORDER


@pytest.mark.parametrize("seed", SEEDS)
def test_analyze_equals_the_jax_modules(seed):
    events = span_sequence(seed)
    assert_same(tocc.analyze(events), jocc.analyze(events))
    no_phase = span_sequence(seed, phase=False)
    assert_same(tocc.analyze(no_phase), jocc.analyze(no_phase))
    window = (102.0, 108.5)
    assert_same(tocc.analyze(events, window=window), jocc.analyze(events, window=window))
    stages = ("dispatch", "drain", "readback_fence")
    assert_same(tocc.analyze(events, stages=stages), jocc.analyze(events, stages=stages))
    assert_same(tocc.stage_intervals(events), jocc.stage_intervals(events))


@pytest.mark.parametrize("seed", SEEDS)
def test_interval_algebra_and_overlap_stats_equal_the_jax_modules(seed):
    rng = np.random.default_rng(100 + seed)
    ivs = [(float(a), float(a + b)) for a, b in zip(rng.uniform(0, 10, 40),
                                                     rng.exponential(0.5, 40))]
    assert tocc.merge_intervals(ivs) == jocc.merge_intervals(ivs)
    assert tocc.busy_seconds(ivs) == jocc.busy_seconds(ivs)
    busy = {name: float(rng.uniform(0.0, 6.0)) for name in jocc.STAGES if rng.random() < 0.7}
    busy["unknown_stage"] = 0.0
    for wall in (0.0, 0.5, 3.0, 6.0, 40.0):
        assert_same(tocc.overlap_stats(busy, wall), jocc.overlap_stats(busy, wall))


@pytest.mark.parametrize("duties", [
    {}, {"io_write": 0.92, "dispatch": 0.3}, {"drain": 0.1, "dispatch": 0.05},
    {"dispatch": 0.5, "drain": 0.6}, {"readback_fence": 0.99, "sweep_chunk": 0.4},
    {"shard_write": 0.95, "io_write": 0.5}, {"readback_fence": 0.9},
    {"custom": 0.8},
])
def test_verdict_equals_the_jax_modules(duties):
    assert tocc.verdict(duties) == jocc.verdict(duties)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_live_snapshot_equals_the_jax_modules(seed, monkeypatch):
    """The same records observed at the same (fake) instants: the rolling
    window's duties and verdict equal, before and after records age out."""
    clock = FakeClock()
    monkeypatch.setattr(tocc, "time", clock)
    monkeypatch.setattr(jocc, "time", clock)
    occ_t, occ_j = tocc.StageOccupancy(window_s=30.0), jocc.StageOccupancy(window_s=30.0)
    rng = np.random.default_rng(200 + seed)
    snaps = []
    for _ in range(120):
        clock.t += float(rng.exponential(0.4))
        name = str(rng.choice(list(jocc.STAGES) + ["freeze"]))
        rec = {"type": "span", "name": name, "wall_s": float(rng.exponential(0.3))}
        occ_t.observe(rec)
        occ_j.observe(rec)
        if rng.random() < 0.2:
            snaps.append((occ_t.snapshot(), occ_j.snapshot()))
    clock.t += 20.0
    snaps.append((occ_t.snapshot(), occ_j.snapshot(timeout=0.5)))
    clock.t += 100.0
    snaps.append((occ_t.snapshot(), occ_j.snapshot()))
    assert snaps[-1][0] == {"stages": {}, "bottleneck": None}
    for got, want in snaps:
        assert_same(got, want)


def _chain(sleeps):
    def work(name):
        def fn(i, payload, sp):
            import time

            time.sleep(sleeps[name])
            return payload
        return fn

    return [Stage("produce", fn=work("produce")),
            Stage("transform", fn=work("transform"), releases_window=True),
            Stage("sink", fn=work("sink"))]


def test_the_stage_graphs_stats_carry_their_occupancy():
    stats = StageGraph(_chain({"produce": 0.0, "transform": 0.01, "sink": 0.002}), window=2,
                       drain_timeout_s=30.0).run(range(12))
    occ = stats["occupancy"]
    # the JAX kernel over the stats' busy seconds (rounded to 1e-6 there,
    # so a duty may round the other way in its third decimal)
    want = jocc.overlap_stats(stats["stage_busy_s"], stats["wall_s"])
    assert set(occ) == set(want) and occ["wall_s"] == want["wall_s"]
    assert set(occ["duty"]) == set(want["duty"])
    assert all(abs(occ["duty"][k] - want["duty"][k]) <= 1.001e-3 for k in want["duty"])
    # the verdict reads the unrounded duties (its percentage may differ by
    # one from the rounded table's)
    assert occ["bottleneck"].startswith("transform ")
    assert max(occ["duty"], key=occ["duty"].get) == "transform"
    # the pipeline's stats pass it through, as the JAX package's do
    written = []
    run = run_pipelined(range(6), lambda i: i, lambda i, b: written.append(i), depth=2,
                        fetch=lambda v: np.asarray([v]), drain_timeout_s=30.0)
    assert written == list(range(6)) and set(run["occupancy"]) >= {"wall_s", "bottleneck"}


def test_the_prefetch_stage_mirrors_its_busy_seconds():
    obs.reset_all()
    stats = {}
    tiles = [np.full((4, 8), float(i)) for i in range(5)]
    out = list(prefetch_to_device(iter(tiles), depth=2, device="cpu", stats=stats))
    assert len(out) == 5
    busy = obs.REGISTRY.gauge("occupancy.busy_s", stage="cw_stream_stage").value
    assert busy == round(stats["stage_busy_s"]["cw_stream_stage"], 6)
    obs.reset_all()
