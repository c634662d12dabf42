"""The series and SLO modules of the port (``obs/series.py``,
``obs/slo.py``) against the JAX package's on the CPU: the P-squared
estimators and ``SpanQuantiles`` on one seeded stream of 10,000 draws
equal bit for bit (the same float64 arithmetic), ``Ring`` decimates alike,
``quantiles_from_histogram`` agrees, a recorder's ``series.jsonl`` reads
back identically through either package's ``load_series``; the objective
grammar accepts and refuses the same strings with the same texts, and
``SLOEngine.status()`` / ``heartbeat_block()`` equal the JAX engine's
after the same span and counter sequence at the same (fake) instants: a
fast-burn breach, a slow burn and a recovery."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.obs import metrics as jmetrics
from pta_replicator_tpu.obs import series as jseries
from pta_replicator_tpu.obs import slo as jslo
from pta_replicator_tpu_torch.obs import metrics as tmetrics
from pta_replicator_tpu_torch.obs import series as tseries
from pta_replicator_tpu_torch.obs import slo as tslo

from test_torch_occupancy import FakeClock

NDRAWS = 10_000
STREAMS = ["normal", "lognormal", "exponential", "uniform", "ties"]


def draws(kind, n=NDRAWS, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "normal": lambda: rng.normal(3.0, 2.0, n),
        "lognormal": lambda: rng.lognormal(-4.0, 1.2, n),
        "exponential": lambda: rng.exponential(0.02, n),
        "uniform": lambda: rng.uniform(-1.0, 1.0, n),
        "ties": lambda: rng.integers(0, 5, n).astype(np.float64),
    }[kind]().tolist()


@pytest.mark.parametrize("kind", STREAMS)
def test_p2_and_span_quantiles_equal_the_jax_modules_bit_for_bit(kind):
    xs = draws(kind)
    for p in (0.1, 0.5, 0.95, 0.99):
        qt, qj = tseries.P2Quantile(p), jseries.P2Quantile(p)
        assert qt.value is None and qj.value is None
        for i, x in enumerate(xs):
            qt.observe(x)
            qj.observe(x)
            if i < 8 or i % 997 == 0:
                assert qt.value == qj.value, (p, i)
        assert qt.value == qj.value and qt.count == qj.count == NDRAWS
        assert qt._q == qj._q and qt._n == qj._n
    st, sj = tseries.SpanQuantiles(), jseries.SpanQuantiles()
    assert st.summary()["p50"] is None
    for x in xs:
        st.observe(x)
        sj.observe(x)
    assert st.summary() == sj.summary()


def test_the_estimators_refuse_alike():
    for bad in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError) as et:
            tseries.P2Quantile(bad)
        with pytest.raises(ValueError) as ej:
            jseries.P2Quantile(bad)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as et:
        tseries.Ring(3)
    with pytest.raises(ValueError) as ej:
        jseries.Ring(3)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("budget,offers", [(4, 100), (16, 1000), (512, 5000), (512, 300)])
def test_ring_decimation_equals_the_jax_modules(budget, offers):
    rt, rj = tseries.Ring(budget), jseries.Ring(budget)
    for i in range(offers):
        rt.offer(0.5 * i, i * i)
        rj.offer(0.5 * i, i * i)
        assert len(rt) <= budget
    assert rt.samples == rj.samples and rt.stride == rj.stride
    assert rt.nbytes() == rj.nbytes() and tseries.Ring.SAMPLE_NBYTES == jseries.Ring.SAMPLE_NBYTES


@pytest.mark.parametrize("seed", range(5))
def test_quantiles_from_histogram_equal_the_jax_modules(seed):
    rng = np.random.default_rng(seed)
    buckets = tuple(sorted(rng.uniform(0.0, 1.0, int(rng.integers(1, 10))).tolist()))
    counts = rng.integers(0, 20, len(buckets) + 1).tolist()
    qs = (0.5, 0.9, 0.95, 0.99)
    assert (tseries.quantiles_from_histogram(buckets, counts, qs)
            == jseries.quantiles_from_histogram(buckets, counts, qs))
    assert tseries.quantiles_from_histogram(buckets, [0] * len(counts)) == {}
    assert (tseries.quantiles_from_histogram(buckets, [0] * len(buckets) + [5])
            == jseries.quantiles_from_histogram(buckets, [0] * len(buckets) + [5]))


def test_the_prefix_table_and_schema_are_the_jax_packages():
    assert tseries.DEFAULT_PREFIXES == jseries.DEFAULT_PREFIXES
    assert tseries.SERIES_SCHEMA == jseries.SERIES_SCHEMA
    assert tseries.SERIES_SCHEMA_VERSION == jseries.SERIES_SCHEMA_VERSION
    assert tseries.process_rss_bytes() > 0


def _drive_recorders(monkeypatch, ticks=40):
    """One metric sequence into a port and a JAX recorder (each on its own
    registry) at the same fake instants, with the same span records."""
    clock = FakeClock(2000.0)
    for mod in (tseries, jseries):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "process_rss_bytes", lambda: 123_456_789)
    regs = {"port": tmetrics.MetricsRegistry(), "jax": jmetrics.MetricsRegistry()}
    recs = {"port": tseries.SeriesRecorder(regs["port"], ring_budget=8),
            "jax": jseries.SeriesRecorder(regs["jax"], ring_budget=8)}
    rng = np.random.default_rng(7)
    for k in range(ticks):
        clock.t += 1.0
        done = float(k // 3)
        rate = float(rng.uniform(0.0, 1.0))
        for reg in regs.values():
            reg.gauge("sweep.chunks_done").set(done)
            reg.counter("sweep.realizations").inc(200)
            reg.gauge("occupancy.duty_cycle", stage="drain").set(rate)
            reg.gauge("io.tim.toas").set(k)          # not a sampled prefix
            reg.histogram("cw_stream.stage_s", buckets=(0.01, 0.1, 1.0)).observe(rate / 3)
        for name in ("dispatch", "drain", "likelihood_batch"):
            wall = float(rng.exponential(0.05))
            for rec in recs.values():
                rec.observe_span({"type": "span", "name": name, "wall_s": wall})
        for rec in recs.values():
            rec.sample()
    return clock, recs


def test_a_recorders_trends_snapshot_and_jsonl_equal_the_jax_modules(monkeypatch, tmp_path):
    clock, recs = _drive_recorders(monkeypatch)
    for window in (5.0, 20.0, 120.0):
        assert recs["port"].trends(window) == recs["jax"].trends(window)
    snaps = {k: r.snapshot(recent=5) for k, r in recs.items()}
    assert snaps["port"] == snaps["jax"]
    assert recs["port"].span_quantiles() == recs["jax"].span_quantiles()
    assert recs["port"].nbytes() == recs["jax"].nbytes()
    paths = {k: r.write_jsonl(str(tmp_path / f"{k}.jsonl")) for k, r in recs.items()}
    loaded = {(pkg, mod.__name__): mod.load_series(paths[pkg])
              for pkg in paths for mod in (tseries, jseries)}
    # either loader reads either file alike; the two files are equal but
    # for the writer's pid line
    for pkg in paths:
        assert loaded[pkg, tseries.__name__] == loaded[pkg, jseries.__name__]
    port, jax = loaded["port", tseries.__name__], loaded["jax", tseries.__name__]
    assert port["series"] == jax["series"] and port["quantiles"] == jax["quantiles"]
    assert {k for k in port["meta"]} == {k for k in jax["meta"]}
    # decimated to the 8-sample budget, the whole run still spanned
    chunks = [s for s in port["series"] if s["name"] == "sweep.chunks_done"][0]
    assert chunks["stride"] > 1 and len(chunks["samples"]) <= 8
    assert not any(s["name"] == "io.tim.toas" for s in port["series"])
    assert {q["name"] for q in port["quantiles"]} >= {"dispatch", "cw_stream.stage_s"}


# --------------------------------------------------------------------- SLO

GOOD_SPECS = [
    "serve=likelihood_batch:p99_ms<=60@99.9%",
    "admit=err(likelihood.rejected/likelihood.requests)@99.5%",
    " lat = drain:p50_ms<=2.5@90% ",
    "a=dispatch:p95_ms<=100@50%",
]
BAD_SPECS = [
    "no_equals_sign", "=drain:p99_ms<=1@99%", "x=drain:p99_ms<=1", "x=drain:p99_ms<=1@99",
    "x=drain:p99_ms<=1@abc%", "x=drain:p99_ms<=1@100%", "x=drain:p99_ms<=1@0%",
    "x=err(faults.injected{site=drain}/sweep.realizations)@99%", "x=drain:p999_ms<=1@99%",
    "x=bogus@99%", "x=drain:p99_ms<=1@99%;x=dispatch:p50_ms<=2@90%",
]


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_the_grammar_accepts_what_the_jax_grammar_accepts(spec):
    got, want = tslo.parse_objective(spec), jslo.parse_objective(spec)
    assert _fields(got) == _fields(want) and got.spec_str() == want.spec_str()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_the_grammar_refuses_with_the_jax_texts(spec):
    with pytest.raises(tslo.SLOSpecError) as et:
        tslo.parse_objectives(spec)
    with pytest.raises(jslo.SLOSpecError) as ej:
        jslo.parse_objectives(spec)
    assert str(et.value) == str(ej.value)


def test_objectives_from_the_environment(monkeypatch):
    monkeypatch.delenv("PTA_SLO", raising=False)
    assert tslo.from_env() == [] == jslo.from_env()
    monkeypatch.setenv("PTA_SLO", ";".join(GOOD_SPECS[:2]))
    assert [_fields(o) for o in tslo.from_env()] == [_fields(o) for o in jslo.from_env()]
    assert (tslo.DEFAULT_WINDOW_S, tslo.DEFAULT_FAST_WINDOW_S, tslo.DEFAULT_FAST_BURN,
            tslo.BUCKET_S) == (jslo.DEFAULT_WINDOW_S, jslo.DEFAULT_FAST_WINDOW_S,
                               jslo.DEFAULT_FAST_BURN, jslo.BUCKET_S)
    with pytest.raises(tslo.SLOSpecError, match="duplicate"):
        tslo.SLOEngine([tslo.parse_objective(GOOD_SPECS[0])] * 2)


def _status(engine, **kw):
    doc = engine.status(**kw)
    doc.pop("written_at")
    return doc


@pytest.mark.parametrize("scenario", ["fast_burn", "slow_burn", "recovery"])
def test_the_engine_equals_the_jax_engine(scenario, monkeypatch):
    clock = FakeClock(7000.0)
    for mod in (tslo, jslo):
        monkeypatch.setattr(mod, "time", clock)
    specs = "lat=likelihood_batch:p99_ms<=50@99%;admit=err(likelihood.rejected/likelihood.requests)@95%"
    regs = {"port": tmetrics.MetricsRegistry(), "jax": jmetrics.MetricsRegistry()}
    engines = {"port": tslo.SLOEngine(specs, registry=regs["port"]),
               "jax": jslo.SLOEngine(specs, registry=regs["jax"])}
    rng = np.random.default_rng({"fast_burn": 1, "slow_burn": 2, "recovery": 3}[scenario])
    history = []
    for k in range(90):
        clock.t += 2.0
        if scenario == "fast_burn":
            slow = k >= 40                      # every span past the threshold
            rejected = k >= 60
        elif scenario == "slow_burn":
            slow = rng.random() < 0.03          # above the 1% allowance, below 14.4x
            rejected = rng.random() < 0.06
        else:
            slow = 20 <= k < 35                 # a burst, then clean for 110 s
            rejected = False
        wall = 0.2 if slow else float(rng.uniform(0.001, 0.04))
        for name, reg in regs.items():
            engines[name].observe_span({"type": "span", "name": "likelihood_batch",
                                        "wall_s": wall})
            engines[name].observe_span({"type": "span", "name": "dispatch", "wall_s": 9.0})
            reg.counter("likelihood.requests").inc(4)
            if rejected:
                reg.counter("likelihood.requests").inc(1)
                reg.counter("likelihood.rejected").inc(1)
        for engine in engines.values():
            engine.sample()
        got, want = _status(engines["port"]), _status(engines["jax"])
        assert got == want, k
        assert engines["port"].heartbeat_block() == engines["jax"].heartbeat_block()
        history.append(want)
    breached = [bool(h["breached"]) for h in history]
    if scenario == "fast_burn":
        assert breached[-1] and history[-1]["objectives"]["lat"]["breaches"] == 1
    elif scenario == "slow_burn":
        assert not any(breached)
        assert history[-1]["objectives"]["lat"]["burn_rate_slow"] > 1.0
    else:
        assert any(breached) and not breached[-1]
    # the gauges and breach counters mirrored into each registry alike
    assert (json.dumps(regs["port"].to_json(), sort_keys=True)
            == json.dumps(regs["jax"].to_json(), sort_keys=True))


def test_any_breach_reads_alike():
    docs = [None, {}, {"breached": ["a", 1]}, {"objectives": {"b": {"breach": True},
                                                               "c": {"breach": False}}},
            {"objectives": "bad"}, "text"]
    for doc in docs:
        assert tslo.any_breach(doc) == jslo.any_breach(doc)
    disarmed = tslo.SLOEngine(None)
    disarmed.sample()
    assert not disarmed.armed and disarmed.heartbeat_block() == {"objectives": {},
                                                                 "breached": []}


def test_the_kept_statm_descriptor_reads_a_fresh_resident_size():
    """process_rss_bytes keeps /proc/self/statm open and reads it afresh:
    it follows the resident size as a reopened file does, and a process
    whose descriptor another pid opened (a forked child) opens its own."""
    import os

    def reopened():
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    before = tseries.process_rss_bytes()
    blob = bytearray(64 << 20)
    after, fresh = tseries.process_rss_bytes(), reopened()
    assert after - before > 48 << 20
    assert abs(after - fresh) < 4 << 20
    del blob
    # a forked child finds its parent's descriptor under another pid and
    # opens its own
    stale = tseries._STATM[1]
    tseries._STATM[0] = -1
    assert tseries.process_rss_bytes() > 0
    assert tseries._STATM[0] == os.getpid() and tseries._STATM[1] != stale
    os.close(stale)
