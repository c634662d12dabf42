"""The port's telemetry core against the JAX package's, on the CPU: the same
sequence of spans (nested, with attributes, on worker threads that inherit
the caller's stack), events, counters, gauges and histograms through both
packages' tracers and registries gives the same summaries, JSON, Prometheus
text and chrome-trace events; the kind-collision error and the bounded idle
buffer behave alike; the report's pure functions give equal output on the
same inputs; the capture functions write the JAX formats; the profiling
shims; ``solve_eager`` and ``sample_eager`` against the JAX functions
(float64, <= 1e-12); and ``project_bank`` through the prefetch layer equal
bit for bit to the chunk-by-chunk projection it replaced."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.covariance import COV_STREAM_FOLD
from pta_replicator_tpu.covariance import kernels as jcovk
from pta_replicator_tpu.obs import metrics as jmetrics
from pta_replicator_tpu.obs import report as jreport
from pta_replicator_tpu.obs import trace as jtrace
from pta_replicator_tpu.utils import profiling as jprof
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch import obs
from pta_replicator_tpu_torch.covariance import kernels as tcovk
from pta_replicator_tpu_torch.obs import metrics as tmetrics
from pta_replicator_tpu_torch.obs import names as tnames
from pta_replicator_tpu_torch.obs import report as treport
from pta_replicator_tpu_torch.obs import trace as ttrace
from pta_replicator_tpu_torch.utils import profiling as tprof

#: solve_eager / sample_eager against the JAX functions, float64, relative
#: to the largest entry
TOL_COV = 1e-12

PACKAGES = {"jax": (jtrace, jmetrics), "port": (ttrace, tmetrics)}


def _drive(trace_mod, metrics_mod):
    """One fixed sequence through a private tracer and registry."""
    tracer = trace_mod.Tracer()
    reg = metrics_mod.MetricsRegistry()
    with tracer.span("outer", npsr=4) as sp:
        sp["ntoa_max"] = 400
        with tracer.span("inner", file="a.tim"):
            reg.counter("io.tim.files").inc()
            reg.counter("io.tim.toas").inc(150)
        stack = tracer.current_stack()

        def worker(k):
            with tracer.inherit(stack):
                with tracer.span("drain", chunk=k):
                    reg.gauge("stages.busy_s", stage="drain").inc(0.5)
                tracer.event("faults.retry", scope="sweep", attempt=k)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with tracer.span("io_write", nbytes=12):
            pass
    reg.gauge("sweep.chunks_done").set(2)
    reg.gauge("sweep.chunks_total").set(4.0)
    for v in (2e-4, 0.03, 0.03, 7.0):
        reg.histogram("likelihood.latency_s", route="grid").observe(v)
    reg.histogram("custom.latency_s", buckets=(0.1, 1.0)).observe(0.5)
    return tracer, reg


@pytest.fixture(scope="module")
def driven():
    return {name: _drive(*mods) for name, mods in PACKAGES.items()}


def test_summaries_paths_and_calls_are_equal(driven):
    (jt, _), (tt, _) = driven["jax"], driven["port"]
    calls = lambda t: {p: s["calls"] for p, s in t.summary().items()}
    assert calls(tt) == calls(jt)
    assert calls(tt) == {"outer": 1, "outer/inner": 1, "outer/drain": 2, "outer/io_write": 1}
    assert set(next(iter(tt.summary().values()))) == set(next(iter(jt.summary().values())))


def test_registry_json_and_prometheus_are_equal(driven):
    (_, jr), (_, tr) = driven["jax"], driven["port"]
    assert tr.to_json() == jr.to_json()
    assert tr.to_prometheus() == jr.to_prometheus()
    assert json.loads(tr.dumps()) == json.loads(jr.dumps())


def _chrome_events(trace):
    """Chrome-trace events apart from timestamps, durations and real
    thread ids (a stage's synthetic track id stays)."""
    out = []
    for ev in trace["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid")}
        if ev.get("ph") == "X" and ev["name"] not in ttrace.STAGE_SORT_ORDER:
            ev.pop("tid")
        out.append(json.dumps(ev, sort_keys=True))
    return sorted(out)


def test_chrome_traces_have_the_same_events(driven):
    (jt, _), (tt, _) = driven["jax"], driven["port"]
    assert _chrome_events(tt.chrome_trace()) == _chrome_events(jt.chrome_trace())
    assert tt.chrome_trace()["displayTimeUnit"] == jt.chrome_trace()["displayTimeUnit"]


def test_events_carry_the_same_records(driven):
    (jt, _), (tt, _) = driven["jax"], driven["port"]
    strip = lambda evs: sorted(json.dumps({k: v for k, v in e.items()
                                           if k not in ("t0", "wall_s", "cpu_s", "tid", "seq")},
                                          sort_keys=True) for e in evs)
    assert strip(tt.events()) == strip(jt.events())
    assert ttrace.EVENT_SCHEMA == jtrace.EVENT_SCHEMA
    assert ttrace.TRACE_FIELDS == jtrace.TRACE_FIELDS
    assert ttrace.SCHEMA_VERSION == jtrace.SCHEMA_VERSION


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_the_kind_collision_error_is_the_same(package):
    _, metrics_mod = PACKAGES[package]
    reg = metrics_mod.MetricsRegistry()
    reg.counter("x.y")
    with pytest.raises(TypeError, match="already registered as counter, not gauge"):
        reg.gauge("x.y")
    with pytest.raises(ValueError, match="negative increment"):
        reg.counter("x.y").inc(-1)


def test_the_bounded_idle_buffer_behaves_alike():
    out = {}
    for name, (trace_mod, _) in PACKAGES.items():
        tracer = trace_mod.Tracer()
        for _ in range(trace_mod.Tracer.IDLE_MAX_EVENTS + 7):
            with tracer.span("s"):
                pass
        out[name] = (len(tracer.events()), tracer.dropped, tracer.summary()["s"]["calls"])
    assert out["port"] == out["jax"] == (ttrace.Tracer.IDLE_MAX_EVENTS, 7,
                                         ttrace.Tracer.IDLE_MAX_EVENTS + 7)


def test_a_backwards_wallclock_jump_cannot_negate_a_span(monkeypatch):
    import time as _time

    t = ttrace.Tracer()
    wall = iter([1000.0, 400.0, 400.0])
    monkeypatch.setattr(_time, "time", lambda: next(wall, 400.0))
    with t.span("jumpy"):
        pass
    rec = [e for e in t.events() if e["type"] == "span"][0]
    assert rec["t0"] == 1000.0 and rec["wall_s"] >= 0.0 and rec["cpu_s"] >= 0.0


def test_the_names_registry_is_the_jax_registry():
    from pta_replicator_tpu.obs import names as jnames

    mine = {k: v for k, v in vars(tnames).items() if k.isupper()}
    assert mine == {k: v for k, v in vars(jnames).items() if k.isupper()}
    assert tnames.is_registered("cw_stream_stage", "span")


# ------------------------------------------------------ report functions

def _events_and_docs(driven):
    (jt, jr), _ = driven["jax"], driven["port"]
    numerics_doc = {
        "sites": {"gp.woodbury": {"nonfinite": 0, "max_abs": 3.5e4, "headroom_bits": 112.0},
                  "cov.cholesky": {"nonfinite": 2, "max_abs": 1.0, "headroom_bits": None,
                                   "episode_active": True}},
        "drift": {"realization": {"worst": 2e-4, "samples": 3, "tolerance": 1e-4}},
        "episodes_active": ["cov.cholesky"],
    }
    return jt.events(), jr.to_json(), numerics_doc


def test_the_report_functions_give_equal_output(driven):
    events, metrics, numerics_doc = _events_and_docs(driven)
    agg_t, agg_j = treport.aggregate_spans(events), jreport.aggregate_spans(events)
    assert agg_t == agg_j
    for min_ms in (0.0, 1e9):
        assert treport.render_span_tree(agg_t, min_ms=min_ms) == jreport.render_span_tree(
            agg_j, min_ms=min_ms)
    assert treport._metric_rows(metrics) == jreport._metric_rows(metrics)
    assert treport.render_numerics(numerics_doc) == jreport.render_numerics(numerics_doc)
    assert treport.render_numerics({}) == jreport.render_numerics({}) == ""
    assert treport.render_span_tree({}) == jreport.render_span_tree({})


def test_load_events_tolerates_a_truncated_last_line(tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text('{"type": "meta", "schema": 1, "t0": 1.0}\n{"type": "sp')
    assert treport.load_events(str(path)) == jreport.load_events(str(path))


# ----------------------------------------------------------- captures

def test_a_capture_writes_the_jax_formats(tmp_path, monkeypatch):
    d = tmp_path / "cap"
    d.mkdir()
    for stale in ("progress.json", "numerics.json", "metrics.prom", "critpath.json"):
        (d / stale).write_text("{}")
    monkeypatch.setenv("PTA_NUMERICS", "1")
    obs.start_capture(str(d))
    try:
        with obs.span("realize"):
            with obs.span("compute", nreal=4):
                obs.counter("sweep.realizations").inc(4)
            obs.event("faults.retry", scope="sweep", attempt=1)
        summary = obs.telemetry_summary()
    finally:
        obs.finish_capture(context={"argv": ["realize"]})
        obs.reset_all()
        obs.configure(None)
    assert set(summary) == {"spans", "jax"} and summary["jax"] == {}
    assert summary["spans"]["realize/compute"]["calls"] == 1
    files = {p.name for p in d.iterdir()}
    assert {"events.jsonl", "metrics.json", "metrics.prom", "chrome_trace.json",
            "meta.json", "numerics.json"} <= files
    assert not {"progress.json", "critpath.json"} & files
    meta = json.loads((d / "meta.json").read_text())
    assert meta["device_memory"] == [] and meta["argv"] == ["realize"]
    assert meta["torch_version"] == torch.__version__
    # either package reads the capture the same way
    data_t, data_j = treport.load_telemetry(str(d)), jreport.load_telemetry(str(d))
    assert data_t["events"] == data_j["events"] and data_t["metrics"] == data_j["metrics"]
    assert not data_t["problems"]
    assert treport.aggregate_spans(data_t["events"]) == jreport.aggregate_spans(data_j["events"])
    text = treport.render_report(str(d))
    assert "compute" in text and "sweep.realizations = 4" in text
    as_json = json.loads(treport.render_report(str(d), as_json=True))
    assert as_json["spans"]["realize/compute"]["calls"] == 1


def test_finish_without_a_capture_is_a_no_op(tmp_path):
    obs.configure(None)
    obs.finish_capture()
    assert not list(tmp_path.iterdir())


def test_the_report_names_the_artifacts_it_does_not_render(tmp_path):
    (tmp_path / "events.jsonl").write_text(
        '{"type": "span", "name": "a", "path": "a", "t0": 1.0, "wall_s": 0.5, "cpu_s": 0.1, '
        '"tid": 1, "seq": 0, "attrs": {}}\n')
    for name in ("progress.json", "series.jsonl", "slo.json"):
        (tmp_path / name).write_text("{}")
    text = treport.render_report(str(tmp_path))
    assert ("not rendered by the port (ROADMAP A.16.4): progress.json, series.jsonl, slo.json"
            in text)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert "no telemetry data" in treport.render_report(str(empty))


# ------------------------------------------------------ profiling shims

def test_the_profiling_shims_delegate_to_the_tracer():
    tprof.reset()
    with tprof.stage("demo"):
        with tprof.stage("sub"):
            pass
    with tprof.stage("demo"):
        pass
    t = tprof.timings()
    assert t["demo"]["calls"] == 2 and t["sub"]["calls"] == 1 and t["demo"]["total_s"] >= 0
    assert "demo/sub" in obs.TRACER.summary()
    assert tprof.vm_rss_mb() > 0
    with pytest.raises(NotImplementedError, match="A.16.4"):
        tprof.device_trace("d")


def test_the_injection_stages_are_the_jax_packages():
    from pta_replicator_tpu.batch import synthetic_batch as jsynth
    from pta_replicator_tpu.models import batched as JB
    from pta_replicator_tpu_torch.batch import synthetic_batch
    from pta_replicator_tpu_torch.models import batched as TB

    batch = synthetic_batch(npsr=3, ntoa=64, seed=0, dtype=torch.float64, device="cpu")
    kw = dict(efac=1.1, log10_ecorr=-6.8, rn_log10_amplitude=-14.0, rn_gamma=3.0, rn_nmodes=5,
              gwb_log10_amplitude=-14.3, gwb_gamma=4.33, gwb_npts=64, gwb_howml=4.0)
    cat = np.array([[1.0], [2.0], [1e9], [100.0], [2e-8], [0.3], [0.4], [0.5]])
    stages = tprof.injection_stage_fns(batch, TB.Recipe(**kw, cgw_params=cat))
    want = jprof.injection_stage_fns(jsynth(npsr=3, ntoa=64, seed=0),
                                     JB.Recipe(**kw, cgw_params=jnp.asarray(cat)))
    assert set(stages) == set(want)
    for name, fn in stages.items():
        out = fn(torch.Generator().manual_seed(1))
        assert out.shape == batch.toas_s.shape and bool(torch.isfinite(out).all()), name


# ------------------------------------------------------------ covariance

def _cov_ops():
    from pta_replicator_tpu.batch import synthetic_batch
    from pta_replicator_tpu.covariance import (
        LowRankCov, banded_from_times, dense_from_times, kron_time_channel,
    )

    batch = synthetic_batch(npsr=3, ntoa=64, nbackend=2, seed=1, dtype=jnp.float64)
    t, m = np.asarray(batch.toas_s), np.asarray(batch.mask)
    banded = banded_from_times(t, m, rho=0.6, corr_s=40 * 86400.0, block=16, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    return batch, {
        "banded": banded,
        "dense": dense_from_times(t, m, corr_s=60 * 86400.0, dtype=jnp.float64),
        "kron": kron_time_channel(t, channels=4, time_ell_s=20 * 86400.0, chan_rho=0.8,
                                  dtype=jnp.float64),
        "lowrank": LowRankCov(base=banded, U=jnp.asarray(rng.standard_normal((3, 64, 4)) * 0.3),
                              phi=jnp.asarray(rng.uniform(0.5, 1.5, (3, 4)))),
    }


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("kind", ["banded", "dense", "kron", "lowrank"])
def test_solve_and_sample_eager_match_jax(kind):
    from pta_replicator_tpu.models import batched as JB

    batch, ops = _cov_ops()
    jop = ops[kind]
    top = convert.covop_from_arrays(vars(jop), device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 64))
    s2 = rng.uniform(0.5, 2.0, 3)
    obs.reset_all()
    tcovk._SOLVE_TALLY.update(total=0, structured=0)
    got = tcovk.solve_eager(top, torch.as_tensor(x), s2=torch.as_tensor(s2))
    want = jcovk.solve_eager(jop, jnp.asarray(x), s2=jnp.asarray(s2))
    assert _rel(got, want) <= TOL_COV
    assert obs.REGISTRY.counter("cov.solves").value == 1
    assert obs.REGISTRY.gauge("cov.blocked_fraction").value == float(kind != "dense")
    assert obs.TRACER.summary()["cov_solve"]["calls"] == 1

    # the sample on the JAX package's replayed normals of one realization
    key = jax.random.PRNGKey(5)
    recipe = JB.Recipe(efac=jnp.asarray(1.0), noise_cov=jop, cov_log10_sigma=jnp.asarray(-6.0))
    draws = jax_realize_draws(key, batch, recipe, 1)
    want = jcovk.sample_eager(jop, jax.random.fold_in(jax.random.split(key, 1)[0],
                                                      COV_STREAM_FOLD), s2=jnp.asarray(s2))
    got = tcovk.sample_eager(top, {k: torch.as_tensor(v[0]) for k, v in draws.items()
                                   if k.startswith("cov")}, s2=torch.as_tensor(s2))
    assert _rel(got, want) <= TOL_COV
    assert obs.TRACER.summary()["cov_sample"]["calls"] == 1
    # or drawn from a generator: the op's shapes, reproducible
    a = tcovk.sample_eager(top, torch.Generator().manual_seed(4))
    b = tcovk.sample_eager(top, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == (3, 64) and bool(torch.isfinite(a).all())


# --------------------------------------------- the bank through prefetch

def test_project_bank_through_prefetch_is_bitwise_the_chunked_projection():
    from pta_replicator_tpu_torch.batch import synthetic_batch
    from pta_replicator_tpu_torch.models.batched import Recipe

    batch = synthetic_batch(npsr=3, ntoa=96, seed=2, dtype=torch.float64, device="cpu")
    recipe = Recipe(efac=1.1, rn_log10_amplitude=-14.0, rn_gamma=3.0, rn_nmodes=4,
                    gwb_log10_amplitude=-14.3, gwb_gamma=4.33, gwb_npts=64, gwb_howml=4.0)
    reduced = lk.gp.ReducedGP.build(batch, recipe)
    cube = np.random.default_rng(0).standard_normal((10, 3, 96)).astype(np.float32)
    bank = lk.RealizationBank.from_array(cube, chunk=4)
    obs.reset_all()
    got = lk.project_bank(bank, reduced, batch)
    parts = [reduced.project(torch.as_tensor(b).to(dtype=reduced.TNT.dtype), batch)
             for b in bank.iter_chunks()]
    assert torch.equal(got.rNr, torch.cat([p.rNr for p in parts]))
    assert torch.equal(got.d, torch.cat([p.d for p in parts]))
    calls = {p: s["calls"] for p, s in obs.TRACER.summary().items()}
    assert calls["likelihood_project"] == 1
    assert calls["likelihood_project/cw_stream_stage"] == 4  # 3 chunks and the end
    assert obs.REGISTRY.counter("cw_stream.bytes_staged").value == cube.nbytes
    # a bank of tensors is handed over as it is
    tbank = lk.RealizationBank.from_array(torch.from_numpy(cube), chunk=4)
    again = lk.project_bank(tbank, reduced, batch)
    assert torch.equal(again.rNr, got.rNr) and torch.equal(again.d, got.d)


def test_stage_graph_workers_nest_under_the_callers_span(tmp_path):
    from pta_replicator_tpu_torch.parallel.pipeline import run_pipelined
    from pta_replicator_tpu_torch.parallel.prefetch import prefetch_to_device

    obs.reset_all()
    with obs.span("outer"):
        run_pipelined(range(3), lambda i: torch.full((2,), float(i)),
                      lambda i, block: None, depth=2)
        with obs.span("stream"):
            assert len(list(prefetch_to_device(iter([np.ones(3)] * 2), device="cpu"))) == 2
    calls = {p: s["calls"] for p, s in obs.TRACER.summary().items()}
    assert {k: v for k, v in calls.items() if k.startswith("outer/")} == {
        "outer/dispatch": 3, "outer/drain": 3, "outer/io_write": 3, "outer/stream": 1,
        "outer/stream/cw_stream_stage": 3}
    assert obs.REGISTRY.gauge("sweep.inflight_chunks").value == 0
    assert obs.REGISTRY.gauge("sweep.last_dispatched_chunk").value == 2
    assert obs.REGISTRY.gauge("stages.busy_s", stage="io_write").value >= 0
