"""The port's flight recorder (``obs/flightrec.py``), capture functions and
HTTP surface (``obs/serve.py``) against the JAX package's on the CPU: a
heartbeat from each package's recorder after the same span and metric
sequence is equal less its process- and clock-bound keys; ``progress.json``
and ``postmortem.json`` pass the JAX schemas and the JAX schema checker;
the watchdog warns at a 0.1 s stall; a second capture stops the first
recorder; the crash hooks leave the process as they found it; ``/healthz``
and ``/readyz`` answer as the JAX server's."""
import importlib.util
import json
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import obs as jobs
from pta_replicator_tpu.obs import flightrec as jflightrec
from pta_replicator_tpu.obs import numerics as jnumerics
from pta_replicator_tpu.obs import occupancy as jocc
from pta_replicator_tpu.obs import serve as jserve
from pta_replicator_tpu.obs import series as jseries
from pta_replicator_tpu.obs import slo as jslo
from pta_replicator_tpu_torch import obs as tobs
from pta_replicator_tpu_torch.obs import flightrec as tflightrec
from pta_replicator_tpu_torch.obs import numerics as tnumerics
from pta_replicator_tpu_torch.obs import occupancy as tocc
from pta_replicator_tpu_torch.obs import serve as tserve
from pta_replicator_tpu_torch.obs import series as tseries
from pta_replicator_tpu_torch.obs import slo as tslo

from test_torch_occupancy import FakeClock

#: heartbeat keys bound to the process or the wall clock
VOLATILE = ("pid", "written_at", "uptime_s", "last_span_age_s", "device_memory")
SLO = "lat=dispatch:p99_ms<=50@99%;admit=err(likelihood.rejected/likelihood.requests)@95%"
CHECKER = Path(__file__).resolve().parent.parent / "scripts" / "check_telemetry_schema.py"


@pytest.fixture(autouse=True)
def _fresh_globals():
    """Both packages' globals clean before and after, and the process's
    signal handlers and excepthook as they were."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    hook = sys.excepthook
    for pkg in (tobs, jobs):
        pkg.reset_all()
    yield
    for pkg in (tobs, jobs):
        pkg.configure(None)
        pkg.reset_all()
    tflightrec.uninstall_crash_hooks()
    assert tflightrec.active() is None
    for s, h in handlers.items():
        assert signal.getsignal(s) is h
    assert sys.excepthook is hook


def _wait_for(predicate, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _checker():
    spec = importlib.util.spec_from_file_location("check_telemetry_schema", str(CHECKER))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_schemas_are_the_jax_packages():
    assert tflightrec.PROGRESS_SCHEMA == jflightrec.PROGRESS_SCHEMA
    assert tflightrec.POSTMORTEM_SCHEMA == jflightrec.POSTMORTEM_SCHEMA
    assert tflightrec.PROGRESS_SCHEMA_VERSION == jflightrec.PROGRESS_SCHEMA_VERSION
    assert (tflightrec.FlightRecorder.OVERHEAD_TARGET, tflightrec.FlightRecorder.MAX_INTERVAL_S,
            tflightrec.FlightRecorder.LIVE_ARTIFACT_EVERY) == (
        jflightrec.FlightRecorder.OVERHEAD_TARGET, jflightrec.FlightRecorder.MAX_INTERVAL_S,
        jflightrec.FlightRecorder.LIVE_ARTIFACT_EVERY)
    assert tserve.ROUTES == jserve.ROUTES


def _span(name, wall):
    return {"type": "span", "name": name, "path": f"realize/sweep_pipeline/{name}",
            "t0": 1.0, "wall_s": wall, "cpu_s": 0.0, "tid": 1, "seq": 0, "attrs": {}}


@pytest.mark.parametrize("with_slo", [False, True])
def test_a_heartbeat_equals_the_jax_recorders(tmp_path, monkeypatch, with_slo):
    """The same records and metrics at the same fake instants, the sampler's
    steps run by hand: the two heartbeats are equal but for VOLATILE."""
    clock = FakeClock(9000.0)
    clock.strftime, clock.gmtime = time.strftime, time.gmtime
    for mod in (tflightrec, jflightrec, tseries, jseries, tslo, jslo, tocc, jocc):
        monkeypatch.setattr(mod, "time", clock)
    for mod in (tseries, jseries):
        monkeypatch.setattr(mod, "process_rss_bytes", lambda: 987_654_321)
    tnumerics.reset()
    jnumerics.reset()
    pkgs = {"port": (tobs, tflightrec), "jax": (jobs, jflightrec)}
    recs = {k: fr.FlightRecorder(str(tmp_path / k), stall_timeout_s=None,
                                 slo_objectives=SLO if with_slo else [])
            for k, (_o, fr) in pkgs.items()}
    beats = {k: [] for k in pkgs}
    for k in range(30):
        clock.t += 0.5
        for name, (o, _fr) in pkgs.items():
            o.gauge("sweep.chunks_total").set(10)
            o.gauge("sweep.chunks_done").set(k // 3)
            o.gauge("sweep.inflight_chunks").set(2)
            o.gauge("sweep.last_dispatched_chunk").set(min(9, k // 3 + 1))
            o.counter("sweep.realizations").inc(200 if k % 3 == 2 else 0)
            o.counter("likelihood.requests").inc(4)
            o.counter("likelihood.rejected").inc(1 if k > 20 else 0)
        for stage, wall in (("dispatch", 0.01 * (k % 4)), ("drain", 0.4), ("io_write", 0.05)):
            for rec in recs.values():
                rec._on_record(_span(stage, wall))
        if k % 5 == 4:
            for name, rec in recs.items():
                rec.series.sample()
                rec.slo.sample()
                beats[name].append(rec._heartbeat())
    with tobs.span("realize"), jobs.span("realize"):
        for name, rec in recs.items():
            beats[name].append(rec._heartbeat(finished=True))
    assert beats["port"] and len(beats["port"]) == len(beats["jax"])
    me = str(threading.get_ident())
    for got, want in zip(beats["port"], beats["jax"]):
        for key in VOLATILE:
            got.pop(key, None)
            want.pop(key, None)
        # this thread's stacks: a thread another test left running (a
        # server's worker) keeps its own span open in the process's tracer
        for hb in (got, want):
            hb["open_spans"] = {k: v for k, v in hb["open_spans"].items() if k == me}
        assert got == want
    final = beats["port"][-1]
    assert final["finished"] and final["jax"] == {}
    assert final["sweep"]["chunks_done"] == 9 and final["sweep"]["eta_s"] > 0
    assert final["occupancy"]["bottleneck"] == "drain 80% busy -> readback-bound"
    assert list(final["open_spans"].values()) == [["realize"]]
    assert bool(final["slo"]["objectives"]) == with_slo
    assert final["numerics"] == tnumerics.heartbeat_block()
    # the live duties were mirrored into the occupancy gauges alike
    assert (tobs.REGISTRY.gauge("occupancy.duty_cycle", stage="drain").value
            == jobs.REGISTRY.gauge("occupancy.duty_cycle", stage="drain").value)


def test_a_captures_artifacts_pass_the_jax_schemas(tmp_path, monkeypatch):
    d = tmp_path / "cap"
    monkeypatch.setenv("PTA_SLO", SLO)
    tobs.start_capture(str(d), heartbeat_interval_s=0.02)
    try:
        rec = tflightrec.active()
        assert rec is not None and rec.slo.armed
        tobs.gauge("sweep.chunks_total").set(3)
        with tobs.span("realize"):
            for i in range(3):
                with tobs.span("dispatch", chunk=i):
                    time.sleep(0.01)
                tobs.gauge("sweep.chunks_done").set(i + 1)
            assert _wait_for(lambda: (d / "progress.json").exists() and (d / "slo.json").exists())
        rec.write_postmortem("manual")
    finally:
        tobs.finish_capture(context={"argv": ["test"]})
    progress = json.loads((d / "progress.json").read_text())
    assert progress["finished"] is True and progress["sweep"]["chunks_done"] == 3
    checker = _checker()
    assert checker.validate_flightrec_file(str(d / "progress.json"), "progress") == []
    assert checker.validate_flightrec_file(str(d / "postmortem.json"), "postmortem") == []
    assert checker.validate_series_file(str(d / "series.jsonl")) == []
    assert checker.validate_slo_file(str(d / "slo.json")) == []
    assert checker.main([str(d)]) == 0
    for key, typ in jflightrec.PROGRESS_SCHEMA.items():
        assert isinstance(progress[key], typ) or (typ is float and isinstance(progress[key], int)), key
    pm = json.loads((d / "postmortem.json").read_text())
    assert set(jflightrec.POSTMORTEM_SCHEMA) <= set(pm) and pm["reason"] == "manual"
    assert any(r.get("name") == "dispatch" for r in pm["ring"])
    # the sampler's own cost and the process RSS were recorded
    metrics = json.loads((d / "metrics.json").read_text())
    assert metrics["obs.overhead_s"][0]["value"] > 0 and metrics["proc.rss_bytes"][0]["value"] > 0


def test_the_watchdog_warns_at_a_tenth_of_a_second(tmp_path):
    rec = tflightrec.FlightRecorder(str(tmp_path), interval_s=0.02, stall_timeout_s=0.1).start()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with tobs.span("wedged_stage"):
                time.sleep(0.4)
        stalls = [w for w in caught if issubclass(w.category, tflightrec.StallWarning)]
        assert len(stalls) == 1 and "wedged_stage" in str(stalls[0].message)
        assert tobs.counter("flightrec.stalls").value == 1
        assert any(r["type"] == "event" and r["name"] == "flightrec.stall" for r in rec.ring)
    finally:
        rec.stop()
    hb = json.loads((tmp_path / "progress.json").read_text())
    assert hb["stalls"] == 1.0 and hb["finished"] is True


def test_a_second_capture_stops_the_first_recorder(tmp_path):
    first, second = tmp_path / "a", tmp_path / "b"
    tobs.start_capture(str(first), heartbeat_interval_s=0.02, crash_hooks=False)
    rec = tflightrec.active()
    thread = rec._thread
    tobs.start_capture(str(second), heartbeat_interval_s=0.02, crash_hooks=False)
    try:
        assert rec._thread is None and not thread.is_alive()
        assert tflightrec.active() is not rec
        assert json.loads((first / "progress.json").read_text())["finished"] is False
    finally:
        tobs.finish_capture()
    assert tflightrec.active() is None
    assert json.loads((second / "progress.json").read_text())["finished"] is True


def test_finish_capture_on_an_exception_writes_the_postmortem(tmp_path):
    d = tmp_path / "cap"
    tobs.start_capture(str(d), heartbeat_interval_s=0.02)
    assert signal.getsignal(signal.SIGTERM) is tflightrec._signal_handler
    with pytest.raises(RuntimeError, match="boom"):
        try:
            with tobs.span("realize"):
                raise RuntimeError("boom")
        finally:
            tobs.finish_capture()
    pm = json.loads((d / "postmortem.json").read_text())
    assert pm["reason"] == "exception" and pm["exception"]["type"] == "RuntimeError"
    assert json.loads((d / "progress.json").read_text())["finished"] is False
    # the capture's handlers went with it (the fixture checks the rest)
    assert signal.getsignal(signal.SIGTERM) is not tflightrec._signal_handler


def test_the_signal_handler_flushes_and_defers_to_the_previous_one(tmp_path):
    """The handler itself, called as the signal would (no signal is sent to
    this process): the postmortem lands, then the chained handler runs."""
    seen = []
    previous = signal.signal(signal.SIGINT, lambda signum, frame: seen.append(signum))
    try:
        rec = tflightrec.FlightRecorder(str(tmp_path), interval_s=0.02,
                                        stall_timeout_s=None).start()
        assert tflightrec.install_crash_hooks()
        with tobs.span("sweep_pipeline"):
            tflightrec._signal_handler(signal.SIGINT, None)
        assert seen == [signal.SIGINT]
        pm = json.loads((tmp_path / "postmortem.json").read_text())
        assert pm["reason"] == "SIGINT"
        assert ["sweep_pipeline"] in pm["heartbeat"]["open_spans"].values()
        # the flush thread stops the recorder after the postmortem is on disk
        assert _wait_for(lambda: tflightrec.active() is None)
        assert tflightrec.uninstall_crash_hooks()
        assert signal.getsignal(signal.SIGINT) is not tflightrec._signal_handler
    finally:
        signal.signal(signal.SIGINT, previous)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.mark.parametrize("route", ["/healthz", "/readyz", "/progress", "/metrics", "/slo",
                                   "/critpath", "/nope", "/"])
def test_the_http_surface_answers_as_the_jax_servers(tmp_path, route):
    """The same directory served by both packages' servers on loopback
    port 0: the same status codes and states, before a heartbeat, live,
    during a fast-burn breach and after a postmortem."""
    d = tmp_path / "cap"
    d.mkdir()
    servers = [mod.serve_directory(str(d), 0, background=True) for mod in (tserve, jserve)]
    try:
        def both():
            out = []
            for mod, srv in zip((tserve, jserve), servers):
                code, body = _get(mod.serve_url(srv, route))
                doc = json.loads(body) if body[:1] in (b"{", b"[") else None
                if isinstance(doc, dict):
                    doc.pop("heartbeat_age_s", None)
                    doc.pop("directory", None)
                out.append((code, doc if doc is not None else body))
            assert out[0] == out[1], out
            return out[0]

        assert both()[0] in (200, 404, 503)
        (d / "progress.json").write_text(json.dumps({"schema": 5, "finished": False}))
        (d / "metrics.prom").write_text("# TYPE x counter\nx 1\n")
        (d / "slo.json").write_text(json.dumps({"objectives": {}, "breached": []}))
        live = both()
        if route in ("/healthz", "/readyz"):
            assert live[0] == 200 and live[1]["state"] == "live"
        (d / "slo.json").write_text(json.dumps({"breached": ["lat"]}))
        burn = both()
        if route == "/readyz":
            assert burn[0] == 503 and burn[1]["state"] == "slo-breach"
        if route == "/healthz":
            assert burn[0] == 200
        if route == "/critpath":
            assert burn[0] == 404
        (d / "postmortem.json").write_text(json.dumps({"reason": "SIGTERM"}))
        dead = both()
        if route in ("/healthz", "/readyz"):
            assert dead[0] == 503 and dead[1]["state"] == "postmortem"
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_a_live_recorders_readyz_follows_the_slo_verdict(tmp_path):
    """A real capture with a tight latency objective: /readyz 200 while the
    spans are fast, 503 once they burn the budget fast."""
    d = tmp_path / "cap"
    tobs.start_capture(str(d), heartbeat_interval_s=0.02, crash_hooks=False,
                       slo="lat=likelihood_batch:p99_ms<=5@99%")
    server = tserve.serve_directory(str(d), 0, background=True)
    try:
        for _ in range(5):
            tobs.TRACER.record_span("likelihood_batch", time.time(), 0.001)
        assert _wait_for(lambda: (d / "slo.json").exists()
                         and _get(tserve.serve_url(server, "/readyz"))[0] == 200)
        for _ in range(5):
            tobs.TRACER.record_span("likelihood_batch", time.time(), 0.5)
        assert _wait_for(lambda: _get(tserve.serve_url(server, "/readyz"))[0] == 503)
        code, body = _get(tserve.serve_url(server, "/readyz"))
        assert json.loads(body)["breached"] == ["lat"]
        assert _get(tserve.serve_url(server, "/healthz"))[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        tobs.finish_capture()
    assert tobs.REGISTRY.counter("slo.breaches", objective="lat").value == 1


def test_the_sampler_reads_no_card_memory_without_cuda():
    # the CPU build: no card, so the heartbeat names none
    assert tflightrec.device_memory_snapshot() == [] == tobs.device_memory_snapshot()
    assert threading.current_thread() is threading.main_thread()


def test_the_atomic_writer_replaces_whole_and_leaves_no_temp_file(tmp_path):
    """The sampler's atomic write: the exact text, a second write replacing
    the first whole, the JAX writer's bytes for the same payload, and no
    temporary file left in the capture directory."""
    path = tmp_path / "progress.json"
    payload = {"schema": 3, "sweep": {"chunks_done": 7}, "name": "α"}
    tflightrec._atomic_json(str(path), payload, indent=None)
    jpath = tmp_path / "jax.json"
    jflightrec._atomic_json(str(jpath), payload, indent=None)
    assert path.read_bytes() == jpath.read_bytes()
    tflightrec._atomic_json(str(path), payload)
    jflightrec._atomic_json(str(jpath), payload)
    assert path.read_bytes() == jpath.read_bytes()
    tflightrec._atomic_text(str(tmp_path / "metrics.prom"), "a 1\n" * 10_000)
    assert (tmp_path / "metrics.prom").read_text() == "a 1\n" * 10_000
    tflightrec._atomic_text(str(tmp_path / "metrics.prom"), "b 2\n")
    assert (tmp_path / "metrics.prom").read_text() == "b 2\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax.json", "metrics.prom",
                                                           "progress.json"]
