"""The live-run surface of ``python -m pta_replicator_tpu_torch`` on the
CPU, on the small ragged par/tim dataset of ``_torch_dataset.py``, against
the JAX package's CLI: ``realize --telemetry DIR --checkpoint`` leaves a
``finished`` heartbeat, ``series.jsonl`` and (with ``PTA_SLO``)
``slo.json`` with the JAX CLI's span paths; a child process SIGTERMed
mid-sweep leaves ``postmortem.json`` (reason SIGTERM) that ``postmortem
DIR`` renders; ``watch --once`` exits as the JAX CLI's; ``watch --serve
0`` answers over loopback; either package's ``report`` renders the other's
capture with its utilization, series, heartbeat and SLO sections; and the
likelihood server under a capture emits the JAX server's spans, metrics
and events for the same request pattern. Signals go to child processes
only, each with its own timeout."""
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import obs as jobs
from pta_replicator_tpu import likelihood as jlk
from pta_replicator_tpu.__main__ import main as jax_main
from pta_replicator_tpu.faults import inject as jinject
from pta_replicator_tpu.obs import flightrec as jflightrec
from pta_replicator_tpu.obs import report as jreport
from pta_replicator_tpu.obs import series as jseries
from pta_replicator_tpu_torch import likelihood as tlk
from pta_replicator_tpu_torch import obs as tobs
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.faults import inject as tinject
from pta_replicator_tpu_torch.obs import flightrec as tflightrec
from pta_replicator_tpu_torch.obs import occupancy as tocc
from pta_replicator_tpu_torch.obs import report as treport
from pta_replicator_tpu_torch.obs import series as tseries

from test_torch_likelihood import _case, _design
from test_torch_telemetry_cli import _argv, dataset  # noqa: F401 (the module fixture)

REPO = Path(__file__).resolve().parent.parent
SLO_ENV = "lat=dispatch:p99_ms<=5000@99%"
#: a child's whole life, start to exit, at most
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _process_state():
    """Captures of either package run in this process: each test leaves
    the handlers, the excepthook and both packages' recorders as it found
    them (the JAX CLI keeps its crash hooks chained; they are put back)."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    hook = sys.excepthook
    yield
    for pkg in (tobs, jobs):
        pkg.configure(None)
        pkg.reset_all()
    for s, h in handlers.items():
        signal.signal(s, h)
    sys.excepthook = hook
    jflightrec._hooks_installed = False
    jflightrec._prev_handlers.clear()
    jflightrec._prev_excepthook = None
    assert tflightrec.active() is None and jflightrec.active() is None


def _wait_for(predicate, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _read_json(path):
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _child(args, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw.pop("env", {}))
    return subprocess.Popen([sys.executable, "-m", "pta_replicator_tpu_torch", *args],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def _calls(data):
    return {p: a["calls"] for p, a in treport.aggregate_spans(data["events"]).items()}


def test_a_checkpointed_realize_leaves_the_live_artifacts(dataset, tmp_path, monkeypatch,
                                                          capsys):
    root, common, spec_path = dataset
    monkeypatch.setenv("PTA_SLO", SLO_ENV)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    main(_argv("realize_depth2", root, common, spec_path, "live_port")
         + ["--device", "cpu", "--telemetry", str(port_dir)])
    jax_main(_argv("realize_depth2", root, common, spec_path, "live_jax")
             + ["--telemetry", str(jax_dir)])
    capsys.readouterr()
    hb = json.loads((port_dir / "progress.json").read_text())
    assert hb["finished"] is True and hb["sweep"]["chunks_done"] == hb["sweep"]["chunks_total"] == 2
    assert hb["jax"] == {} and "lat" in hb["slo"]["objectives"]
    for loader in (tseries.load_series, jseries.load_series):
        series = loader(str(port_dir / "series.jsonl"))
        assert series["meta"]["schema"] == 1
    slo = json.loads((port_dir / "slo.json").read_text())
    assert slo["objectives"]["lat"]["events"] == 2 and slo["breached"] == []
    got, want = treport.load_telemetry(str(port_dir)), jreport.load_telemetry(str(jax_dir))
    assert _calls(got) == _calls(want)
    assert set(got["progress"]) == set(want["progress"])
    assert set(got["slo"]["objectives"]["lat"]) == set(want["slo"]["objectives"]["lat"])
    # the span stamps the pipeline's occupancy, as the JAX sweep's does
    pipe = [r for r in got["events"] if r.get("name") == "sweep_pipeline"][0]
    assert set(pipe["attrs"]["occupancy"]) >= {"wall_s", "duty", "bottleneck"}


def test_a_sigtermed_run_leaves_its_black_box(dataset, tmp_path, capsys):
    """A child ``realize`` held in its third chunk's drain by a fault,
    SIGTERMed once its heartbeat shows a chunk done: ``postmortem.json``
    with reason SIGTERM, the ring and the open sweep; the exit status of
    a re-raised SIGTERM; ``postmortem DIR`` and ``watch --once`` of both
    packages read it."""
    root, common, spec_path = dataset
    d = tmp_path / "killed"
    args = ["realize", *common, "--recipe", str(root / "r.json"), "--out",
            str(tmp_path / "k.npz"), "--nreal", "16", "--chunk", "4", "--checkpoint",
            str(tmp_path / "k_ck.npz"), "--fit", "--device", "cpu", "--telemetry", str(d),
            "--faults", "drain:stall=60@chunk=2"]
    child = _child(args, env={"PTA_SLO": SLO_ENV})
    try:
        def progressed():
            hb = _read_json(d / "progress.json")
            return bool(hb) and (hb.get("sweep") or {}).get("chunks_done", 0) >= 1
        assert _wait_for(progressed, timeout=90), (
            child.stderr.read() if child.poll() is not None else "no progress")
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert rc == -signal.SIGTERM
    pm = json.loads((d / "postmortem.json").read_text())
    assert pm["reason"] == "SIGTERM" and pm["ring"]
    assert any("sweep_pipeline" in stack for stack in pm["heartbeat"]["open_spans"].values())
    assert any(r.get("name") == "dispatch" for r in pm["ring"])
    main(["postmortem", str(d)])
    text = capsys.readouterr().out
    assert "reason: SIGTERM" in text and "in flight" in text
    jax_main(["postmortem", str(d)])
    assert "reason: SIGTERM" in capsys.readouterr().out
    codes = []
    for cli in (main, jax_main):
        with pytest.raises(SystemExit) as exc:
            cli(["watch", str(d), "--once"])
        codes.append(exc.value.code)
    assert codes == [2, 2]
    # the report of a killed run names its end
    report = treport.render_report(str(d))
    assert "POSTMORTEM present (reason: SIGTERM" in report
    assert "run did not finish cleanly" in report


@pytest.mark.parametrize("state", ["none", "finished"])
def test_watch_once_exits_as_the_jax_cli(tmp_path, state, capsys):
    d = tmp_path / "cap"
    d.mkdir()
    if state == "finished":
        tobs.start_capture(str(d), heartbeat_interval_s=0.02, crash_hooks=False)
        tobs.gauge("sweep.chunks_total").set(2)
        tobs.gauge("sweep.chunks_done").set(2)
        tobs.finish_capture()
    codes = []
    for cli in (main, jax_main):
        try:
            cli(["watch", str(d), "--once"])
            codes.append(0)
        except SystemExit as exc:
            codes.append(exc.code)
    out = capsys.readouterr().out
    assert codes == ([3, 3] if state == "none" else [0, 0])
    if state == "finished":
        assert "chunks 2/2 (100.0%)" in out and "FINISHED" in out


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_watch_serve_answers_over_loopback(tmp_path):
    """``watch DIR --serve 0`` in a child beside a live capture in this
    process: /healthz, /readyz, /progress and /metrics answer; the watch
    exits 0 when the capture finishes."""
    d = tmp_path / "cap"
    tobs.start_capture(str(d), heartbeat_interval_s=0.02, crash_hooks=False, slo=SLO_ENV)
    child = _child(["watch", str(d), "--serve", "0", "--interval", "0.05"])
    try:
        line = child.stderr.readline()
        match = re.search(r"serving (http://127\.0\.0\.1:\d+)/", line)
        assert match, line
        base = match.group(1)
        tobs.gauge("sweep.chunks_total").set(4)
        with tobs.span("dispatch", chunk=0):
            tobs.gauge("sweep.chunks_done").set(1)
        # the live files refresh every fifth tick
        assert _wait_for(lambda: b"sweep_chunks_done" in _get(base + "/metrics")[1], timeout=20)
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["state"] == "live"
        assert _get(base + "/readyz")[0] == 200
        code, body = _get(base + "/progress")
        assert code == 200 and json.loads(body)["schema"] == 5
        assert _get(base + "/critpath")[0] == 404
    finally:
        tobs.finish_capture()
        try:
            rc = child.wait(timeout=CHILD_TIMEOUT_S)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    assert rc == 0, child.stderr.read()
    assert "FINISHED" in child.stdout.read()


def _unfinished_capture(pkg, d):
    """A capture of ``pkg``'s flight recorder with stage spans, an SLO and
    series ticks, whose recorder stopped without a finished heartbeat."""
    pkg.start_capture(str(d), heartbeat_interval_s=0.02, crash_hooks=False, slo=SLO_ENV)
    pkg.gauge("sweep.chunks_total").set(4)
    with pkg.span("sweep_pipeline"):
        for i in range(3):
            with pkg.span("dispatch", chunk=i):
                time.sleep(0.01)
            with pkg.span("drain", chunk=i):
                time.sleep(0.03)
            pkg.gauge("sweep.chunks_done").set(i + 1)
    rec = pkg.flightrec.active()
    assert _wait_for(lambda: len(rec.series.snapshot()["series"]) > 0, timeout=10)
    time.sleep(0.1)
    rec.stop(finished=False)
    pkg.finish_capture()


SECTIONS = ("utilization (stage occupancy):", "series (sampled by the flight recorder):",
            "latency percentiles", "slo (error budgets", "run did not finish cleanly")


def test_either_packages_report_renders_the_others_live_capture(tmp_path):
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    _unfinished_capture(tobs, dirs["port"])
    _unfinished_capture(jobs, dirs["jax"])
    for reader, d in ((treport, dirs["jax"]), (jreport, dirs["port"]),
                      (treport, dirs["port"])):
        text = reader.render_report(str(d))
        for section in SECTIONS:
            assert section in text, (reader.__name__, d.name, section)
    # and the JSON aggregate carries the same blocks
    doc = json.loads(treport.render_report(str(dirs["jax"]), as_json=True))
    assert doc["utilization"]["bottleneck"] and doc["progress"]["finished"] is False
    assert doc["slo"]["objectives"]["lat"]["events"] == 3


# ------------------------------------------------------------ the server

def _served_under_capture(pkg_obs, lk, inject, d, bank, batch, recipe, design, device):
    """One stalled first request, two admitted that expire, two rejected
    past ``max_queue``: the capture's events and the server's stats."""
    pkg_obs.start_capture(str(d), heartbeat_interval_s=0.02, crash_hooks=False)
    try:
        server = lk.LikelihoodServer(lk.RealizationBank.from_array(bank), batch, recipe,
                                     ("gwb_gamma",), design=design, max_batch=1,
                                     max_delay_s=0.0, max_queue=2, request_deadline_s=0.1,
                                     **device).start()
        inject.arm("likelihood_batch:stall=0.4@call=1")
        futures, rejected = [], 0
        try:
            futures.append(server.submit(gwb_gamma=4.0))
            assert _wait_for(lambda: bool(inject.fired()), timeout=30)
            for g in (4.1, 4.2, 4.3, 4.4):
                try:
                    futures.append(server.submit(gwb_gamma=g))
                except lk.ServerSaturated:
                    rejected += 1
        finally:
            server.stop(timeout=60)
            inject.disarm()
        stats = server.stats()
    finally:
        pkg_obs.finish_capture()
    return futures, rejected, stats


def test_the_server_under_a_capture_emits_the_jax_servers_telemetry(tmp_path):
    batch, recipe, res, (tb, tr) = _case("base")
    bank = np.stack([res, 0.5 * res, -1.5 * res])
    design = _design(batch)
    runs = {
        "port": _served_under_capture(tobs, tlk, tinject, tmp_path / "port", bank, tb, tr,
                                      design, {"device": "cpu"}),
        "jax": _served_under_capture(jobs, jlk, jinject, tmp_path / "jax", bank, batch,
                                     recipe, design, {}),
    }
    caps = {k: treport.load_telemetry(str(tmp_path / k)) for k in runs}
    request_spans = ("likelihood_submit", "likelihood_queue_wait", "likelihood_resolve",
                     "likelihood_batch", "likelihood_serve")

    def by_name(cap):
        out = {}
        for rec in cap["events"]:
            if rec.get("type") == "span" and rec["name"] in request_spans:
                out.setdefault(rec["name"], []).append(rec)
        return out

    spans = {k: by_name(c) for k, c in caps.items()}
    counts = {k: {n: len(v) for n, v in s.items()} for k, s in spans.items()}
    assert counts["port"] == counts["jax"] == {
        "likelihood_submit": 5, "likelihood_queue_wait": 3, "likelihood_resolve": 1,
        "likelihood_batch": 1, "likelihood_serve": 1}
    for k, (futures, rejected, stats) in runs.items():
        assert rejected == 2 and len(futures) == 3
        assert futures[0].result(timeout=30).shape == (3,)
        assert all(isinstance(f.exception(timeout=30), Exception) for f in futures[1:])
        # one trace a request: each queue wait and resolution in a submitted trace
        submitted = {r["trace_id"] for r in spans[k]["likelihood_submit"]}
        assert len(submitted) == 5
        assert {r["trace_id"] for r in spans[k]["likelihood_queue_wait"]} <= submitted
        assert spans[k]["likelihood_batch"][0]["links"] == [futures[0].trace_id]
        assert spans[k]["likelihood_resolve"][0]["trace_id"] == futures[0].trace_id
    likelihood_metrics = {k: {n: c["metrics"][n][0].get("value")
                              for n in c["metrics"]
                              if n.startswith(("likelihood.", "trace."))}
                          for k, c in caps.items()}
    assert likelihood_metrics["port"] == likelihood_metrics["jax"]
    assert likelihood_metrics["port"]["likelihood.requests"] == 3
    assert likelihood_metrics["port"]["likelihood.rejected"] == 2
    assert likelihood_metrics["port"]["likelihood.deadline_expired"] == 2
    kinds = {k: sorted(r["name"] for r in c["events"] if r.get("type") == "event"
                       and r["name"].startswith("likelihood."))
             for k, c in caps.items()}
    assert kinds["port"] == kinds["jax"] == ["likelihood.deadline_expired"] * 2 + \
        ["likelihood.rejected"] * 2
    stats = {k: r[2] for k, r in runs.items()}
    assert set(stats["port"]) == set(stats["jax"])
    assert set(stats["port"]["latency"]) == set(stats["jax"]["latency"])
    assert set(stats["port"]["batch_fill"]) == set(stats["jax"]["batch_fill"])
    assert (stats["port"]["requests"], stats["port"]["rejected"],
            stats["port"]["deadline_expired"]) == (1, 2, 2)
    tserved = tlk.LikelihoodServer(tlk.RealizationBank.from_array(bank), tb, tr, ("gwb_gamma",),
                                   design=design, device="cpu")
    tserved.reset_stats()
    assert tserved.stats()["latency"] == {"count": 0}


@pytest.mark.parametrize("values", [[], [1.0], [3.0, 3.0, 3.0], list(range(50)),
                                    [0.5, -2.0, 7.25, 1e6, 3.0]])
def test_sparklines_equal_the_jax_reports(values):
    assert treport.sparkline(values) == jreport.sparkline(values)
    assert treport.sparkline(values, width=7) == jreport.sparkline(values, width=7)


def test_the_live_sections_render_as_the_jax_reports(tmp_path, capsys):
    """Each new renderer on the same loaded capture: the JAX text, line
    for line (heartbeat, SLO, series, percentiles, utilization, the
    postmortem's body but for its directory line)."""
    d = tmp_path / "cap"
    _unfinished_capture(tobs, d)
    tobs.REGISTRY.reset()
    rec_dir = tmp_path / "pm"
    rec = tflightrec.FlightRecorder(str(rec_dir), stall_timeout_s=None)
    rec._on_record({"type": "span", "name": "drain", "path": "sweep_pipeline/drain",
                    "t0": 5.0, "wall_s": 0.25, "cpu_s": 0.0, "tid": 1, "seq": 0, "attrs": {}})
    rec.write_postmortem("SIGTERM")
    data = treport.load_telemetry(str(d))
    hb, slo, series = data["progress"], data["slo"], data["series"]
    assert treport.render_heartbeat(hb) == jreport.render_heartbeat(hb)
    assert treport.render_slo(slo) == jreport.render_slo(slo) != ""
    assert (treport.render_series(series, trends=hb["trends"])
            == jreport.render_series(series, trends=hb["trends"]) != "")
    assert treport.render_percentiles(series) == jreport.render_percentiles(series) != ""
    util = tocc.analyze(data["events"])
    assert treport.render_utilization(util) == jreport.render_utilization(util)
    got = treport.render_postmortem(str(rec_dir)).splitlines()[1:]
    want = jreport.render_postmortem(str(rec_dir)).splitlines()[1:]
    assert got == want and any("reason: SIGTERM" in line for line in got)
