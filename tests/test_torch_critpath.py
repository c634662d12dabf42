"""The port's critical-path attribution (``pta_replicator_tpu_torch/obs/
critpath.py``) against the JAX module on the CPU: ``analyze`` and
``render_critpath`` equal on the JAX tests' schedules (queue-wait and
window blocking, stragglers, reruns in any record order), and on a real
capture of a three-chunk sweep of the port, which either package's
``analyze_capture`` attributes alike; the ``critpath`` subcommand, the
``/critpath`` route and the report's section."""
import importlib.util
import json
import os
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.obs import critpath as jcritpath
from pta_replicator_tpu.obs.trace import chunk_trace_context as jax_chunk_trace_context
from pta_replicator_tpu_torch import obs
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.obs import critpath, names
from pta_replicator_tpu_torch.obs.report import render_report
from pta_replicator_tpu_torch.obs.serve import serve_directory, serve_url
from pta_replicator_tpu_torch.scenarios.compile import flagship_workload
from pta_replicator_tpu_torch.utils.sweep import sweep

NCHUNKS, CHUNK = 3, 4


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(None)
    obs.reset_all()
    yield
    obs.configure(None)
    obs.reset_all()


def _span(name, t0, wall, **attrs):
    rec = {"type": "span", "name": name, "path": name, "t0": t0, "wall_s": wall,
           "cpu_s": wall, "tid": 1, "seq": 0}
    if attrs:
        rec["attrs"] = attrs
    return rec


def _chunked_schedule():
    """The JAX tests' two-chunk schedule: chunk 1 admitted 4 s after chunk
    0's dispatch ended, with 0.5 s of queue-wait before its drain."""
    return [
        _span(names.SPAN_SWEEP_PIPELINE, 0.0, 10.0),
        _span(names.SPAN_DISPATCH, 0.0, 1.0, chunk=0),
        _span(names.SPAN_DRAIN, 1.0, 2.0, chunk=0),
        _span(names.SPAN_IO_WRITE, 3.0, 1.0, chunk=0),
        _span(names.SPAN_DISPATCH, 5.0, 1.0, chunk=1),
        _span(names.SPAN_DRAIN, 6.5, 2.5, chunk=1),
        _span(names.SPAN_IO_WRITE, 9.0, 1.0, chunk=1),
    ]


def _skewed():
    """Four devices' staging spans, one 1.6x the others' busy time."""
    return [_span(names.SPAN_SWEEP_PIPELINE, 0.0, 4.0)] + [
        _span(names.SPAN_CW_STREAM_STAGE, i * 0.1, busy, device=dev)
        for i, (dev, busy) in enumerate((("d0", 1.0), ("d1", 1.0), ("d2", 1.0),
                                         ("d3", 1.6)))
    ]


def _balanced():
    return [_span(names.SPAN_SWEEP_PIPELINE, 0.0, 4.0)] + [
        _span(names.SPAN_CW_STREAM_STAGE, i * 0.1, 1.0, device=f"d{i}") for i in range(4)
    ]


def _nested_and_fused():
    """A fused schedule (static_build first) with a window-less stage
    extent, a retried chunk (two drains) and a nested-stage span."""
    return [
        _span(names.SPAN_STATIC_BUILD, 0.0, 0.4, chunk=0),
        _span(names.SPAN_DISPATCH, 0.4, 0.3, chunk=0),
        _span(names.SPAN_DRAIN, 0.7, 0.5, chunk=0),
        _span(names.SPAN_DRAIN, 1.5, 0.5, chunk=0),
        _span(names.SPAN_IO_WRITE, 2.0, 0.2, chunk=0),
        _span(names.SPAN_STATIC_BUILD, 0.4, 0.4, chunk=1),
        _span(names.SPAN_DISPATCH, 0.8, 0.3, chunk=1),
        _span(names.SPAN_DRAIN, 2.0, 0.4, chunk=1),
        _span(names.SPAN_IO_WRITE, 2.4, 0.2, chunk=1),
        _span(names.SPAN_CW_STREAM_STAGE, 0.1, 0.2),
    ]


SCHEDULES = {"chunked": _chunked_schedule, "reversed": lambda: _chunked_schedule()[::-1],
             "skewed": _skewed, "balanced": _balanced, "fused": _nested_and_fused,
             "empty": lambda: [_span("unrelated", 0.0, 1.0)]}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_analyze_and_render_equal_the_jax_modules(name):
    events = SCHEDULES[name]()
    got, want = critpath.analyze(events), jcritpath.analyze(events)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if got is not None:
        assert critpath.render_critpath(got) == jcritpath.render_critpath(want)
        window, exclusive = critpath.critical_intervals(events)
        assert (window, exclusive) == jcritpath.critical_intervals(events)


def test_chunk_chain_queue_wait_and_window_blocking():
    doc = critpath.analyze(_chunked_schedule())
    chunks = doc["chunks"]
    assert chunks["count"] == 2
    assert chunks["queue_wait_s"] == {names.SPAN_DRAIN: 0.5}
    assert chunks["blocked_on_window_s"] == pytest.approx(4.0)
    assert chunks["bottleneck_fraction"] == {names.SPAN_DRAIN: 1.0}
    assert doc["verdict"]["bottleneck"] == names.SPAN_DRAIN
    assert doc["stages"][names.SPAN_DRAIN]["critical_s"] == pytest.approx(4.5)
    assert doc["schema_version"] == critpath.CRITPATH_SCHEMA_VERSION == \
        jcritpath.CRITPATH_SCHEMA_VERSION


def test_stragglers_on_a_skewed_device_schedule():
    dev = critpath.analyze(_skewed())["devices"]
    assert dev["straggler_ratio"] == pytest.approx(1.6) and dev["stragglers"] == ["d3"]
    dev = critpath.analyze(_balanced())["devices"]
    assert dev["straggler_ratio"] == pytest.approx(1.0) and dev["stragglers"] == []


def test_verdict_stable_across_byte_identical_reruns():
    events = _chunked_schedule()
    a = json.dumps(critpath.analyze(events), sort_keys=True)
    b = json.dumps(critpath.analyze(events), sort_keys=True)
    c = json.dumps(critpath.analyze(list(reversed(events))), sort_keys=True)
    assert a == b == c


def _schema_checker():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        str(Path(__file__).resolve().parent.parent / "scripts" / "check_telemetry_schema.py"))
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    return checker


@pytest.fixture(scope="module")
def sweep_capture(tmp_path_factory):
    """A real capture of a three-chunk port sweep at depth 2 on the CPU."""
    root = tmp_path_factory.mktemp("critpath")
    d, ck = str(root / "cap"), str(root / "ck.npz")
    b, r = flagship_workload(npsr=3, ntoa=128, ncw=2, dtype=torch.float64, device="cpu")
    obs.configure(None)
    obs.reset_all()
    obs.start_capture(d, flight_recorder=False)
    try:
        sweep(3, b, r, NCHUNKS * CHUNK, ck, chunk=CHUNK, fit=True, pipeline_depth=2,
              device="cpu")
    finally:
        obs.finish_capture()
        obs.configure(None)
        obs.reset_all()
    return d, ck


def test_a_port_capture_attributes_alike_in_either_package(sweep_capture):
    d, ck = sweep_capture
    got, want = critpath.analyze_capture(d), jcritpath.analyze_capture(d)
    assert got.pop("analyzer")["overhead_s"] >= 0 and "analyzer" in want
    want.pop("analyzer")
    assert got == want
    assert got["chunks"]["count"] == NCHUNKS
    assert got["chunks"]["trace_coherent_fraction"] == 1.0
    assert {names.SPAN_DISPATCH, names.SPAN_DRAIN, names.SPAN_IO_WRITE} <= set(got["stages"])
    # each chunk's chain is one trace: the JAX package's id for the scope
    with open(os.path.join(d, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    chains = {}
    for e in events:
        if e.get("name") in critpath.CHUNK_STAGES and "chunk" in e.get("attrs", {}):
            chains.setdefault(e["attrs"]["chunk"], set()).add((e["name"], e["trace_id"]))
    assert sorted(chains) == list(range(NCHUNKS))
    for i, chain in chains.items():
        want_id = jax_chunk_trace_context(ck, i).trace_id
        assert chain == {(s, want_id) for s in ("dispatch", "drain", "io_write")}
    # the decomposition closes
    wall = got["window"]["wall_s"]
    critical = sum(s["critical_s"] for s in got["stages"].values())
    assert critical + got["blocked_s"] == pytest.approx(wall, abs=1e-5)


def test_the_critpath_subcommand_writes_a_document_the_jax_checker_accepts(
        sweep_capture, tmp_path, capsys):
    d, _ = sweep_capture
    out = str(tmp_path / "cp.json")
    main(["critpath", d, "--out", out])
    text = capsys.readouterr()
    assert text.out.startswith("critical path (attribution over the phase window):")
    assert f"critpath: wrote {out}" in text.err
    doc = json.loads(Path(out).read_text())
    assert doc["chunks"]["count"] == NCHUNKS
    main(["critpath", d, "--json", "--out", out])
    printed = json.loads(capsys.readouterr().out)
    assert printed["verdict"] == doc["verdict"]
    checker = _schema_checker()
    assert checker.validate_critpath_file(out) == []
    # a capture without stage spans: exit 2, nothing written
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "events.jsonl").write_text(json.dumps(_span("unrelated", 0.0, 1.0)) + "\n")
    with pytest.raises(SystemExit) as exc:
        main(["critpath", str(empty)])
    assert exc.value.code == 2 and not (empty / "critpath.json").exists()
    capsys.readouterr()


def test_critpath_route_and_report_round_trip(tmp_path):
    d = tmp_path / "cap"
    d.mkdir()
    (d / "events.jsonl").write_text("".join(json.dumps(r) + "\n" for r in _chunked_schedule()))
    # no artifact yet: the report attributes from the events
    out = render_report(str(d))
    assert "critical path (attribution over the phase window):" in out
    assert "verdict:" in out and names.SPAN_DRAIN in out
    path = critpath.write_critpath(str(d))
    doc = json.loads(Path(path).read_text())
    as_json = json.loads(render_report(str(d), as_json=True))
    assert as_json["critpath"]["verdict"]["bottleneck"] == names.SPAN_DRAIN
    # a document from a newer writer is not misread: re-derived instead
    newer = dict(doc, schema_version=critpath.CRITPATH_SCHEMA_VERSION + 1,
                 verdict={"summary": "from the future", "ranked": []})
    (d / "critpath.json").write_text(json.dumps(newer))
    assert "from the future" not in render_report(str(d))
    (d / "critpath.json").write_text(json.dumps(doc))
    server = serve_directory(str(d), 0, background=True)
    try:
        with urllib.request.urlopen(serve_url(server, "/critpath"), timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "application/json"
            assert json.loads(resp.read()) == doc
        with urllib.request.urlopen(serve_url(server, "/"), timeout=5) as resp:
            assert "/critpath" in json.loads(resp.read())["endpoints"]
    finally:
        server.shutdown()
        server.server_close()


def test_analyze_capture_times_itself_and_sets_the_gauges(sweep_capture):
    d, _ = sweep_capture
    doc = critpath.analyze_capture(d)
    assert doc["analyzer"]["overhead_s"] >= 0
    assert obs.gauge(names.CRITPATH_CHUNKS).value == NCHUNKS
    assert obs.gauge(names.CRITPATH_STRAGGLERS).value == 0
    spans = [e for e in obs.TRACER.events() if e.get("name") == names.SPAN_CRITPATH_ANALYZE]
    assert len(spans) == 1
    assert critpath.analyze_capture(str(Path(d) / "missing")) is None
