"""The port's merged host and device timeline (``pta_replicator_tpu_torch/
obs/timeline.py``) against the JAX module on the CPU: the same capture
directory gives the same host events, chunk flows, critical-path track
and ``otherData``; a synthetic ``*.trace.json`` without the open marker is
anchored as the JAX module anchors it; a CPU ``device_trace`` capture is
anchored on its open marker, and the JAX module merges it too."""
import json
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.obs import timeline as jtimeline
from pta_replicator_tpu_torch import obs
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.obs import critpath, devprof, names, timeline
from pta_replicator_tpu_torch.scenarios.compile import flagship_workload
from pta_replicator_tpu_torch.utils.sweep import sweep

NCHUNKS, CHUNK = 3, 4
#: the merged document's device processes (obs/timeline.py)
DEVICE_PID_BASE = 1 << 21


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(None)
    obs.reset_all()
    yield
    obs.configure(None)
    obs.reset_all()


def _capture(directory, ck, traced=False):
    """A three-chunk depth-2 port sweep on the CPU captured into
    ``directory``, under a CPU ``device_trace`` when ``traced``."""
    import contextlib

    b, r = flagship_workload(npsr=3, ntoa=128, ncw=2, dtype=torch.float64, device="cpu")
    obs.start_capture(str(directory), flight_recorder=False)
    try:
        with devprof.device_trace(device="cpu") if traced else contextlib.nullcontext():
            sweep(3, b, r, NCHUNKS * CHUNK, str(ck), chunk=CHUNK, fit=True, pipeline_depth=2,
                  device="cpu")
    finally:
        obs.finish_capture()
        obs.configure(None)
        obs.reset_all()


@pytest.fixture(scope="module")
def host_capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("timeline_host")
    _capture(root / "cap", root / "ck.npz")
    critpath.write_critpath(str(root / "cap"))
    return str(root / "cap")


@pytest.fixture(scope="module")
def traced_capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("timeline_traced")
    _capture(root / "cap", root / "ck.npz", traced=True)
    return str(root / "cap")


def _host_part(doc):
    return [e for e in doc["traceEvents"] if not (isinstance(e.get("pid"), int)
                                                  and e["pid"] >= DEVICE_PID_BASE)]


def _device_part(doc):
    return [e for e in doc["traceEvents"] if isinstance(e.get("pid"), int)
            and e["pid"] >= DEVICE_PID_BASE]


def test_host_events_flows_and_the_critical_path_equal_the_jax_modules(host_capture):
    got, want = timeline.build_timeline(host_capture), jtimeline.build_timeline(host_capture)
    assert got == want
    other = got["otherData"]
    assert other["host_spans"] > 0 and other["critpath_slices"] > 0
    assert other["device_events"] == 0 and other["problems"] == []
    # one flow chain a chunk: dispatch -> drain -> io_write
    chunks = {}
    for e in got["traceEvents"]:
        if e.get("cat") == "chunk":
            chunks.setdefault(e["id"], []).append(e["ph"])
    assert chunks == {i: ["s", "t", "f"] for i in range(NCHUNKS)}
    assert other["flow_events"] == 3 * NCHUNKS
    tracks = [e["args"]["name"] for e in got["traceEvents"] if e.get("name") == "thread_name"]
    assert "critical path" in tracks
    assert {"stage:dispatch", "stage:drain", "stage:io_write"} <= set(tracks)


def _synthetic(tmp_path, marker):
    """A capture dir with one device_trace span and a registered trace of
    three events; with ``marker`` the open marker sits 0.25 ms after the
    trace's earliest event."""
    d = tmp_path / "cap"
    (d / "device_trace").mkdir(parents=True)
    wall_open = 1_700_000_000.5
    events = [
        {"type": "meta", "pid": 4242},
        {"type": "span", "name": names.SPAN_DEVICE_TRACE, "path": names.SPAN_DEVICE_TRACE,
         "t0": wall_open - 0.01, "wall_s": 1.0, "cpu_s": 0.1, "tid": 1, "seq": 0,
         "attrs": {"logdir": str(d / "device_trace"), "t_wall_open": wall_open}},
    ]
    (d / "events.jsonl").write_text("".join(json.dumps(e) + "\n" for e in events))
    (d / "meta.json").write_text(json.dumps({"device_traces": ["device_trace"]}))
    trace = [{"name": "process_name", "ph": "M", "pid": 7, "args": {"name": "gpu"}},
             {"name": "kernel_a", "ph": "X", "ts": 1000.0, "dur": 5.0, "pid": 7, "tid": 1},
             {"name": "kernel_b", "ph": "X", "ts": 1400.0, "dur": 5.0, "pid": "Spans", "tid": 2}]
    if marker:
        trace.append({"name": devprof.OPEN_MARKER, "ph": "X", "ts": 1250.0, "dur": 1.0,
                      "pid": 7, "tid": 3})
    (d / "device_trace" / "host.1.pt.trace.json").write_text(json.dumps({"traceEvents": trace}))
    return str(d), wall_open


def _unlabeled(events):
    """``events`` with the process label of the merged trace's origin
    dropped (the port labels its traces torch.profiler:, the JAX module
    xla:)."""
    return [e for e in events if e.get("name") != "process_labels"]


def test_a_trace_without_the_open_marker_is_anchored_as_jax_anchors_it(tmp_path):
    d, wall_open = _synthetic(tmp_path, marker=False)
    got, want = timeline.build_timeline(d), jtimeline.build_timeline(d)
    assert _host_part(got) == _host_part(want)
    assert _unlabeled(_device_part(got)) == _unlabeled(_device_part(want))
    assert got["otherData"] == want["otherData"]
    stamped = [e for e in _device_part(got) if e.get("ph") == "X"]
    assert min(e["ts"] for e in stamped) == pytest.approx(wall_open * 1e6)
    labels = {e["args"]["labels"] for e in _device_part(got) if e["name"] == "process_labels"}
    assert labels == {"torch.profiler:device_trace"}


def test_the_open_marker_anchors_the_profilers_clock(tmp_path):
    d, wall_open = _synthetic(tmp_path, marker=True)
    got, want = timeline.build_timeline(d), jtimeline.build_timeline(d)
    mine = {e["name"]: e["ts"] for e in _device_part(got) if e.get("ph") == "X"}
    theirs = {e["name"]: e["ts"] for e in _device_part(want) if e.get("ph") == "X"}
    assert mine[devprof.OPEN_MARKER] == pytest.approx(wall_open * 1e6, abs=1e-3)
    # the JAX rule anchors the earliest event instead: 250 us apart
    assert theirs["kernel_a"] == pytest.approx(wall_open * 1e6, abs=1e-3)
    for name in mine:
        assert mine[name] - theirs[name] == pytest.approx(-250.0, abs=1e-3)


def test_a_cpu_device_trace_capture_merges_in_either_package(traced_capture):
    meta = json.loads((Path(traced_capture) / "meta.json").read_text())
    assert meta["device_traces"] == ["device_trace"]
    got, want = timeline.build_timeline(traced_capture), jtimeline.build_timeline(traced_capture)
    assert got["otherData"]["device_events"] == want["otherData"]["device_events"] > 0
    assert got["otherData"]["problems"] == want["otherData"]["problems"] == []
    assert _host_part(got) == _host_part(want)
    # the marker lands on t_wall_open; every device event is shifted by one
    # offset, the JAX rule's plus the profiler's start-up before the marker
    with open(os.path.join(traced_capture, "events.jsonl")) as fh:
        span = next(e for e in map(json.loads, fh) if e.get("name") == names.SPAN_DEVICE_TRACE)
    mine, theirs = _device_part(got), _device_part(want)
    marker = [e for e in mine if e.get("name") == devprof.OPEN_MARKER]
    assert len(marker) == 1
    assert marker[0]["ts"] == pytest.approx(span["attrs"]["t_wall_open"] * 1e6, abs=1.0)
    # (wall-clock microseconds near 1.8e15 carry a float64 ulp of 0.25)
    shifts = [a["ts"] - b["ts"] for a, b in zip(mine, theirs)
              if isinstance(a.get("ts"), (int, float)) and a.get("ph") != "M"]
    assert max(shifts) - min(shifts) <= 1.0 and max(shifts) <= 1.0
    # the profiled operators fall inside the device_trace span
    ops = [e for e in mine if e.get("cat") == "cpu_op"]
    t0, t1 = span["t0"] * 1e6, (span["t0"] + span["wall_s"]) * 1e6
    assert ops and all(t0 <= e["ts"] <= t1 for e in ops)


def test_the_timeline_subcommand_writes_and_summarizes(host_capture, tmp_path, capsys):
    out = str(tmp_path / "tl.json")
    main(["timeline", host_capture, "--out", out])
    summary = json.loads(capsys.readouterr().out)
    assert summary["out"] == out and summary["host_spans"] > 0
    doc = json.loads(Path(out).read_text())
    assert summary["events"] == len(doc["traceEvents"])
    assert doc["otherData"] == timeline.build_timeline(host_capture)["otherData"]
    missing = str(tmp_path / "nope")
    main(["timeline", missing, "--out", str(tmp_path / "empty.json")])
    captured = capsys.readouterr()
    assert json.loads(captured.out)["problems"] and "warning:" in captured.err
