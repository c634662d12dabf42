"""The port's device profiling (``pta_replicator_tpu_torch/obs/devprof.py``)
on the CPU: ``device_trace(device="cpu")`` writes and registers its chrome
trace and refuses a nested session and a missing capture; ``roofline``,
``classify`` and ``peak_for`` equal the JAX module's on the same numbers;
the kernel counts ``chip_smoke.py`` bounds its kernels with give the
numbers they gave there; the tuner records the Woodbury kernel's cost and
roofline; and ``realize --telemetry DIR --device-trace`` through the CLI
leaves a capture the JAX checker and either package's timeline read."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.obs import devprof as jdevprof
from pta_replicator_tpu.obs import metrics as jmetrics
from pta_replicator_tpu.obs import timeline as jtimeline
from pta_replicator_tpu_torch import obs
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.likelihood import tuner
from pta_replicator_tpu_torch.obs import devprof, names, timeline
from pta_replicator_tpu_torch.obs.report import render_report
from pta_replicator_tpu_torch.ops import cw
from pta_replicator_tpu_torch.ops import gp as ops_gp
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe

from _torch_dataset import small_pulsars, write_with

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(None)
    obs.reset_all()
    yield
    obs.configure(None)
    obs.reset_all()


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        str(Path(__file__).resolve().parent.parent / "scripts" / "check_telemetry_schema.py"))
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    return checker


# ------------------------------------------------------ the device trace

def test_a_cpu_device_trace_is_written_and_registered(tmp_path):
    d = tmp_path / "cap"
    obs.start_capture(str(d), flight_recorder=False)
    try:
        with devprof.device_trace(device="cpu") as logdir:
            torch.ones(16).sum()
        assert logdir == str(d / "device_trace")
    finally:
        obs.finish_capture()
        obs.configure(None)
    meta = json.loads((d / "meta.json").read_text())
    assert meta["device_traces"] == ["device_trace"]
    trace = json.loads((d / "device_trace" / devprof.trace_file_name()).read_text())
    names_seen = {e.get("name") for e in trace["traceEvents"]}
    assert devprof.OPEN_MARKER in names_seen and "aten::sum" in names_seen
    assert devprof.trace_file_name().endswith(".pt.trace.json")
    events = [json.loads(line) for line in (d / "events.jsonl").read_text().splitlines()]
    span = next(e for e in events if e.get("name") == names.SPAN_DEVICE_TRACE)
    done = next(e for e in events if e.get("name") == names.EVENT_DEVICE_TRACE)
    assert span["attrs"]["t_wall_open"] <= span["attrs"]["t_wall_close"]
    assert done["attrs"]["logdir"] == str(d / "device_trace")
    assert _checker().validate_device_traces(str(d)) == []
    # a new capture forgets the last one's traces
    obs.start_capture(str(tmp_path / "next"), flight_recorder=False)
    obs.finish_capture()
    assert "device_traces" not in json.loads((tmp_path / "next" / "meta.json").read_text())


def test_device_trace_refuses_nesting_a_missing_capture_and_a_missing_card(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with pytest.raises(ValueError, match="no telemetry capture is active"):
        with devprof.device_trace(device="cpu"):
            pass
    with devprof.device_trace(str(tmp_path / "outer"), device="cpu"):
        with pytest.raises(RuntimeError, match="does not nest"):
            with devprof.device_trace(str(tmp_path / "inner"), device="cpu"):
                pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="does not nest"):
            with devprof.device_trace(str(tmp_path / "inside"), device="cpu"):
                pass
    assert devprof.trace_dirs() == [str(tmp_path / "outer")]
    assert not (tmp_path / "inner").exists() and not (tmp_path / "inside").exists()
    # after a refusal the next session starts
    with devprof.device_trace(str(tmp_path / "after"), device="cpu"):
        pass
    assert (tmp_path / "after" / devprof.trace_file_name()).exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with devprof.device_trace(str(tmp_path / "card")):
                pass


def test_trace_dirs_relativize_inside_the_capture(tmp_path):
    devprof.reset()
    inside, outside = str(tmp_path / "cap" / "device_trace"), str(tmp_path / "elsewhere")
    for logdir in (inside, outside):
        with devprof.device_trace(logdir, device="cpu"):
            pass
    assert devprof.trace_dirs() == [inside, outside]
    assert devprof.trace_dirs(relative_to=str(tmp_path / "cap")) == ["device_trace", outside]
    devprof.reset()
    assert devprof.trace_dirs() == []


# ---------------------------------------------------------- the roofline

ROOFLINE_CASES = [
    dict(flops=2.0e12, bytes_accessed=1.0e10, elapsed_s=0.5, calls=3),
    dict(flops=5.0e9, bytes_accessed=8.0e9, elapsed_s=1e-3, calls=1),
    dict(flops=1.0e9, elapsed_s=2e-3, calls=2),
    dict(flops=0.0, bytes_accessed=1.0, elapsed_s=1.0),
]


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
@pytest.mark.parametrize("peaks", [None, ("67e12", "3.35e12"), ("989e12", "3.35e12")])
def test_roofline_classify_and_peak_for_equal_the_jax_modules(monkeypatch, case, peaks):
    if peaks is not None:
        monkeypatch.setenv("DEVPROF_PEAK_FLOPS", peaks[0])
        monkeypatch.setenv("DEVPROF_PEAK_BYTES_PER_S", peaks[1])
    kw = ROOFLINE_CASES[case]
    assert devprof.peak_for("some card") == jdevprof.peak_for("some card")
    got = devprof.roofline("k", device_kind="some card", **kw)
    want = jdevprof.roofline("k", device_kind="some card", **kw)
    assert got == want
    if "ridge_intensity" in got:
        assert devprof.classify(got["intensity_flop_per_byte"], got["ridge_intensity"]) == \
            jdevprof.classify(want["intensity_flop_per_byte"], want["ridge_intensity"])
    # the gauges carry the same numbers under the port's names
    for key, val in got.items():
        if key != "bound":
            assert obs.gauge(f"cuda.roofline.{key}", label="k").value == val
            assert jmetrics.REGISTRY.gauge(f"jax.roofline.{key}", label="k").value == val


def test_peak_for_reads_the_h100_row_by_dtype(monkeypatch):
    monkeypatch.delenv("DEVPROF_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DEVPROF_PEAK_BYTES_PER_S", raising=False)
    assert devprof.peak_for(H100) == (67e12, 3.35e12)
    assert devprof.peak_for(H100, torch.float32) == (67e12, 3.35e12)
    assert devprof.peak_for(H100, "bfloat16") == (989e12, 3.35e12)
    assert devprof.peak_for(H100, torch.int8) is None
    assert devprof.peak_for("cpu") is None
    assert devprof.classify(10.0, 20.0) == "memory-bound"
    assert devprof.classify(20.0, 20.0) == "compute-bound"
    # a half-set override warns and falls back, as the JAX module does
    monkeypatch.setenv("DEVPROF_PEAK_FLOPS", "1e12")
    with pytest.warns(UserWarning, match="both env vars are required"):
        assert devprof.peak_for(H100) == (67e12, 3.35e12)


def test_record_kernel_cost_sets_the_cuda_cost_gauges():
    cost = devprof.record_kernel_cost("cw_catalog_response", 1.5e9, 2.5e8)
    assert cost == {"flops": 1.5e9, "bytes_accessed": 2.5e8}
    assert obs.gauge("cuda.cost.flops", label="cw_catalog_response").value == 1.5e9
    assert obs.gauge("cuda.cost.bytes_accessed", label="cw_catalog_response").value == 2.5e8
    assert names.is_registered("cuda.cost.flops", "metric")


# ------------------------------------------------------ the kernel counts

@pytest.mark.parametrize("npsr,ntoa,nsrc,itemsize,psr_term,evolve", [
    (68, 7758, 100, 4, True, True), (68, 7758, 10_000, 8, True, True),
    (68, 7758, 3000, 4, False, False), (3, 64, 2, 8, False, True),
])
def test_the_cw_counts_are_the_ones_chip_smoke_bounded_with(npsr, ntoa, nsrc, itemsize,
                                                            psr_term, evolve):
    # the formulas chip_smoke.py's cw_bound held before they moved
    ops = cw.OPS_PER_ELEMENT[(psr_term, evolve)] * npsr * ntoa * nsrc
    nbytes = itemsize * (2 * npsr * ntoa + cw.NC_SRC * nsrc + cw.NC_PSR * npsr * nsrc)
    assert cw.cw_catalog_operations(npsr, ntoa, nsrc, psr_term, evolve) == ops
    assert cw.cw_catalog_bytes(npsr, ntoa, nsrc, itemsize) == nbytes
    # the flagship's f32 bound: 0.0787 ms of operations (PERF.md's table)
    if (npsr, ntoa, nsrc, itemsize) == (68, 7758, 100, 4):
        assert ops == 5_275_440_000 and round(ops / 67e12 * 1e3, 4) == 0.0787


@pytest.mark.parametrize("npsr,ntoa,q,itemsize,precision", [
    (68, 7758, 123, 8, "highest"), (68, 7758, 123, 4, "highest"), (68, 7758, 183, 8, "highest"),
    (68, 7758, 123, 8, "bf16"), (68, 7758, 286, 4, "bf16"), (2, 16, 3, 8, "highest"),
])
def test_the_woodbury_bytes_are_the_ones_chip_smoke_bounded_with(npsr, ntoa, q, itemsize,
                                                                 precision):
    # chip_smoke.py's woodbury_bound and woodbury_bf16_bound before the move
    if precision == "bf16":
        want = itemsize * (npsr * ntoa * q + 2 * npsr * ntoa) + 4 * (npsr * q * q + npsr * q
                                                                     + npsr)
    else:
        want = itemsize * (npsr * ntoa * q + 2 * npsr * ntoa + npsr * q * q + npsr * q + npsr)
    assert ops_gp.woodbury_bytes(npsr, ntoa, q, itemsize, precision) == want
    # the flagship f64 bound: 0.160 ms of bytes (PERF.md's table)
    if (q, itemsize, precision) == (123, 8, "highest"):
        assert round(want / 3.35e12 * 1e3, 3) == 0.160


def test_the_tuner_records_the_woodbury_cost_and_roofline(tmp_path, monkeypatch):
    monkeypatch.setenv("DEVPROF_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("DEVPROF_PEAK_BYTES_PER_S", "1e13")
    gen = torch.Generator().manual_seed(0)
    T = torch.randn((3, 96, 5), generator=gen, dtype=torch.float64)
    w, r = torch.ones(T.shape[:2], dtype=T.dtype), torch.zeros(T.shape[:2], dtype=T.dtype)
    choice = tuner.autotune(T, w, r, candidates=(32, 64), reps=1, write=False,
                            cache_path=str(tmp_path / "c.json"))
    assert [s["tile"] for s in choice["scored"]] == [32, 64]
    flops = obs.gauge("cuda.cost.flops", label="fused_woodbury_update").value
    assert flops == ops_gp.woodbury_operations(3, 96, 5)
    assert obs.gauge("cuda.cost.bytes_accessed", label="fused_woodbury_update").value == \
        ops_gp.woodbury_bytes(3, 96, 5, 8)
    for s in choice["scored"]:
        label = f"fused_woodbury_update[tile={s['tile']}]"
        rate = obs.gauge("cuda.roofline.flops_per_s", label=label).value
        assert rate == pytest.approx(flops / s["seconds"])
        assert 0 < obs.gauge("cuda.roofline.pct_of_roofline", label=label).value


# ------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("devprof_cli")
    pardir, timdir = write_with(tsim, small_pulsars(), str(root))
    (root / "r.json").write_text(json.dumps(ng15_like_recipe(4, ncw=1, gwb_npts=100,
                                                             gwb_howml=4.0)))
    return root, ["--pardir", pardir, "--timdir", timdir, "--recipe", str(root / "r.json"),
                  "--nreal", "8", "--chunk", "4", "--fit", "--device", "cpu"]


def test_realize_device_trace_leaves_a_capture_either_package_merges(dataset, capsys):
    root, common = dataset
    d = root / "tel"
    main(["realize", *common, "--out", str(root / "o.npz"), "--checkpoint",
          str(root / "ck.npz"), "--telemetry", str(d), "--device-trace"])
    capsys.readouterr()
    meta = json.loads((d / "meta.json").read_text())
    assert meta["device_traces"] == ["device_trace"]
    assert (d / "device_trace" / devprof.trace_file_name()).exists()
    assert _checker().main([str(d)]) == 0
    capsys.readouterr()
    events = [json.loads(line) for line in (d / "events.jsonl").read_text().splitlines()]
    paths = {e["path"] for e in events if e.get("type") == "span"}
    assert "realize/device_trace" in paths
    assert "realize/device_trace/compute/sweep_pipeline/dispatch" in paths
    got, want = timeline.build_timeline(str(d)), jtimeline.build_timeline(str(d))
    assert got["otherData"]["device_events"] == want["otherData"]["device_events"] > 0
    assert got["otherData"]["flow_events"] == 3 * 2
    text = render_report(str(d))
    assert "device trace: device_trace (torch.profiler chrome trace" in text
    assert "critical path (attribution over the phase window):" in text
    # the outputs are the same bytes as without the trace
    main(["realize", *common, "--out", str(root / "plain.npz"), "--checkpoint",
          str(root / "plain_ck.npz")])
    capsys.readouterr()
    with np.load(root / "o.npz") as a, np.load(root / "plain.npz") as b:
        np.testing.assert_array_equal(a["residuals"], b["residuals"])
