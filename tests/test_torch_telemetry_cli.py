"""``--telemetry DIR`` and ``report DIR`` of ``python -m
pta_replicator_tpu_torch`` against the JAX package's CLI on the CPU, on
the small ragged par/tim dataset of ``_torch_dataset.py``: ``info``,
``realize --fit``, ``realize --checkpoint`` at depth 2 and at depth 1,
``likelihood --grid`` and ``scenario compile`` run through both packages'
``main`` with a capture each. The span paths and calls are equal sets, the
metric names equal after dropping the groups the port does not emit yet,
and the integer counters equal. The JAX package's schema checker validates
a port capture, and each package's loader reads the other's. Outputs are
equal byte for byte with and without a capture; ``scenario fuzz --fast``
records one ``scenario_fuzz_case`` span per counted case; the planted
defect's shrink counts the JAX run's steps; ``report`` renders a capture."""
import importlib.util
import json
import zipfile

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.__main__ import main as jax_main
from pta_replicator_tpu.obs import report as jreport
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.obs import report as treport
from pta_replicator_tpu_torch.scenarios import ScenarioSpec
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe

from _torch_dataset import small_pulsars, write_with

from test_torch_cli import SPEC
from test_torch_fuzz import BASE, PERTURB

#: metric groups left out of the comparison: the JAX package's compile
#: accounting (``jax.*``, which the port does not emit); the port's device
#: accounting (``cuda.cost.*`` and ``cuda.roofline.*``), which only the
#: tuner's search records, on no CLI path; the critical path's gauges
#: (``critpath.*``), which only the ``critpath DIR`` pass after a run sets;
#: and the flight recorder's per-tick metrics (``obs.overhead_s``,
#: ``proc.rss_bytes``), which exist only once its sampler has ticked, in
#: either package
NOT_EMITTED = ("jax.", "cuda.cost.", "cuda.roofline.", "critpath.")
NOT_EMITTED_NAMES = ("obs.overhead_s", "proc.rss_bytes")
#: counters whose values must be equal between the packages
INTEGER_COUNTERS = ("io.par.files", "io.tim.files", "io.tim.toas", "batch.freezes",
                    "batch.toas_frozen", "simulate.pulsars_loaded", "sweep.realizations",
                    "sweep.chunks_total", "scenario.compiled")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The small dataset, a recipe with a one-source CW catalog, the noise
    recipe for the likelihood, the bank the port wrote, and a spec."""
    root = tmp_path_factory.mktemp("telemetry_cli")
    pardir, timdir = write_with(tsim, small_pulsars(), str(root))
    spec = ng15_like_recipe(4, ncw=1, gwb_npts=100, gwb_howml=4.0)
    (root / "r.json").write_text(json.dumps(spec))
    noise = {k: v for k, v in spec.items() if not k.startswith("cgw_")}
    noise["rn_nmodes"] = 10
    (root / "noise.json").write_text(json.dumps(noise))
    common = ["--pardir", pardir, "--timdir", timdir]
    main(["realize", *common, "--recipe", str(root / "r.json"), "--out", str(root / "bank.npz"),
          "--checkpoint", str(root / "bank_ck.npz"), "--nreal", "8", "--chunk", "4", "--fit",
          "--device", "cpu"])
    spec_path = str(root / "s.json")
    ScenarioSpec.from_dict(SPEC).validate().save(spec_path)
    return root, common, spec_path


def _argv(case, root, common, spec_path, tag):
    rec = ["--recipe", str(root / "r.json")]
    sweep = ["--nreal", "8", "--chunk", "4", "--checkpoint", str(root / f"{tag}_ck.npz"), "--fit"]
    return {
        "info": ["info", *common],
        "realize_fit": ["realize", *common, *rec, "--out", str(root / f"{tag}.npz"), "--nreal",
                        "4", "--fit"],
        "realize_depth2": ["realize", *common, *rec, "--out", str(root / f"{tag}.npz"), *sweep],
        "realize_depth1": ["realize", *common, *rec, "--out", str(root / f"{tag}.npz"), *sweep,
                           "--pipeline-depth", "1"],
        "likelihood": ["likelihood", "--bank", str(root / "bank_ck.npz"), "--recipe",
                       str(root / "noise.json"), *common, "--grid",
                       "gwb_log10_amplitude=-14.6:-13.6:3", "--out", str(root / f"{tag}.json")],
        "scenario_compile": ["scenario", "compile", spec_path],
    }[case]


def _metric_names(metrics):
    return {n for n in metrics
            if not n.startswith(NOT_EMITTED) and n not in NOT_EMITTED_NAMES}


def _value(metrics, name):
    return metrics[name][0]["value"]


CASES = ["info", "realize_fit", "realize_depth2", "realize_depth1", "likelihood",
         "scenario_compile"]


@pytest.mark.parametrize("case", CASES)
def test_a_capture_has_the_jax_clis_spans_and_metrics(dataset, tmp_path, case, capsys):
    root, common, spec_path = dataset
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    main(_argv(case, root, common, spec_path, f"{case}_port")
         + ["--device", "cpu", "--telemetry", str(port_dir)])
    jax_main(_argv(case, root, common, spec_path, f"{case}_jax") + ["--telemetry", str(jax_dir)])
    capsys.readouterr()
    got, want = treport.load_telemetry(str(port_dir)), jreport.load_telemetry(str(jax_dir))
    calls = lambda d: {p: a["calls"] for p, a in treport.aggregate_spans(d["events"]).items()}
    assert calls(got) == calls(want)
    assert calls(got)[case.split("_")[0]] == 1
    assert _metric_names(got["metrics"]) == _metric_names(want["metrics"])
    for name in INTEGER_COUNTERS:
        if name in want["metrics"]:
            assert _value(got["metrics"], name) == _value(want["metrics"], name), name
    for fname in ("events.jsonl", "metrics.json", "metrics.prom", "chrome_trace.json",
                  "meta.json"):
        assert (port_dir / fname).exists(), fname
    assert json.loads((port_dir / "meta.json").read_text())["device_memory"] == []


def test_the_jax_schema_checker_and_loaders_read_a_port_capture(dataset, tmp_path, capsys):
    root, common, spec_path = dataset
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    main(_argv("realize_depth2", root, common, spec_path, "x_port")
         + ["--device", "cpu", "--telemetry", str(port_dir)])
    jax_main(_argv("realize_depth2", root, common, spec_path, "x_jax")
             + ["--telemetry", str(jax_dir)])
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        str(__import__("pathlib").Path(__file__).resolve().parent.parent / "scripts"
            / "check_telemetry_schema.py"))
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    assert checker.main([str(port_dir)]) == 0
    capsys.readouterr()
    for d in (port_dir, jax_dir):
        a, b = treport.load_telemetry(str(d)), jreport.load_telemetry(str(d))
        assert a["events"] == b["events"] and a["metrics"] == b["metrics"]
        assert a["meta"] == b["meta"]
        assert treport.aggregate_spans(a["events"]) == jreport.aggregate_spans(b["events"])
    # the port's report renders the JAX capture whole
    text = treport.render_report(str(jax_dir))
    assert "sweep_pipeline" in text and "jax accounting:" in text
    assert "not rendered by the port" not in text
    assert "utilization (stage occupancy):" in text


def _members(path):
    """An npz's members and their stored bytes (the zip's timestamps
    excluded)."""
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("depth", ["1", "2"])
def test_outputs_are_the_same_bytes_with_and_without_a_capture(dataset, tmp_path, capsys,
                                                               depth):
    root, common, _ = dataset
    outs = {}
    for tag, extra in (("plain", []), ("captured", ["--telemetry", str(tmp_path / "t")])):
        ck = tmp_path / f"{tag}_ck.npz"
        main(["realize", *common, "--recipe", str(root / "r.json"), "--out",
              str(tmp_path / f"{tag}.npz"), "--nreal", "8", "--chunk", "4", "--checkpoint",
              str(ck), "--fit", "--pipeline-depth", depth, "--device", "cpu", *extra])
        outs[tag] = (_members(tmp_path / f"{tag}.npz"), _members(ck))
    capsys.readouterr()
    assert outs["captured"] == outs["plain"]


def test_the_report_subcommand_renders_a_capture(dataset, tmp_path, capsys):
    root, common, spec_path = dataset
    d = tmp_path / "cap"
    main(_argv("realize_depth2", root, common, spec_path, "rep") + ["--device", "cpu",
                                                                   "--telemetry", str(d)])
    capsys.readouterr()
    main(["report", str(d)])
    text = capsys.readouterr().out
    assert "sweep_pipeline" in text and "sweep.realizations = 8" in text
    main(["report", str(d), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["spans"]["realize/compute/sweep_pipeline/drain"]["calls"] == 2
    main(["report", str(d), "--min-ms", "1e9"])
    tree = capsys.readouterr().out.split("\n\n")[1]
    assert tree.splitlines() == [tree.splitlines()[0]] and tree.startswith("span")


def test_fuzz_fast_counts_one_span_a_case(tmp_path, capsys):
    d = tmp_path / "cap"
    main(["scenario", "fuzz", "--fast", "--out-dir", str(tmp_path / "f"), "--device", "cpu",
          "--telemetry", str(d)])
    report = json.loads(capsys.readouterr().out)
    data = treport.load_telemetry(str(d))
    calls = {p: a["calls"] for p, a in treport.aggregate_spans(data["events"]).items()}
    assert calls["scenario/scenario_fuzz_case"] == _value(data["metrics"], "scenario.fuzz_cases")
    assert calls["scenario/scenario_fuzz_case"] >= report["n_scenarios"]
    assert "scenario.fuzz_disagreements" not in data["metrics"]


def test_the_planted_shrink_counts_the_jax_runs_steps():
    from pta_replicator_tpu import obs as jobs
    from pta_replicator_tpu.scenarios import compile_spec as jax_compile_spec
    from pta_replicator_tpu.scenarios import fuzz as jfz
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.scenarios import compile_spec
    from pta_replicator_tpu_torch.scenarios import fuzz as fz

    planted = {**BASE, "ecorr": {"log10_ecorr": -6.8}, "burst": {"log10_amp": -7.0}}
    obs.reset_all()
    jobs.reset_all()
    fz.shrink(fz.ScenarioSpec.from_dict(planted).validate(),
              lambda s: not fz.run_scenario(compile_spec(s, validate=False, device="cpu"),
                                            perturb=PERTURB).agree)
    jfz.shrink(jfz.ScenarioSpec.from_dict(planted).validate(),
               lambda s: not jfz.run_scenario(jax_compile_spec(s, validate=False),
                                              perturb=PERTURB).agree)
    steps = obs.REGISTRY.counter("scenario.shrink_steps").value
    assert steps > 0 and steps == jobs.REGISTRY.counter("scenario.shrink_steps").value
    assert (obs.REGISTRY.counter("scenario.fuzz_disagreements").value
            == jobs.REGISTRY.counter("scenario.fuzz_disagreements").value > 0)
    assert (obs.REGISTRY.counter("scenario.fuzz_cases").value
            == jobs.REGISTRY.counter("scenario.fuzz_cases").value)
