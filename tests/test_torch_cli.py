"""``python -m pta_replicator_tpu_torch scenario`` on the CPU (``--device
cpu``): validate, compile and run print the JAX CLI's JSON summary keys
with equal values where the draws do not enter; run stamps the spec's
provenance into the sidecar and resumes a finished checkpoint with the
same bytes; fuzz and replay print the JAX CLI's report keys and exit 1 on
a disagreement; the JAX CLI's guards; ``--telemetry`` refused naming
ROADMAP A.16; no fall-back to the CPU without a card."""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.__main__ import main as jax_main
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.scenarios import ScenarioSpec

SPEC = {
    "name": "t", "seed": 3,
    "array": {"npsr": 3, "ntoa": 64, "nbackend": 2, "span_days": 2000.0},
    "white": {"efac": 1.1, "per_backend": True},
    "red": {"log10_amplitude": -14.0, "gamma": 3.0, "nmodes": 4},
    "gwb": {"log10_amplitude": -14.3, "gamma": 4.33, "npts": 64, "howml": 4.0, "orf": "hd"},
    "burst": {"log10_amp": -7.0},
    "sweep": {"nreal": 4, "chunk": 2},
}


@pytest.fixture
def spec_path(tmp_path):
    path = str(tmp_path / "s.json")
    ScenarioSpec.from_dict(SPEC).validate().save(path)
    return path


def _summary(run, argv, capsys):
    run(argv)
    return json.loads(capsys.readouterr().out.strip())


def test_validate_and_compile_print_the_jax_summaries(spec_path, tmp_path, capsys):
    spec = ScenarioSpec.from_dict(SPEC)
    got = _summary(main, ["scenario", "validate", spec_path], capsys)
    assert got == _summary(jax_main, ["scenario", "validate", spec_path], capsys)
    assert got["valid"] and got["hash"] == spec.content_hash

    out = str(tmp_path / "w.npz")
    got = _summary(main, ["scenario", "compile", spec_path, "--out", out, "--device", "cpu"],
                   capsys)
    jout = str(tmp_path / "jw.npz")
    want = _summary(jax_main, ["scenario", "compile", spec_path, "--out", jout], capsys)
    assert got == {**want, "out": out}
    assert got["fingerprint"] == spec.content_hash and got["families"] == [
        "white", "red", "burst", "gwb_powerlaw", "orf_hd"]
    with np.load(out) as z:
        assert z["static"].shape == (3, 64) and np.abs(z["static"]).max() > 0
        assert str(z["fingerprint"]) == spec.content_hash


def test_run_stamps_provenance_and_resumes_with_the_same_bytes(spec_path, tmp_path, capsys):
    ck, res = str(tmp_path / "ck.npz"), str(tmp_path / "r.npz")
    argv = ["scenario", "run", spec_path, "--out", res, "--checkpoint", ck, "--device", "cpu"]
    got = _summary(main, argv, capsys)
    want = _summary(jax_main, ["scenario", "run", spec_path, "--out", str(tmp_path / "jr.npz"),
                               "--checkpoint", str(tmp_path / "jck.npz")], capsys)
    assert got.keys() == want.keys()
    assert got["shape"] == want["shape"] == [4, 3, 64] and got["hash"] == want["hash"]
    assert got["rms_s"] > 0
    meta = json.load(open(ck + ".meta.json"))
    assert meta["provenance"] == {"spec_name": "t", "spec_hash": got["hash"],
                                  "scenario_version": 1}
    first = {p: open(p, "rb").read() for p in (ck, res)}
    res2 = str(tmp_path / "r2.npz")
    again = _summary(main, argv[:4] + [res2] + argv[5:], capsys)
    assert again["rms_s"] == got["rms_s"]
    assert open(ck, "rb").read() == first[ck]
    with np.load(res) as a, np.load(res2) as b:
        assert np.array_equal(a["residuals"], b["residuals"])
        assert np.array_equal(a["mask"], np.ones((3, 64)))


@pytest.mark.parametrize("argv,message", [
    (["run", "{spec}", "--nreal", "3"], "multiple of the spec's"),
    (["run", "{spec}", "--nreal", "1"], "multiple of the spec's"),
    (["run", "{spec}", "{spec}"], "exactly one SPEC"),
    (["compile", "{spec}", "{spec}", "--out", "w.npz"], "exactly one SPEC"),
    (["validate"], "give at least one SPEC"),
])
def test_the_jax_clis_guards(spec_path, argv, message):
    argv = ["scenario"] + [a.format(spec=spec_path) for a in argv] + ["--device", "cpu"]
    with pytest.raises(SystemExit, match=message):
        main(argv)
    with pytest.raises(SystemExit, match=message):
        jax_main(argv[:-2])


def test_a_bad_spec_names_its_field(tmp_path):
    path = str(tmp_path / "bad.json")
    json.dump({"array": {"npsr": 3}, "white": {"efac": -2.0}}, open(path, "w"))
    with pytest.raises(SystemExit, match="white.efac must be >= 0"):
        main(["scenario", "validate", path])


def test_fuzz_fast_exits_zero_with_the_jax_report(tmp_path, capsys):
    out_dir = str(tmp_path / "failures")
    main(["scenario", "fuzz", "--fast", "--out-dir", out_dir, "--device", "cpu"])
    captured = capsys.readouterr()
    report = json.loads(captured.out)
    assert report["n_scenarios"] == 8 and report["agreement_rate"] == 1.0
    assert captured.err.strip().splitlines()[-1] == "scenario 8/8"
    assert set(report) == {
        "n_scenarios", "root_seed", "elapsed_s", "scenarios_per_s", "agreement_rate",
        "n_disagreements", "max_rel_disagreement", "max_rel_by_family", "tolerances",
        "coverage", "combo_histogram_size", "failures", "sweep_identity"}
    assert not (tmp_path / "failures").exists()  # made only on a disagreement


def test_replay_prints_the_jax_verdicts_and_exits_one_on_a_planted_defect(
        spec_path, monkeypatch, capsys):
    from pta_replicator_tpu_torch.scenarios import fuzz as fz

    got = _summary(main, ["scenario", "replay", spec_path, "--device", "cpu"], capsys)
    want = _summary(jax_main, ["scenario", "replay", spec_path], capsys)
    assert got.keys() == want.keys()
    assert got["agree"] and got["spec_hash"] == want["spec_hash"]
    assert got["families"] == want["families"]
    assert got["verdicts"].keys() == want["verdicts"].keys()

    run = fz.run_scenario
    monkeypatch.setattr(fz, "run_scenario",
                        lambda c: run(c, perturb={"family": "white", "scale": 1.01}))
    with pytest.raises(SystemExit) as err:
        main(["scenario", "replay", spec_path, "--device", "cpu"])
    assert err.value.code == 1
    assert json.loads(capsys.readouterr().out)["worst_family"] == "white"


def test_fuzz_takes_no_spec_as_the_jax_cli(spec_path):
    with pytest.raises(SystemExit, match="takes no SPEC files"):
        main(["scenario", "fuzz", spec_path, "--device", "cpu"])
    with pytest.raises(SystemExit, match="takes no SPEC files"):
        jax_main(["scenario", "fuzz", spec_path])


@pytest.mark.parametrize("argv", [
    ["scenario", "fuzz", "--fast"],
    ["scenario", "validate", "{spec}"],
    ["likelihood", "--bank", "b.npz", "--recipe", "r.json", "--synthetic", "4x128"],
])
def test_telemetry_is_refused_naming_the_roadmap(spec_path, argv):
    argv = [a.format(spec=spec_path) for a in argv] + ["--telemetry", "t", "--device", "cpu"]
    with pytest.raises(SystemExit, match=r"--telemetry: not ported yet \(ROADMAP A\.16"):
        main(argv)


def test_no_card_is_an_error_not_a_fall_back_to_the_cpu(spec_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for action in ("compile", "run"):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(["scenario", action, spec_path])


def test_the_module_runs_as_a_program(spec_path):
    out = subprocess.run([sys.executable, "-m", "pta_replicator_tpu_torch", "scenario",
                          "validate", spec_path], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["valid"] is True
