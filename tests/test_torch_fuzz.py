"""The differential fuzz harness (``pta_replicator_tpu_torch/scenarios/
fuzz.py``) against the JAX package's, on the CPU: the generator gives the
JAX package's specs; given the JAX package's draws, the port's oracle
gives the JAX oracle's delays family by family (limit 1e-12 relative to
the largest entry; bit equality expected); the mixed scenario agrees and
the planted defect shrinks to the JAX shrinker's minimal spec; a short
run agrees everywhere with the JAX package's coverage counts, and the
sweep identity holds."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from _torch_parity import jax_realization_draws
from pta_replicator_tpu.scenarios import compile_spec as jax_compile_spec
from pta_replicator_tpu.scenarios import fuzz as jfz
from pta_replicator_tpu.scenarios import spec_families as jax_spec_families
from pta_replicator_tpu_torch.scenarios import ScenarioSpec, compile_spec, load_spec
from pta_replicator_tpu_torch.scenarios import fuzz as fz

#: the port's oracle against the JAX oracle under the same draws: both
#: are host float64 numpy over the same arrays in the same order
TOL_ORACLE = 1e-12

BASE = {
    "name": "t", "seed": 3,
    "array": {"npsr": 3, "ntoa": 64, "nbackend": 2, "span_days": 2000.0},
    "white": {"efac": 1.1, "per_backend": True},
    "red": {"log10_amplitude": -14.0, "gamma": 3.0, "nmodes": 4},
}

#: every oracle family at once (a population replaces gwb and cw, so it
#: is left out); the covariance kind varies per case
EVERY_FAMILY = {
    **BASE,
    "white": {"efac": {"dist": "uniform", "lo": 0.9, "hi": 1.3}, "log10_equad": -6.5,
              "per_backend": True},
    "ecorr": {"log10_ecorr": -6.8, "per_backend": True},
    "chromatic": {"log10_amplitude": -13.8, "gamma": 3.0, "index": 4.0, "nmodes": 4},
    "gwb": {"log10_amplitude": -14.3, "gamma": 4.33, "npts": 64, "howml": 4.0, "orf": "hd",
            "turnover": {"f0": 2e-9, "beta": 1.0, "power": 1.0}},
    "cw": {"nsrc": 3, "pdist_kpc": {"dist": "uniform", "lo": 0.5, "hi": 3.0}},
    "burst": {"log10_amp": -7.0},
    "memory": {"log10_strain": -13.0},
    "transient": {"psr": 1, "kind": "glitch", "log10_amp": -6.5},
}
COVARIANCE = {
    "banded": {"kind": "banded", "log10_sigma": -6.6, "rho": 0.5, "corr_days": 30.0,
               "block": 8},
    "kron": {"kind": "kron", "log10_sigma": -6.6, "channels": 2, "time_ell_days": 20.0,
             "chan_rho": 0.7},
    "dense": {"kind": "dense", "log10_sigma": -6.6, "corr_days": 30.0},
}
PERTURB = {"family": "ecorr", "scale": 1.01}


def mkspec(**over):
    return ScenarioSpec.from_dict({**BASE, **over}).validate()


def _np_draws(draws):
    return {k: np.asarray(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_oracles():
    """Per covariance kind: the JAX package's draws and its oracle delays,
    compiled at the port's batch dtype (float32)."""
    out = {}
    for kind, cov in COVARIANCE.items():
        spec = jfz.ScenarioSpec.from_dict({**EVERY_FAMILY, "covariance": cov}).validate()
        c = jax_compile_spec(spec, dtype=jnp.float32)
        draws = jax_realization_draws(c.realize_key(), c.batch, c.recipe)
        out[kind] = _np_draws(draws), jfz.oracle_family_delays(c)
    return out


@pytest.fixture(scope="module")
def jax_planted():
    """The JAX package's shrink of the planted-defect spec."""
    spec = jfz.ScenarioSpec.from_dict(
        {**BASE, "ecorr": {"log10_ecorr": -6.8}, "burst": {"log10_amp": -7.0}}).validate()

    def fails(s):
        return not jfz.run_scenario(jax_compile_spec(s, validate=False),
                                    perturb=PERTURB).agree

    return jfz.shrink(spec, fails)


@pytest.mark.parametrize("root", (0, 5, 9))
def test_the_generator_gives_the_jax_packages_specs(root):
    for i in range(40):
        got, want = fz.sample_spec(root, i), jfz.sample_spec(root, i)
        assert got.to_dict() == want.to_dict(), (root, i)
        assert got.content_hash == want.content_hash


@pytest.mark.parametrize("kind", sorted(COVARIANCE))
def test_the_oracle_equals_the_jax_oracle_under_the_jax_draws(kind, jax_oracles):
    draws, want = jax_oracles[kind]
    spec = ScenarioSpec.from_dict({**EVERY_FAMILY, "covariance": COVARIANCE[kind]}).validate()
    compiled = compile_spec(spec, device="cpu")
    got = fz.oracle_family_delays(compiled, draws)
    assert set(got) == set(want) == {
        "white", "ecorr", "red", "chromatic", "gwb", "cw", "burst", "memory", "transient",
        "covariance"}
    for fam, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[fam] - w).max() / np.abs(w).max()
        assert err <= TOL_ORACLE, (fam, err)


@pytest.mark.parametrize("kind", sorted(COVARIANCE))
def test_the_batched_side_agrees_under_the_jax_draws(kind, jax_oracles):
    """The port's batched families and engine total within the documented
    tolerances of the JAX oracle, under the JAX package's draws."""
    draws, want = jax_oracles[kind]
    spec = ScenarioSpec.from_dict({**EVERY_FAMILY, "covariance": COVARIANCE[kind]}).validate()
    compiled = compile_spec(spec, device="cpu")
    draws = {k: torch.tensor(v) for k, v in draws.items()}
    res = fz.run_scenario(compiled, draws=draws)
    assert res.agree, res.to_dict()
    dev = fz.batched_family_delays(compiled, draws)
    for fam, w in want.items():
        assert fz._rel(dev[fam], w) <= fz.FAMILY_TOLERANCES[fam], fam


def test_the_differential_agrees_on_the_mixed_scenario():
    spec = mkspec(
        ecorr={"log10_ecorr": -6.8},
        gwb={"log10_amplitude": -14.3, "gamma": 4.33, "npts": 64, "howml": 4.0, "orf": "hd"},
        cw={"nsrc": 2},
        memory={"log10_strain": -13.0},
        transient={"psr": 1, "kind": "glitch", "log10_amp": -6.5},
    )
    res = fz.run_scenario(compile_spec(spec, device="cpu"))
    assert res.agree, res.to_dict()
    assert set(res.verdicts) == {"white", "ecorr", "red", "gwb", "cw", "memory", "transient",
                                 "total"}
    for fam, v in res.verdicts.items():
        assert v["rel"] <= v["tol"], (fam, v)


def test_a_planted_disagreement_shrinks_to_the_jax_minimal_spec(tmp_path, jax_planted):
    spec = mkspec(ecorr={"log10_ecorr": -6.8}, burst={"log10_amp": -7.0})
    res = fz.run_scenario(compile_spec(spec, device="cpu"), perturb=PERTURB)
    assert not res.agree and res.worst_family == "ecorr"

    def fails(s):
        return not fz.run_scenario(compile_spec(s, validate=False, device="cpu"),
                                   perturb=PERTURB).agree

    minimal, steps = fz.shrink(spec, fails)
    jax_minimal, jax_steps = jax_planted
    assert steps > 0 and steps == jax_steps
    assert fz.spec_families(minimal) == ("ecorr",)
    assert minimal.content_hash == jax_minimal.content_hash
    # replayable, and innocent without the planted defect
    path = str(tmp_path / "min.json")
    minimal.save(path)
    assert fz.run_scenario(compile_spec(load_spec(path), device="cpu")).agree
    assert fz.replay(path, device="cpu").agree


def test_a_short_run_agrees_with_the_jax_packages_coverage():
    report = fz.fuzz(8, root_seed=0, sweep_every=4, device="cpu")
    assert report["agreement_rate"] == 1.0 and not report["failures"]
    specs = [jfz.sample_spec(0, i) for i in range(8)]
    coverage, combos = {}, set()
    for s in specs:
        fams = jax_spec_families(s)
        for f in fams:
            coverage[f] = coverage.get(f, 0) + 1
        combos.add("+".join(sorted(fams)))
    assert report["coverage"] == dict(sorted(coverage.items()))
    assert report["combo_histogram_size"] == len(combos)
    for fam, rel in report["max_rel_by_family"].items():
        assert rel <= fz.FAMILY_TOLERANCES[fam], fam
    checked = sum(1 for i, s in enumerate(specs) if s.sweep is not None and i % 4 == 0)
    assert report["sweep_identity"]["checked"] == checked
    assert report["sweep_identity"]["all_bit_identical"] in (True, None)
    assert set(report) == {
        "n_scenarios", "root_seed", "elapsed_s", "scenarios_per_s", "agreement_rate",
        "n_disagreements", "max_rel_disagreement", "max_rel_by_family", "tolerances",
        "coverage", "combo_histogram_size", "failures", "sweep_identity"}


def test_the_sweep_identity_holds_on_a_generated_spec(tmp_path):
    spec = next(s for s in (fz.sample_spec(0, i) for i in range(40)) if s.sweep is not None)
    chk = fz.check_sweep_identity(compile_spec(spec, validate=False, device="cpu"),
                                  str(tmp_path))
    assert chk["bit_identical"] and chk["checkpoint_identical"]


def _chip_smoke():
    """``chip_smoke.py`` as a module (its checks run only under __main__)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_covering_run_covers_every_required_token():
    """The chip check's scenario count: the first n whose specs carry
    every required token and a spec the sweep-identity arm checks; its run
    covers them all, agrees, and holds the identity."""
    smoke = _chip_smoke()
    n = smoke.fuzz_cover_n()
    assert n < smoke.FUZZ_CAP
    required = set(smoke.REQUIRED_COVERAGE)
    specs = [fz.sample_spec(0, i) for i in range(n)]
    covered = set().union(*(fz.spec_families(s) for s in specs[:-1]))
    checked = [i for i, s in enumerate(specs) if s.sweep is not None and i % 4 == 0]
    assert not required <= covered or checked[-1] == n - 1  # the smallest
    report = fz.fuzz(n, root_seed=0, sweep_every=4, device="cpu")
    assert required <= set(report["coverage"])
    assert report["agreement_rate"] == 1.0
    assert report["sweep_identity"] == {"checked": len(checked), "all_bit_identical": True}


def test_the_planted_arm_detects_shrinks_and_replays(tmp_path):
    report = fz.fuzz(6, root_seed=5, out_dir=str(tmp_path), perturb=PERTURB, device="cpu")
    with_ecorr = [i for i in range(6) if fz.sample_spec(5, i).ecorr is not None]
    assert [f["index"] for f in report["failures"]] == with_ecorr
    for f in report["failures"]:
        assert f["minimal_families"] == ["ecorr"]
        assert fz.replay(f["replay_file"], device="cpu").agree
