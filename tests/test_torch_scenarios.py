"""The port's scenario layer (``scenarios/spec.py``, ``scenarios/compile.py``)
against the JAX package's, on the CPU:

* the spec: the same ``content_hash`` and the same ``SpecError`` message,
  field name included, for the JAX test file's bad specs;
* the compiler: for eight specs of the JAX package's own sampler (chosen to
  cover every section: banded, Kronecker, dense and solar-wind covariance,
  anisotropic, HD and uncorrelated ORFs, turnover, streamed CW, glitch,
  populations with and without outliers), the committed specs and the
  flagship preset, every batch and recipe array equal to the JAX compile's
  at float64 (the port's index arrays are int64 where JAX's are int32:
  equal values), with equal ``drawn`` and ``families``;
* those scenarios realized with the JAX draws carried across
  (``tests/_torch_parity.py``) at <= 1e-9 relative RMS;
* a non-positive-definite ORF raising the same named ``SpecError``.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws, rel_rms
from pta_replicator_tpu import scenarios as J
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.scenarios import fuzz as fz
from pta_replicator_tpu_torch import realize
from pta_replicator_tpu_torch import scenarios as T
from pta_replicator_tpu_torch.scenarios import compile as tcompile

REPO = pathlib.Path(__file__).resolve().parent.parent
SPECS = REPO / "pta_replicator_tpu_torch" / "scenarios" / "specs"
#: the JAX sampler's scenarios (root 0) that together enable every section
SAMPLED = (1, 4, 11, 17, 19, 20, 21, 29)
TOL_REALIZE = 1e-9

BASE = {
    "name": "t", "seed": 3,
    "array": {"npsr": 3, "ntoa": 64, "nbackend": 2, "span_days": 2000.0},
    "white": {"efac": 1.1, "per_backend": True},
    "red": {"log10_amplitude": -14.0, "gamma": 3.0, "nmodes": 4},
}


def spec_dict(**over):
    return {**{k: (dict(v) if isinstance(v, dict) else v) for k, v in BASE.items()}, **over}


#: (spec dict, a fragment of the message), the JAX test file's bad specs
BAD_SPECS = [
    (spec_dict(array={"npulsars": 3}), "array.*unknown key.*npulsars"),
    ({"array": {}, "whtie": {}}, "unknown top-level"),
    (spec_dict(white={"efac": {"dist": "zipf", "lo": 1}}), "white.efac.dist"),
    (spec_dict(white={"efac": {"dist": "uniform", "lo": 2.0, "hi": 1.0}}), "lo must be <= hi"),
    (spec_dict(white={"efac": {"dist": "normal", "mean": 1.0}}), "needs 'sd'"),
    (spec_dict(gwb={"log10_amplitude": -14.0, "gamma": 4.0}, population={"n_binaries": 10}),
     "population and gwb"),
    (spec_dict(cw={"nsrc": 2}, population={"n_binaries": 10}), "population and cw"),
    (spec_dict(transient={"psr": 7, "log10_amp": -7.0}), "transient.psr.*out of range"),
    (spec_dict(sweep={"nreal": 5, "chunk": 2}), "nreal.*multiple"),
    ({"array": {"npsr": 2}}, "no signal family"),
    (spec_dict(scenario_version=99), "newer than this reader"),
    ({"preset": "bench_flagship", "white": {"efac": 1.0}}, "preset.*must not also carry"),
    ({"preset": "nope"}, "preset must be one of"),
    ({"preset": "bench_flagship", "preset_params": {"ncww": 50}}, "preset_params.*ncww"),
    (spec_dict(white={"efac": [1.0, 1.1]}), "white.efac.*array.npsr = 3"),
    (spec_dict(red={"log10_amplitude": -14.0, "gamma": [3.0, 3.1]}), "red.gamma.*array.npsr = 3"),
    (spec_dict(white={"efac": [1.0, 1.1, 1.2], "per_backend": True}), "cannot combine with"),
    (spec_dict(white={"efac": -2.0}), "white.efac must be >= 0"),
    (spec_dict(gwb={"log10_amplitude": -14.0, "gamma": 4.0, "orf": {"lmax": 1, "clm": [1.0]}}),
     r"gwb.orf.clm must be a list of \(lmax\+1\)\^2 = 4"),
    (spec_dict(population={"orf": {"clm": [1.0]}}), "population.orf: anisotropic ORF needs lmax"),
    (spec_dict(covariance={"kind": "kron", "log10_sigma": -6.5, "channels": 3}),
     "covariance.channels = 3 must divide array.ntoa = 64"),
    (spec_dict(covariance={"kind": "banded", "log10_sigma": -6.5, "chan_rho": 0.5}),
     "do not apply to kind 'banded'"),
    (spec_dict(covariance={"preset": "solar_wind", "kind": "dense"}), "solar_wind preset IS"),
]


def _spec_error(pkg, d):
    with pytest.raises(pkg.SpecError) as err:
        pkg.ScenarioSpec.from_dict(d).validate()
    return str(err.value)


@pytest.mark.parametrize("d,fragment", BAD_SPECS)
def test_bad_specs_raise_the_jax_message(d, fragment):
    got = _spec_error(T, d)
    assert got == _spec_error(J, d)
    assert pytest.importorskip("re").search(fragment, got), got


def _valid_dicts():
    out = [spec_dict(), spec_dict(seed=2**40, sweep={"nreal": 4, "chunk": 2})]
    out += [json.loads(p.read_text()) for p in sorted(SPECS.glob("*.json"))]
    return out + [fz.sample_spec(0, k).to_dict() for k in SAMPLED]


def test_content_hash_and_canonical_form_equal_jax():
    for d in _valid_dicts():
        t, j = T.ScenarioSpec.from_dict(d).validate(), J.ScenarioSpec.from_dict(d).validate()
        assert t.canonical_json() == j.canonical_json()
        assert t.content_hash == j.content_hash
        assert T.ScenarioSpec.from_dict(t.to_dict()).content_hash == t.content_hash


def test_load_spec_json_and_toml_as_jax(tmp_path):
    spec = T.ScenarioSpec.from_dict(spec_dict(ecorr={"log10_ecorr": -6.8})).validate()
    path = str(tmp_path / "s.json")
    spec.save(path)
    assert T.load_spec(path).content_hash == J.load_spec(path).content_hash == spec.content_hash
    toml = tmp_path / "s.toml"
    toml.write_text('name = "t"\nseed = 3\n[array]\nnpsr = 3\nntoa = 64\n'
                    '[white]\nefac = 1.1\n')
    assert T.load_spec(str(toml)).content_hash == J.load_spec(str(toml)).content_hash
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for missing in (str(bad), str(tmp_path / "absent.json")):
        messages = []
        for pkg in (T, J):
            with pytest.raises(pkg.SpecError) as err:
                pkg.load_spec(missing)
            messages.append(str(err.value))
        assert messages[0] == messages[1] and missing in messages[0]


def test_the_committed_flagship_spec_is_the_jax_packages():
    jax_spec = REPO / "pta_replicator_tpu" / "scenarios" / "specs" / "flagship.json"
    assert (SPECS / "flagship.json").read_text() == jax_spec.read_text()


# ------------------------------------------------------------- compile

def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_fields_equal(got, want, where):
    """Every field of the JAX dataclass ``want`` equal in ``got``: arrays
    in value and shape (and dtype, index arrays aside), nested ops field
    by field, statics by value."""
    for name, w in vars(want).items():
        g = getattr(got, name, None)
        if name in ("cgw_backend", "gwb_synthesis_precision"):
            assert g is None
            continue
        if w is None:
            assert g is None, f"{where}.{name}"
        elif hasattr(w, "shape"):
            gh, wh = _host(g), np.asarray(w)
            assert gh.shape == wh.shape and np.array_equal(gh, wh), f"{where}.{name}"
            if wh.dtype.kind == "i":
                assert gh.dtype == np.int64, f"{where}.{name}"
            else:
                assert gh.dtype == wh.dtype, f"{where}.{name}"
        elif dataclasses.is_dataclass(w):
            _assert_fields_equal(g, w, f"{where}.{name}")
        else:
            assert g == w, f"{where}.{name}"


def _compile_both(d):
    tc = T.compile_spec(T.ScenarioSpec.from_dict(d), dtype=torch.float64, device="cpu")
    jc = J.compile_spec(J.ScenarioSpec.from_dict(d), dtype=jnp.float64)
    return tc, jc


def _assert_compiled_equal(tc, jc):
    _assert_fields_equal(tc.batch, jc.batch, "batch")
    _assert_fields_equal(tc.recipe, jc.recipe, "recipe")
    assert tc.families == jc.families
    assert tc.fingerprint == jc.fingerprint and tc.spec_hash == jc.spec_hash
    assert vars(tc.plan) == vars(jc.plan)
    assert tc.provenance() == jc.provenance()
    assert tc.drawn.keys() == jc.drawn.keys()
    for k, v in jc.drawn.items():
        np.testing.assert_array_equal(tc.drawn[k], v)


@pytest.fixture(scope="module", params=SAMPLED)
def sampled(request):
    return _compile_both(fz.sample_spec(0, request.param).to_dict())


def test_sampled_spec_compiles_to_the_jax_arrays(sampled):
    _assert_compiled_equal(*sampled)


def test_sampled_spec_realizes_as_jax_with_its_draws(sampled):
    tc, jc = sampled
    key = jax.random.PRNGKey(21)
    want = np.asarray(JB.realize(key, jc.batch, jc.recipe, nreal=2, fit=True))
    got = realize(None, tc.batch, tc.recipe, 2, fit=True,
                  noise=jax_realize_draws(key, jc.batch, jc.recipe, 2), device="cpu")
    assert rel_rms(got, want) <= TOL_REALIZE


def test_the_sampled_specs_cover_every_section():
    families = set()
    for k in SAMPLED:
        families |= set(tcompile.spec_families(T.ScenarioSpec.from_dict(
            fz.sample_spec(0, k).to_dict())))
    assert {"white", "ecorr", "red", "chromatic", "burst", "memory", "gwb_powerlaw",
            "gwb_turnover", "gwb_freespec", "population_cw", "orf_hd", "orf_none", "orf_aniso",
            "cw", "cw_streamed", "transient", "glitch", "cov_banded", "cov_kron",
            "cov_dense"} <= families


def test_ng15_population_spec_compiles_to_the_jax_arrays_at_a_cut_array():
    """The committed full-width scenario, with only its array cut (8 x 512)
    so the JAX basis stays cheap: 100,000 binaries, ~3,000 outliers, the
    anisotropic ORF, the burst, memory and glitch."""
    d = json.loads((SPECS / "ng15_population.json").read_text())
    d["array"].update(npsr=8, ntoa=512)
    tc, jc = _compile_both(d)
    _assert_compiled_equal(tc, jc)
    assert tc.drawn["population_outliers"] == 3000
    assert tc.recipe.cgw_params.shape == (8, 3000)


def test_flagship_preset_gives_the_jax_fingerprint():
    small = dict(npsr=4, ntoa=128, nbackend=2, ncw=3)
    d = {"name": "flagship", "preset": "bench_flagship", "preset_params": small}
    # the JAX preset builds its batch at JAX's ambient dtype, float64 here
    tc = T.compile_spec(T.ScenarioSpec.from_dict(d), dtype=torch.float64, device="cpu")
    jc = J.compile_spec(J.ScenarioSpec.from_dict(d))
    assert tc.fingerprint == jc.fingerprint
    assert tc.fingerprint == T.flagship_workload(**small, with_fingerprint=True,
                                                 dtype=torch.float64, device="cpu")[2]
    _assert_fields_equal(tc.batch, jc.batch, "batch")
    _assert_fields_equal(tc.recipe, jc.recipe, "recipe")
    assert tc.families == ("preset:bench_flagship",) and vars(tc.plan) == vars(jc.plan)


def test_flagship_preset_drops_the_jax_only_params():
    """``cgw_backend`` and ``gwb_synthesis_precision`` are accepted (the
    spec validates) and dropped, as ``convert.recipe_from_arrays`` drops
    them: the same workload and fingerprint."""
    small = dict(npsr=4, ntoa=128, nbackend=2, ncw=3)
    plain = T.compile_spec(T.ScenarioSpec.from_dict(
        {"preset": "bench_flagship", "preset_params": small}), device="cpu")
    extra = T.compile_spec(T.ScenarioSpec.from_dict(
        {"preset": "bench_flagship", "preset_params": {
            **small, "cgw_backend": "pallas_interpret", "gwb_synthesis_precision": "highest"}}),
        device="cpu")
    assert extra.fingerprint == plain.fingerprint
    assert not hasattr(extra.recipe, "cgw_backend")
    assert torch.equal(extra.recipe.cgw_params, plain.recipe.cgw_params)


def test_non_positive_definite_orf_raises_the_jax_spec_error():
    for section in ("gwb", "population"):
        orf = {"lmax": 1, "clm": [float(np.sqrt(4 * np.pi)), 12.0, -12.0, 12.0]}
        body = ({"log10_amplitude": -14.0, "gamma": 4.0, "orf": orf} if section == "gwb"
                else {"n_binaries": 50, "nbins": 4, "orf": orf})
        d = spec_dict(array={"npsr": 6, "ntoa": 64, "span_days": 2000.0}, **{section: body})
        with pytest.raises(T.SpecError) as got:
            T.compile_spec(T.ScenarioSpec.from_dict(d), device="cpu")
        with pytest.raises(J.SpecError) as want:
            J.compile_spec(J.ScenarioSpec.from_dict(d))
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith(f"{section}.orf: the assembled ORF matrix is not "
                                         "positive definite")


def test_realize_seed_static_delays_and_determinism():
    d = spec_dict(burst={"log10_amp": -7.0}, cw={"nsrc": 2})
    a = T.compile_spec(T.ScenarioSpec.from_dict(d), device="cpu")
    b = T.compile_spec(T.ScenarioSpec.from_dict(d), device="cpu")
    _assert_fields_equal(a.recipe, b.recipe, "recipe")
    bits = np.asarray(jax.random.key_data(J.family_key(3, "realize"))).astype(np.uint64)
    assert a.realize_seed() == int(bits[0] << np.uint64(32) | bits[1])
    static = a.static_delays()
    assert static.shape == (3, 64) and static.device.type == "cpu"
    assert bool(torch.isfinite(static).all()) and float(static.abs().max()) > 0
    assert a.batch.dtype == torch.float32  # the default batch dtype


def test_compile_spec_raises_without_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.compile_spec(T.ScenarioSpec.from_dict(spec_dict()))
