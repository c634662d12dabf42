"""The oracle's refit and its noise covariance, port against the JAX
package, bit for bit: ``SimulatedPulsar.fit`` over every fitter (wls, gls,
downhill, auto) and column set (full, spin, an explicit list) with
``niter=2``, with a covariance passed or built by
``covariance_from_recipe`` from a port ``Recipe`` that ``convert`` made of
a JAX one (per-backend white noise and ECORR, red, chromatic and the GWB
auto-term; with a banded and with a dense ``noise_cov``); the fitted par
lines (values and ``_write_par_errors``' error columns), model, residuals
and uncertainties; ``noise_covariance`` term by term; the errors that
refuse to guess (no ``psr_index``, no ``backend_names``, an unknown
backend, a WLS fit given a covariance); and ``to_enterprise`` through a
stand-in ``enterprise.pulsar`` module, and without one."""
import dataclasses
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.batch import freeze as jax_freeze
from pta_replicator_tpu.covariance import banded_from_times as jax_banded
from pta_replicator_tpu.covariance import dense_from_times as jax_dense
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.timing import fit as jfit

import pta_replicator_tpu_torch as T
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.batch import freeze
from pta_replicator_tpu_torch.timing import fit as tfit

from _torch_dataset import small_pulsars, write_with

import pta_replicator_tpu as J

#: an explicit column list: spin, position, parallax, FD and a JUMP (each
#: pulsar keeps those its par declares)
COLUMNS = ["OFFSET", "F0", "F1", "RAJ", "DECJ", "PX", "FD1", "JUMP1"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("oracle_fit")))


def _noisy(module, package, dirs):
    """Idealized pulsars with red and white noise (the same legacy draws in
    both packages), so that a refit has power to absorb."""
    psrs = module.load_from_directories(*dirs)
    for i, p in enumerate(psrs):
        module.make_ideal(p)
        package.add_red_noise(p, -13.6, 3.0, seed=10 + i)
        package.add_measurement_noise(p, efac=1.1, log10_equad=-6.7, seed=20 + i)
    return psrs


def _same_fit(got, want):
    assert got.par.lines == want.par.lines
    assert got.loc == want.loc
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert np.array_equal(got.residuals.resids_value, want.residuals.resids_value)
    assert np.array_equal(got.toas.mjd, want.toas.mjd)
    for attr in ("fit_results", "fit_uncertainties"):
        a, b = getattr(got, attr), getattr(want, attr)
        assert list(a) == list(b)
        assert all(a[k] == b[k] for k in a), attr


@pytest.mark.parametrize("params", ["full", "spin", "list"])
@pytest.mark.parametrize("fitter", ["wls", "gls", "downhill", "auto"])
def test_fit_equals_jax(dirs, fitter, params):
    cols = COLUMNS if params == "list" else params
    out = {}
    for name, module, package in (("port", tsim, T), ("jax", jsim, J)):
        psrs = _noisy(module, package, dirs)
        for p in psrs:
            p.fit(fitter, params=cols, niter=2)
        out[name] = psrs
    for got, want in zip(out["port"], out["jax"], strict=True):
        _same_fit(got, want)
    names = list(out["port"][0].fit_results)
    assert names[:3] == ["OFFSET", "F0", "F1"]
    if params == "spin":
        assert len(names) == 3
    elif params == "list":
        assert set(names) <= set(COLUMNS) and len(names) > 3


def _recipes(psrs_port, psrs_jax, noise_cov):
    """A JAX recipe with per-backend EFAC/EQUAD/ECORR, per-pulsar red and
    chromatic noise and the GWB auto-term (tests/test_batched.py:959-975),
    optionally with a banded or dense ``noise_cov``, and the port's
    ``Recipe`` carried across by ``convert``; with the backend names."""
    jb = jax_freeze(psrs_jax, dtype=jnp.float64)
    nb = len(jb.backend_names)
    rng = np.random.default_rng(5)
    fields = dict(
        efac=jnp.asarray(rng.uniform(0.9, 1.4, (jb.npsr, nb))),
        log10_equad=jnp.asarray(rng.uniform(-6.8, -6.2, (jb.npsr, nb))),
        log10_ecorr=jnp.asarray(rng.uniform(-6.9, -6.4, (jb.npsr, nb))),
        rn_log10_amplitude=jnp.asarray(rng.uniform(-13.8, -13.2, jb.npsr)),
        rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, jb.npsr)),
        chrom_log10_amplitude=jnp.asarray(rng.uniform(-13.9, -13.4, jb.npsr)),
        chrom_gamma=jnp.asarray(rng.uniform(2.5, 4.0, jb.npsr)),
        chrom_index=jnp.asarray(2.0),
        gwb_log10_amplitude=jnp.asarray(-14.2),
        gwb_gamma=jnp.asarray(13.0 / 3.0),
    )
    if noise_cov == "banded":
        fields.update(noise_cov=jax_banded(jb.toas_s, jb.mask, rho=0.5, corr_s=30 * 86400.0,
                                           block=16),
                      cov_log10_sigma=jnp.asarray(-6.4))
    elif noise_cov == "dense":
        fields.update(noise_cov=jax_dense(jb.toas_s, jb.mask, corr_s=20 * 86400.0),
                      cov_log10_sigma=jnp.asarray(rng.uniform(-6.8, -6.4, jb.npsr)))
    jr = JB.Recipe(**fields)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    assert freeze(psrs_port, dtype=torch.float64, device="cpu").backend_names == jb.backend_names
    return jr, tr, jb.backend_names


@pytest.mark.parametrize("noise_cov", [None, "banded", "dense"])
def test_covariance_from_recipe_equals_jax(dirs, noise_cov):
    port, jax_ = _noisy(tsim, T, dirs), _noisy(jsim, J, dirs)
    jr, tr, names = _recipes(port, jax_, noise_cov)
    for i, (p, q) in enumerate(zip(port, jax_)):
        got = tfit.covariance_from_recipe(p, tr, psr_index=i, backend_names=names)
        want = jfit.covariance_from_recipe(q, jr, psr_index=i, backend_names=names)
        assert got.shape == (p.toas.ntoas,) * 2 and got.dtype == np.float64
        assert np.array_equal(got, want), (noise_cov, i)


@pytest.mark.parametrize("fitter", ["gls", "downhill"])
@pytest.mark.parametrize("noise_cov", [None, "banded", "dense"])
def test_gls_fit_from_a_recipe_equals_jax(dirs, noise_cov, fitter):
    port, jax_ = _noisy(tsim, T, dirs), _noisy(jsim, J, dirs)
    jr, tr, names = _recipes(port, jax_, noise_cov)
    for i, (p, q) in enumerate(zip(port, jax_)):
        p.fit(fitter, recipe=tr, psr_index=i, backend_names=names, niter=2)
        q.fit(fitter, recipe=jr, psr_index=i, backend_names=names, niter=2)
        _same_fit(p, q)


def test_gls_fit_with_a_covariance_passed_equals_jax(dirs):
    port, jax_ = _noisy(tsim, T, dirs), _noisy(jsim, J, dirs)
    for p, q in zip(port, jax_):
        t = p.toas.get_mjds() * 86400.0
        cov = tfit.noise_covariance(p.toas.errors_s, efac=1.1, equad_s=2e-7,
                                    rn_log10_amplitude=-13.6, rn_gamma=3.0, toas_s=t)
        p.fit("gls", cov=cov, params=COLUMNS)
        q.fit("gls", cov=cov, params=COLUMNS)
        _same_fit(p, q)


def test_the_fitted_par_is_what_write_partim_persists(dirs, tmp_path):
    """The fitted values and their errors reach the written par, and the
    reloaded pulsar carries them."""
    psrs = _noisy(tsim, T, dirs)
    for p in psrs:
        before = list(p.par.lines)
        p.fit("wls", niter=2)
        assert p.par.lines != before
        p.write_partim(str(tmp_path / f"{p.name}.par"), str(tmp_path / f"{p.name}.tim"))
        back = tsim.load_pulsar(str(tmp_path / f"{p.name}.par"), str(tmp_path / f"{p.name}.tim"))
        assert back.par.lines == p.par.lines
        assert back.model.f0 == p.model.f0
        f0_line = next(line for line in back.par.lines if line.split()[0] == "F0")
        assert len(f0_line.split()) == 4  # value, fit flag, error


@pytest.mark.parametrize("which", [0, 1], ids=("ecliptic", "equatorial"))
def test_write_par_errors_equals_jax(dirs, which):
    """``_write_par_errors`` on its own, with the full parameter covariance
    (the ecliptic rotation's cross terms) and without."""
    port, jax_ = tsim.load_from_directories(*dirs), jsim.load_from_directories(*dirs)
    p, q = port[which], jax_[which]
    from pta_replicator_tpu_torch.timing.components import full_design_matrix

    _, names = full_design_matrix(p.par, p.toas.get_mjds(), freqs_mhz=p.toas.freqs_mhz,
                                  f0=p.model.f0, flags=p.toas.flags)
    rng = np.random.default_rng(3)
    A = rng.standard_normal((len(names), len(names)))
    pcov = (A @ A.T) * 1e-12
    sig = dict(zip(names, np.sqrt(np.diag(pcov))))
    for kw in (dict(), dict(names=names, pcov=pcov)):
        p._write_par_errors(sig, **kw)
        q._write_par_errors(sig, **kw)
        assert p.par.lines == q.par.lines


def test_noise_covariance_term_by_term_equals_jax():
    rng = np.random.default_rng(9)
    n = 180
    t = np.sort(rng.uniform(4.6e9, 5.0e9, n))
    sig = rng.uniform(1e-7, 1e-6, n)
    idx = np.repeat(np.arange(45), 4)
    freqs = np.where(np.arange(n) % 7 == 0, 0.0, rng.uniform(400.0, 2000.0, n))
    spectra = {
        "power_law": dict(log10_amplitude=-14.2, spectral_index=13 / 3),
        "turnover": dict(log10_amplitude=-14.2, spectral_index=13 / 3, turnover=True, f0=3e-9),
        "user": dict(user_spectrum=np.stack([np.geomspace(1e-9, 1e-7, 6),
                                             1e-15 * np.geomspace(1, 0.2, 6)], axis=1)),
    }
    terms = {
        "white_scalar": dict(efac=1.2, equad_s=3e-7),
        "white_per_toa": dict(efac=rng.uniform(0.9, 1.3, n), equad_s=rng.uniform(0, 5e-7, n)),
        "ecorr_scalar": dict(ecorr_s=4e-7, epoch_index=idx),
        "ecorr_per_epoch": dict(ecorr_s=rng.uniform(1e-7, 5e-7, 45), epoch_index=idx),
        "red": dict(rn_log10_amplitude=-13.8, rn_gamma=3.5, toas_s=t, rn_nmodes=14),
        "red_tspan": dict(rn_log10_amplitude=-13.8, rn_gamma=3.5, toas_s=t, tspan_s=6e8),
        "chromatic": dict(chrom_log10_amplitude=-13.9, chrom_gamma=2.8, chrom_index=4.0,
                          chrom_nmodes=9, chrom_ref_freq_mhz=1000.0, toas_s=t, freqs_mhz=freqs),
        **{f"gwb_{k}": dict(gwb_spectrum=v, gwb_nmodes=11, toas_s=t) for k, v in spectra.items()},
    }
    every = {}
    for name, kw in terms.items():
        got = tfit.noise_covariance(sig, **kw)
        assert np.array_equal(got, jfit.noise_covariance(sig, **kw)), name
        every.update(kw)
    every["efac"], every["equad_s"] = terms["white_per_toa"]["efac"], 2e-7
    every["gwb_spectrum"] = spectra["power_law"]
    assert np.array_equal(tfit.noise_covariance(sig, **every), jfit.noise_covariance(sig, **every))
    for kw, match in ((dict(rn_log10_amplitude=-14, rn_gamma=3), "toas_s"),
                      (dict(chrom_log10_amplitude=-14, chrom_gamma=3, toas_s=t), "freqs_mhz"),
                      (dict(gwb_spectrum=spectra["power_law"]), "toas_s")):
        with pytest.raises(ValueError, match=match):
            tfit.noise_covariance(sig, **kw)


@pytest.mark.parametrize("noise_cov", [None, "banded"])
def test_per_pulsar_tables_need_psr_index(dirs, noise_cov):
    port, jax_ = _noisy(tsim, T, dirs), _noisy(jsim, J, dirs)
    jr, tr, names = _recipes(port, jax_, noise_cov)
    with pytest.raises(ValueError, match="psr_index"):
        tfit.covariance_from_recipe(port[0], tr, backend_names=names)
    with pytest.raises(ValueError, match="psr_index"):
        port[0].fit("gls", recipe=tr, backend_names=names)
    if noise_cov is not None:
        scalar = dataclasses.replace(tr, efac=None, log10_equad=None, log10_ecorr=None,
                                     rn_log10_amplitude=None, rn_gamma=None,
                                     chrom_log10_amplitude=None, chrom_gamma=None)
        with pytest.raises(ValueError, match="per-pulsar noise_cov"):
            tfit.covariance_from_recipe(port[0], scalar)


def test_per_backend_tables_need_their_backend_names(dirs):
    port, jax_ = _noisy(tsim, T, dirs), _noisy(jsim, J, dirs)
    _, tr, names = _recipes(port, jax_, None)
    with pytest.raises(ValueError, match="backend_names"):
        tfit.covariance_from_recipe(port[0], tr, psr_index=0)
    with pytest.raises(ValueError, match=r"not in backend_names"):
        tfit.covariance_from_recipe(port[2], tr, psr_index=2, backend_names=names[:1])


def test_a_wls_fit_refuses_a_covariance_and_unknown_fitters(dirs):
    psr = _noisy(tsim, T, dirs)[0]
    cov = np.diag(psr.toas.errors_s**2)
    for fitter in ("wls", "auto"):
        with pytest.raises(ValueError, match="fitter='gls'"):
            psr.fit(fitter, cov=cov)
    with pytest.raises(ValueError, match="must be one of"):
        psr.fit("lm")


def test_a_recipe_on_any_device_is_read_through_the_host(dirs):
    """The recipe's tensors are read with ``.detach().cpu()``: a recipe
    whose tables need a gradient gives the same covariance."""
    port, jax_ = _noisy(tsim, T, dirs), _noisy(jsim, J, dirs)
    _, tr, names = _recipes(port, jax_, "dense")
    grad = dataclasses.replace(tr, efac=tr.efac.clone().requires_grad_(True))
    assert np.array_equal(tfit.covariance_from_recipe(port[1], grad, psr_index=1,
                                                      backend_names=names),
                          tfit.covariance_from_recipe(port[1], tr, psr_index=1,
                                                      backend_names=names))


def test_to_enterprise_through_a_stand_in_module(dirs, monkeypatch):
    """The success path with a stand-in ``enterprise.pulsar.Pulsar`` that
    reads the written pair while the temporary directory lives
    (tests/test_simulate.py:190)."""
    psr = _noisy(tsim, T, dirs)[1]
    captured = {}

    class StandIn:
        def __init__(self, parfile, timfile, ephem=None, timing_package=None, **kw):
            captured.update(psr=tsim.load_pulsar(parfile, timfile), ephem=ephem,
                            timing_package=timing_package, kw=kw)

    mod, sub = types.ModuleType("enterprise"), types.ModuleType("enterprise.pulsar")
    sub.Pulsar = StandIn
    mod.pulsar = sub
    monkeypatch.setitem(sys.modules, "enterprise", mod)
    monkeypatch.setitem(sys.modules, "enterprise.pulsar", sub)
    out = psr.to_enterprise(ephem="DE440", timing_package="tempo2", drop_t2pulsar=False)
    assert isinstance(out, StandIn)
    assert (captured["ephem"], captured["timing_package"], captured["kw"]) == (
        "DE440", "tempo2", {"drop_t2pulsar": False})
    back = captured["psr"]
    assert back.par.lines == psr.par.lines and back.name == psr.name
    assert np.abs(np.asarray((back.toas.mjd - psr.toas.mjd) * 86400.0, float)).max() < 1e-9
    assert back.toas.flags == psr.toas.flags


def test_to_enterprise_without_enterprise_names_the_manual_route(dirs, monkeypatch):
    psr = tsim.load_from_directories(*dirs)[0]
    monkeypatch.setitem(sys.modules, "enterprise", None)
    with pytest.raises(ImportError, match="write_partim"):
        psr.to_enterprise()
