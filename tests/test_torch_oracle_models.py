"""The port's per-pulsar oracle against the JAX package's, bit for bit: the
numpy forms of the Fourier helpers, the pure math of every signal model
(white noise, ECORR, red and chromatic noise, CW, bursts, memory, the GWB
synthesis, the outliers' orientations) on seeded numpy inputs, and every
``add_*`` operator on ``tests/_torch_dataset.py``'s 4-pulsar dataset,
loaded and idealized through each package, with ``np.random.seed`` set
before each package's run (through ``seed=``, and with ``seed=None``):
the ledger, the residuals and the longdouble TOAs must be equal. Then the
reference's regression recipe (``tests/test_parity_libstempo.py:30-56``)
as a whole, the GWB's user-spectrum and turnover forms,
``add_gwb_plus_outlier_cws``, and the error paths. The tensor forms of the
Fourier helpers keep their own parity tests (``test_torch_realize.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import pta_replicator_tpu as J
from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.models import bursts as jbursts
from pta_replicator_tpu.models import cgw as jcgw
from pta_replicator_tpu.models import gwb as jgwb
from pta_replicator_tpu.models import population as jpop
from pta_replicator_tpu.models import red_noise as jred
from pta_replicator_tpu.models import white_noise as jwhite
from pta_replicator_tpu.ops import fourier as jfourier

import pta_replicator_tpu_torch as T
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.models import bursts as tbursts
from pta_replicator_tpu_torch.models import cgw as tcgw
from pta_replicator_tpu_torch.models import gwb as tgwb
from pta_replicator_tpu_torch.models import population as tpop
from pta_replicator_tpu_torch.models import red_noise as tred
from pta_replicator_tpu_torch.models import white_noise as twhite
from pta_replicator_tpu_torch.ops import fourier as tfourier

from _torch_dataset import small_pulsars, write_with

TREF = 53000 * 86400


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("oracle_models")))


def _ideal(module, dirs):
    psrs = module.load_from_directories(*dirs)
    for p in psrs:
        module.make_ideal(p)
    return psrs


def _equal(a, b) -> bool:
    """Ledger parameter values: arrays element for element, waveform
    callables by their code (each package's run builds its own closures),
    anything else by ==."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if callable(a):
        return callable(b) and a.__code__ is b.__code__
    return a is b or a == b


def _same_state(port, jax_):
    for got, want in zip(port, jax_, strict=True):
        assert got.toas.mjd.dtype == np.longdouble
        assert np.array_equal(got.toas.mjd, want.toas.mjd), got.name
        assert np.array_equal(got.residuals.resids_value, want.residuals.resids_value), got.name
        assert list(got.added_signals_time) == list(want.added_signals_time), got.name
        for k, v in want.added_signals_time.items():
            assert got.added_signals_time[k].dtype == np.float64
            assert np.array_equal(got.added_signals_time[k], v), (got.name, k)
        assert _equal(got.added_signals, want.added_signals), got.name


# ------------------------------------------------------- Fourier helpers

@pytest.mark.parametrize("kw", [
    dict(),
    dict(nmodes=7),
    dict(nmodes=12, logf=True),
    dict(nmodes=9, fmin=2e-9, fmax=3e-8),
    dict(nmodes=9, fmin=2e-9, fmax=3e-8, logf=True),
    dict(nmodes=5, fmin=1e-9),
    dict(modes=np.linspace(2e-9, 2e-8, 6)),
    dict(nmodes=1, logf=True),
], ids=lambda kw: "-".join(kw) or "default")
@pytest.mark.parametrize("tspan", [4.7e8, np.array([4.7e8, 3.1e8, 5.2e8])], ids=("scalar", "per_pulsar"))
def test_fourier_frequencies_numpy_form_equals_jax(kw, tspan):
    got = tfourier.fourier_frequencies(tspan, **kw)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, jfourier.fourier_frequencies(tspan, **kw))


@pytest.mark.parametrize("libstempo", [False, True])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_fourier_basis_numpy_form_equals_jax(libstempo, shift, lead):
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(4.5e9, 5.0e9, lead + (64,)), axis=-1)
    f = np.arange(1, 9) / 4.9e8 * np.ones(lead + (1,))
    ps = rng.uniform(0, 2 * np.pi, f.shape) if shift else None
    got = tfourier.fourier_basis(t, f, phase_shift=ps, libstempo_convention=libstempo)
    want = jfourier.fourier_basis(t, f, phase_shift=ps, libstempo_convention=libstempo)
    assert got.shape == lead + (64, 16) and np.array_equal(got, want)


@pytest.mark.parametrize("per_pulsar", [False, True])
def test_powerlaw_prior_numpy_form_equals_jax(per_pulsar):
    rng = np.random.default_rng(2)
    if per_pulsar:
        T, amp, gam = rng.uniform(3e8, 5e8, 4), rng.uniform(-15, -13, 4), rng.uniform(2, 5, 4)
        f = np.arange(1, 31)[None, :] / T[:, None]
    else:
        T, amp, gam = 4.4e8, -14.3, 13 / 3
        f = np.arange(1, 31) / T
    fd = np.repeat(f, 2, axis=-1)
    got = tfourier.powerlaw_prior(fd, amp, gam, T)
    assert np.array_equal(got, jfourier.powerlaw_prior(fd, amp, gam, T))


def test_the_tensor_forms_stay_tensors():
    T = torch.tensor([4.7e8, 3.1e8], dtype=torch.float64)
    f = tfourier.fourier_frequencies(T, nmodes=4)
    assert isinstance(f, torch.Tensor)
    np.testing.assert_array_equal(f.numpy(), tfourier.fourier_frequencies(T.numpy(), nmodes=4))


# ---------------------------------------------------------- pure math

@pytest.mark.parametrize("tnequad", [False, True])
def test_white_and_jitter_math_equals_jax(tnequad):
    rng = np.random.default_rng(3)
    n = 97
    args = (rng.uniform(1e-7, 1e-6, n), rng.uniform(0.8, 1.5, n), rng.uniform(0, 1e-6, n),
            rng.standard_normal(n), rng.standard_normal(n))
    assert np.array_equal(twhite.measurement_noise_delay(*args, tnequad=tnequad),
                          jwhite.measurement_noise_delay(*args, tnequad=tnequad))
    idx = np.sort(rng.integers(0, 20, n))
    ec, eps = rng.uniform(1e-7, 1e-6, 20), rng.standard_normal(20)
    assert np.array_equal(twhite.jitter_delay(idx, ec, eps), jwhite.jitter_delay(idx, ec, eps))
    flags = rng.choice(["A", "B", "C"], n)
    assert np.array_equal(twhite.expand_by_flags([1.1, 2.2], ["A", "C"], flags, default=-1.0),
                          jwhite.expand_by_flags([1.1, 2.2], ["A", "C"], flags, default=-1.0))


@pytest.mark.parametrize("kw", [dict(), dict(libstempo_convention=True),
                                dict(modes=np.linspace(3e-9, 3e-8, 8)), dict(tspan_s=6e8)],
                         ids=("default", "libstempo", "modes", "tspan"))
def test_red_noise_delay_equals_jax(kw):
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(4.5e9, 5.0e9, 120))
    k = len(kw["modes"]) if "modes" in kw else 30
    eps = rng.standard_normal(2 * k)
    got = tred.red_noise_delay(t, -14.2, 3.7, eps, nmodes=k, **kw)
    assert np.array_equal(got, jred.red_noise_delay(t, -14.2, 3.7, eps, nmodes=k, **kw))


def _catalog(n, seed=5):
    rng = np.random.default_rng(seed)
    return dict(
        gwtheta=np.arccos(rng.uniform(-1, 1, n)), gwphi=rng.uniform(0, 2 * np.pi, n),
        mc=10 ** rng.uniform(8, 9.5, n), dist=rng.uniform(10, 500, n),
        fgw=10 ** rng.uniform(-8.8, -7.5, n), phase0=rng.uniform(0, 2 * np.pi, n),
        psi=rng.uniform(0, np.pi, n), inc=np.arccos(rng.uniform(-1, 1, n)))


def test_antenna_pattern_equals_jax():
    cat = _catalog(40)
    phat = np.array([0.3, -0.5, 0.81])
    phat /= np.linalg.norm(phat)
    for got, want in zip(tcgw.antenna_pattern(cat["gwtheta"], cat["gwphi"], phat),
                         jcgw.antenna_pattern(cat["gwtheta"], cat["gwphi"], phat), strict=True):
        assert np.array_equal(got, want)
    for got, want in zip(tcgw.antenna_pattern(1.1, 2.3, phat), jcgw.antenna_pattern(1.1, 2.3, phat)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", [dict(), dict(evolve=False, phase_approx=True),
                                  dict(evolve=False), dict(psr_term=False),
                                  dict(pphase="per_source"), dict(pdist="per_source"),
                                  dict(nan_to_zero=True, merged=True)],
                         ids=("evolve", "phase_approx", "monochromatic", "earth_term", "pphase",
                              "pdist", "nan_to_zero"))
def test_cw_delay_equals_jax(mode):
    mode = dict(mode)
    cat = _catalog(30)
    if mode.pop("merged", False):
        cat["mc"][:5] = 1e11  # past merger inside the span: NaN -> 0
        cat["fgw"][:5] = 1e-7
    rng = np.random.default_rng(6)
    if mode.get("pphase") == "per_source":
        mode["pphase"] = rng.uniform(0, 2 * np.pi, 30)
    if mode.get("pdist") == "per_source":
        mode["pdist"] = rng.uniform(0.5, 3.0, 30)
    t = np.sort(rng.uniform(-3e8, 3e8, 150))
    phat = np.array([0.6, 0.0, 0.8])
    got = tcgw.cw_delay(t, phat, *cat.values(), **mode)
    want = jcgw.cw_delay(t, phat, *cat.values(), **mode)
    assert got.shape == (30, 150)
    assert np.array_equal(got, want, equal_nan=True)
    if mode.get("nan_to_zero"):
        assert np.isfinite(got).all() and (got[:5] == 0).any()


def test_burst_math_equals_jax():
    rng = np.random.default_rng(7)
    hp, hc = rng.standard_normal(50), rng.standard_normal(50)
    for got, want in zip(tbursts.polarization_rotation(hp, hc, 0.7),
                         jbursts.polarization_rotation(hp, hc, 0.7)):
        assert np.array_equal(got, want)
    t = np.sort(rng.uniform(4.5e9, 5.0e9, 50))
    assert np.array_equal(tbursts.quadratic_subtract(t, hp), jbursts.quadratic_subtract(t, hp))
    assert np.array_equal(tbursts.memory_ramp(t, 4.7e9, 0.3, 1e-14),
                          jbursts.memory_ramp(t, 4.7e9, 0.3, 1e-14))


SPECTRA = {
    "power_law": dict(log10_amplitude=-14.3, spectral_index=13 / 3),
    "turnover": dict(log10_amplitude=-14.3, spectral_index=13 / 3, turnover=True, f0=3e-9,
                     beta=0.8, power=1.5),
    "user": dict(user_spectrum=np.stack([np.geomspace(2e-9, 6e-8, 9),
                                         1e-15 * np.geomspace(1, 0.1, 9)], axis=1)),
}


@pytest.mark.parametrize("form", SPECTRA)
def test_characteristic_strain_numpy_form_equals_jax(form):
    f = np.geomspace(1e-10, 2e-7, 300)
    got = tgwb.characteristic_strain(f, **SPECTRA[form])
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, jgwb.characteristic_strain(f, **SPECTRA[form]))


def test_a_floored_user_spectrum_warns_on_the_numpy_form():
    spec = np.stack([np.geomspace(2e-9, 6e-8, 4), [1e-15, 1e-31, 0.0, 1e-15]], axis=1)
    with pytest.warns(UserWarning, match="2 strain value"):
        got = tgwb.characteristic_strain(np.geomspace(1e-9, 1e-7, 20), user_spectrum=spec)
    with pytest.warns(UserWarning):
        want = jgwb.characteristic_strain(np.geomspace(1e-9, 1e-7, 20), user_spectrum=spec)
    assert np.array_equal(got, want)


def test_gwb_synthesis_and_interpolation_equal_jax():
    rng = np.random.default_rng(8)
    ut, dt_grid, f = tgwb.gwb_grid(4.5e9, 5.0e9, 120, 10)
    npsr, nf = 3, len(f)
    w = rng.standard_normal((npsr, nf)) + 1j * rng.standard_normal((npsr, nf))
    A = rng.standard_normal((npsr, npsr))
    M = np.linalg.cholesky(A @ A.T + npsr * np.eye(npsr))
    C = tgwb.residual_psd_coeff(tgwb.characteristic_strain(f, -14.0, 4.33), f, 5e8, 10)
    got = tgwb.gwb_time_series(w, M, C, dt_grid, 120)
    assert got.shape == (npsr, 120)
    assert np.array_equal(got, jgwb.gwb_time_series(w, M, C, dt_grid, 120))
    toas = np.sort(rng.uniform(4.5e9, 5.0e9, 77))
    assert np.array_equal(tgwb.interp_to_toas(ut, got[1], toas),
                          jgwb.interp_to_toas(ut, got[1], toas))


def test_random_orientations_follow_the_legacy_stream():
    np.random.seed(11)
    got = tpop._random_orientations(25)
    np.random.seed(11)
    want = jpop._random_orientations(25)
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a, b)


# ------------------------------------------------------- the operators

def _backend_lists(psrs):
    """Per-backend (flags, efac, log10_equad, log10_ecorr) over the listed
    backends of pulsar 2 (four), one of them left unlisted."""
    flags = sorted({str(v) for v in psrs[2].toas.get_flag("f")})[:-1]
    n = len(flags)
    return flags, list(np.linspace(0.9, 1.6, n)), list(np.linspace(-6.9, -6.3, n)), \
        list(np.linspace(-7.0, -6.4, n))


def _op_white(m, psrs, seed, tnequad=False):
    for i, p in enumerate(psrs):
        m.add_measurement_noise(p, efac=1.3, log10_equad=-6.5, seed=None if seed is None else seed + i,
                                tnequad=tnequad)


def _op_white_backends(m, psrs, seed):
    flags, efac, equad, _ = _backend_lists(psrs)
    for i, p in enumerate(psrs):
        m.add_measurement_noise(p, efac=efac, log10_equad=equad, flags=flags,
                                seed=None if seed is None else seed + i)
        m.add_measurement_noise(p, efac=1.2, log10_equad=-6.6, flags=flags[:1], tnequad=True)


def _op_jitter(m, psrs, seed):
    for i, p in enumerate(psrs):
        m.add_jitter(p, log10_ecorr=np.log10(3e-7), seed=None if seed is None else seed + i)
        m.add_jitter(p, log10_ecorr=-6.8, coarsegrain=1.0)


def _op_jitter_backends(m, psrs, seed):
    flags, _, _, ecorr = _backend_lists(psrs)
    for i, p in enumerate(psrs):
        m.add_jitter(p, log10_ecorr=ecorr, flags=flags, seed=None if seed is None else seed + i)
        m.add_jitter(p, log10_ecorr=-6.9, flags=flags)


def _op_red(m, psrs, seed):
    for i, p in enumerate(psrs):
        s = None if seed is None else seed + i
        m.add_red_noise(p, -14.5, 3.5, seed=s)
        m.add_red_noise(p, -15.0, 4.2, components=12, libstempo_convention=True)
        m.add_red_noise(p, -14.8, 3.0, modes=np.linspace(3e-9, 2e-8, 5), Tspan=6e8)


def _op_chromatic(m, psrs, seed):
    for i, p in enumerate(psrs):
        m.add_chromatic_noise(p, -13.5, 3.0, seed=None if seed is None else seed + i)
        m.add_chromatic_noise(p, -14.0, 2.5, components=10, chromatic_index=4.0,
                              ref_freq_mhz=1000.0, Tspan=6e8, signal_name="scattering")


def _op_gwb(m, psrs, seed, **kw):
    m.add_gwb(psrs, -14.0, 4.33, seed=seed, **kw)


def _op_cgw(m, psrs, seed):
    del seed
    for p in psrs:
        common = dict(gwtheta=1.2, gwphi=2.5, mc=1e9, dist=15.0, fgw=1e-8, phase0=0.5, psi=1.5,
                      inc=np.pi / 4, tref=TREF)
        m.add_cgw(p, **common)
        m.add_cgw(p, **common, evolve=False, phase_approx=True, pdist=1.3)
        m.add_cgw(p, **common, evolve=False, psrTerm=False, signal_name="cw_earth")
        m.add_cgw(p, **common, pphase=1.1)


def _op_catalog(m, psrs, seed):
    del seed
    cat = _catalog(60)
    lists = {f"{k}_list": v for k, v in cat.items()}
    for p in psrs:
        m.add_catalog_of_cws(p, **lists, tref=TREF, chunk_size=7)
        m.add_catalog_of_cws(p, **lists, tref=TREF, pdist=np.linspace(0.5, 2, 60),
                             evolve=False, phase_approx=True)
        m.add_catalog_of_cws(p, **lists, tref=TREF, pphase=np.linspace(0, 6, 60),
                             psrTerm=False)


def _op_transients(m, psrs, seed):
    del seed
    t0 = float(np.mean([float(np.mean(p.toas.get_mjds())) for p in psrs])) * 86400.0
    width = 100 * 86400.0
    hp = lambda t: 4e-9 * np.exp(-0.5 * ((t - t0) / width) ** 2)
    hc = lambda t: 2e-9 * np.sin((t - t0) / width) * np.exp(-0.5 * ((t - t0) / width) ** 2)
    for p in psrs:
        m.add_burst(p, 0.9, 4.1, hp, hc, psi=0.6)
        m.add_burst(p, 0.9, 4.1, hp, hc, psi=0.6, remove_quad=True, signal_name="burst_q")
        m.add_gw_memory(p, strain=5e-15, gwtheta=1.1, gwphi=2.3, bwm_pol=0.7, t0_mjd=t0 / 86400)
    m.add_noise_transient(psrs[1], hp)


OPERATORS = {
    "measurement_noise": _op_white,
    "measurement_noise_tnequad": lambda m, p, s: _op_white(m, p, s, tnequad=True),
    "measurement_noise_backends": _op_white_backends,
    "jitter": _op_jitter,
    "jitter_backends": _op_jitter_backends,
    "red_noise": _op_red,
    "chromatic_noise": _op_chromatic,
    "gwb": _op_gwb,
    "gwb_uncorrelated": lambda m, p, s: _op_gwb(m, p, s, no_correlations=True),
    "gwb_anisotropic": lambda m, p, s: _op_gwb(m, p, s, lmax=1,
                                               clm=[np.sqrt(4 * np.pi), 0.3, -0.2, 0.1]),
    "gwb_npts_none": lambda m, p, s: _op_gwb(m, p, s, npts=None, howml=4),
    "cgw": _op_cgw,
    "catalog_of_cws": _op_catalog,
    "burst_memory_transient": _op_transients,
}


@pytest.mark.parametrize("seeding", ["seed", "global"])
@pytest.mark.parametrize("op", OPERATORS)
def test_each_operator_equals_jax_bit_for_bit(dirs, op, seeding):
    """``seed``: the operator seeds the legacy RNG itself; ``global``: the
    caller seeds it and passes ``seed=None``."""
    out = {}
    for name, module, package in (("port", tsim, T), ("jax", jsim, J)):
        psrs = _ideal(module, dirs)
        np.random.seed(99)
        OPERATORS[op](package, psrs, 1234 if seeding == "seed" else None)
        out[name] = psrs
    _same_state(out["port"], out["jax"])
    assert all(p.added_signals_time for p in out["port"][:1])


@pytest.mark.parametrize("form", ["turnover", "user"])
def test_add_gwb_spectrum_forms_equal_jax(dirs, form):
    kw = SPECTRA[form]
    kw = ({"turnover": True, "f0": kw["f0"], "beta": kw["beta"], "power": kw["power"]}
          if form == "turnover" else {"userSpec": kw["user_spectrum"]})
    amp = (-14.3, 13 / 3) if form == "turnover" else (None, None)
    out = {}
    for name, module, package in (("port", tsim, T), ("jax", jsim, J)):
        psrs = _ideal(module, dirs)
        package.add_gwb(psrs, *amp, seed=77, **kw)
        out[name] = psrs
    _same_state(out["port"], out["jax"])
    assert np.std(out["port"][0].added_signals_time[f"{out['port'][0].name}_gwb"]) > 0


def test_the_libstempo_regression_recipe_equals_jax(dirs):
    """tests/test_parity_libstempo.py:30-56 as a whole; then the ledger
    decomposes each pulsar's residuals through the timing model: the ideal
    TOAs shifted once by the sum of the ledger give the same residuals to
    <= 5e-9 s (the longdouble epochs' rounding, one per injection). The
    first-order form of :68-75 (ledger sum less its weighted mean) misses
    by the timing model's Doppler factor (~1e-4 of the delay) on this
    dataset's astrometry and binaries, in both packages alike."""
    out = {}
    for name, module, package in (("port", tsim, T), ("jax", jsim, J)):
        psrs = _ideal(module, dirs)
        package.add_gwb(psrs, -14, 4.33, seed=123456)
        for ii, psr in enumerate(psrs):
            package.add_measurement_noise(psr, efac=1.00, log10_equad=None, seed=54321 + ii,
                                          tnequad=False)
            package.add_jitter(psr, log10_ecorr=np.log10(3e-7), seed=54321 + ii)
        for ii, psr in enumerate(psrs):
            package.add_red_noise(psr, -15, 4.2, components=30, Tspan=None, seed=12345 + ii,
                                  libstempo_convention=True)
        for psr in psrs:
            package.add_cgw(psr, gwtheta=np.pi / 2, gwphi=2.5, mc=1e9, dist=5.0, fgw=1e-8,
                            phase0=0.5, psi=1.5, inc=np.pi / 4, pdist=1.0, pphase=None,
                            psrTerm=True, evolve=True, phase_approx=False, tref=TREF)
        out[name] = psrs
    _same_state(out["port"], out["jax"])
    for psr, base in zip(out["port"], _ideal(tsim, dirs), strict=True):
        total = np.sum(list(psr.added_signals_time.values()), axis=0)
        base.toas.adjust_seconds(total)
        base.update_residuals()
        assert np.abs(psr.residuals.resids_value - base.residuals.resids_value).max() <= 5e-9


def _population(seed=3, n=3000):
    rng = np.random.default_rng(seed)
    mtot = 10 ** rng.uniform(8, 10, n) * 1.989e33
    return ([mtot, rng.uniform(0.1, 1, n), rng.uniform(0.05, 1.5, n),
             10 ** rng.uniform(-8.9, -7.6, n)], rng.uniform(0, 50, n),
            np.geomspace(1e-9, 3e-8, 9), 16 * 3.156e7)


def test_add_gwb_plus_outlier_cws_equals_jax(dirs):
    vals, weights, fobs, T_obs = _population()
    out = {}
    for name, module, package in (("port", tsim, T), ("jax", jsim, J)):
        psrs = _ideal(module, dirs)
        out[name] = (psrs, package.add_gwb_plus_outlier_cws(psrs, vals, weights, fobs, T_obs,
                                                            outlier_per_bin=4, seed=5))
    _same_state(out["port"][0], out["jax"][0])
    for got, want in zip(out["port"][1], out["jax"][1], strict=True):
        assert np.array_equal(got, want)
    assert len(out["port"][1][2]) > 0


def test_the_package_exports_the_jax_roots_names():
    assert set(J.__all__) <= set(T.__all__)
    import pta_replicator_tpu.models as jm
    import pta_replicator_tpu_torch.models as tm
    assert tm.__all__ == jm.__all__


# ------------------------------------------------------- error paths

def test_operators_need_make_ideal(dirs):
    psr = tsim.load_from_directories(*dirs)[0]
    with pytest.raises(ValueError, match="make_ideal"):
        T.add_red_noise(psr, -14, 4, seed=1)


@pytest.mark.parametrize("call, match", [
    (lambda m, p: m.add_measurement_noise(p, efac=[1.0, 2.0]), "flags is None"),
    (lambda m, p: m.add_measurement_noise(p, efac=[1.0], flags=["ASP", "PUPPI"]), "same length"),
    (lambda m, p: m.add_jitter(p, log10_ecorr=[-6.0, -6.5]), "flags is None"),
    (lambda m, p: m.add_jitter(p, log10_ecorr=[-6.0], flags=["ASP", "PUPPI"]), "same length"),
], ids=("efac_list_without_flags", "efac_flags_length", "ecorr_list_without_flags",
        "ecorr_flags_length"))
def test_bad_white_noise_arguments_raise_as_in_jax(dirs, call, match):
    for module, package in ((tsim, T), (jsim, J)):
        psr = _ideal(module, dirs)[0]
        with pytest.raises(ValueError, match=match):
            call(package, psr)


def test_unlisted_backends_get_no_white_noise(dirs):
    psr = _ideal(tsim, dirs)[2]
    flags = ["ASP"]
    T.add_measurement_noise(psr, efac=[1.5], log10_equad=[-6.0], flags=flags, seed=3)
    T.add_jitter(psr, log10_ecorr=[-6.0], flags=flags, seed=3)
    listed = psr.toas.get_flag("f") == "ASP"
    assert 0 < listed.sum() < psr.toas.ntoas
    for name in (f"{psr.name}_measurement_noise", f"{psr.name}_jitter"):
        dt = psr.added_signals_time[name]
        assert np.all(dt[~listed] == 0.0) and np.all(dt[listed] != 0.0)
    assert psr.added_signals[f"{psr.name}_ASP_jitter"] == {"log10_ecorr": -6.0}


def test_chromatic_noise_needs_frequencies(dirs):
    for module, package in ((tsim, T), (jsim, J)):
        psr = _ideal(module, dirs)[0]
        psr.toas.freqs_mhz = None
        with pytest.raises(ValueError, match="observing frequencies"):
            package.add_chromatic_noise(psr, -14, 3, seed=1)
