"""The port's timing engine against the JAX package's, on a ragged dataset
with every column family: the time scales and observatory geometry, the
binary delays (ELL1 and DD), ``phase_residuals``, ``full_design_matrix``,
``design_tensor`` and the WLS/GLS solvers. The operations are the same
numpy operations in the same order, so the bits are equal; each check is
an equality (the ≤1e-13 relative tolerance of the dataset path is met with
room to spare)."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.timing import components as jcomp
from pta_replicator_tpu.timing import fit as jfit
from pta_replicator_tpu.timing import model as jmodel
from pta_replicator_tpu.timing import time_scales as jts
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.timing import components as tcomp
from pta_replicator_tpu_torch.timing import fit as tfit
from pta_replicator_tpu_torch.timing import model as tmodel
from pta_replicator_tpu_torch.timing import time_scales as tts

from _torch_dataset import small_pulsars, write_with

FAMILIES = ("OFFSET", "F0", "F1", "RAJ", "DECJ", "PMRA", "PMDEC", "PX", "DMX_", "FD1", "FD2",
            "PB", "A1", "TASC", "EPS1", "EPS2", "M2", "SINI", "T0", "OM", "ECC", "JUMP")


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(port pulsars, JAX pulsars) loaded from one dataset, as read."""
    pardir, timdir = write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("timing")))
    return (tsim.load_from_directories(pardir, timdir),
            jsim.load_from_directories(pardir, timdir))


def test_time_scales_and_observatory_geometry_equal_jax():
    mjd = np.linspace(41000.0, 60000.0, 997)
    for name in ("tai_minus_utc", "tdb_minus_tt", "tdb_minus_utc", "gmst_rad"):
        assert np.array_equal(getattr(tts, name)(mjd), getattr(jts, name)(mjd)), name
    codes = ["AO", "GBT", "gb", "7", "@", "AXIS", "meerkat"] * (len(mjd) // 7) + ["AO"] * (
        len(mjd) % 7)
    got = tts.observatory_position_au(mjd, codes)
    assert np.array_equal(got, jts.observatory_position_au(mjd, codes))
    assert np.abs(got).max() > 0 and (got[4::7] == 0).all()
    for code in ("ao", "arecibo", "1", "nope"):
        assert tts.site_itrf_m(code) == jts.site_itrf_m(code)


def test_binary_delays_equal_jax(loaded):
    ports, jaxs = loaded
    t = np.linspace(53000.0, 58800.0, 501)
    kinds = set()
    for a, b in zip(ports, jaxs):
        got, want = tcomp.BinaryModel.from_par(a.par), jcomp.BinaryModel.from_par(b.par)
        if want is None:
            assert got is None
            continue
        kinds.add(got.model)
        assert got.fit_param_names() == want.fit_param_names()
        assert np.array_equal(got.delay_s(t), want.delay_s(t))
        cols, names = tcomp.binary_columns(got, t)
        jcols, jnames = jcomp.binary_columns(want, t)
        assert names == jnames and np.array_equal(np.stack(cols), np.stack(jcols))
    assert kinds == {"ELL1", "DD"}


def test_timing_models_and_delays_equal_jax(loaded):
    ports, jaxs = loaded
    for a, b in zip(ports, jaxs):
        got, want = tmodel.TimingModel.from_par(a.par), jmodel.TimingModel.from_par(b.par)
        assert got.pm_vec_rad_yr == want.pm_vec_rad_yr and got.px_rad == want.px_rad
        assert (got.ra_rad, got.dec_rad, got.jumps, got.fd, got.dmx) == (
            want.ra_rad, want.dec_rad, want.jumps, want.fd, want.dmx)
        t = a.toas.get_mjds()
        kw = dict(freqs_mhz=a.toas.freqs_mhz, flags=a.toas.flags,
                  observatories=a.toas.observatories)
        assert np.array_equal(got.delays_s(t, **kw), want.delays_s(t, **kw))


def test_phase_residuals_equal_jax(loaded):
    ports, jaxs = loaded
    for a, b in zip(ports, jaxs):
        kw = dict(freqs_mhz=a.toas.freqs_mhz, flags=a.toas.flags,
                  observatories=a.toas.observatories)
        got = tmodel.phase_residuals(a.model, a.toas.mjd, a.toas.errors_s, **kw)
        want = jmodel.phase_residuals(b.model, b.toas.mjd, b.toas.errors_s, **kw)
        assert np.array_equal(got, want)
        spin = tmodel.SpindownTiming.from_par(a.par)
        assert np.array_equal(
            tmodel.phase_residuals(spin, a.toas.mjd, a.toas.errors_s),
            jmodel.phase_residuals(jmodel.SpindownTiming.from_par(b.par), b.toas.mjd,
                                   b.toas.errors_s))
        assert tmodel.weighted_mean(got, a.toas.errors_s) == jmodel.weighted_mean(
            want, b.toas.errors_s)


@pytest.mark.parametrize("include", ["auto", "spin", ["F0", "RAJ", "DMX_0002", "JUMP1"]])
def test_full_design_matrix_equals_jax_with_every_column_family(loaded, include):
    ports, jaxs = loaded
    seen = set()
    for a, b in zip(ports, jaxs):
        kw = dict(freqs_mhz=a.toas.freqs_mhz, f0=a.model.f0, include=include,
                  flags=a.toas.flags)
        got, names = tcomp.full_design_matrix(a.par, a.toas.get_mjds(), **kw)
        want, jnames = jcomp.full_design_matrix(b.par, b.toas.get_mjds(), **kw)
        assert names == jnames and got.dtype == np.float64
        assert np.array_equal(got, want)
        seen |= {f for f in FAMILIES for n in names if n.startswith(f)}
    if include == "auto":
        assert seen == set(FAMILIES)


def test_design_tensor_equals_jax_and_pads_rows_and_columns(loaded):
    ports, jaxs = loaded
    nt = max(p.toas.ntoas for p in ports) + 5
    got, names = tfit.design_tensor(ports, ntoa_max=nt)
    want, jnames = jfit.design_tensor(jaxs, ntoa_max=nt)
    assert names == jnames and got.shape == want.shape and np.array_equal(got, want)
    widths = [len(n) for n in names]
    assert len(set(widths)) > 1 and got.shape[2] == max(widths)
    for i, p in enumerate(ports):
        assert not got[i, p.toas.ntoas:].any() and not got[i, :, widths[i]:].any()


def test_wls_and_gls_solvers_equal_jax(loaded):
    ports, _ = loaded
    p = ports[0]
    M, _ = tcomp.full_design_matrix(p.par, p.toas.get_mjds(), freqs_mhz=p.toas.freqs_mhz,
                                    f0=p.model.f0, flags=p.toas.flags)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(p.toas.ntoas) * 1e-6
    sigma = p.toas.errors_s
    for got, want in zip(tfit.wls_fit(r, sigma, M, return_cov=True),
                         jfit.wls_fit(r, sigma, M, return_cov=True)):
        assert np.array_equal(got, want)
    C = np.diag(sigma**2) + 1e-14 * np.exp(-np.abs(np.subtract.outer(p.toas.get_mjds(),
                                                                      p.toas.get_mjds())) / 30)
    for got, want in zip(tfit.gls_fit(r, C, M, return_cov=True),
                         jfit.gls_fit(r, C, M, return_cov=True)):
        assert np.array_equal(got, want)
    assert np.array_equal(tfit.design_matrix(r, 300.0, nspin=3),
                          jfit.design_matrix(r, 300.0, nspin=3))
