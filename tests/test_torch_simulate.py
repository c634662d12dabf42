"""The port's pulsar lifecycle against the JAX package's: ``simulate_pulsar``,
``load_pulsar``, ``load_from_directories`` (the thread pool in a
deterministic order, equal to the serial load), ``make_ideal`` (TOAs and
residuals bit for bit, residual RMS <= 1e-9 s, the JAX package's own
bound), ``inject`` and the ledger, the ``write_partim`` round trip, and
``save_pulsar`` / ``load_pulsar_checkpoint`` with each package reading the
other's file; the oracle's refit and ``to_enterprise`` run."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.utils import checkpoint as jck
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.utils import checkpoint as tck

from _torch_dataset import small_pulsars, write_with

#: make_ideal's bound on the residual RMS (tests/test_simulate.py)
IDEAL_RMS_S = 1e-9


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("simulate")))


def _same_pulsar(got, want, residuals=True):
    assert (got.name, got.loc, got.ephem) == (want.name, want.loc, want.ephem)
    assert got.toas.mjd.dtype == np.longdouble and np.array_equal(got.toas.mjd, want.toas.mjd)
    assert np.array_equal(got.toas.errors_s, want.toas.errors_s)
    assert np.array_equal(got.toas.freqs_mhz, want.toas.freqs_mhz)
    assert (got.toas.flags, got.toas.observatories) == (want.toas.flags, want.toas.observatories)
    if residuals:
        assert np.array_equal(got.residuals.resids_value, want.residuals.resids_value)


def _pairs(pardir, timdir):
    return [(os.path.join(pardir, p), os.path.join(timdir, t))
            for p, t in zip(sorted(os.listdir(pardir)), sorted(os.listdir(timdir)))]


def test_simulate_pulsar_equals_jax(dirs):
    parfile = _pairs(*dirs)[1][0]
    mjds = np.linspace(54000.0, 57000.0, 211)
    args = dict(freq=np.linspace(700.0, 1600.0, 211), observatory="GBT", flags={"f": "GUPPI"})
    got = tsim.simulate_pulsar(parfile, mjds, 0.8, **args)
    want = jsim.simulate_pulsar(parfile, mjds, 0.8, **args)
    _same_pulsar(got, want)
    assert got.added_signals is None
    with pytest.raises(FileNotFoundError):
        tsim.simulate_pulsar(parfile + ".missing", mjds, 0.8)


def test_load_pulsar_equals_jax(dirs):
    for parfile, timfile in _pairs(*dirs):
        _same_pulsar(tsim.load_pulsar(parfile, timfile), jsim.load_pulsar(parfile, timfile))


def test_load_from_directories_parallel_equals_serial_and_jax(dirs):
    parallel = tsim.load_from_directories(*dirs, workers=4)
    serial = tsim.load_from_directories(*dirs, workers=1)
    want = jsim.load_from_directories(*dirs)
    assert [p.name for p in parallel] == [p.name for p in want] == sorted(
        os.path.splitext(n)[0] for n in os.listdir(dirs[0]))
    for a, b, c in zip(parallel, serial, want):
        _same_pulsar(a, b)
        _same_pulsar(a, c)
    assert [p.name for p in tsim.load_from_directories(*dirs, num_psrs=2)] == [
        p.name for p in want[:2]]
    with pytest.raises(FileNotFoundError):
        tsim.load_from_directories(dirs[0] + "/missing", dirs[1])


def test_make_ideal_equals_jax_and_zeroes_the_residuals(dirs):
    ports, jaxs = tsim.load_from_directories(*dirs), jsim.load_from_directories(*dirs)
    for a, b in zip(ports, jaxs):
        assert np.sqrt(np.mean(a.residuals.resids_value**2)) > 1e-6
        tsim.make_ideal(a)
        jsim.make_ideal(b)
        _same_pulsar(a, b)
        assert np.sqrt(np.mean(a.residuals.resids_value**2)) <= IDEAL_RMS_S
        assert a.added_signals == {} and a.added_signals_time == {}


def test_inject_and_the_ledger_equal_jax(dirs):
    parfile, timfile = _pairs(*dirs)[0]
    got, want = tsim.load_pulsar(parfile, timfile), jsim.load_pulsar(parfile, timfile)
    with pytest.raises(ValueError, match="make_ideal"):
        got.inject("white", {}, np.zeros(got.toas.ntoas))
    tsim.make_ideal(got)
    jsim.make_ideal(want)
    dt = np.random.default_rng(1).standard_normal(got.toas.ntoas) * 1e-6
    names = [(p.inject("white", {"efac": 1.1}, dt), p.inject("white", {"efac": 1.2}, 2 * dt),
              p.update_added_signals("cw", {"mc": 1e9}))
             for p in (got, want)]
    assert names[0] == names[1] == ("white", "white_2", "cw")
    _same_pulsar(got, want)
    assert got.added_signals == want.added_signals
    assert got.added_signals["white_2"]["disambiguated_from"] == "white"
    for k in want.added_signals_time:
        assert np.array_equal(got.added_signals_time[k], want.added_signals_time[k])
    assert [np.array_equal(a, b) for a, b in zip(got.to_arrays()[:3], want.to_arrays()[:3])] == [
        True] * 3


def test_write_partim_round_trip(dirs, tmp_path):
    parfile, timfile = _pairs(*dirs)[2]
    psr = tsim.load_pulsar(parfile, timfile)
    tsim.make_ideal(psr)
    psr.write_partim(str(tmp_path / "a.par"), str(tmp_path / "a.tim"))
    back = tsim.load_pulsar(str(tmp_path / "a.par"), str(tmp_path / "a.tim"))
    # epochs are written at 1e-15 day (86 ps)
    step = np.abs(np.asarray((back.toas.mjd - psr.toas.mjd) * np.longdouble(86400.0), float))
    assert step.max() <= 1e-10
    back.write_partim(str(tmp_path / "b.par"), str(tmp_path / "b.tim"))
    for ext in ("par", "tim"):
        assert (tmp_path / f"a.{ext}").read_bytes() == (tmp_path / f"b.{ext}").read_bytes()
    assert (tmp_path / "a.par").read_text().splitlines() == psr.par.lines


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pulsar_checkpoints_load_in_either_package(dirs, tmp_path, writer):
    parfile, timfile = _pairs(*dirs)[0]
    psrs = {"port": tsim.load_pulsar(parfile, timfile), "jax": jsim.load_pulsar(parfile, timfile)}
    for p in psrs.values():
        (tsim if isinstance(p, tsim.SimulatedPulsar) else jsim).make_ideal(p)
        p.inject("red", {"gamma": 4.0}, np.linspace(-1e-7, 2e-7, p.toas.ntoas))
    path = str(tmp_path / "psr.npz")
    (tck if writer == "port" else jck).save_pulsar(psrs[writer], path)
    got, want = tck.load_pulsar_checkpoint(path), jck.load_pulsar_checkpoint(path)
    _same_pulsar(got, want)
    _same_pulsar(got, psrs[writer], residuals=False)
    assert got.added_signals == want.added_signals == {"red": {"gamma": 4.0}}
    assert np.array_equal(got.added_signals_time["red"], want.added_signals_time["red"])
    assert got.par.lines == want.par.lines and got.model == convert.pulsar_from_jax(want).model


def test_the_oracle_refit_and_to_enterprise_run(dirs, monkeypatch):
    """The refit runs and writes the fitted par (its parity with the JAX
    package is tests/test_torch_oracle_fit.py's); ``to_enterprise`` hands a
    written par/tim pair to ``enterprise.pulsar.Pulsar``."""
    import sys
    import types

    psr = tsim.load_pulsar(*_pairs(*dirs)[0])
    tsim.make_ideal(psr)
    psr.inject("red", {}, 1e-6 * np.sin(np.linspace(0.0, 9.0, psr.toas.ntoas)))
    before = list(psr.par.lines)
    psr.fit()
    assert psr.par.lines != before and "F0" in psr.fit_uncertainties
    sub = types.ModuleType("enterprise.pulsar")
    sub.Pulsar = lambda par, tim, **kw: (os.path.basename(par), os.path.basename(tim), kw)
    monkeypatch.setitem(sys.modules, "enterprise", types.ModuleType("enterprise"))
    monkeypatch.setitem(sys.modules, "enterprise.pulsar", sub)
    assert psr.to_enterprise() == (f"{psr.name}.par", f"{psr.name}.tim",
                                   {"ephem": "DE440", "timing_package": "pint"})
