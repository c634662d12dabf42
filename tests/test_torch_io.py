"""The port's par/tim/noise-dictionary I/O and its host helpers against the
JAX package's: ``read_par`` and the ``ParModel`` accessors, ``read_tim``
(native and Python parsers, an INCLUDE directive) with the same longdouble
epoch bits, ``write_tim`` and ``ParModel.write`` with the same bytes,
``fabricate_toas``, ``parse_noise_dict``, ``quantize`` and the sky
coordinates; and the native reader's build, which raises instead of
falling back to the Python parser."""
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.io import par as jpar
from pta_replicator_tpu.io import tim as jtim
from pta_replicator_tpu.io.noise_dict import parse_noise_dict as jax_noise_dict
from pta_replicator_tpu.ops import coords as jcoords
from pta_replicator_tpu.ops.quantize import quantize as jax_quantize
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.io import native
from pta_replicator_tpu_torch.io import par as tpar
from pta_replicator_tpu_torch.io import tim as ttim
from pta_replicator_tpu_torch.io.noise_dict import parse_noise_dict
from pta_replicator_tpu_torch.ops import coords as tcoords
from pta_replicator_tpu_torch.ops.quantize import quantize

from _torch_dataset import file_bytes, small_pulsars, write_with

PARSERS = {"native": True, "python": False}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The small dataset written by the JAX package and by the port."""
    pulsars = small_pulsars()
    root = tmp_path_factory.mktemp("io")
    return (pulsars, write_with(jsim, pulsars, str(root / "jax")),
            write_with(tsim, pulsars, str(root / "port")))


def _parfiles(pardir):
    return sorted(os.path.join(pardir, f) for f in os.listdir(pardir))


def test_the_port_writes_the_jax_package_bytes(dataset):
    _, jax_dirs, port_dirs = dataset
    for jd, pd in zip(jax_dirs, port_dirs):
        want, got = file_bytes(jd), file_bytes(pd)
        assert list(got) == list(want) and len(got) == 4
        assert got == want


@pytest.mark.parametrize("index", range(4))
def test_read_par_and_its_accessors_equal_jax(dataset, index):
    _, (pardir, _), _ = dataset
    path = _parfiles(pardir)[index]
    got, want = tpar.read_par(path), jpar.read_par(path)
    for field in ("name", "raj_hours", "decj_deg", "elong_deg", "elat_deg", "f0", "f1", "f2",
                  "pepoch_mjd", "dm", "params", "lines", "path"):
        assert getattr(got, field) == getattr(want, field), field
    for accessor in ("loc", "jumps", "fd_terms", "dmx_windows", "waves", "wave_om",
                     "wave_epoch"):
        assert getattr(got, accessor) == getattr(want, accessor), accessor
    assert got.jumps and len(got.fd_terms) == 2 and len(got.dmx_windows) > 3
    assert got.param_error("F0") == want.param_error("F0")
    # the setters rewrite the same lines
    for model in (got, want):
        model.set_param("F1", -1.25e-15)
        model.set_param_error("F0", 3.5e-13)
        model.set_jump(0, 1.5e-6)
        model.set_jump_error(0, 2e-8)
        model.ensure_waves(2, om=0.01)
    assert got.lines == want.lines and got.params == want.params
    out_port, out_jax = path + ".port", path + ".jax"
    got.write(out_port)
    want.write(out_jax)
    assert open(out_port, "rb").read() == open(out_jax, "rb").read()
    os.unlink(out_port), os.unlink(out_jax)


def test_parse_par_lines_equals_read_par(dataset):
    _, (pardir, _), _ = dataset
    for path in _parfiles(pardir):
        with open(path) as fh:
            lines = fh.read().splitlines()
        a, b = tpar.parse_par_lines(lines, path=path), tpar.read_par(path)
        assert (a.params, a.lines, a.loc, a.name) == (b.params, b.lines, b.loc, b.name)


def _same_toas(got, want):
    assert got.mjd.dtype == np.longdouble and np.array_equal(got.mjd, want.mjd)
    for field in ("errors_s", "freqs_mhz"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    for field in ("observatories", "flags", "labels"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("parser", sorted(PARSERS))
def test_read_tim_equals_jax(dataset, parser):
    _, (_, timdir), _ = dataset
    ttim.reads.clear()
    for path in _parfiles(timdir):
        got = ttim.read_tim(path, use_native=PARSERS[parser])
        _same_toas(got, jtim.read_tim(path, use_native=PARSERS[parser]))
        assert 150 <= got.ntoas <= 400 and len(set(f["f"] for f in got.flags)) >= 1
    assert ttim.reads == {parser: 4}


def test_native_and_python_parsers_read_the_same_bits(dataset):
    _, (_, timdir), _ = dataset
    for path in _parfiles(timdir):
        _same_toas(ttim.read_tim(path), ttim.read_tim(path, use_native=False))


def test_an_include_directive_goes_through_the_python_parser(dataset, tmp_path):
    _, (_, timdir), _ = dataset
    first, second = _parfiles(timdir)[:2]
    shutil.copy(second, tmp_path / "inner.tim")
    outer = tmp_path / "outer.tim"
    outer.write_text(open(first).read() + "TIME 0.5\nINCLUDE inner.tim\nEFAC 1.5\n")
    ttim.reads.clear()
    got = ttim.read_tim(str(outer))
    assert ttim.reads == {"python": 1}
    want = jtim.read_tim(str(outer))
    _same_toas(got, want)
    assert got.ntoas == ttim.read_tim(first).ntoas + ttim.read_tim(second).ntoas


@pytest.mark.parametrize("parser", sorted(PARSERS))
def test_write_tim_writes_the_jax_bytes(dataset, tmp_path, parser):
    _, (_, timdir), _ = dataset
    for path in _parfiles(timdir):
        toas = jtim.read_tim(path)
        toas.adjust_seconds(np.linspace(-3e-6, 5e-6, toas.ntoas))
        mine = ttim.TOAData(mjd=toas.mjd.copy(), errors_s=toas.errors_s.copy(),
                            freqs_mhz=toas.freqs_mhz.copy(),
                            observatories=list(toas.observatories),
                            flags=[dict(f) for f in toas.flags], labels=list(toas.labels))
        ttim.write_tim(mine, str(tmp_path / "port.tim"), use_native=PARSERS[parser])
        jtim.write_tim(toas, str(tmp_path / "jax.tim"))
        assert (tmp_path / "port.tim").read_bytes() == (tmp_path / "jax.tim").read_bytes()
        # a second write through the static-parts cache keeps the bytes
        ttim.write_tim(mine, str(tmp_path / "again.tim"), reuse_static_parts=True)
        ttim.write_tim(mine, str(tmp_path / "again.tim"), reuse_static_parts=True)
        assert (tmp_path / "again.tim").read_bytes() == (tmp_path / "jax.tim").read_bytes()


def test_fabricate_toas_equals_jax():
    mjds = np.linspace(55000.0, 56000.0, 37)
    flags = {"f": "PUPPI", "fe": "L-wide"}
    got = ttim.fabricate_toas(mjds, np.linspace(0.5, 2.0, 37), freq_mhz=1400.0,
                              observatory="AO", flags=flags)
    want = jtim.fabricate_toas(mjds, np.linspace(0.5, 2.0, 37), freq_mhz=1400.0,
                               observatory="AO", flags=flags)
    _same_toas(got, want)
    got.adjust_seconds(np.full(37, 1e-6))
    want.adjust_seconds(np.full(37, 1e-6))
    assert np.array_equal(got.mjd, want.mjd)


def test_a_failed_native_build_raises_and_nothing_falls_back(dataset, tmp_path, monkeypatch):
    _, (_, timdir), _ = dataset
    source = native.SOURCE.read_text()
    broken = tmp_path / "fast_tim.cpp"
    broken.write_text(source + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="failed"):
        native.load_library(broken)
    monkeypatch.setattr(native, "SOURCE", broken)
    path = _parfiles(timdir)[0]
    ttim.reads.clear()
    with pytest.raises(RuntimeError, match="failed"):
        ttim.read_tim(path)
    with pytest.raises(RuntimeError, match="failed"):
        ttim.write_tim(ttim.read_tim(path, use_native=False), str(tmp_path / "x.tim"))
    assert ttim.reads == {"python": 1}
    # an unbuilt source and no compiler: the same, naming the compiler
    fresh = tmp_path / "fresh.cpp"
    fresh.write_text(source + "\n// an unbuilt copy\n")
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.load_library(fresh)


def test_the_native_library_is_built_into_the_port(dataset):
    native.load_library()
    path = native.library_path()
    assert path.is_file() and path.parent.name == "_build"
    assert path.parent.parent.name == "pta_replicator_tpu_torch"


def test_parse_noise_dict_equals_jax():
    raw = {"J0030+0451_ASP_efac": 1.1, "J0030+0451_ASP_log10_ecorr": -6.5,
           "J0030+0451_PUPPI_efac": 0.9, "J0030+0451_PUPPI_log10_t2equad": -7.1,
           "J0030+0451_red_noise_gamma": 3.2, "J0030+0451_red_noise_log10_A": -14.1,
           "B1855+09_GUPPI_log10_tnequad": -6.9, "B1855+09_odd_key": 7}
    assert parse_noise_dict(raw) == jax_noise_dict(raw)


def test_quantize_equals_jax(dataset):
    pulsars, _, _ = dataset
    for p in pulsars:
        t = np.asarray(p.mjd, np.float64)
        flags = [f["f"] for f in p.flags]
        got, want = quantize(t, flags=flags, dt=0.1), jax_quantize(t, flags=flags, dt=0.1)
        assert np.array_equal(got.epoch_index, want.epoch_index)
        assert np.array_equal(got.ave_times, want.ave_times)
        assert np.array_equal(got.ave_flags, want.ave_flags)
        assert np.array_equal(got.exploder(), want.exploder())


@pytest.mark.parametrize("name", ["J1909-3744", "B1855+09"])
def test_sky_coordinates_equal_jax(name):
    for loc in ({"RAJ": 19.15, "DECJ": -37.7}, {"ELONG": 284.3, "ELAT": 32.1}):
        assert tcoords.pulsar_ra_dec(loc, name) == jcoords.pulsar_ra_dec(loc, name)
        assert tcoords.pulsar_theta_phi(loc, name) == jcoords.pulsar_theta_phi(loc, name)
    assert np.array_equal(tcoords.unit_vector(0.7, 2.1), jcoords.unit_vector(0.7, 2.1))
    epoch = tcoords.ecliptic_epoch(name)
    assert tcoords.equatorial_to_ecliptic(1.2, -0.4, epoch) == \
        jcoords.equatorial_to_ecliptic(1.2, -0.4, epoch)
    assert np.array_equal(tcoords.equatorial_to_ecliptic_tangent(1.2, -0.4, epoch),
                          jcoords.equatorial_to_ecliptic_tangent(1.2, -0.4, epoch))
