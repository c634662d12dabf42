"""Realizations written out as par/tim datasets (``utils/export.py``):
``write_realization_partim`` writes the JAX package's bytes for the same
delays and restores the template bit for bit; ``materialize_realizations``
rebuilds the engine's draws, so dataset r carries the pre-fit delays of
cube row r, for ``realize`` and for a checkpointed sweep whose r falls in
its second chunk (reloaded, residualized, within 5e-9 s, the JAX CLI
test's bound)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.utils.export import write_realization_partim as jax_write
from pta_replicator_tpu_torch import realize
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import _build_recipe
from pta_replicator_tpu_torch.batch import freeze
from pta_replicator_tpu_torch.utils.export import (
    materialize_realizations, write_realization_partim,
)
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe
from pta_replicator_tpu_torch.utils.sweep import sweep

from _torch_dataset import file_bytes, small_pulsars, write_with

#: dataset r <-> cube row r (tests/test_cli.py)
TOL_SHIFT_S = 5e-9


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    pardir, timdir = write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("export")))
    return pardir, timdir


def _ideal(module, dirs):
    psrs = module.load_from_directories(*dirs)
    for p in psrs:
        module.make_ideal(p)
    return psrs


@pytest.fixture(scope="module")
def engine(dataset):
    """Ideal port pulsars, their float64 batch and a stochastic recipe with
    a CW catalog, on the CPU."""
    psrs = _ideal(tsim, dataset)
    batch = freeze(psrs, dtype=torch.float64, device="cpu")
    spec = ng15_like_recipe(batch.npsr, ncw=5, gwb_npts=100, gwb_howml=4.0)
    spec["rn_nmodes"] = 8
    return psrs, batch, _build_recipe(spec, psrs)


def test_write_realization_partim_writes_the_jax_bytes_and_restores_the_template(
        dataset, tmp_path):
    ports, jaxs = _ideal(tsim, dataset), _ideal(jsim, dataset)
    before = [p.toas.mjd.copy() for p in ports]
    nt = max(p.toas.ntoas for p in ports)
    delays = np.random.default_rng(4).standard_normal((len(ports), nt)) * 3e-6
    write_realization_partim(ports, torch.from_numpy(delays), str(tmp_path / "port"))
    jax_write(jaxs, delays, str(tmp_path / "jax"))
    assert file_bytes(tmp_path / "port") == file_bytes(tmp_path / "jax")
    assert len(file_bytes(tmp_path / "port")) == 2 * len(ports)
    for p, mjd in zip(ports, before):
        assert np.array_equal(p.toas.mjd, mjd)
    with pytest.raises(ValueError, match="npsr"):
        write_realization_partim(ports, delays[:2], str(tmp_path / "bad"))


def _shift_residuals(psr, rdir):
    """The reloaded dataset's TOA shift against the template [s],
    residualized (weighted mean removed), as the cube rows are."""
    back = tsim.load_pulsar(os.path.join(rdir, f"{psr.name}.par"),
                            os.path.join(rdir, f"{psr.name}.tim"))
    shift = np.asarray((back.toas.mjd - psr.toas.mjd) * np.longdouble(86400.0), np.float64)
    w = 1.0 / psr.toas.errors_s**2
    return shift - np.sum(w * shift) / np.sum(w)


def _assert_rows_match(psrs, cube, outdir, rows):
    for r in rows:
        for i, p in enumerate(psrs):
            got = _shift_residuals(p, os.path.join(outdir, f"real{r:05d}"))
            want = cube[r, i, : p.toas.ntoas]
            assert np.abs(want).max() > 1e-7
            np.testing.assert_allclose(got, want, atol=TOL_SHIFT_S, rtol=0)


def test_dataset_r_carries_the_delays_of_realize_row_r(engine, tmp_path):
    psrs, batch, recipe = engine
    cube = realize(torch.Generator().manual_seed(11), batch, recipe, 6, device="cpu").numpy()
    dirs = materialize_realizations(psrs, batch, recipe, 11, 6, str(tmp_path), write_max=4,
                                    device="cpu")
    assert [os.path.basename(d) for d in dirs] == [f"real{r:05d}" for r in range(4)]
    _assert_rows_match(psrs, cube, str(tmp_path), (0, 3))


def test_dataset_r_carries_the_delays_of_a_sweep_row_in_its_second_chunk(engine, tmp_path):
    psrs, batch, recipe = engine
    cube = sweep(5, batch, recipe, 8, str(tmp_path / "ck.npz"), chunk=4, reduce_fn=None,
                 device="cpu")
    dirs = materialize_realizations(psrs, batch, recipe, 5, 8, str(tmp_path / "ds"),
                                    write_max=6, sweep_chunk=4, device="cpu")
    assert len(dirs) == 6
    _assert_rows_match(psrs, cube, str(tmp_path / "ds"), (0, 5))
    with pytest.raises(ValueError, match="multiple"):
        materialize_realizations(psrs, batch, recipe, 5, 6, str(tmp_path / "x"), sweep_chunk=4,
                                 device="cpu")


def test_another_draw_layout_writes_other_datasets(engine, tmp_path):
    """The guard behind the layout rule: the direct layout written for a
    sweep's cube misses row 5 by far more than the bound."""
    psrs, batch, recipe = engine
    cube = sweep(5, batch, recipe, 8, str(tmp_path / "ck.npz"), chunk=4, reduce_fn=None,
                 device="cpu")
    materialize_realizations(psrs, batch, recipe, 5, 8, str(tmp_path / "ds"), write_max=6,
                             device="cpu")
    got = _shift_residuals(psrs[0], str(tmp_path / "ds" / "real00005"))
    assert np.abs(got - cube[5, 0, : psrs[0].toas.ntoas]).max() > 100 * TOL_SHIFT_S


def test_recipe_json_round_trips(engine):
    _, batch, _ = engine
    spec = ng15_like_recipe(batch.npsr, ncw=5)
    assert json.loads(json.dumps(spec)) == spec
    assert np.asarray(spec["efac"]).shape == (batch.npsr, 4)
    assert np.asarray(spec["cgw_params"]).shape == (8, 5)
