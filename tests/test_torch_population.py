"""The population path of the port (``models/population.py``,
``utils/cosmology.py``) against the JAX package: the cosmology and the
split bit for bit, the recipe field by field through
``convert.recipe_from_arrays``, a zero-outlier split without a CW catalog,
and the recipe realized with the JAX draws at <= 1e-9 of the RMS
(float64, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_parity import jax_realize_draws, rel_rms
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.models import population as jpop
from pta_replicator_tpu.ops.orf import hellings_downs_matrix
from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship
from pta_replicator_tpu.utils import cosmology as jcosmo
from pta_replicator_tpu_torch import convert, realize
from pta_replicator_tpu_torch.models import population as tpop
from pta_replicator_tpu_torch.utils import cosmology as tcosmo
from test_population import _toy_population

T_OBS = 16 * 365.25 * 86400.0
FOBS = np.logspace(-9, -7.5, 6)
TOL_REALIZE = 1e-9


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)


def test_cosmology_bit_for_bit():
    z = np.random.default_rng(4).uniform(0.0, 6.0, 257)
    for fn in ("comoving_distance_cm", "luminosity_distance_cm"):
        assert _same(getattr(tcosmo, fn)(z), getattr(jcosmo, fn)(z)), fn
        assert getattr(tcosmo, fn)(1.3) == getattr(jcosmo, fn)(1.3), fn
    mtot, mrat = 10 ** np.linspace(8, 10, 9), np.linspace(0.1, 1.0, 9)
    m1, m2 = tcosmo.m1m2_from_mtmr(mtot, mrat)
    assert _same(m1, jcosmo.m1m2_from_mtmr(mtot, mrat)[0])
    assert _same(tcosmo.chirp_mass(m1, m2), jcosmo.chirp_mass(m1, m2))
    args = (1e9 * tcosmo.MSOL_G, 1e3 * tcosmo.MPC_CM * np.linspace(1, 3, 5), 1e-8)
    assert _same(tcosmo.gw_strain_source(*args), jcosmo.gw_strain_source(*args))
    for name in ("H0_KM_S_MPC", "OMEGA_M", "C_CMS", "G_CGS", "MSOL_G", "PC_CM", "MPC_CM"):
        assert getattr(tcosmo, name) == getattr(jcosmo, name), name


@pytest.mark.parametrize("outlier_per_bin", (0, 1, 3, 100))
def test_split_population_equals_jax(outlier_per_bin):
    vals, weights = _toy_population()
    weights[::7] = 0.0  # zero-strain entries never become outliers
    got = tpop.split_population(vals, weights, FOBS, T_OBS, outlier_per_bin)
    want = jpop.split_population(vals, weights, FOBS, T_OBS, outlier_per_bin)
    for f in dataclasses.fields(want):
        assert _same(getattr(got, f.name), getattr(want, f.name)), f.name
    assert _same(got.user_spectrum, want.user_spectrum)


def _recipes(outlier_per_bin, base=None, jbase=None):
    vals, weights = _toy_population(n=80, seed=5)
    chol = np.linalg.cholesky(hellings_downs_matrix(
        np.stack([np.linspace(0.1, 6.0, 3), np.linspace(0.3, 2.8, 3)], axis=1)))
    kw = dict(outlier_per_bin=outlier_per_bin, seed=11, howml=4.0, gwb_npts=64)
    want = jpop.population_recipe(vals, weights, FOBS, T_OBS, chol, base_recipe=jbase, **kw)
    got = tpop.population_recipe(vals, weights, FOBS, T_OBS, chol, base_recipe=base,
                                 device="cpu", **kw)
    return got, want


def test_population_recipe_equals_jax_field_by_field():
    got, want = _recipes(3)
    carried = convert.recipe_from_arrays(vars(want), device="cpu")
    assert got.cgw_params.shape[0] == 8 and got.cgw_params.shape[1] > 0
    for f in dataclasses.fields(carried):
        g, w = getattr(got, f.name), getattr(carried, f.name)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), f.name
        else:
            assert g == w, f.name


def test_zero_outlier_split_leaves_the_catalog_off():
    got, want = _recipes(0)
    assert got.cgw_params is None and want.cgw_params is None
    assert got.gwb_user_spectrum is not None


def test_population_recipe_realizes_as_jax_with_its_draws():
    """A.22's gate: the population on a small flagship batch (its noise
    kept as the base recipe), realized from the JAX draws."""
    jb, jr = jax_flagship(npsr=3, ntoa=512, ncw=2)
    jr = dataclasses.replace(jr, cgw_params=None)
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    base = convert.recipe_from_arrays(vars(jr), device="cpu")
    got_r, want_r = _recipes(2, base=base, jbase=jr)
    key = jax.random.PRNGKey(8)
    want = np.asarray(JB.realize(key, jb, want_r, nreal=3, fit=True))
    got = realize(None, tb, got_r, 3, fit=True, noise=jax_realize_draws(key, jb, want_r, 3),
                  device="cpu")
    assert rel_rms(got, want) <= TOL_REALIZE
