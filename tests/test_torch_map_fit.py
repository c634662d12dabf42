"""The port's MAP fit (``likelihood/infer.py::map_fit``) against the JAX
package's on tests/test_likelihood.py's setup, float64 on the CPU: the
same damped-Newton steps from gradients and Hessians of the same
likelihood (autograd in the port, jax.grad/jax.hessian in the
reference), so the same point, curvature and iteration count."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu import likelihood as jlk
from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.models.batched import Recipe, realize
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.likelihood import gp as tgp

#: x and sigma, relative: both evaluate the same float64 likelihood and its
#: derivatives, differing by rounding
TOL_MAP = 1e-6
START = {"gwb_log10_amplitude": -14.6, "gwb_gamma": 3.8}


def _full_recipe(batch, seed=0):
    """tests/test_likelihood.py's acceptance configuration."""
    nb = len(batch.backend_names)
    rng = np.random.default_rng(seed)
    return Recipe(
        efac=jnp.asarray(rng.uniform(0.9, 1.4, (batch.npsr, nb))),
        log10_equad=jnp.asarray(rng.uniform(-6.8, -6.2, (batch.npsr, nb))),
        log10_ecorr=jnp.asarray(rng.uniform(-6.9, -6.4, (batch.npsr, nb))),
        rn_log10_amplitude=jnp.asarray(rng.uniform(-13.8, -13.2, batch.npsr)),
        rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, batch.npsr)),
        gwb_log10_amplitude=jnp.asarray(-14.2),
        gwb_gamma=jnp.asarray(13.0 / 3.0),
        rn_nmodes=20,
        gwb_gls_nmodes=15,
    )


@pytest.fixture(scope="module")
def setup():
    batch = synthetic_batch(npsr=12, ntoa=300, nbackend=3, seed=1, dtype=jnp.float64)
    recipe = _full_recipe(batch)
    r0 = np.asarray(realize(jax.random.PRNGKey(11), batch, recipe, nreal=1))[0]
    port = (convert.batch_from_arrays(vars(batch), device="cpu"),
            convert.recipe_from_arrays(vars(recipe), device="cpu"))
    return batch, recipe, r0, port


def test_map_fit_matches_jax(setup):
    batch, recipe, r0, (tb, tr) = setup
    want = jlk.map_fit(jnp.asarray(r0), batch, recipe, START)
    got = lk.map_fit(r0, tb, tr, START, device="cpu")
    assert got.converged == want.converged and got.converged
    assert got.iterations == want.iterations
    assert got.names == want.names == ("gwb_gamma", "gwb_log10_amplitude")
    assert np.max(np.abs(got.x - want.x) / np.abs(want.x)) <= TOL_MAP
    assert np.max(np.abs(got.sigma - want.sigma) / np.abs(want.sigma)) <= TOL_MAP
    assert np.isclose(got.loglikelihood, want.loglikelihood, rtol=1e-10)
    np.testing.assert_allclose(got.fisher, np.asarray(want.fisher), rtol=TOL_MAP)
    d = got.as_dict()
    assert d["names"] == ["gwb_gamma", "gwb_log10_amplitude"] and d["iterations"] == got.iterations
    assert d["x"] == [float(v) for v in got.x] and np.isfinite(d["loglikelihood"])


def test_map_fit_climbs_and_prices_curvature(setup):
    """The reference's own checks on the port: it improves on the start,
    beats (or ties) the truth point, and reports finite sigmas."""
    _, _, r0, (tb, tr) = setup
    mr = lk.map_fit(r0, tb, tr, START, device="cpu")
    start = dataclasses.replace(tr, gwb_log10_amplitude=torch.tensor(-14.6, dtype=torch.float64),
                                gwb_gamma=torch.tensor(3.8, dtype=torch.float64))
    r = torch.from_numpy(r0)
    assert mr.loglikelihood >= float(tgp.loglikelihood(r, tb, start))
    assert mr.loglikelihood >= float(tgp.loglikelihood(r, tb, tr)) - 1e-6
    assert np.all(np.isfinite(mr.sigma)) and mr.iterations <= 50


def test_map_fit_runs_in_float64_from_a_float32_batch(setup):
    """The fit casts to float64 (float32 cannot resolve the differences
    near the peak): a float32 batch and residuals give the float64 fit of
    the same (rounded) inputs."""
    _, _, r0, (tb, tr) = setup
    tb32 = tb.astype(torch.float32)
    r32 = torch.from_numpy(r0).float()
    got = lk.map_fit(r32, tb32, tr, START, device="cpu")
    want = lk.map_fit(r32.double(), tb32.astype(torch.float64), tr, START, device="cpu")
    assert got.converged and np.array_equal(got.x, want.x)


def test_map_fit_with_white_noise_axes_and_a_design(setup):
    """Gradients reach sigma^2 (EFAC) through the white/ECORR solver, and
    the design's marginalization joins the objective; the JAX fit agrees."""
    batch, recipe, r0, (tb, tr) = setup
    t = np.asarray(batch.toas_s) / np.asarray(batch.tspan_s)[:, None]
    design = np.stack([np.ones_like(t), t, t**2], -1) * np.asarray(batch.mask)[..., None]
    jrec = dataclasses.replace(recipe, efac=jnp.asarray(1.1))
    trec = dataclasses.replace(tr, efac=torch.tensor(1.1, dtype=torch.float64))
    start = {"efac": 1.3, "gwb_log10_amplitude": -14.4}
    want = jlk.map_fit(jnp.asarray(r0), batch, jrec, start, design=jnp.asarray(design))
    got = lk.map_fit(r0, tb, trec, start, design=design, device="cpu")
    assert got.converged == want.converged and got.iterations == want.iterations
    assert np.max(np.abs(got.x - want.x) / np.abs(want.x)) <= TOL_MAP
    assert np.max(np.abs(got.sigma - want.sigma) / np.abs(want.sigma)) <= TOL_MAP


def test_map_fit_checks_its_axes(setup):
    _, _, r0, (tb, tr) = setup
    with pytest.raises(ValueError, match="not a Recipe field"):
        lk.map_fit(r0, tb, tr, {"nope": 1.0}, device="cpu")
    with pytest.raises(ValueError, match="static"):
        lk.map_fit(r0, tb, tr, {"rn_nmodes": 10.0}, device="cpu")
