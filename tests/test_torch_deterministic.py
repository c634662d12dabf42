"""The deterministic families and the user GWB spectrum of the port against
the JAX package, float64 on the CPU: a burst with memory, a burst and a
transient (each alone, and all four families through
``deterministic_delays``), ``characteristic_strain`` with a user spectrum
(inside its nodes, clamped at both ends, floored with a warning),
``gwb_delays`` and ``realize`` with it, the GLS noise model's GWB block,
and the likelihood's reduced route (``_reducible``).

Tolerance: 1e-12 of the largest |reference| entry (the same float64
formulas in another order), apart from ``realize``, whose stochastic
delays already differ at ~1e-10 (the realize tests' own 1e-9)."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.likelihood import infer as jinfer
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.models import gwb as jgwb
from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship
from pta_replicator_tpu_torch import convert, realize
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.likelihood import infer as tinfer
from pta_replicator_tpu_torch.models import batched as TB
from pta_replicator_tpu_torch.models import gwb as tgwb
from pta_replicator_tpu_torch.scenarios.compile import deterministic_families

SHAPE = dict(npsr=4, ntoa=1024, ncw=12)
TOL = 1e-12
TOL_REALIZE = 1e-9


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def workload():
    jb, jr = jax_flagship(**SHAPE)
    return jb, jr, convert.batch_from_arrays(vars(jb), device="cpu")


@pytest.fixture(scope="module")
def families(workload):
    return deterministic_families(workload[0], seed=3, transient_psr=2)


def _user_spectrum():
    """Nodes between 2 and 60 nHz: the synthesis grid runs below and above
    them, so both clamps engage."""
    f = np.geomspace(2e-9, 6e-8, 9)
    return np.stack([f, 1e-15 * (f / 1e-8) ** (-2.0 / 3.0) * (1 + 0.3 * np.sin(f / 1e-8))], axis=1)


# ------------------------------------------------------- the families

def test_gw_memory_delays_match_jax(workload, families):
    jb, _, tb = workload
    strain, theta, phi, pol, t0 = families["gwm_params"]
    want = JB.gw_memory_delays(jb, strain, theta, phi, pol, t0)
    got = TB.gw_memory_delays(tb, *torch.as_tensor(families["gwm_params"]).unbind(0))
    assert np.any(np.asarray(want) != 0.0)
    assert _rel_max(got, want) <= TOL


def test_burst_delays_match_jax(workload, families):
    jb, _, tb = workload
    sky, grid = families["burst_sky"], families["burst_grid"]
    want = JB.burst_delays(jb, sky[0], sky[1], jnp.asarray(families["burst_hplus"]),
                           jnp.asarray(families["burst_hcross"]), grid[0], grid[1], psi=sky[2])
    t = lambda x: torch.as_tensor(x)
    got = TB.burst_delays(tb, t(sky[0]), t(sky[1]), t(families["burst_hplus"]),
                          t(families["burst_hcross"]), t(grid[0]), t(grid[1]), psi=t(sky[2]))
    assert np.any(np.asarray(want) != 0.0)
    # zero outside the window
    outside = (tb.toas_s < grid[0]) | (tb.toas_s > grid[1])
    assert bool(outside.any()) and bool((got[outside] == 0).all())
    assert _rel_max(got, want) <= TOL


def test_transient_delays_match_jax(workload, families):
    jb, _, tb = workload
    grid = families["transient_grid"]
    want = JB.transient_delays(jb, 2, jnp.asarray(families["transient_waveform"]), grid[0], grid[1])
    got = TB.transient_delays(tb, 2, torch.as_tensor(families["transient_waveform"]),
                              torch.as_tensor(grid[0]), torch.as_tensor(grid[1]))
    assert np.count_nonzero(np.asarray(got).any(axis=-1)) == 1 and bool(got[2].abs().max() > 0)
    assert _rel_max(got, want) <= TOL
    with pytest.raises(ValueError, match="outside the batch"):
        TB.transient_delays(tb, 4, torch.as_tensor(families["transient_waveform"]), 0.0, 1.0)


def test_deterministic_delays_with_every_family_match_jax(workload, families):
    """The CW catalog, then memory, burst and transient, once per sweep."""
    jb, jr, tb = workload
    jr = dataclasses.replace(jr, **{k: v if k == "transient_psr" else jnp.asarray(v)
                                    for k, v in families.items()})
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    assert tr.transient_psr == 2
    want = np.asarray(JB.deterministic_delays(jb, jr))
    got = TB.deterministic_delays(tb, tr, device="cpu")
    assert _rel_max(got, want) <= TOL
    cw_only = TB.deterministic_delays(tb, dataclasses.replace(
        tr, gwm_params=None, burst_sky=None, burst_hplus=None, burst_hcross=None,
        burst_grid=None, transient_waveform=None, transient_grid=None), device="cpu")
    assert float((got - cw_only).abs().max()) > 0.0


# ------------------------------------------------- the user spectrum

def test_interp_matches_numpy():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 10, 7))
    fp = rng.standard_normal(7)
    x = np.concatenate([rng.uniform(-3, 13, 40), xp])
    got = tgwb.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp))
    np.testing.assert_allclose(got.numpy(), np.interp(x, xp, fp), rtol=0, atol=1e-14)


@pytest.mark.parametrize("where", ["inside", "below", "above"])
def test_characteristic_strain_user_spectrum_matches_jax(where):
    spec = _user_spectrum()
    lo, hi = spec[0, 0], spec[-1, 0]
    f = {"inside": np.geomspace(lo, hi, 17), "below": np.geomspace(lo / 50, lo, 5),
         "above": np.geomspace(hi, hi * 20, 5)}[where]
    want = np.asarray(jgwb.characteristic_strain(jnp.asarray(f), user_spectrum=jnp.asarray(spec),
                                                 xp=jnp))
    got = tgwb.characteristic_strain(torch.as_tensor(f), user_spectrum=torch.as_tensor(spec))
    assert _rel_max(got, want) <= TOL
    if where != "inside":  # clamped to the end node's value
        end = spec[0, 1] if where == "below" else spec[-1, 1]
        np.testing.assert_allclose(got.numpy(), end, rtol=1e-12)


def test_user_spectrum_floor_warns_as_jax():
    spec = _user_spectrum()
    spec[3, 1] = 0.0
    f = np.geomspace(spec[0, 0], spec[-1, 0], 11)
    with pytest.warns(UserWarning, match="floored to 1e-30"):
        want = np.asarray(jgwb.characteristic_strain(jnp.asarray(f), user_spectrum=np.asarray(spec),
                                                     xp=jnp))
    with pytest.warns(UserWarning, match="1 strain value\\(s\\) below 1e-30 were floored"):
        got = tgwb.characteristic_strain(torch.as_tensor(f), user_spectrum=torch.as_tensor(spec))
    assert np.all(np.isfinite(got.numpy()))
    assert _rel_max(got, want) <= TOL
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tgwb.characteristic_strain(torch.as_tensor(f), user_spectrum=torch.as_tensor(_user_spectrum()))


def test_gwb_delays_user_spectrum_match_jax(workload):
    jb, jr, tb = workload
    key = jax.random.PRNGKey(4)
    spec = _user_spectrum()
    want = JB.gwb_delays(key, jb, None, None, jr.orf_cholesky, user_spectrum=jnp.asarray(spec))
    nf = jgwb.gwb_grid(jb.start_s, jb.stop_s, 600, 10)[2].shape[0]
    eps = np.asarray(jax.random.normal(key, (2, jr.orf_cholesky.shape[1], nf), jnp.float64))
    got = TB.gwb_delays(None, tb, None, None, torch.as_tensor(np.array(jr.orf_cholesky)),
                        user_spectrum=torch.as_tensor(spec), eps=torch.as_tensor(eps))
    assert _rel_max(got, want) <= TOL


def _spectrum_recipe(jr, amplitude=False):
    """The flagship recipe with its GWB a user spectrum (the power law's
    amplitude kept or dropped; the spectrum overrides it either way)."""
    kw = dict(gwb_user_spectrum=jnp.asarray(_user_spectrum()), gwb_gamma=None)
    if not amplitude:
        kw["gwb_log10_amplitude"] = None
    return dataclasses.replace(jr, **kw)


@pytest.mark.parametrize("amplitude", [False, True])
def test_realize_with_user_spectrum_matches_jax(workload, amplitude):
    jb, jr, tb = workload
    jr = _spectrum_recipe(jr, amplitude)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    key = jax.random.PRNGKey(6)
    draws = jax_realize_draws(key, jb, jr, 3)
    assert "gwb" in draws and "gwb" in TB.noise_shapes(tb, tr)
    want = np.asarray(JB.realize(key, jb, jr, nreal=3, fit=True))
    got = realize(None, tb, tr, 3, fit=True, noise=draws, device="cpu")
    assert _rel_max(got, want) <= TOL_REALIZE


def test_gls_noise_model_user_spectrum_matches_jax(workload):
    jb, jr, tb = workload
    jr = _spectrum_recipe(jr)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    want = JB.gls_noise_model(jb, jr)
    got = TB.gls_noise_model(tb, tr)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert _rel_max(g, w) <= TOL
    assert _rel_max(TB.gls_prior(tb, tr), want[3]) <= TOL


@pytest.mark.parametrize("names,amplitude", [
    (("rn_log10_amplitude",), False),
    (("rn_gamma", "rn_log10_amplitude"), False),
    (("gwb_log10_amplitude",), False),
    (("gwb_log10_amplitude",), True),
    (("efac",), False),
])
def test_reducible_with_user_spectrum_matches_jax(workload, names, amplitude):
    jb, jr, tb = workload
    jr = _spectrum_recipe(jr, amplitude)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    assert tinfer._reducible(names, tr) == jinfer._reducible(names, jr)


def test_user_spectrum_recipe_without_red_noise_stays_reducible(workload):
    """Only the GWB block, as a user spectrum: a grid over nothing but phi
    fields is still reducible (the spectrum enables the block)."""
    _, jr, _ = workload
    jr = dataclasses.replace(_spectrum_recipe(jr, amplitude=True), rn_log10_amplitude=None,
                             rn_gamma=None)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    assert tinfer._reducible(("gwb_log10_amplitude",), tr) == jinfer._reducible(
        ("gwb_log10_amplitude",), jr) == True  # noqa: E712


def test_grid_loglikelihood_with_user_spectrum_matches_jax(workload):
    """A red-noise grid over residuals priced with a user-spectrum GWB
    block rides the reduced route in both packages and agrees."""
    jb, jr, tb = workload
    jr = _spectrum_recipe(jr)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    res = np.asarray(JB.realize(jax.random.PRNGKey(2), jb, jr, nreal=1, fit=True))[0]
    grid = {"rn_log10_amplitude": np.linspace(-14.4, -13.2, 3)}
    from pta_replicator_tpu import likelihood as jlk

    t = np.asarray(jb.toas_s) / np.asarray(jb.tspan_s)[:, None]
    design = np.stack([np.ones_like(t), t, t**2], axis=-1)
    want = np.asarray(jlk.grid_loglikelihood(jnp.asarray(res), jb, jr, grid, design=design))
    got = lk.grid_loglikelihood(torch.as_tensor(res), tb, tr, grid,
                                design=torch.as_tensor(design), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
