"""The covariance slice of the port against the JAX package, float64 on the
CPU: every covariance op carried across by ``convert.covop_from_arrays``,
``realize`` with each op on the JAX package's replayed draws, and the
likelihood (direct, bank and a grid over ``cov_log10_sigma``) for a banded
recipe without ECORR (the block-tridiagonal rung) and a Kronecker recipe
with ECORR (the dense rung)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws, rel_rms
from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.covariance import (
    COV_STREAM_FOLD,
    LowRankCov,
    banded_from_times,
    dense_from_times,
    dense_noise_covariance,
    kron_time_channel,
)
from pta_replicator_tpu.likelihood import gp as jgp
from pta_replicator_tpu.likelihood import infer as jinfer
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu_torch import convert, covariance as tcov
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch import realize
from pta_replicator_tpu_torch.models import batched as TB

NPSR, NT = 4, 128
#: an op's matvec/solve/logdet/sample: the same algebra on the same inputs
TOL_OP = 1e-10
#: the port's dense assembly against the JAX package's dense oracle
TOL_DENSE = 1e-8
#: whole realizations, relative to the RMS
TOL_REALIZE = 1e-9
#: log-likelihoods per pulsar, relative
TOL_LL = 1e-10

GRID = {"gwb_log10_amplitude": np.linspace(-14.6, -13.9, 2),
        "gwb_gamma": np.linspace(3.5, 5.0, 2)}


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(npsr=NPSR, ntoa=NT, nbackend=2, seed=1, dtype=jnp.float64)


@pytest.fixture(scope="module")
def masked_batch(batch):
    """The reference tests' batch with a masked tail on pulsar 0."""
    mask = np.asarray(batch.mask).copy()
    mask[0, -9:] = 0.0
    return dataclasses.replace(batch, mask=jnp.asarray(mask, batch.mask.dtype),
                               ntoas=jnp.asarray(mask.sum(axis=-1), batch.ntoas.dtype))


def _ops(batch):
    """The reference tests' four ops (tests/test_covariance.py::_ops)."""
    t, m = np.asarray(batch.toas_s), np.asarray(batch.mask)
    banded = banded_from_times(t, m, rho=0.6, corr_s=40 * 86400.0, block=16, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    return {
        "banded": banded,
        "kron": kron_time_channel(t, channels=4, time_ell_s=20 * 86400.0, chan_rho=0.8,
                                  dtype=jnp.float64),
        "dense": dense_from_times(t, m, corr_s=60 * 86400.0, dtype=jnp.float64),
        "lowrank": LowRankCov(base=banded,
                              U=jnp.asarray(rng.standard_normal((NPSR, NT, 5)) * 0.3 * m[:, :, None]),
                              phi=jnp.asarray(rng.uniform(0.5, 1.5, (NPSR, 5)))),
    }


KINDS = ["banded", "kron", "dense", "lowrank"]


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _recipe(batch, cov=None, ls=-6.3, **kw):
    """The reference tests' recipe (tests/test_covariance.py::_recipe) with
    a GWB block, so the likelihood has a phi grid."""
    rng = np.random.default_rng(0)
    base = dict(
        efac=jnp.asarray(rng.uniform(0.9, 1.2, (NPSR, 2))),
        rn_log10_amplitude=jnp.asarray(rng.uniform(-13.6, -13.2, NPSR)),
        rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, NPSR)),
        gwb_log10_amplitude=jnp.asarray(-14.2), gwb_gamma=jnp.asarray(13.0 / 3.0),
        rn_nmodes=8, gwb_gls_nmodes=5,
    )
    base.update(kw)
    if cov is not None:
        base["noise_cov"] = cov
        base["cov_log10_sigma"] = jnp.asarray(ls)
    return JB.Recipe(**base)


def _design(batch):
    t = np.asarray(batch.toas_s)
    scale = np.asarray(batch.tspan_s)[:, None]
    return np.stack([np.ones_like(t), t / scale, (t / scale) ** 2, np.zeros_like(t)], axis=-1)


def _port(batch, recipe):
    return (convert.batch_from_arrays(vars(batch), device="cpu"),
            convert.recipe_from_arrays(vars(recipe), device="cpu"))


# ------------------------------------------------------------ the ops

@pytest.mark.parametrize("kind", KINDS)
def test_covop_carried_across_matches_jax(batch, masked_batch, kind):
    b = batch if kind == "kron" else masked_batch
    jop = _ops(b)[kind]
    top = convert.covop_from_arrays(vars(jop), device="cpu")
    assert type(top).__name__ == type(jop).__name__
    rng = np.random.default_rng(3)
    x = rng.standard_normal((NPSR, NT))
    X = rng.standard_normal((NPSR, NT, 3))
    s2 = rng.uniform(0.5, 2.0, NPSR)
    for xx in (x, X):
        assert _rel_max(top.matvec(torch.as_tensor(xx), s2=torch.as_tensor(s2)),
                        jop.matvec(jnp.asarray(xx), s2=jnp.asarray(s2))) <= TOL_OP
        assert _rel_max(top.solve(torch.as_tensor(xx), s2=torch.as_tensor(s2)),
                        jop.solve(jnp.asarray(xx), s2=jnp.asarray(s2))) <= TOL_OP
    assert _rel(top.logdet(s2=torch.as_tensor(s2)), jop.logdet(s2=jnp.asarray(s2))) <= TOL_OP
    assert _rel(top.logdet(), jop.logdet()) <= TOL_OP

    # the sample on the replayed draw of one realization key
    key = jax.random.PRNGKey(5)
    draws = jax_realize_draws(key, b, _recipe(b, cov=jop), 1)
    want = jop.sample(jax.random.fold_in(jax.random.split(key, 1)[0], COV_STREAM_FOLD),
                      s2=jnp.asarray(s2))
    got = top.sample({k: torch.as_tensor(v[0]) for k, v in draws.items() if k.startswith("cov")},
                     s2=torch.as_tensor(s2))
    assert _rel_max(got, want) <= TOL_OP
    np.testing.assert_allclose(top.dense(), jop.dense(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(top.dense(pad_identity=False), jop.dense(pad_identity=False),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("kind", KINDS)
def test_dense_assembly_matches_jax_oracle(batch, masked_batch, kind):
    """The port's noise model plus its op's dense matrix against the JAX
    package's dense_noise_covariance."""
    b = batch if kind == "kron" else masked_batch
    recipe = _recipe(b, cov=_ops(b)[kind], log10_ecorr=jnp.asarray(-6.7))
    tb, tr = _port(b, recipe)
    sigma2, ecorr2, U, phi = TB.gls_noise_model(tb, tr)
    C = torch.diag_embed(sigma2)
    onehot = (tb.epoch_index[..., None] == torch.arange(ecorr2.shape[1])).double() * tb.mask[..., None]
    C = C + torch.einsum("pne,pe,pme->pnm", onehot, ecorr2, onehot)
    C = C + torch.einsum("pnr,pr,pmr->pnm", U, phi, U)
    C = C.numpy() + tr.noise_cov.dense(pad_identity=False) * float(tcov.recipe_cov_s2(tr))
    assert _rel_max(C, dense_noise_covariance(b, recipe)) <= TOL_DENSE


def test_noise_cov_draws_come_last_and_are_checked(masked_batch):
    recipe = _recipe(masked_batch, cov=_ops(masked_batch)["lowrank"], log10_ecorr=jnp.asarray(-6.7))
    tb, tr = _port(masked_batch, recipe)
    shapes = TB.noise_shapes(tb, tr)
    assert list(shapes)[-2:] == ["cov", "cov_lowrank"]
    assert shapes["cov"] == (NPSR, NT) and shapes["cov_lowrank"] == (NPSR, 5)
    plain = dataclasses.replace(tr, noise_cov=None, cov_log10_sigma=None)
    assert list(shapes)[:-2] == list(TB.noise_shapes(tb, plain))
    # enabling the covariance leaves every other family's draws unchanged
    g = lambda: torch.Generator().manual_seed(3)
    with_cov = TB.draw_noise(g(), tb, tr, 2)
    without = TB.draw_noise(g(), tb, plain, 2)
    for name, draw in without.items():
        assert torch.equal(with_cov[name], draw)
    small = convert.batch_from_arrays(vars(synthetic_batch(npsr=NPSR, ntoa=64, nbackend=2, seed=1,
                                                           dtype=jnp.float64)), device="cpu")
    with pytest.raises(ValueError, match="noise_cov covers"):
        TB.noise_shapes(small, tr)


# ------------------------------------------------------------ realize

@pytest.mark.parametrize("kind", KINDS)
def test_realize_with_covop_matches_jax(batch, masked_batch, kind):
    b = batch if kind == "kron" else masked_batch
    recipe = _recipe(b, cov=_ops(b)[kind], log10_ecorr=jnp.asarray(-6.7))
    key = jax.random.PRNGKey(11)
    want = np.asarray(JB.realize(key, b, recipe, 3, fit=True))
    tb, tr = _port(b, recipe)
    got = realize(None, tb, tr, 3, fit=True, noise=jax_realize_draws(key, b, recipe, 3),
                  device="cpu")
    assert rel_rms(got.numpy(), want) <= TOL_REALIZE


# --------------------------------------------------------- likelihood

def _likelihood_case(batch, masked_batch, name):
    if name == "banded":  # no ECORR: the block-tridiagonal rung
        b = masked_batch
        recipe = _recipe(b, cov=_ops(b)["banded"])
    else:  # Kronecker with ECORR: the dense rung
        b = batch
        recipe = _recipe(b, cov=_ops(b)["kron"], ls=-6.6, log10_ecorr=jnp.asarray(-6.7))
    res = np.random.default_rng(5).standard_normal((3, NPSR, NT)) * 1e-6 * np.asarray(b.mask)
    return b, recipe, res, _port(b, recipe)


@pytest.mark.parametrize("name", ["banded", "kron_ecorr"])
def test_loglikelihood_with_cov_matches_jax(batch, masked_batch, name):
    b, recipe, res, (tb, tr) = _likelihood_case(batch, masked_batch, name)
    design = _design(b)
    want = jgp.loglikelihood(jnp.asarray(res[0]), b, recipe, design=jnp.asarray(design),
                             per_pulsar=True)
    got = lk.loglikelihood(torch.as_tensor(res[0]), tb, tr, design=torch.as_tensor(design),
                           per_pulsar=True)
    assert _rel(got, want) <= TOL_LL
    # the reduced fast path prices the same C0: equal to the direct route
    reduced = lk.ReducedGP.build(tb, tr, design=torch.as_tensor(design))
    fast = reduced.loglikelihood(reduced.project(torch.as_tensor(res[0]), tb),
                                 lk.phi_for_recipe(tb, tr), per_pulsar=True)
    assert _rel(fast, got) <= 1e-9
    assert reduced.extra is tr.noise_cov


@pytest.mark.parametrize("name", ["banded", "kron_ecorr"])
def test_bank_and_cov_grid_match_jax(batch, masked_batch, name):
    b, recipe, res, (tb, tr) = _likelihood_case(batch, masked_batch, name)
    design = _design(b)
    grid, _ = jinfer.grid_cartesian(GRID)
    want = jinfer.bank_loglikelihood(jnp.asarray(res), b, recipe, grid=grid,
                                     design=jnp.asarray(design))
    got = lk.bank_loglikelihood(torch.as_tensor(res), tb, tr, grid=grid,
                                design=torch.as_tensor(design), device="cpu")
    assert got.shape == (4, 3) and _rel(got, want) <= TOL_LL

    sig = {"cov_log10_sigma": np.linspace(-6.8, -6.0, 3)}
    want = jinfer.grid_loglikelihood(jnp.asarray(res[1]), b, recipe, sig,
                                     design=jnp.asarray(design), per_pulsar=True)
    got = lk.grid_loglikelihood(torch.as_tensor(res[1]), tb, tr, sig,
                                design=torch.as_tensor(design), per_pulsar=True, device="cpu")
    assert got.shape == (3, NPSR) and _rel(got, want) <= TOL_LL
    with pytest.raises(ValueError, match="phi-only"):
        lk.bank_loglikelihood(torch.as_tensor(res), tb, tr, grid=sig, device="cpu")


def test_fused_refuses_a_noise_cov_in_both_packages(masked_batch):
    b = masked_batch
    recipe = _recipe(b, cov=_ops(b)["banded"])
    tb, tr = _port(b, recipe)
    res = np.zeros((2, NPSR, NT))
    grid, _ = jinfer.grid_cartesian(GRID)
    with pytest.raises(ValueError, match="noise_cov"):
        jinfer.bank_loglikelihood(jnp.asarray(res), b, recipe, grid=grid, fused=True)
    with pytest.raises(ValueError, match="noise_cov"):
        jgp.ReducedGP.build_fused(b, recipe)
    with pytest.raises(ValueError, match="noise_cov"):
        lk.bank_loglikelihood(torch.as_tensor(res), tb, tr, grid=grid, fused=True, device="cpu")
    with pytest.raises(ValueError, match="noise_cov"):
        lk.grid_loglikelihood(torch.as_tensor(res[0]), tb, tr, grid, fused=True, device="cpu")
    with pytest.raises(ValueError, match="noise_cov"):
        lk.ReducedGP.build_fused(tb, tr)


def test_server_over_phi_axes_prices_the_cov_in_c0(masked_batch):
    b = masked_batch
    recipe = _recipe(b, cov=_ops(b)["banded"])
    tb, tr = _port(b, recipe)
    res = torch.as_tensor(np.random.default_rng(6).standard_normal((3, NPSR, NT)) * 1e-6)
    grid, _ = lk.grid_cartesian(GRID)
    ll = lk.bank_loglikelihood(res, tb, tr, grid=grid, device="cpu")
    axes = ("gwb_gamma", "gwb_log10_amplitude")
    with lk.LikelihoodServer(lk.RealizationBank.from_array(res), tb, tr, axes,
                             device="cpu") as server:
        for i in range(2):
            row = server.evaluate(**{k: float(grid[k][i]) for k in axes})
            assert _rel(row, ll[i]) <= TOL_LL


# ------------------------------------------------------- the recipe

def test_recipe_to_and_astype_reach_the_covop(masked_batch):
    recipe = _recipe(masked_batch, cov=_ops(masked_batch)["lowrank"])
    _, tr = _port(masked_batch, recipe)
    cast = tr.astype(torch.float32)
    assert cast.noise_cov.U.dtype == torch.float32
    assert cast.noise_cov.base.Ld.dtype == torch.float32
    assert cast.noise_cov.base.nt == NT
    assert tr.noise_cov.U.dtype == torch.float64  # the original is untouched
    moved = tr.to("meta")
    assert moved.noise_cov.base.D.device.type == "meta"
    assert moved.noise_cov.phi.device.type == "meta"
    assert moved.cov_log10_sigma.device.type == "meta"


def test_recipe_validates_the_covariance_fields(masked_batch):
    with pytest.raises(ValueError, match="cov_log10_sigma"):
        TB.Recipe(cov_log10_sigma=-6.0)
    with pytest.raises(ValueError, match="CovOp"):
        TB.Recipe(noise_cov=_ops(masked_batch)["banded"])  # a JAX op, not carried across
    with pytest.raises(TypeError, match="no covariance op"):
        convert.covop_from_arrays({"mat": 1}, device="cpu")


def test_port_builders_match_jax_builders(masked_batch, batch):
    t, m = np.asarray(masked_batch.toas_s), np.asarray(masked_batch.mask)
    pairs = [
        (tcov.banded_from_times(t, m, rho=0.6, corr_s=40 * 86400.0, block=16, device="cpu"),
         _ops(masked_batch)["banded"]),
        (tcov.dense_from_times(t, m, corr_s=60 * 86400.0, device="cpu"),
         _ops(masked_batch)["dense"]),
        (tcov.kron_time_channel(np.asarray(batch.toas_s), 4, 20 * 86400.0, 0.8, device="cpu"),
         _ops(batch)["kron"]),
    ]
    for port_op, jax_op in pairs:
        for name, value in vars(jax_op).items():
            got = getattr(port_op, name)
            if isinstance(got, torch.Tensor):
                np.testing.assert_allclose(got.numpy(), np.asarray(value), rtol=1e-13, atol=1e-15)
            else:
                assert got == value
    with pytest.raises(ValueError, match="FULL TOA grid"):
        tcov.kron_time_channel(t, 4, 20 * 86400.0, 0.8, mask=m, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tcov.kron_time_channel(t[:, :127], 4, 20 * 86400.0, 0.8, device="cpu")


def test_builders_run_on_the_card_unless_asked_for_cpu(masked_batch, batch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, m = np.asarray(masked_batch.toas_s), np.asarray(masked_batch.mask)
    for build in (lambda **d: tcov.banded_from_times(t, m, 0.5, 30 * 86400.0, block=16, **d),
                  lambda **d: tcov.dense_from_times(t, m, 30 * 86400.0, **d),
                  lambda **d: tcov.kron_time_channel(np.asarray(batch.toas_s), 4, 1e6, 0.9, **d),
                  lambda **d: convert.covop_from_arrays(vars(_ops(batch)["kron"]), **d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        assert build(device="cpu").nvalid.device.type == "cpu"
