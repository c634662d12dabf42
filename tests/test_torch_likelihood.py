"""The likelihood slice of the port against the JAX package, float64 on
the CPU: the GP noise model and its white/ECORR solver, the direct and
reduced log-likelihoods, grid and bank evaluation, the server, and the
whole chain realize -> bank_loglikelihood on the JAX package's draws."""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.likelihood import gp as jgp
from pta_replicator_tpu.likelihood import infer as jinfer
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.models.batched import Recipe
from pta_replicator_tpu_torch import convert, realize
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.likelihood import gp as tgp
from pta_replicator_tpu_torch.likelihood import serve as tserve
from pta_replicator_tpu_torch.models import batched as TB

#: noise-model blocks (the same ops on the same inputs)
TOL_BLOCKS = 1e-12
#: log-likelihoods per pulsar, relative
TOL_LL = 1e-10
#: the port's reduced likelihood against the JAX dense-covariance oracle
TOL_DENSE = 1e-8

GRID = {"gwb_log10_amplitude": np.linspace(-14.6, -13.9, 3),
        "gwb_gamma": np.linspace(3.5, 5.0, 3)}


def _recipe(batch, seed=0, **extra):
    """tests/test_gp_kernels.py's noise: per-backend EFAC/EQUAD/ECORR,
    8-mode red noise and a 6-mode GWB block."""
    nb = len(batch.backend_names)
    rng = np.random.default_rng(seed)
    fields = dict(
        efac=jnp.asarray(rng.uniform(0.9, 1.4, (batch.npsr, nb))),
        log10_equad=jnp.asarray(rng.uniform(-6.8, -6.2, (batch.npsr, nb))),
        log10_ecorr=jnp.asarray(rng.uniform(-6.9, -6.4, (batch.npsr, nb))),
        rn_log10_amplitude=jnp.asarray(rng.uniform(-13.8, -13.2, batch.npsr)),
        rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, batch.npsr)),
        gwb_log10_amplitude=jnp.asarray(-14.2),
        gwb_gamma=jnp.asarray(13.0 / 3.0),
        rn_nmodes=8,
        gwb_gls_nmodes=6,
    )
    return Recipe(**dict(fields, **extra))


def _masked(batch, frac=0.15, seed=9):
    """A random tenth-or-so of the TOAs knocked out, ntoas kept consistent."""
    mask = np.asarray(batch.mask) * (np.random.default_rng(seed).random(batch.mask.shape) >= frac)
    return dataclasses.replace(batch, mask=jnp.asarray(mask, batch.mask.dtype),
                               ntoas=jnp.asarray(mask.sum(axis=-1), batch.ntoas.dtype))


def _design(batch, kpad=1):
    """Quadratic design with ``kpad`` all-zero padding columns."""
    t = np.asarray(batch.toas_s)
    scale = np.asarray(batch.tspan_s)[:, None]
    return np.stack([np.ones_like(t), t / scale, (t / scale) ** 2] + [np.zeros_like(t)] * kpad,
                    axis=-1)


def _case(name):
    batch = synthetic_batch(npsr=6, ntoa=180, nbackend=2, seed=3, dtype=jnp.float64)
    if name == "chromatic":
        recipe = _recipe(batch, chrom_log10_amplitude=jnp.asarray(-13.6),
                         chrom_gamma=jnp.asarray(3.0), chrom_index=jnp.asarray(4.0),
                         chrom_nmodes=5, tnequad=True)
    elif name == "masked":
        batch = _masked(batch)
        # per-pulsar GWB amplitudes: the (Np,) branch of the GWB prior
        recipe = _recipe(batch, gwb_log10_amplitude=jnp.asarray(np.linspace(-14.4, -14.0, 6)))
    else:
        recipe = _recipe(batch)
    res = np.random.default_rng(11).standard_normal(batch.toas_s.shape) * 1e-6 * np.asarray(batch.mask)
    port = (convert.batch_from_arrays(vars(batch), device="cpu"),
            convert.recipe_from_arrays(vars(recipe), device="cpu"))
    return batch, recipe, res, port


CASES = ["base", "chromatic", "masked"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def base():
    return _case("base")


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


# ------------------------------------------------------------ noise model

def test_gls_noise_model_matches_jax(case):
    batch, recipe, _, (tb, tr) = case
    want = JB.gls_noise_model(batch, recipe)
    got = TB.gls_noise_model(tb, tr)
    for name, g, x in zip(("sigma2", "ecorr2", "U", "phi"), got, want):
        assert tuple(g.shape) == x.shape, name
        assert _rel_max(g.numpy(), x) <= TOL_BLOCKS, name
    # phi without the basis: the same values
    assert _rel_max(TB.gls_prior(tb, tr).numpy(), want[3]) <= TOL_BLOCKS
    torch.testing.assert_close(tgp.phi_for_recipe(tb, tr), got[3], rtol=0, atol=0)


def test_white_ecorr_parts_and_solver_match_jax(case):
    batch, recipe, _, (tb, tr) = case
    sigma2, ecorr2, _, _ = JB.gls_noise_model(batch, recipe)
    ts2, te2, _, _ = TB.gls_noise_model(tb, tr)
    X = np.random.default_rng(4).standard_normal(batch.toas_s.shape + (5,))
    winv, seg_sum, gain, logdet = JB.white_ecorr_parts(batch, sigma2, ecorr2, jnp.float64)
    twinv, tseg, tgain, tlogdet = TB.white_ecorr_parts(tb, ts2, te2, torch.float64)
    for g, x in ((twinv, winv), (tgain, gain), (tlogdet, logdet),
                 (tseg(torch.from_numpy(X)), seg_sum(jnp.asarray(X)))):
        assert _rel_max(g.numpy(), x) <= TOL_BLOCKS
    _, c0inv, logdet_s = JB.white_ecorr_solver(batch, sigma2, ecorr2, jnp.float64)
    _, tc0inv, tlogdet_s = TB.white_ecorr_solver(tb, ts2, te2, torch.float64)
    assert _rel_max(tc0inv(torch.from_numpy(X)).numpy(), c0inv(jnp.asarray(X))) <= TOL_BLOCKS
    assert _rel_max(tlogdet_s.numpy(), logdet_s) <= TOL_BLOCKS
    # leading (realization) axes ride through the segment sum
    stacked = tseg(torch.from_numpy(np.stack([X, 2 * X])))
    torch.testing.assert_close(stacked[1], 2 * stacked[0], rtol=1e-15, atol=0)


def test_white_ecorr_solver_refuses_a_structured_block(base):
    """A structured block in C0 must be one of the port's covariance ops
    (tests/test_torch_covariance.py prices those)."""
    _, _, _, (tb, tr) = base
    ts2, te2, _, _ = TB.gls_noise_model(tb, tr)
    with pytest.raises(TypeError, match="CovOp"):
        TB.white_ecorr_solver(tb, ts2, te2, torch.float64, extra=object())


def test_gwb_gls_nmodes_carries_across_from_jax(base):
    """A JAX recipe with gwb_gls_nmodes=6 keeps it in the port: the GWB
    block of U is 12 columns wide (8 red modes + 6 GWB modes)."""
    batch, recipe, _, (tb, tr) = base
    assert recipe.gwb_gls_nmodes == 6 and tr.gwb_gls_nmodes == 6
    U = TB.gls_noise_model(tb, tr)[2]
    assert U.shape[-1] == 2 * 8 + 2 * 6 == np.asarray(JB.gls_noise_model(batch, recipe)[2]).shape[-1]
    assert TB._gp_blocks(tb, tr)[-1][1].shape == (batch.npsr, 12)
    assert TB.gls_noise_model(tb, dataclasses.replace(tr, gwb_gls_nmodes=30))[2].shape[-1] == 76


# ------------------------------------------------------------ likelihoods

@pytest.mark.parametrize("with_design", [False, True])
def test_direct_loglikelihood_matches_jax(case, with_design):
    batch, recipe, res, (tb, tr) = case
    design = _design(batch) if with_design else None
    want = np.asarray(jgp.loglikelihood(jnp.asarray(res), batch, recipe, design=design,
                                        per_pulsar=True))
    got = tgp.loglikelihood(torch.from_numpy(res), tb, tr, design=design, per_pulsar=True)
    assert got.shape == (batch.npsr,)
    assert _rel(got.numpy(), want) <= TOL_LL
    total = float(tgp.loglikelihood(torch.from_numpy(res), tb, tr, design=design))
    assert abs(total - want.sum()) <= TOL_LL * abs(want.sum())


@pytest.mark.parametrize("fused", [False, True])
def test_reduced_gp_matches_jax_and_the_dense_oracle(case, fused):
    """The serving path of the port, composed and fused, against the JAX
    ReducedGP at several points, and against the JAX dense-covariance
    oracle at the recipe's own point."""
    batch, recipe, res, (tb, tr) = case
    design = _design(batch)
    jred = jgp.ReducedGP.build(batch, recipe, design=design)
    jproj = jred.project(jnp.asarray(res), batch)
    red = tgp.ReducedGP.build(tb, tr, design=design, fused=fused)
    assert red.fused == fused and (red.CiT is None) == fused
    proj = red.project(torch.from_numpy(res), tb)
    for amp, gamma in [(-14.5, 4.33), (-13.8, 5.0)]:
        jr = dataclasses.replace(recipe, gwb_log10_amplitude=jnp.asarray(amp),
                                 gwb_gamma=jnp.asarray(gamma))
        tr2 = dataclasses.replace(tr, gwb_log10_amplitude=torch.tensor(amp, dtype=torch.float64),
                                  gwb_gamma=torch.tensor(gamma, dtype=torch.float64))
        want = np.asarray(jred.loglikelihood(jproj, jgp.phi_for_recipe(batch, jr), per_pulsar=True))
        got = red.loglikelihood(proj, tgp.phi_for_recipe(tb, tr2), per_pulsar=True)
        assert _rel(got.numpy(), want) <= TOL_LL
    got = red.loglikelihood(proj, tgp.phi_for_recipe(tb, tr), per_pulsar=True).numpy()
    dense = jgp.dense_loglikelihood(res, batch, recipe, design=design, per_pulsar=True)
    assert _rel(got, dense) <= TOL_DENSE


def test_reduced_gp_batch_axes(base):
    """A grid axis on phi and a realization axis on the projection give
    (G, R) results equal to the one-at-a-time evaluations."""
    _, _, res, (tb, tr) = base
    red = tgp.ReducedGP.build(tb, tr, design=_design(base[0]))
    bank = torch.from_numpy(np.stack([res, -0.7 * res, 1.3 * res]))
    proj = red.project(bank, tb)
    phis = torch.stack([tgp.phi_for_recipe(tb, dataclasses.replace(
        tr, gwb_gamma=torch.tensor(g, dtype=torch.float64))) for g in (3.5, 4.5)])
    both = red.loglikelihood(proj, phis)
    assert both.shape == (2, 3)
    for gi in range(2):
        for ri in range(3):
            one = red.loglikelihood(red.project(bank[ri], tb), phis[gi])
            assert abs(float(both[gi, ri] - one)) <= 1e-12 * abs(float(one))


def test_reduced_gp_rejects_no_basis(base):
    _, _, _, (tb, _) = base
    with pytest.raises(ValueError, match="reduced basis"):
        tgp.ReducedGP.build(tb, TB.Recipe(efac=1.0))
    with pytest.raises(ValueError, match="no GP noise block"):
        tgp.phi_for_recipe(tb, TB.Recipe(efac=1.0))


# --------------------------------------------------- grid and bank evaluation

@pytest.mark.parametrize("fused", [False, True])
def test_grid_loglikelihood_reduced_route_matches_jax(case, fused):
    batch, recipe, res, (tb, tr) = case
    design = _design(batch)
    grid, _ = lk.grid_cartesian(GRID)
    want = np.asarray(jinfer.grid_loglikelihood(jnp.asarray(res), batch, recipe, grid,
                                                design=design, per_pulsar=True))
    got = lk.grid_loglikelihood(res, tb, tr, grid, design=design, per_pulsar=True,
                                fused=fused, device="cpu")
    assert got.shape == (9, batch.npsr)
    assert _rel(got.numpy(), want) <= TOL_LL
    chunked = lk.grid_loglikelihood(res, tb, tr, grid, design=design, per_pulsar=True,
                                    fused=fused, chunk=4, device="cpu")
    assert _rel(chunked.numpy(), got.numpy()) <= 1e-14


def test_grid_loglikelihood_direct_route_matches_jax(base):
    """A white-noise axis cannot ride the precompute: the direct route."""
    batch, recipe, res, (tb, tr) = base
    grid = {"efac": np.asarray([0.8, 1.0, 1.3])}
    want = np.asarray(jinfer.grid_loglikelihood(jnp.asarray(res), batch, recipe, grid, chunk=2))
    got = lk.grid_loglikelihood(res, tb, tr, grid, chunk=2, device="cpu")
    assert _rel(got.numpy(), want) <= TOL_LL
    with pytest.raises(ValueError, match="reducible"):
        lk.grid_loglikelihood(res, tb, tr, grid, fused=True, device="cpu")


def test_grid_rejects_static_unknown_and_ragged_axes(base):
    _, _, res, (tb, tr) = base
    with pytest.raises(ValueError, match="not a Recipe field"):
        lk.grid_loglikelihood(res, tb, tr, {"nope": [1.0]}, device="cpu")
    with pytest.raises(ValueError, match="static"):
        lk.grid_loglikelihood(res, tb, tr, {"rn_nmodes": [10]}, device="cpu")
    with pytest.raises(ValueError, match="aligned"):
        lk.grid_loglikelihood(res, tb, tr, {"rn_gamma": [1.0, 2.0],
                                            "rn_log10_amplitude": [1.0]}, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_bank_loglikelihood_matches_jax(base, fused):
    batch, recipe, res, (tb, tr) = base
    design = _design(batch)
    bank = np.stack([res, 0.5 * res, -1.5 * res])
    grid, _ = lk.grid_cartesian(GRID)
    want = np.asarray(jinfer.bank_loglikelihood(jnp.asarray(bank), batch, recipe, grid=grid,
                                                design=design))
    got = lk.bank_loglikelihood(bank, tb, tr, grid=grid, design=design, fused=fused, device="cpu")
    assert got.shape == (9, 3)
    assert _rel(got.numpy(), want) <= TOL_LL
    handle = lk.RealizationBank.from_array(bank, chunk=2)
    from_handle = lk.bank_loglikelihood(handle, tb, tr, grid=grid, design=design, fused=fused,
                                        device="cpu")
    assert _rel(from_handle.numpy(), got.numpy()) <= 1e-14
    flat = lk.bank_loglikelihood(bank, tb, tr, design=design, fused=fused, device="cpu")
    want_flat = np.asarray(jinfer.bank_loglikelihood(jnp.asarray(bank), batch, recipe,
                                                     design=design))
    assert flat.shape == (3,) and _rel(flat.numpy(), want_flat) <= TOL_LL
    with pytest.raises(ValueError, match="phi-only"):
        lk.bank_loglikelihood(bank, tb, tr, grid={"efac": [1.0, 1.1]}, device="cpu")


def test_realize_then_bank_loglikelihood_matches_the_jax_chain():
    """End to end on the JAX package's draws: the JAX realize feeds the
    JAX bank_loglikelihood; the same draws through the port's realize feed
    the port's bank_loglikelihood (quadratic fit and design, f64)."""
    batch = synthetic_batch(npsr=5, ntoa=256, nbackend=2, seed=5, dtype=jnp.float64)
    recipe = _recipe(batch, seed=1)
    key = jax.random.PRNGKey(4)
    jbank = np.asarray(JB.realize(key, batch, recipe, nreal=4, fit=True))
    design = _design(batch, kpad=0)
    grid, _ = lk.grid_cartesian(GRID)
    want = np.asarray(jinfer.bank_loglikelihood(jnp.asarray(jbank), batch, recipe, grid=grid,
                                                design=design))
    tb = convert.batch_from_arrays(vars(batch), device="cpu")
    tr = convert.recipe_from_arrays(vars(recipe), device="cpu")
    tbank = realize(None, tb, tr, 4, fit=True, noise=jax_realize_draws(key, batch, recipe, 4),
                    device="cpu")
    got = lk.bank_loglikelihood(tbank, tb, tr, grid=grid, design=TB.quadratic_design(tb),
                                fused=True, device="cpu")
    assert _rel(got.numpy(), want) <= TOL_LL


# ----------------------------------------------------------------- server

@pytest.fixture
def served(base):
    batch, _, res, (tb, tr) = base
    bank = np.stack([res, 0.5 * res, -1.5 * res])
    return bank, tb, tr, _design(batch)


def test_server_rows_equal_bank_loglikelihood(served):
    bank, tb, tr, design = served
    grid, _ = lk.grid_cartesian(GRID)
    want = lk.bank_loglikelihood(bank, tb, tr, grid=grid, design=design, device="cpu").numpy()
    axes = tuple(GRID)
    with lk.LikelihoodServer(lk.RealizationBank.from_array(bank, chunk=2), tb, tr, axes,
                             design=design, max_batch=4, device="cpu") as server:
        futures = [server.submit(**{k: grid[k][i] for k in axes}) for i in range(9)]
        rows = [f.result(timeout=60) for f in futures]
        stats = server.stats()
    for i, row in enumerate(rows):
        assert row.shape == (3,)
        assert _rel(row, want[i]) <= 1e-12
    assert stats["requests"] == 9 and stats["batches"] >= 3 and stats["latency_s"]["p50"] > 0
    with pytest.raises(ValueError, match="exactly"):
        lk.LikelihoodServer(lk.RealizationBank.from_array(bank), tb, tr, axes,
                            device="cpu").start().submit(gwb_gamma=4.0)


def _gated(monkeypatch):
    """Hold the server's evaluation until released; ``entered`` is set
    once the worker is inside it."""
    entered, release = threading.Event(), threading.Event()
    engine = tserve._reduced_points

    def gated(*args, **kwargs):
        entered.set()
        assert release.wait(30)
        return engine(*args, **kwargs)

    monkeypatch.setattr(tserve, "_reduced_points", gated)
    return entered, release


def test_server_saturates_at_max_queue(served, monkeypatch):
    bank, tb, tr, design = served
    entered, release = _gated(monkeypatch)
    server = lk.LikelihoodServer(lk.RealizationBank.from_array(bank), tb, tr, ("gwb_gamma",),
                                 design=design, max_batch=1, max_delay_s=0.0, max_queue=2,
                                 device="cpu").start()
    try:
        first = server.submit(gwb_gamma=4.0)
        assert entered.wait(30)  # the worker holds the first request
        queued = [server.submit(gwb_gamma=g) for g in (4.1, 4.2)]
        with pytest.raises(lk.ServerSaturated):
            server.submit(gwb_gamma=4.3)
    finally:
        release.set()
        server.stop(timeout=60)
    for f in [first] + queued:
        assert f.result(timeout=60).shape == (3,)
    assert server.stats()["rejected"] == 1


def test_server_expires_queued_requests(served, monkeypatch):
    bank, tb, tr, design = served
    entered, release = _gated(monkeypatch)
    server = lk.LikelihoodServer(lk.RealizationBank.from_array(bank), tb, tr, ("gwb_gamma",),
                                 design=design, max_batch=1, max_delay_s=0.0,
                                 device="cpu").start()
    try:
        first = server.submit(gwb_gamma=4.0)
        assert entered.wait(30)
        late = server.submit(gwb_gamma=4.1, deadline_s=0.01)
        time.sleep(0.05)
    finally:
        release.set()
        server.stop(timeout=60)
    assert first.result(timeout=60).shape == (3,)
    with pytest.raises(lk.DeadlineExpired):
        late.result(timeout=60)
    assert server.stats()["deadline_expired"] == 1


# ----------------------------------------------------------- not ported

def test_unported_parts_raise(base, tmp_path):
    """bf16 is ported and gated: without a numerics capture the entry
    points refuse it (PrecisionNotReady), and an unknown policy stays a
    ValueError."""
    _, _, res, (tb, tr) = base
    with pytest.raises(lk.PrecisionNotReady, match="numerics_capture"):
        lk.grid_loglikelihood(res, tb, tr, GRID, precision="bf16", device="cpu")
    with pytest.raises(lk.PrecisionNotReady, match="numerics_capture"):
        lk.bank_loglikelihood(np.stack([res]), tb, tr, precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tgp.require_precision_ready("fp8")
    assert tgp.require_precision_ready(None) == "highest"
    # the sweep checkpoint is ported (A.8): an empty path now names what it lacks
    with pytest.raises(FileNotFoundError, match="no completed sweep chunks"):
        lk.RealizationBank.from_checkpoint(str(tmp_path / "bank.npz"))


def test_realization_bank_rows_and_chunks(base):
    _, _, res, _ = base
    arr = np.stack([res * k for k in range(5)])
    bank = lk.RealizationBank.from_array(arr, chunk=2)
    assert bank.nreal == 5 and len(list(bank.iter_chunks())) == 3
    np.testing.assert_array_equal(bank.row(3), arr[3])
    np.testing.assert_array_equal(bank.load(), arr)
    with pytest.raises(IndexError):
        bank.row(5)
    tensor_bank = lk.RealizationBank.from_array(torch.from_numpy(arr), chunk=4)
    assert torch.equal(tensor_bank.load(), torch.from_numpy(arr))
    with pytest.raises(ValueError, match="residual cubes"):
        lk.RealizationBank([], (2, 3), np.float64)
