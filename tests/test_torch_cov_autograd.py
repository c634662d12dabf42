"""The covariance solvers under autograd, float64 on the CPU: the
``torch.autograd.Function``s of the block-tridiagonal sweeps
(``ops/gp.py``: the factor, its adjoint, the two substitution sweeps) and
of the blocked Cholesky's SYRK update (``ops/cw.py::CovSyrkUpdate``),
which the port's ``map_fit`` differentiates through on the card. On the
CPU each Function runs its plain version inside, so these tests reach the
same adjoint code as the card (bar the CUDA kernels). Then ``map_fit``
over a banded and a Kronecker + ECORR recipe against the JAX package's
(``jax.hessian`` through its scan and ``jnp.linalg.cholesky``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
from torch.autograd import gradcheck, gradgradcheck

from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.covariance import banded_from_times, kron_time_channel
from pta_replicator_tpu.likelihood.infer import map_fit as jax_map_fit
from pta_replicator_tpu.models.batched import Recipe, realize
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.covariance import kernels as tk
from pta_replicator_tpu_torch.covariance import structure as tstruct
from pta_replicator_tpu_torch.ops import cw as tcw
from pta_replicator_tpu_torch.ops import gp as tgp

F64 = torch.float64
#: a Function's gradient against autograd through the plain loops, relative
#: to the largest entry: the same algebra in another order
TOL_GRAD = 1e-12
#: x and sigma of the port's MAP fit against the JAX package's, relative
TOL_MAP = 1e-6
NPSR, NB, B = 2, 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread from this file on: its tensors are tiny, and the
    idle threads of several test workers at once oversubscribe the cores
    (the gradgradchecks then took minutes instead of seconds).

    The count is not raised again when the file ends: with MKL,
    ``torch.set_num_threads(n)`` for any n > 1 also turns MKL's dynamic
    threading off, after which the batched LU of a later file in the same
    process (``models/batched.py::_lu``) spun for minutes without
    returning. One thread is safe for whatever runs after."""
    torch.set_num_threads(1)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _blocks(seed=0, npsr=NPSR, nb=NB, b=B):
    """A positive-definite block-tridiagonal (D, E) and right-hand sides."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((npsr, nb, b, b))
    D = A @ np.swapaxes(A, -1, -2) + 3 * b * np.eye(b)
    E = 0.5 * rng.standard_normal((npsr, nb - 1, b, b))
    X = rng.standard_normal((npsr, nb, b, 2))
    return [torch.tensor(v, dtype=F64, requires_grad=True) for v in (D, E, X)]


def _factor(D, E):
    return tgp.tridiag_forward(D, E)[:2]


def _spd(npsr, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((npsr, n, n))
    return torch.tensor(A @ np.swapaxes(A, -1, -2) + n * np.eye(n), dtype=F64, requires_grad=True)


def _sym(A):
    """A symmetric input: the blocked and the library Cholesky read other
    triangles of a diagonal block, and agree on symmetric matrices only."""
    return (A + A.mT) / 2


# ------------------------------------------------- gradcheck, gradgradcheck

def test_factor_gradcheck_and_gradgradcheck():
    D, E, _ = _blocks()
    assert gradcheck(_factor, (D, E))
    assert gradgradcheck(_factor, (D, E))


@pytest.mark.parametrize("sweep", [tgp.tridiag_forward_solve, tgp.tridiag_backward])
def test_substitution_sweep_gradcheck_and_gradgradcheck(sweep):
    D, E, X = _blocks(1)
    Ld, M, _ = tgp.tridiag_forward_plain(D.detach(), E.detach())
    args = (Ld.requires_grad_(True), M.requires_grad_(True), X)
    assert gradcheck(sweep, args)
    assert gradgradcheck(sweep, args)


def test_factor_adjoint_gradcheck():
    """Kernel 1's Function (its backward, kernel 2, is once differentiable:
    no third derivative is asked for)."""
    D, E, _ = _blocks(2)
    Ld, M, _ = tgp.tridiag_forward_plain(D.detach(), E.detach())
    rng = np.random.default_rng(3)
    gLd, gM = (torch.tensor(rng.standard_normal(Ld.shape), dtype=F64, requires_grad=True)
               for _ in range(2))
    args = (Ld.requires_grad_(True), M.requires_grad_(True), gLd, gM)
    assert gradcheck(tgp.TridiagFactorAdjoint.apply, args)


def test_blocked_cholesky_gradcheck_and_gradgradcheck():
    """Two whole blocks of 4 and a padded tail (n = 11), the plain SYRK
    inside its Function."""
    A = _spd(2, 11, 4)
    fn = lambda A: tk.blocked_cholesky(_sym(A), block=4)
    assert gradcheck(fn, (A,))
    assert gradgradcheck(fn, (A,))


def test_syrk_update_gradcheck_and_gradgradcheck():
    rng = np.random.default_rng(5)
    C = torch.tensor(rng.standard_normal((2, 8, 8)), dtype=F64, requires_grad=True)
    L = torch.tensor(rng.standard_normal((2, 8, 3)), dtype=F64, requires_grad=True)
    fn = lambda C, L: tcw.cov_syrk_update(C, L, tile=4)
    assert gradcheck(fn, (C, L))
    assert gradgradcheck(fn, (C, L))


# ------------------------------------------- against the plain loops' autograd

def _grads(outs, ins, cots, create_graph=False):
    return torch.autograd.grad(outs, ins, cots, create_graph=create_graph)


def test_factor_gradient_and_hessian_match_the_plain_loop():
    """First and second derivatives of a scalar of the factor: the
    Functions (kernel 1 and kernel 2's plain versions) against autograd
    through ``tridiag_forward_plain``."""
    D, E, _ = _blocks(6, nb=6, b=4)
    rng = np.random.default_rng(7)
    R1, R2, V1, V2 = (torch.tensor(rng.standard_normal(s), dtype=F64)
                      for s in (D.shape, D.shape, D.shape, E.shape))

    def hvp(factor):
        Ld, M = factor(D, E)
        s = torch.sum((Ld * R1) ** 2) + torch.sum(torch.sin(M * R2))
        g = torch.autograd.grad(s, (D, E), create_graph=True)
        h = torch.autograd.grad(torch.sum(g[0] * V1) + torch.sum(g[1] * V2), (D, E))
        return g, h

    got, want = hvp(_factor), hvp(lambda D, E: tgp.tridiag_forward_plain(D, E)[:2])
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert _rel(a.detach(), b.detach()) <= TOL_GRAD


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_sweep_gradients_match_the_plain_loop(which):
    D, E, X = _blocks(8)
    Ld, M, _ = tgp.tridiag_forward_plain(D.detach(), E.detach())
    Ld.requires_grad_(True)
    M.requires_grad_(True)
    fn, plain = {"forward": (tgp.tridiag_forward_solve, tgp.tridiag_forward_solve_plain),
                 "backward": (tgp.tridiag_backward, tgp.tridiag_backward_plain)}[which]
    cot = torch.tensor(np.random.default_rng(9).standard_normal(X.shape), dtype=F64)
    got = _grads(fn(Ld, M, X), (Ld, M, X), cot)
    want = _grads(plain(Ld, M, X), (Ld, M, X), cot)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL_GRAD


def test_syrk_and_blocked_cholesky_gradients_match_the_plain_and_library_routes():
    rng = np.random.default_rng(10)
    C = torch.tensor(rng.standard_normal((2, 8, 8)), dtype=F64, requires_grad=True)
    L = torch.tensor(rng.standard_normal((2, 8, 3)), dtype=F64, requires_grad=True)
    cot = torch.tensor(rng.standard_normal((2, 8, 8)), dtype=F64)
    got = _grads(tcw.cov_syrk_update(C, L, tile=4), (C, L), cot)
    want = _grads(tcw.cov_syrk_plain(C, L, tile=4), (C, L), cot)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL_GRAD
    A = _spd(2, 11, 11)
    cot = torch.tensor(rng.standard_normal((2, 11, 11)), dtype=F64).tril()
    got = _grads(tk.blocked_cholesky(_sym(A), block=4), (A,), cot)[0]
    want = _grads(torch.linalg.cholesky(_sym(A)), (A,), cot)[0]
    assert _rel(got, want) <= TOL_GRAD


def test_adjoint_plain_versions_agree_with_autograd():
    """Kernel 1's plain loop is the factor's exact adjoint; kernel 2's plain
    version is autograd through it, and a single block column (no gE)
    works too."""
    for nb in (1, 5):
        D, E, _ = _blocks(11, nb=nb)
        Ld, M, _ = tgp.tridiag_forward_plain(D, E)
        rng = np.random.default_rng(12)
        gLd, gM = (torch.tensor(rng.standard_normal(Ld.shape), dtype=F64) for _ in range(2))
        gD, gE = tgp.tridiag_factor_adjoint_plain(Ld.detach(), M.detach(), gLd, gM)
        want = _grads((Ld, M), (D, E), (gLd, gM)) if nb > 1 else _grads(Ld, D, gLd) + (None,)
        assert _rel(gD, want[0]) <= TOL_GRAD
        assert gE.shape == E.shape and (nb == 1 or _rel(gE, want[1]) <= TOL_GRAD)
        hD, hE = torch.ones_like(gD), torch.ones_like(gE)
        out = tgp.tridiag_factor_adjoint_vjp_plain(Ld.detach(), M.detach(), gLd, gM, hD, hE)
        assert len(out) == 4 and all(o.shape == Ld.shape for o in out)
        assert all(bool(torch.isfinite(o).all()) for o in out)
        assert not out[1][:, 0].any() and not out[3][:, 0].any()  # M_0 is never read


# ------------------------------------------------ routing, bits, NaN, padding

def test_forward_bits_equal_with_and_without_grad():
    D, E, X = _blocks(13)
    with torch.no_grad():
        plain = tgp.tridiag_forward(D, E, X)
        syrk = tcw.cov_syrk_update(D[:, 0], D[:, 1], tile=B)
        chol = tk.blocked_cholesky(_spd(2, 11, 14), block=4)
    got = tgp.tridiag_forward(D, E, X)
    assert [type(t.grad_fn).__name__ for t in got] == [
        "TridiagFactorBackward", "TridiagFactorBackward", "TridiagForwardSolveBackward"]
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert all(p.grad_fn is None for p in plain)
    Ld, M = got[0], got[1]
    assert torch.equal(tgp.tridiag_backward(Ld, M, X), tgp.tridiag_backward_plain(Ld, M, X))
    with torch.no_grad():
        sweeps = (tgp.tridiag_forward_solve(Ld, M, X), tgp.tridiag_backward(Ld, M, X))
    assert all(z.grad_fn is None for z in sweeps)
    assert torch.equal(sweeps[0], tgp.tridiag_forward_solve_plain(Ld, M, X))
    assert torch.equal(tcw.cov_syrk_update(D[:, 0], D[:, 1], tile=B), syrk)
    assert torch.equal(tk.blocked_cholesky(_spd(2, 11, 14), block=4), chol)


def test_a_nan_factor_gives_nan_gradients_not_an_exception():
    D, E, _ = _blocks(15)
    Dbad = D.detach().clone()
    Dbad[0, 2] = -Dbad[0, 2]  # block column 2 of pulsar 0 indefinite
    Dbad.requires_grad_(True)
    Ld, M = _factor(Dbad, E)
    gD, gE = torch.autograd.grad(torch.sum(Ld) + torch.sum(M), (Dbad, E))
    assert bool(torch.isnan(gD[0]).any()) and bool(torch.isfinite(gD[1]).all())
    assert bool(torch.isfinite(gE[1]).all())


def test_padded_rows_get_zero_gradient():
    """The banded solver's padding (masked TOAs at safe sigma^2 = 1, the
    block grid's tail past Nt) takes no gradient: d(log det + r C0^-1 r) /
    d sigma^2 is zero there and matches autograd through the plain loops
    elsewhere."""
    rng = np.random.default_rng(16)
    npsr, nt = 2, 45  # three blocks of 16, the last cut at 13
    toas = np.sort(rng.uniform(0, 4e8, (npsr, nt)), axis=1)
    mask = np.ones((npsr, nt))
    mask[1, -7:] = 0.0
    op = tstruct.banded_from_times(torch.tensor(toas), torch.tensor(mask), rho=0.6,
                                   corr_s=40 * 86400.0, block=16, dtype=F64, device="cpu")
    sigma2 = torch.tensor(rng.uniform(0.5, 2.0, (npsr, nt)), dtype=F64, requires_grad=True)
    r = torch.tensor(rng.standard_normal((npsr, nt)) * mask, dtype=F64)
    m = torch.tensor(mask, dtype=F64)

    def objective():
        safe = torch.where(m > 0, sigma2, 1.0)
        c0inv, logdet = tstruct.banded_combined_solver(op, safe, torch.tensor(0.7, dtype=F64), F64)
        return torch.sum(logdet) + torch.sum(r * c0inv(r[..., None])[..., 0])

    (got,) = torch.autograd.grad(objective(), sigma2)
    plain = (tgp.tridiag_forward_plain, tgp.tridiag_forward_solve_plain, tgp.tridiag_backward_plain)
    saved = (tgp.tridiag_forward, tgp.tridiag_forward_solve, tgp.tridiag_backward)
    try:
        tgp.tridiag_forward, tgp.tridiag_forward_solve, tgp.tridiag_backward = plain
        (want,) = torch.autograd.grad(objective(), sigma2)
    finally:
        tgp.tridiag_forward, tgp.tridiag_forward_solve, tgp.tridiag_backward = saved
    assert not got[1, -7:].any() and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_GRAD


@pytest.mark.parametrize("b, width, route", [
    (1, 16, "shared"), (5, 16, "shared"), (16, 16, "shared"), (17, 32, "scratch"), (32, 32, "scratch"),
])
def test_adjoint_plan_and_counts(b, width, route):
    """The launch kernels 1 and 2 take (the C side refuses any other): one
    block of 16 warps per pulsar at the template width b' (16 up to b = 16,
    else 32), its b' x (b' + 4) tiles (83 for kernel 1, 88 for kernel 2) in
    shared memory at b' = 16 and in a device scratch at 32; and the counts
    their wrappers record, at config B's 68 x 485 x 16, which the redesign
    left as the function's."""
    for second, tiles in ((False, 83), (True, 88)):
        plan = tgp.tridiag_adjoint_plan(68, b, second)
        nbytes = tiles * width * (width + 4) * 8
        assert (plan.route, plan.width, plan.threads, plan.grid) == (route, width, 512, (68, 1))
        assert (plan.shared_bytes, plan.scratch_bytes) == (
            (nbytes, 0) if route == "shared" else (0, 68 * nbytes))
        assert plan.shared_bytes <= 227 * 1024
    with pytest.raises(ValueError, match="blocks of 1..32"):
        tgp.tridiag_adjoint_plan(68, 33, False)
    blocks, sub = 68 * 485 * 256, 68 * 484 * 256
    assert tgp.tridiag_adjoint_bytes(68, 485, 16, False, 8) == 8 * (5 * blocks + sub)
    assert tgp.tridiag_adjoint_bytes(68, 485, 16, True, 8) == 8 * (9 * blocks + sub)
    assert tgp.tridiag_adjoint_operations(68, 485, 16, False) == 68 * 485 * 9 * 16**3
    assert tgp.tridiag_adjoint_operations(68, 485, 16, True) == 68 * 485 * 28 * 16**3


@pytest.mark.parametrize("block, ecorr, device, refused", [
    (33, False, "cuda", True),
    (16, False, "cuda", False),
    (33, True, "cuda", False),
    (33, False, "cpu", False),
])
def test_the_card_refuses_up_front_a_banded_block_its_adjoint_kernels_do_not_take(
        block, ecorr, device, refused):
    """map_objective (so map_fit) refuses on the card, before any work, a
    banded noise_cov without ECORR whose block is past kernels 1 and 2's
    limit; ECORR (the dense rung) and the CPU take any block."""
    from pta_replicator_tpu_torch.likelihood.infer import _check_card_cov
    from pta_replicator_tpu_torch.models.batched import Recipe as TorchRecipe

    t = np.sort(np.random.default_rng(4).uniform(0.0, 3e8, (2, 70)), axis=1)
    cov = tstruct.banded_from_times(t, np.ones_like(t), rho=0.6, corr_s=40 * 86400.0,
                                    block=block, device="cpu")
    recipe = TorchRecipe(noise_cov=cov, log10_ecorr=torch.tensor(-6.6) if ecorr else None)
    if refused:
        with pytest.raises(ValueError, match="block 33 .* at most 32"):
            _check_card_cov(recipe, torch.device(device))
    else:
        _check_card_cov(recipe, torch.device(device))


# ------------------------------------------------------------- map_fit parity

def _round_trip(rung):
    """benchmarks/cov_solve.py's round-trip recipe at 2 x 128 (banded, the
    block-tridiagonal rung) or with tests/test_covariance.py's Kronecker op
    and ECORR (the dense rung), its residuals and its start."""
    batch = synthetic_batch(npsr=2, ntoa=128, nbackend=2, seed=3, dtype=np.float64)
    t, m = np.asarray(batch.toas_s), np.asarray(batch.mask)
    if rung == "banded":
        cov, extra = banded_from_times(t, m, rho=0.6, corr_s=40 * 86400.0, block=16,
                                       dtype=np.float64), {}
    else:
        cov = kron_time_channel(t, channels=4, time_ell_s=20 * 86400.0, chan_rho=0.8,
                                dtype=np.float64)
        extra = {"log10_ecorr": jnp.asarray(-6.6)}
    truth = {"cov_log10_sigma": -6.3, "rn_log10_amplitude": -13.3}
    recipe = Recipe(efac=jnp.asarray(1.1), rn_log10_amplitude=jnp.asarray(-13.3),
                    rn_gamma=jnp.asarray(4.0), rn_nmodes=10, noise_cov=cov,
                    cov_log10_sigma=jnp.asarray(-6.3), **extra)
    res = np.asarray(realize(jax.random.PRNGKey(11), batch, recipe, nreal=1, fit=False))[0]
    return batch, recipe, res, {k: v + 0.25 for k, v in truth.items()}


@pytest.mark.parametrize("rung", ["banded", "kron_ecorr"])
def test_map_fit_over_a_covariance_matches_jax(rung):
    batch, recipe, res, start = _round_trip(rung)
    design = np.ones(np.asarray(batch.toas_s).shape)[..., None]
    want = jax_map_fit(jnp.asarray(res), batch, recipe, start, design=jnp.asarray(design))
    tb = convert.batch_from_arrays(vars(batch), device="cpu")
    tr = convert.recipe_from_arrays(vars(recipe), device="cpu")
    got = lk.map_fit(res.copy(), tb, tr, start, design=design, device="cpu")
    assert got.converged and want.converged and got.iterations == want.iterations
    assert got.names == want.names
    assert np.max(np.abs(got.x - want.x) / np.abs(want.x)) <= TOL_MAP
    assert np.max(np.abs(got.sigma - want.sigma) / np.abs(want.sigma)) <= TOL_MAP
