"""The arithmetic of the factor sweep's adjoint kernels (``csrc/block_tridiag.cu``:
kernel 1, ``tridiag_factor_adjoint``, and kernel 2, ``tridiag_factor_adjoint_vjp``)
modelled in plain PyTorch in the kernels' order, float64 on the CPU, against the
plain versions the card is held to (``ops/gp.py``).

The kernels take every term that depends only on the inputs off the block-column
chain: an explicit L_k^-1 (by substitution with the diagonal's reciprocals, a lane
per column), the products with it, then the chain's few dependent products, then
the outputs. Products with an explicit inverse round otherwise than the plain
versions' triangular solves; these tests hold the model within ``TOL`` of each
output's largest |entry| on config B's real C0 blocks (at two pulsars) and on
random blocks of stated condition numbers, so the form's reach is known before a
card run. Kernel 2 reads kernel 1's gD and gE for S2 = G + G^T and W: the model
shows that equals recomputing them, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pta_replicator_tpu_torch import flagship_workload
from pta_replicator_tpu_torch.covariance import banded_from_times, recipe_cov_s2
from pta_replicator_tpu_torch.covariance import structure as tstruct
from pta_replicator_tpu_torch.kernels import build, tridiag_study
from pta_replicator_tpu_torch.models import batched as tb
from pta_replicator_tpu_torch.ops import gp as tgp

F64 = torch.float64
#: the card's gate (chip_smoke.py's TOL_COV): |model - plain| over the plain's largest |entry|
TOL = 1e-12


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _pad(t):
    """(Np, nb - 1, b, b) terms of columns 1.. as (Np, nb, b, b), column 0 zero."""
    return torch.cat([t.new_zeros((t.shape[0], 1) + t.shape[2:]), t], 1)


def _inverse(L):
    """L^-1 as the kernels' inverse warp takes it: column c by right-looking
    substitution, each step the running sum times its diagonal's reciprocal."""
    b = L.shape[-1]
    rd = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
    x = torch.eye(b, dtype=L.dtype).expand(L.shape).clone()
    for j in range(b):
        x[..., j, :] = x[..., j, :] * rd[..., j, None]
        x[..., j + 1:, :] -= L[..., j + 1:, j, None] * x[..., j, None, :]
    return x


def _sym(X):
    """X's lower triangle mirrored (Phi(X) + Phi(X)^T)."""
    return X.tril() + X.tril(-1).mT


def _phi(X):
    return X.tril() - 0.5 * torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))


def kernel1_model(Ld, M, gLd, gM):
    """Kernel 1: the input-only terms of every column (L^-1, A = gM Lp^-1,
    B = M Lp^-1, V1 = Li M, U1 = V1 Lp^-1, P = A^T M), then the chain over
    k = nb - 1 ... 0 (T = Sym(X) V1, C = -P + U1^T T, Lbar = tril(gLd + C),
    X = L^T Lbar), then the outputs (G = Li^T (Phi(X) Li), gD, W = A - S2 B).
    Returns ``(gD, gE, lbar)``."""
    L = Ld.tril()
    nb = L.shape[1]
    Li = _inverse(L)
    A = _pad(gM[:, 1:] @ Li[:, :-1])
    B = _pad(M[:, 1:] @ Li[:, :-1])
    V1 = _pad(Li[:, 1:] @ M[:, 1:])
    U1 = _pad(V1[:, 1:] @ Li[:, :-1])
    P = _pad(A[:, 1:].mT @ M[:, 1:])
    X, lbar = [None] * nb, [None] * nb
    for k in reversed(range(nb)):
        C = 0.0 if k == nb - 1 else -P[:, k + 1] + U1[:, k + 1].mT @ (_sym(X[k + 1]) @ V1[:, k + 1])
        lbar[k] = (gLd[:, k] + C).tril()
        X[k] = L[:, k].mT @ lbar[k]
    X, lbar = torch.stack(X, 1), torch.stack(lbar, 1)
    G = Li.mT @ (_phi(X) @ Li)
    S2 = G + G.mT
    gD = S2.tril(-1) + torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))
    return gD, A[:, 1:] - S2[:, 1:] @ B[:, 1:], lbar


def _s2_w(Ld, M, gM, lbar):
    """S2 and W of every column recomputed from Lbar (kernel 1's output
    arithmetic on the same terms)."""
    L = Ld.tril()
    Li = _inverse(L)
    X = L.mT @ lbar
    G = Li.mT @ (_phi(X) @ Li)
    S2 = G + G.mT
    W = gM[:, 1:] @ Li[:, :-1] - S2[:, 1:] @ (M[:, 1:] @ Li[:, :-1])
    return S2, W


def kernel2_model(Ld, M, lbar, gD, gE, hD, hE, s2_w=None):
    """Kernel 2: S2 = gD + gD^T and W = gE (or ``s2_w``, recomputed), the
    input-only terms (L^-1, Q0 = hE Lp^-T, Vm = Li M, Q1 = Li Q0, H0 = Li
    (Sym(hD) Li^T)), the chain over k = 0 ... nb - 1 (X2 = Q1 - Vm Ah^T of
    the last column, Z = H0 - X2 Vm^T - Vm X2^T, Ah = Phi(Z)), then the
    outputs. Returns ``(hLd, hM, hgLd, hgM)``."""
    L = Ld.tril()
    nb = L.shape[1]
    if s2_w is None:
        S2 = _sym(gD) + torch.diag_embed(torch.diagonal(gD, dim1=-2, dim2=-1))
        W = _pad(gE)
    else:
        S2, W = s2_w[0], _pad(s2_w[1])
    Li = _inverse(L)
    Q0 = _pad(hE @ Li[:, :-1].mT)
    Vm = Li @ M
    Q1 = Li @ Q0
    H0 = Li @ (_sym(hD) @ Li.mT)
    Z = [None] * nb
    for k in range(nb):
        Z[k] = H0[:, k]
        if k:
            X2 = Q1[:, k] - Vm[:, k] @ _phi(Z[k - 1]).mT
            Z[k] = Z[k] - X2 @ Vm[:, k].mT - Vm[:, k] @ X2.mT
    Z = torch.stack(Z, 1)
    Ah = _phi(Z)
    Ch = (L @ Ah).tril()
    V = Q0[:, 1:] - M[:, 1:] @ Ah[:, :-1].mT
    P = (-S2 @ (L @ _sym(Z)) + lbar @ Ah.mT).tril()
    hLd = torch.cat([P[:, :-1] - (W[:, 1:].mT @ V).tril(), P[:, -1:]], 1)
    hM = _pad(-W[:, 1:] @ Ch[:, :-1] - S2[:, 1:] @ V)
    return hLd, hM, Ch, _pad(V)


def _cotangents(Ld, seed):
    rng = np.random.default_rng(seed)
    npsr, nb, b, _ = Ld.shape
    gLd, gM, hD = (torch.tensor(rng.standard_normal(Ld.shape), dtype=F64) for _ in range(3))
    hE = torch.tensor(rng.standard_normal((npsr, nb - 1, b, b)), dtype=F64)
    return gLd, gM, hD, hE


def _check(Ld, M, seed=1):
    """Both models against the plain versions; the largest relative error."""
    gLd, gM, hD, hE = _cotangents(Ld, seed)
    gD, gE, lbar = kernel1_model(Ld, M, gLd, gM)
    errs = [_rel(g, w) for g, w in zip((gD, gE), tgp.tridiag_factor_adjoint_plain(Ld, M, gLd, gM))
            if w.numel()]
    got = kernel2_model(Ld, M, lbar, gD, gE, hD, hE)
    for g, w in zip(got, tgp.tridiag_factor_adjoint_vjp_plain(Ld, M, gLd, gM, hD, hE)):
        errs.append(_rel(g, w) if w.any() else float(g.abs().max()))
    return max(errs)


def _config_b_factor(npsr=2, ntoa=320):
    """The factor of config B's C0 blocks (the flagship recipe without
    ECORR, the compiler's banded covariance: rho 0.5, 30-day taper, block
    16, sigma 10^-6.4) at ``npsr`` pulsars of ``ntoa`` TOAs."""
    batch, recipe = flagship_workload(npsr=npsr, ntoa=ntoa, ncw=3, dtype=F64, device="cpu")
    op = banded_from_times(batch.toas_s, batch.mask, rho=0.5, corr_s=30 * 86400.0, block=16,
                           dtype=F64, device="cpu")
    recipe = dataclasses.replace(recipe, log10_ecorr=None, noise_cov=op, cov_log10_sigma=-6.4)
    sigma2 = tb.gls_noise_model(batch, recipe)[0]
    safe = torch.where(batch.mask > 0, sigma2, 1.0)
    D, E = tstruct.banded_c0_blocks(op, safe, recipe_cov_s2(recipe, F64), F64)
    return tgp.tridiag_forward_plain(D, E)[:2]


def _conditioned_factor(cond, npsr=2, nb=12, b=16, seed=0):
    """The factor of diagonal blocks Q diag(1 .. cond) Q^T (log-spaced
    spectrum, random orthogonal Q) coupled by small random off-diagonal
    blocks."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((npsr, nb, b, b)))
    D = (Q * np.logspace(0.0, np.log10(cond), b)) @ np.swapaxes(Q, -1, -2)
    E = 0.03 * rng.standard_normal((npsr, nb - 1, b, b))
    return tgp.tridiag_forward_plain(torch.tensor(D), torch.tensor(E))[:2]


@pytest.fixture(scope="module")
def config_b():
    return _config_b_factor()


@pytest.mark.parametrize("seed", [1, 2])
def test_models_match_the_plain_versions_on_config_b_blocks(config_b, seed):
    Ld, M = config_b
    assert Ld.shape[1:] == (20, 16, 16)
    assert _check(Ld, M, seed) <= TOL


@pytest.mark.parametrize("cond", [1e2, 1e6, 1e9, 1e12])
def test_models_reach_at_stated_condition_numbers(cond):
    """The explicit-inverse form stays within the gate on blocks whose
    spectra span ``cond``."""
    Ld, M = _conditioned_factor(cond)
    L = Ld[0, 5].tril()
    assert float(torch.linalg.cond(L @ L.mT)) > 0.5 * cond
    assert _check(Ld, M) <= TOL


@pytest.mark.parametrize("nb,b", [(1, 5), (2, 8), (3, 17), (5, 3)])
def test_models_match_the_plain_versions_at_the_card_tests_shapes(nb, b):
    rng = np.random.default_rng(nb * b)
    A = rng.standard_normal((3, nb, b, b))
    D = torch.tensor(A @ np.swapaxes(A, -1, -2) + 3 * b * np.eye(b))
    E = torch.tensor(0.5 * rng.standard_normal((3, nb - 1, b, b)))
    Ld, M, _ = tgp.tridiag_forward_plain(D, E)
    assert _check(Ld, M, seed=nb) <= TOL


def test_s2_from_gd_and_w_from_ge_equal_their_recomputation_bit_for_bit(config_b):
    """gD + gD^T is G + G^T exactly (its diagonal doubles G's exactly; IEEE
    addition commutes) and gE is W, so kernel 2 reading kernel 1's outputs
    gives the very bits of recomputing kernel 1's column."""
    Ld, M = config_b
    gLd, gM, hD, hE = _cotangents(Ld, 3)
    gD, gE, lbar = kernel1_model(Ld, M, gLd, gM)
    S2, W = _s2_w(Ld, M, gM, lbar)
    assert torch.equal(_sym(gD) + torch.diag_embed(torch.diagonal(gD, dim1=-2, dim2=-1)), S2)
    assert torch.equal(gE, W)
    read = kernel2_model(Ld, M, lbar, gD, gE, hD, hE)
    recomputed = kernel2_model(Ld, M, lbar, gD, gE, hD, hE, s2_w=(S2, W))
    assert all(torch.equal(a, b) for a, b in zip(read, recomputed))
    want = tgp.tridiag_factor_adjoint_vjp_plain(Ld, M, gLd, gM, hD, hE)
    assert max(_rel(g, w) for g, w in zip(read, want)) <= TOL


def test_the_function_feeds_kernel_2_kernel_1s_outputs(monkeypatch):
    """TridiagFactorAdjoint saves gD and gE and hands them, with Lbar, to
    the kernel-2 wrapper (on the CPU the plain version then runs)."""
    Ld, M = _conditioned_factor(1e3, nb=5, b=4)
    gLd, gM, hD, hE = _cotangents(Ld, 4)
    seen = {}
    vjp = tgp.tridiag_factor_adjoint_vjp

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return vjp(*args, **kwargs)

    monkeypatch.setattr(tgp, "tridiag_factor_adjoint_vjp", spy)
    ins = [t.clone().requires_grad_(True) for t in (Ld, M, gLd, gM)]
    gD, gE = tgp.TridiagFactorAdjoint.apply(*ins)
    got = torch.autograd.grad((gD, gE), ins, (hD, hE))
    assert torch.equal(seen["gD"], gD.detach()) and torch.equal(seen["gE"], gE.detach())
    assert "lbar" in seen
    want = tgp.tridiag_factor_adjoint_vjp_plain(Ld, M, gLd, gM, hD, hE)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_card_wrapper_refuses_kernel_2_without_kernel_1s_outputs():
    """On a CUDA tensor the kernel-2 wrapper needs lbar, gD and gE; it checks
    before any launch (a meta tensor stands in for the card's)."""
    Ld = torch.empty((2, 3, 4, 4), dtype=F64, device="meta")
    hE = torch.empty((2, 2, 4, 4), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="lbar, gD and gE"):
        tgp.tridiag_factor_adjoint_vjp(Ld, Ld, Ld, Ld, Ld, hE, lbar=Ld)


@pytest.mark.parametrize("variant", sorted(tridiag_study.ADJOINT_VARIANTS))
def test_the_studys_partial_builds_apply_to_the_kernels_source(variant):
    """Each of kernels/tridiag_study.py's builds of the adjoint kernels
    finds every text it replaces in csrc/block_tridiag.cu (the study
    raises on the card otherwise), and changes the source."""
    source = (build.CSRC_DIR / "block_tridiag.cu").read_text()
    edited = source
    for old, new in tridiag_study.ADJOINT_VARIANTS[variant]:
        assert old in edited
        edited = edited.replace(old, new)
    assert (edited != source) == (variant != "kernel")
    assert len(tridiag_study.ADJOINT_ROLES) * 32 == tgp.TRIDIAG_ADJOINT_THREADS
