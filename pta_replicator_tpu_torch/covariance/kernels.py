"""Structured-covariance solve kernels: blocked Cholesky, block-
tridiagonal (banded) Cholesky, and Kronecker solves.

Counterpart of ``pta_replicator_tpu/covariance/kernels.py``. The solver
ladder (cheapest structure that fits wins):

=====================  ==============================  ===================
structure              factorization                   cost per pulsar
=====================  ==============================  ===================
diagonal (+ECORR)      analytic Woodbury               O(Nt)
                       (``white_ecorr_solver``)
block-tridiagonal      :func:`block_tridiag_cholesky`  O(Nt b^2)
Kronecker time (x)     :func:`kron_cholesky`           O(ne^3 + nc^3
channel                                                + Nt (ne + nc))
dense                  :func:`blocked_cholesky`        O(Nt^3)
=====================  ==============================  ===================

The tensor's device picks the route. On a CUDA tensor the dense rung is
the blocked Cholesky, whose trailing update is the kernel of
``csrc/cov_syrk.cu`` (``ops/cw.py::cov_syrk_update``); on a CPU tensor it
is the library Cholesky, as the reference's is off the TPU. The three
block-tridiagonal factor/solve functions call the wrappers of
``ops/gp.py``, which run the two kernels of ``csrc/block_tridiag.cu`` on
a CUDA tensor and their plain versions on a CPU one. A kernel that fails
to build or launch raises.

A failed factorization gives NaN entries, as the reference's does, not an
exception (``torch.linalg.cholesky_ex``, no host synchronisation).
"""
from __future__ import annotations

import torch

from ..ops import cw as ops_cw
from ..ops import gp as ops_gp


def _chol_logdet(L):
    """log det from a (batched) Cholesky factor: 2 sum log diag."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def _cholesky(S):
    """Lower library Cholesky factor of S, NaN where S is not positive
    definite (as the reference's factor is), without the host
    synchronisation of ``torch.linalg.cholesky``'s error check."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _lower_solve_right(L, B):
    """``B L^-T`` for a lower factor L: the panel solve."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True, left=False)


# ------------------------------------------------------ blocked dense

def blocked_cholesky(A, block: int = 128):
    """Lower Cholesky factor of a batched SPD matrix ``A`` (Np, n, n) by
    the right-looking blocked algorithm: per block column, the library
    Cholesky of the diagonal block, the triangular panel solve, and the
    trailing update ``ops/cw.py::cov_syrk_update`` (the kernel on a CUDA
    tensor, the plain tiled loop on a CPU one).

    ``n`` is padded up to a multiple of ``block`` with identity rows
    (decoupled: they factor to a unit diagonal and touch nothing), so any
    n works. The factorization runs in one working copy of ``A``, which it
    overwrites with the factor; ``A`` itself is left as it is."""
    npsr, n, _ = A.shape
    nb = -(-n // block)
    npad = nb * block - n
    W = torch.nn.functional.pad(A, (0, npad, 0, npad)) if npad else A.clone()
    if npad:
        idx = torch.arange(n, nb * block, device=A.device)
        W[:, idx, idx] = 1.0
    for k in range(nb):
        k0, k1 = k * block, (k + 1) * block
        Lkk = _cholesky(W[:, k0:k1, k0:k1])
        W[:, k0:k1, k0:k1] = Lkk
        if k1 < nb * block:
            P = _lower_solve_right(Lkk, W[:, k1:, k0:k1]).contiguous()
            W[:, k1:, k0:k1] = P
            trail = W[:, k1:, k1:]
            updated = ops_cw.cov_syrk_update(trail, P, tile=block)
            if updated is not trail:  # the plain version returns a new tensor
                trail.copy_(updated)
    return W.tril_()[:, :n, :n]


def dense_cholesky(A, block: int = 128):
    """Batched lower Cholesky of (Np, n, n): :func:`blocked_cholesky` on a
    CUDA tensor, the library Cholesky on a CPU one."""
    if A.device.type == "cuda":
        return blocked_cholesky(A, block=block)
    return _cholesky(A)


def cholesky_solve(L, X):
    """Solve ``(L L^T) Z = X`` for (Np, n, n) factor and (Np, n, Q)
    right-hand sides via two batched triangular solves."""
    Y = torch.linalg.solve_triangular(L, X, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


# ----------------------------------------------- block-tridiagonal

def block_tridiag_cholesky(D, E):
    """Cholesky of a symmetric positive-definite block-tridiagonal matrix:
    ``D`` (Np, nb, b, b) diagonal blocks, ``E`` (Np, nb-1, b, b) sub-
    diagonal blocks (``E[k]`` is the (k+1, k) block). Returns ``(Ld, M)``:
    the diagonal Cholesky blocks and the sub-diagonal factor blocks
    (``M[0]`` is zero). O(Nt b^2) instead of the dense O(Nt^3): the
    forward factor sweep without right-hand sides."""
    Ld, M, _ = ops_gp.tridiag_forward(D, E)
    return Ld, M


def block_tridiag_logdet(Ld):
    """log det from the block-tridiagonal factor's diagonal blocks."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(Ld, dim1=-2, dim2=-1)), dim=(-2, -1))


def block_tridiag_solve(Ld, M, X):
    """Solve ``(L L^T) Z = X`` for the factor of
    :func:`block_tridiag_cholesky`; ``X`` is (Np, nb, b, Q). The
    substitution-only forward sweep, then the backward sweep."""
    return ops_gp.tridiag_backward(Ld, M, ops_gp.tridiag_forward_solve(Ld, M, X))


def block_tridiag_factor_solve(D, E, X):
    """Fused factor + solve of a block-tridiagonal SPD system: ``(Ld, M,
    Z)``, the factor of :func:`block_tridiag_cholesky` and the solution of
    ``(L L^T) Z = X``: one forward sweep factors and forward-substitutes,
    then the backward sweep."""
    return ops_gp.tridiag_factor_solve(D, E, X)


def block_tridiag_matvec(D, E, X):
    """``C X`` for the block-tridiagonal (D, E) representation and (Np,
    nb, b, Q) operands."""
    out = torch.einsum("pkij,pkjq->pkiq", D, X)
    out[:, 1:] += torch.einsum("pkij,pkjq->pkiq", E, X[:, :-1])
    out[:, :-1] += torch.einsum("pkji,pkjq->pkiq", E, X[:, 1:])
    return out


def block_tridiag_matmul_factor(Ld, M, Z):
    """``L Z`` for the block-tridiagonal factor: the sampling map (``L z``
    has covariance ``L L^T``); ``Z`` is (..., Np, nb, b), leading axes
    being realizations."""
    out = torch.einsum("pkij,...pkj->...pki", Ld, Z)
    out[..., 1:, :] += torch.einsum("pkij,...pkj->...pki", M[:, 1:], Z[..., :-1, :])
    return out


# ------------------------------------------------------- Kronecker

def kron_cholesky(Ct, Cf):
    """Per-factor Cholesky of a Kronecker covariance ``Ct (x) Cf`` ((Np,
    ne, ne) epoch-level temporal factor, (Np, nc, nc) channel factor): the
    Kronecker product of the lower factors is the dense factor under the
    epoch-major TOA ordering."""
    return _cholesky(Ct), _cholesky(Cf)


def kron_solve(Lt, Lf, X):
    """Solve ``(Ct (x) Cf) Z = X`` from the per-factor Cholesky factors:
    X (Np, ne*nc, Q) on the (ne, nc) grid, ``Ct^-1`` along epochs and
    ``Cf^-1`` along channels."""
    npsr, nt, q = X.shape
    ne, nc = Lt.shape[-1], Lf.shape[-1]
    Y = cholesky_solve(Lt, X.reshape(npsr, ne, nc * q)).reshape(npsr, ne, nc, q)
    Yc = Y.transpose(1, 2).reshape(npsr, nc, ne * q)
    Z = cholesky_solve(Lf, Yc).reshape(npsr, nc, ne, q)
    return Z.transpose(1, 2).reshape(npsr, nt, q)


def kron_logdet(Lt, Lf):
    """log det of ``Ct (x) Cf`` from the factor Cholesky diagonals."""
    return Lf.shape[-1] * _chol_logdet(Lt) + Lt.shape[-1] * _chol_logdet(Lf)


def kron_sample_map(Lt, Lf, Z):
    """``(Lt (x) Lf) z`` for a (..., Np, ne, nc) standard-normal grid: the
    sampling map ``Lt Z Lf^T`` (epoch-major vec convention)."""
    Y = torch.einsum("pij,...pjc->...pic", Lt, Z)
    return torch.einsum("...pic,pkc->...pik", Y, Lf)


# --------------------------------------------- eager telemetry entries

#: running tallies behind the ``cov.blocked_fraction`` gauge: structured
#: (banded, Kronecker, low-rank) solves against every solve the eager
#: entries below priced
_SOLVE_TALLY = {"total": 0, "structured": 0}


def solve_eager(op, x, s2=None):
    """Solve ``C z = x`` through a covariance op under the ``cov_solve``
    span, counting it in ``cov.solves`` and the ``cov.blocked_fraction``
    gauge: the instrumented entry of host-driven callers.

    The span measures the host: on the card it closes when the solve's
    kernels are queued, and the caller's readback is the fence (nothing
    here waits for the card)."""
    from ..obs import counter, gauge, names, span

    structured = type(op).__name__ != "DenseCov"
    with span(names.SPAN_COV_SOLVE, kind=type(op).__name__, structured=structured):
        out = op.solve(x, s2=s2)
    counter(names.COV_SOLVES).inc()
    _SOLVE_TALLY["total"] += 1
    _SOLVE_TALLY["structured"] += int(structured)
    gauge(names.COV_BLOCKED_FRACTION).set(_SOLVE_TALLY["structured"] / _SOLVE_TALLY["total"])
    return out


def sample_eager(op, draws, s2=None):
    """One correlated-noise realization through a covariance op under the
    ``cov_sample`` span: the fuzz harness's batched-side entry.

    ``draws`` is the op's standard normals by family name (the shapes of
    ``op.draw_shapes()``), or a ``torch.Generator`` to draw them from, in
    float64 on the generator's device (the JAX package's function takes a
    key in its place). As :func:`solve_eager`, the span waits for nothing
    on the card."""
    from ..obs import names, span

    with span(names.SPAN_COV_SAMPLE, kind=type(op).__name__):
        if isinstance(draws, torch.Generator):
            draws = {name: torch.randn(shape, generator=draws, dtype=torch.float64,
                                       device=draws.device)
                     for name, shape in op.draw_shapes().items()}
        return op.sample(draws, s2=s2)
