"""Weighted / generalized least-squares timing-model refit, and the padded
full-model design tensor of the batched refit.

Counterpart of ``pta_replicator_tpu/timing/fit.py``, on numpy alone (the
JAX package's ``xp`` switch is gone): the spin design, the column-
normalized WLS and GLS solvers, and :func:`design_tensor`, whose tensor
becomes the ``Recipe``'s ``fit_design`` on the card. The same operations
in the same order, so the same bits. Reference analog:
``SimulatedPulsar.fit`` selecting PINT's WLS/GLS fitters
(pta_replicator/simulate.py:44-69).

``noise_covariance`` and ``covariance_from_recipe``, which serve the numpy
oracle's fit and noise models, wait for ROADMAP A.18.
"""
from __future__ import annotations

import numpy as np


def design_matrix(toas_s: np.ndarray, f0: float, nspin: int = 2):
    """Timing design matrix in time units, columns [1, dt, dt^2/2, dt^3/6][:nspin+1] / F0-scaled.

    ``toas_s``: TOA epochs in seconds relative to any reference; ``nspin``:
    number of spin-frequency derivatives to fit (2 -> F0 and F1).
    """
    t = np.asarray(toas_s)
    cols = [np.ones_like(t)]
    fact = 1.0
    for k in range(1, nspin + 1):
        fact *= k
        cols.append(t**k / (fact * f0))
    return np.stack(cols, axis=-1)


def _normalized_lstsq(Mw, rw, M, r, return_cov: bool = False):
    """Column-normalized least squares (the t^k columns span ~1e14 in scale).

    With ``return_cov`` also returns the parameter covariance
    (M^T C^-1 M)^-1 — the PINT-fitter uncertainty matrix — computed from
    the whitened design via pinv so rank-deficient (zeroed) columns give
    zero variance instead of raising.
    """
    norms = np.sqrt(np.sum(Mw**2, axis=-2))
    norms = np.where(norms == 0, 1.0, norms)
    Mn = Mw / norms
    p_scaled, *_ = np.linalg.lstsq(Mn, rw)
    p = p_scaled / norms
    post = r - M @ p
    if not return_cov:
        return p, post
    pcov = np.linalg.pinv(Mn.T @ Mn, hermitian=True)
    pcov = pcov / (norms[..., :, None] * norms[..., None, :])
    return p, post, pcov


def wls_fit(residuals_s, errors_s, M, return_cov: bool = False):
    """Weighted least squares: minimize ||(r - M p)/sigma||^2.

    Returns (param_update, postfit_residuals_s); with ``return_cov``
    additionally the parameter covariance (M^T N^-1 M)^-1 whose diagonal
    holds the 1-sigma parameter uncertainties squared.
    """
    r = np.asarray(residuals_s)
    sigma = np.asarray(errors_s)
    Mw = M / sigma[..., None]
    rw = r / sigma
    return _normalized_lstsq(Mw, rw, M, r, return_cov=return_cov)


def gls_fit(residuals_s, cov, M, jitter: float = 0.0, return_cov: bool = False):
    """Generalized least squares with a dense noise covariance ``cov``.

    Solves p = (M^T C^-1 M)^-1 M^T C^-1 r via Cholesky of C; with
    ``return_cov`` additionally returns (M^T C^-1 M)^-1 itself (the
    per-parameter uncertainty matrix PINT's GLSFitter reports).
    """
    r = np.asarray(residuals_s)
    n = r.shape[-1]
    C = np.asarray(cov) + jitter * np.eye(n)
    L = np.linalg.cholesky(C)
    # whiten by solving L x = v
    Mw = np.linalg.solve(L, M)
    rw = np.linalg.solve(L, r)
    return _normalized_lstsq(Mw, rw, M, r, return_cov=return_cov)


def design_tensor(psrs, ntoa_max=None, nspin: int = 2, include="auto"):
    """Padded (Np, Nt_max, K_max) float64 full-model design tensor for the
    batched refit (``models.batched.design_fit_subtract``), on the host.

    Builds each pulsar's :func:`~.components.full_design_matrix` (spin,
    astrometry, DMX/DM, FD, binary, JUMPs) and zero-pads TOAs and columns
    to common sizes — padding rows carry zero batch mask and padding
    columns are neutralized by the solver. Pass the SAME pulsar list (same
    order) used to freeze the batch. Returns ``(tensor, names)`` with
    ``names[i]`` the column labels of pulsar ``i``; the caller moves the
    tensor to the card (``Recipe(fit_design=...)``).
    """
    from .components import full_design_matrix

    mats, names = [], []
    for psr in psrs:
        M, nm = full_design_matrix(
            psr.par,
            psr.toas.get_mjds(),
            freqs_mhz=psr.toas.freqs_mhz,
            f0=psr.model.f0,
            nspin=nspin,
            include=include,
            flags=psr.toas.flags,
        )
        mats.append(np.asarray(M, np.float64))
        names.append(nm)
    nt = ntoa_max or max(m.shape[0] for m in mats)
    kmax = max(m.shape[1] for m in mats)
    out = np.zeros((len(mats), nt, kmax))
    for i, m in enumerate(mats):
        out[i, : m.shape[0], : m.shape[1]] = m
    return out, names
