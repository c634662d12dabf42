"""Weighted / generalized least-squares timing-model refit, the oracle's
dense noise covariance, and the padded full-model design tensor of the
batched refit.

Counterpart of ``pta_replicator_tpu/timing/fit.py``, on numpy alone (the
JAX package's ``xp`` switch is gone): the spin design, the column-
normalized WLS and GLS solvers, :func:`noise_covariance` and
:func:`covariance_from_recipe` (the dense float64 C that
``SimulatedPulsar.fit`` weights a GLS refit with, from the port's
``Recipe``, whose tensors may lie on the card), and :func:`design_tensor`,
whose tensor becomes the ``Recipe``'s ``fit_design`` on the card. The same
operations in the same order, so the same bits. Reference analog:
``SimulatedPulsar.fit`` selecting PINT's WLS/GLS fitters
(pta_replicator/simulate.py:44-69).
"""
from __future__ import annotations

import numpy as np

from ..obs.trace import traced as _traced


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


def noise_covariance(
    errors_s,
    efac=1.0,
    equad_s=0.0,
    ecorr_s=None,
    epoch_index=None,
    rn_log10_amplitude=None,
    rn_gamma=None,
    toas_s=None,
    rn_nmodes: int = 30,
    tspan_s=None,
    chrom_log10_amplitude=None,
    chrom_gamma=None,
    chrom_index: float = 2.0,
    chrom_nmodes: int = 30,
    chrom_ref_freq_mhz: float = 1400.0,
    freqs_mhz=None,
    gwb_spectrum: dict = None,
    gwb_nmodes: int = 30,
):
    """The dense (Nt, Nt) float64 GLS noise covariance the reference gets
    from PINT's GLSFitter (simulate.py:57-61):

        C = diag((EFAC sigma)^2 + EQUAD^2) + U diag(ECORR^2) U^T
            + F Phi(A, gamma) F^T  [+ S F Phi_chrom F^T S, chromatic]
            [+ F Phi_gwb F^T, the GWB's auto-term]

    ``efac``/``equad_s`` are scalars or per-TOA vectors; ``ecorr_s`` is a
    scalar or per-epoch vector with ``epoch_index`` mapping TOAs to epochs
    (``ops/quantize.py``); the red-noise term uses the rank-reduced Fourier
    basis on ``toas_s``. The chromatic term is the same basis scaled per
    TOA by the ``(ref/freq)^chrom_index`` diagonal S (0 at frequencies <=
    0). ``gwb_spectrum``: keyword arguments of
    ``models/gwb.py::characteristic_strain`` (a power law, turnover or user
    spectrum), weighted as a red-noise process with prior
    hc^2(f) / (12 pi^2 f^3 T) — the reference omits it (PINT knows nothing
    of the injection), as the batched engine's ``gls_noise_model`` does not.
    """
    from ..ops.fourier import fourier_basis, fourier_frequencies, powerlaw_prior

    sigma = np.asarray(errors_s)
    n = sigma.shape[-1]
    ef = np.asarray(efac) * np.ones_like(sigma)
    eq = np.asarray(equad_s) * np.ones_like(sigma)
    C = np.zeros((n, n)) + np.diag((ef * sigma) ** 2 + eq**2)

    if ecorr_s is not None and epoch_index is not None:
        idx = np.asarray(epoch_index)
        nep = int(idx.max()) + 1
        ec = np.asarray(ecorr_s) * np.ones((nep,))
        # U[t, e] = 1 iff TOA t falls in epoch e (reference quantize_fast
        # exploder, white_noise.py:7-44)
        U = np.asarray(idx[:, None] == np.arange(nep)[None, :], dtype=C.dtype)
        C = C + (U * ec[None, :] ** 2) @ U.T

    if rn_log10_amplitude is not None:
        if toas_s is None:
            raise ValueError("red-noise covariance needs toas_s")

        t = np.asarray(toas_s)
        T = tspan_s if tspan_s is not None else float(t.max() - t.min())
        f = fourier_frequencies(T, nmodes=rn_nmodes)
        F = fourier_basis(t, f)
        phi = powerlaw_prior(np.repeat(f, 2), rn_log10_amplitude, rn_gamma, T)
        C = C + (F * phi[None, :]) @ F.T

    if chrom_log10_amplitude is not None:
        if toas_s is None or freqs_mhz is None:
            raise ValueError("chromatic covariance needs toas_s and freqs_mhz")

        t = np.asarray(toas_s)
        T = tspan_s if tspan_s is not None else float(t.max() - t.min())
        f = fourier_frequencies(T, nmodes=chrom_nmodes)
        F = fourier_basis(t, f)
        phi = powerlaw_prior(np.repeat(f, 2), chrom_log10_amplitude, chrom_gamma, T)
        fr = np.asarray(freqs_mhz)
        s = np.where(
            fr > 0.0,
            (chrom_ref_freq_mhz / np.where(fr > 0.0, fr, 1.0)) ** chrom_index,
            0.0,
        )
        Fs = F * s[:, None]
        C = C + (Fs * phi[None, :]) @ Fs.T

    if gwb_spectrum is not None:
        if toas_s is None:
            raise ValueError("GWB auto-term covariance needs toas_s")
        from ..models.gwb import characteristic_strain

        t = np.asarray(toas_s)
        T = tspan_s if tspan_s is not None else float(t.max() - t.min())
        f = fourier_frequencies(T, nmodes=gwb_nmodes)
        F = fourier_basis(t, f)
        hc = characteristic_strain(f, **gwb_spectrum)
        phi = np.repeat(hc**2 / (12.0 * np.pi**2 * f**3 * T), 2)
        C = C + (F * phi[None, :]) @ F.T
    return C


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
    from ..obs import span
    from .components import full_design_matrix

    with span("design_tensor", npsr=len(psrs), nspin=nspin) as sp:
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
        sp["kmax"] = kmax
        out = np.zeros((len(mats), nt, kmax))
        for i, m in enumerate(mats):
            out[i, : m.shape[0], : m.shape[1]] = m
        return out, names


@_traced("covariance_from_recipe")
def covariance_from_recipe(psr, recipe, coarsegrain: float = 0.1, psr_index=None,
                           backend_names=None, flagid: str = "f"):
    """The dense float64 noise covariance of one oracle pulsar from the
    port's ``Recipe``, whose tensors may lie on any device (each is read
    back through ``.detach().cpu()``).

    Recipe fields resolve exactly, never by averaging: scalars pass
    through, (Np,) per-pulsar vectors are selected by ``psr_index``, and
    (Np, NB) per-backend tables are gathered per TOA against
    ``backend_names`` (the ``PulsarBatch.backend_names`` vocabulary the
    tables were built for, matched on the ``flagid`` TOA flag, as ``freeze``
    does). ECORR tables become per-epoch values through the same flag-aware
    quantization and first-TOA-of-epoch backend rule the batch uses. A
    ``noise_cov`` op adds its own dense float64 block (``CovOp.dense``),
    scaled by ``10^(2 cov_log10_sigma)`` and cut to this pulsar's TOAs.
    Reference analog: PINT's GLSFitter consuming the full per-backend noise
    model (pta_replicator/simulate.py:57-61).
    """
    from ..constants import DAY_IN_SEC
    from ..covariance.structure import _as_np64, recipe_cov_s2
    from ..ops.quantize import quantize

    mjds = psr.toas.get_mjds()

    def row(v):
        v = _as_np64(v)
        if v.ndim == 0:
            return v
        if psr_index is None:
            raise ValueError(
                "recipe carries per-pulsar arrays; pass psr_index (the "
                "pulsar's row in the tables), and backend_names for "
                "(Np, NB) per-backend tables"
            )
        return v[psr_index]

    def flag_indices(values):
        """Map flag values onto backend_names columns (freeze's vocabulary)."""
        if backend_names is None:
            raise ValueError(
                "per-backend (Np, NB) recipe tables need backend_names "
                "(PulsarBatch.backend_names) to map TOA flags to columns"
            )
        vocab = {str(name): k for k, name in enumerate(backend_names)}
        values = [str(v) for v in values]
        missing = sorted({v for v in values if v not in vocab})
        if missing:
            raise ValueError(f"TOA -{flagid} flags {missing} not in backend_names")
        return np.asarray([vocab[v] for v in values])

    def per_toa(v):
        v = row(v)
        return v if v.ndim == 0 else v[flag_indices(psr.toas.get_flag(flagid))]

    efac = per_toa(recipe.efac) if recipe.efac is not None else 1.0
    equad = 10.0 ** per_toa(recipe.log10_equad) if recipe.log10_equad is not None else 0.0
    # the injection's convention: t2equad (the default) scales EQUAD by
    # EFAC, tnequad adds it unscaled
    if not recipe.tnequad:
        equad = equad * efac

    ecorr = epoch_index = None
    if recipe.log10_ecorr is not None:
        ec = row(recipe.log10_ecorr)
        if ec.ndim == 0:
            epoch_index = quantize(mjds, dt=coarsegrain).epoch_index
            ecorr = 10.0**ec
        else:
            # quantize's ave_flags is the first-TOA-of-epoch backend rule
            # freeze uses
            flags = [str(v) for v in psr.toas.get_flag(flagid)]
            bins = quantize(mjds, flags=flags, dt=coarsegrain)
            epoch_index = bins.epoch_index
            ecorr = 10.0 ** np.asarray(ec)[flag_indices(bins.ave_flags)]

    rn_amp = row(recipe.rn_log10_amplitude) if recipe.rn_log10_amplitude is not None else None
    rn_gamma = row(recipe.rn_gamma) if recipe.rn_gamma is not None else None
    chrom_amp = chrom_gamma = None
    chrom_kwargs = {}
    if recipe.chrom_log10_amplitude is not None:
        chrom_amp = row(recipe.chrom_log10_amplitude)
        chrom_gamma = row(recipe.chrom_gamma)
        cidx = recipe.chrom_index if recipe.chrom_index is not None else 2.0
        chrom_kwargs = dict(
            chrom_index=float(row(cidx)),
            chrom_nmodes=recipe.chrom_nmodes,
            chrom_ref_freq_mhz=recipe.chrom_ref_freq_mhz,
            freqs_mhz=psr.toas.freqs_mhz,
        )
    extra_cov = None
    if recipe.noise_cov is not None:
        # the op's own dense float64 block for this pulsar, valid when the op
        # was built on this pulsar's TOA grid; a ragged pulsar takes the
        # leading TOA window
        dense_all = _as_np64(recipe.noise_cov.dense(pad_identity=False))
        if psr_index is None and dense_all.shape[0] != 1:
            raise ValueError(
                "recipe carries a per-pulsar noise_cov block; pass "
                "psr_index (the pulsar's row in the CovOp)"
            )
        p = psr_index if psr_index is not None else 0
        dense = dense_all[p]
        s2 = recipe_cov_s2(recipe)
        if s2 is not None:
            s2 = _as_np64(s2)
            s2 = float(s2) if s2.ndim == 0 else float(s2[p])
        else:
            s2 = 1.0
        nt = len(mjds)
        extra_cov = s2 * dense[:nt, :nt]

    gwb_spectrum = None
    if recipe.gwb_log10_amplitude is not None or recipe.gwb_user_spectrum is not None:
        gwb_spectrum = dict(
            log10_amplitude=(None if recipe.gwb_log10_amplitude is None
                             else float(row(recipe.gwb_log10_amplitude))),
            spectral_index=None if recipe.gwb_gamma is None else float(row(recipe.gwb_gamma)),
            turnover=recipe.gwb_turnover,
            f0=recipe.gwb_f0,
            beta=recipe.gwb_beta,
            power=recipe.gwb_power,
            user_spectrum=(None if recipe.gwb_user_spectrum is None
                           else _as_np64(recipe.gwb_user_spectrum)),
        )
    C = noise_covariance(
        psr.toas.errors_s,
        efac=efac,
        equad_s=equad,
        ecorr_s=ecorr,
        epoch_index=epoch_index,
        rn_log10_amplitude=rn_amp,
        rn_gamma=rn_gamma,
        toas_s=mjds * DAY_IN_SEC,
        rn_nmodes=recipe.rn_nmodes,
        chrom_log10_amplitude=chrom_amp,
        chrom_gamma=chrom_gamma,
        **chrom_kwargs,
        gwb_spectrum=gwb_spectrum,
        gwb_nmodes=recipe.gwb_gls_nmodes,
    )
    if extra_cov is not None:
        C = C + extra_cov
    return C
