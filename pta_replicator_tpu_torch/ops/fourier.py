"""Fourier basis and power-law prior for the rank-reduced red-noise basis.

Counterpart of ``pta_replicator_tpu/ops/fourier.py``. Every function
accepts an optional leading pulsar axis on its array arguments and
dispatches on the type of its first one: tensors run in their dtype and on
their device (the batched engine); anything else runs in host float64
numpy by the JAX package's own operations in its order (the per-pulsar
oracle: ``models/red_noise.py``, ``timing/fit.py::noise_covariance``), so
those results equal the JAX package's bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import YEAR_IN_SEC


def fourier_frequencies(tspan_s, nmodes: int = 30, logf: bool = False,
                        fmin=None, fmax=None, modes=None):
    """Sampling frequencies for the rank-reduced basis, shape (..., K).

    Default: f_k = k/T for k = 1..nmodes; optionally log/linear spacing
    between fmin and fmax, or an explicit mode list. ``tspan_s`` is a
    tensor (scalar or (Np,)), or a number or array for the numpy form;
    ``fmin``/``fmax`` are scalars or (Np,).
    """
    if not isinstance(tspan_s, torch.Tensor):
        return _np_fourier_frequencies(tspan_s, nmodes, logf, fmin, fmax, modes)
    T = tspan_s
    if modes is not None:
        return torch.as_tensor(modes, dtype=T.dtype, device=T.device)
    k = torch.arange(1, nmodes + 1, dtype=T.dtype, device=T.device)
    if fmin is None and fmax is None and not logf:
        return k / T[..., None]
    as_t = lambda v: torch.as_tensor(v, dtype=T.dtype, device=T.device)
    lo = 1.0 / T if fmin is None else as_t(fmin) + torch.zeros_like(T)
    hi = nmodes / T if fmax is None else as_t(fmax) + torch.zeros_like(T)
    x = (k - 1.0) / max(nmodes - 1, 1)
    if logf:
        return lo[..., None] * (hi / lo)[..., None] ** x
    return lo[..., None] + (hi - lo)[..., None] * x


def fourier_basis(toas_s, freqs, phase_shift=None,
                  libstempo_convention: bool = False):
    """Interleaved sin/cos design matrix F of shape (..., ntoa, 2*nmodes).

    Column order is [sin, cos] per frequency; with
    ``libstempo_convention=True`` it is [cos, sin] and times are referenced
    to each pulsar's first TOA.
    """
    if not isinstance(toas_s, torch.Tensor):
        return _np_fourier_basis(toas_s, freqs, phase_shift, libstempo_convention)
    t = toas_s
    f = freqs
    shift = torch.zeros_like(f) if phase_shift is None else phase_shift
    if libstempo_convention:
        arg = (2 * math.pi * (t - t[..., :1])[..., :, None] * f[..., None, :]
               + shift[..., None, :])
        first, second = torch.cos(arg), torch.sin(arg)
    else:
        arg = 2 * math.pi * t[..., :, None] * f[..., None, :] + shift[..., None, :]
        first, second = torch.sin(arg), torch.cos(arg)
    return torch.stack([first, second], dim=-1).reshape(
        arg.shape[:-1] + (2 * arg.shape[-1],)
    )


def powerlaw_prior(freqs_doubled, log10_amplitude, gamma, tspan_s):
    """Per-coefficient variance of the power-law PSD prior, (..., 2K):
    P = A^2 (f yr)^(-gamma) / (12 pi^2 Tspan) * yr^3.

    Evaluated in log space: the direct product passes through ~1e-38 for
    typical PTA amplitudes at high mode numbers, where float32 flushes to
    zero and would truncate the injected spectrum."""
    if not isinstance(freqs_doubled, torch.Tensor):
        return _np_powerlaw_prior(freqs_doubled, log10_amplitude, gamma, tspan_s)
    f = freqs_doubled
    log_prior = (
        2.0 * math.log(10.0) * log10_amplitude[..., None]
        - gamma[..., None] * torch.log(f / (1.0 / YEAR_IN_SEC))
        + 3.0 * math.log(YEAR_IN_SEC)
        - torch.log(12.0 * math.pi**2 * tspan_s[..., None])
    )
    return torch.exp(log_prior)


# ---------------------------------------------- host float64 numpy forms

def _np_fourier_frequencies(tspan_s, nmodes, logf, fmin, fmax, modes):
    if modes is not None:
        return np.asarray(modes)
    T = np.asarray(tspan_s)
    if fmin is None and fmax is None and not logf:
        return np.arange(1, nmodes + 1) / T[..., None]
    lo = 1.0 / T if fmin is None else np.asarray(fmin) + np.zeros_like(T)
    hi = nmodes / T if fmax is None else np.asarray(fmax) + np.zeros_like(T)
    x = np.arange(nmodes) / max(nmodes - 1, 1)
    if logf:
        return lo[..., None] * (hi / lo)[..., None] ** x
    return lo[..., None] + (hi - lo)[..., None] * x


def _np_fourier_basis(toas_s, freqs, phase_shift, libstempo_convention):
    t = np.asarray(toas_s)
    f = np.asarray(freqs)
    shift = np.zeros_like(f) if phase_shift is None else np.asarray(phase_shift)
    if libstempo_convention:
        arg = (2 * np.pi * (t - t[..., :1])[..., :, None] * f[..., None, :]
               + shift[..., None, :])
        first, second = np.cos(arg), np.sin(arg)
    else:
        arg = 2 * np.pi * t[..., :, None] * f[..., None, :] + shift[..., None, :]
        first, second = np.sin(arg), np.cos(arg)
    return np.stack([first, second], axis=-1).reshape(arg.shape[:-1] + (2 * arg.shape[-1],))


def _np_powerlaw_prior(freqs_doubled, log10_amplitude, gamma, tspan_s):
    f = np.asarray(freqs_doubled)
    log10_amplitude = np.asarray(log10_amplitude)
    gamma = np.asarray(gamma)
    T = np.asarray(tspan_s)
    log_prior = (
        2.0 * np.log(np.asarray(10.0, f.dtype)) * log10_amplitude[..., None]
        - gamma[..., None] * np.log(f / (1.0 / YEAR_IN_SEC))
        + 3.0 * np.log(np.asarray(YEAR_IN_SEC, f.dtype))
        - np.log(12.0 * np.pi**2 * T[..., None])
    )
    return np.exp(log_prior)
