"""Stochastic gravitational-wave background: grids, spectrum, synthesis.

Counterpart of the pure-math stage of ``pta_replicator_tpu/models/gwb.py``
(frequency-domain method of Chamberlin, Creighton, Demorest et al. 2014).
The grids and the synthesis matrices are host float64 numpy, cast last by
the caller; the spectrum runs on tensors in the working dtype.
"""
from __future__ import annotations

import functools
import math

import numpy as np


def gwb_grid(start_s: float, stop_s: float, npts: int, howml: float):
    """Common time grid and frequency grid for the synthesis.

    Frequencies are k/(dur*howml) for k < npts*howml/2, with f[0] replaced
    by f[1] (the DC bin is zeroed later). The count is fixed analytically:
    an arange to the Nyquist frequency would let float rounding of ``dur``
    decide whether the boundary bin exists, shifting every later draw.
    """
    dur = stop_s - start_s
    ut = np.linspace(start_s, stop_s, npts)
    dt_grid = dur / npts
    ratio = npts * howml / 2.0
    nf = int(np.floor(ratio)) if float(ratio).is_integer() else int(np.ceil(ratio))
    f = np.arange(nf) / (dur * howml)
    f[0] = f[1]
    return ut, dt_grid, f


def characteristic_strain(f, log10_amplitude, spectral_index,
                          turnover: bool = False, f0: float = 1e-9,
                          beta: float = 1.0, power: float = 1.0):
    """Power-law hc(f) = A (f/f_1yr)^alpha, optionally with a turnover;
    f_1yr = 1/3.16e7 Hz as in the reference. Tensors in, tensor out."""
    amp = 10.0**log10_amplitude
    alpha = -0.5 * (spectral_index - 3.0)
    hcf = amp * (f / (1.0 / 3.16e7)) ** alpha
    if turnover:
        si = alpha - beta
        hcf = hcf / (1.0 + (f / f0) ** (power * si)) ** (1.0 / power)
    return hcf


def residual_psd_coeff(hcf, f, dur: float, howml: float):
    """C(f) = hc^2 / (96 pi^2 f^3) * dur * howml — the variance scaling
    turning strain into timing-residual Fourier amplitudes."""
    return 1.0 / (96.0 * math.pi**2) * hcf**2 / f**3 * dur * howml


@functools.lru_cache(maxsize=8)
def dft_synthesis_matrices(nf: int, npts: int, drop: int = 10):
    """(nf, npts) float64 cosine/sine matrices evaluating the
    hermitian-packed inverse FFT of length N = 2*nf-2 at output samples
    ``drop .. drop+npts`` only:

        x[n] = (2/N) * sum_k [Re X[k] cos(2 pi k n / N)
                              - Im X[k] sin(2 pi k n / N)]

    (DC and Nyquist bins are zeroed by the caller). The phase is reduced
    with exact integer arithmetic (k*n mod N), so the trig arguments stay
    in [0, 2 pi). Cached: callers must not write into the result.
    """
    N = 2 * nf - 2
    k = np.arange(nf, dtype=np.int64)[:, None]
    n = np.arange(drop, drop + npts, dtype=np.int64)[None, :]
    phase = 2.0 * np.pi * ((k * n) % N) / N
    return np.cos(phase), np.sin(phase)
