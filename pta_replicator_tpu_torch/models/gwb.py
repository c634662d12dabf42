"""Stochastic gravitational-wave background: grids, spectrum, synthesis,
and the per-pulsar oracle's injection.

Counterpart of ``pta_replicator_tpu/models/gwb.py`` (frequency-domain
method of Chamberlin, Creighton, Demorest et al. 2014: complex Gaussian
frequency series per pulsar, mixed across pulsars by the Cholesky factor
of the ORF, scaled by the characteristic-strain spectrum, inverse-FFT to a
common grid, interpolated onto each pulsar's TOAs; reference analog
``add_gwb``, pta_replicator/red_noise.py:138-298). The grids and the
synthesis matrices are host float64 numpy, cast last by the batched
engine; the spectrum runs on tensors in the working dtype, or, given numpy
frequencies, in host float64 numpy by the JAX package's operations, which
is the form the oracle (``gwb_time_series``, ``interp_to_toas``,
``add_gwb``) runs, so its delays equal that package's bit for bit.
"""
from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from ..constants import DAY_IN_SEC
from ..ops.coords import pulsar_ra_dec
from ..ops.orf import assemble_orf


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


def interp(x, xp, fp):
    """``np.interp`` on tensors: piecewise-linear interpolation of the nodes
    ``(xp, fp)`` (1-D, ``xp`` increasing) at ``x`` (any shape), clamped to
    ``fp[0]`` below ``xp[0]`` and ``fp[-1]`` above ``xp[-1]``. The segment
    is found by ``torch.searchsorted``, and its formula is the reference's
    (``jnp.interp``): ``fp[i-1] + (x - xp[i-1]) / dx * df``."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    df = fp[i] - fp[i - 1]
    f = torch.where(dx == 0, fp[i], fp[i - 1] + (x - xp[i - 1]) / torch.where(dx == 0, 1.0, dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def characteristic_strain(f, log10_amplitude=None, spectral_index=None,
                          turnover: bool = False, f0: float = 1e-9,
                          beta: float = 1.0, power: float = 1.0,
                          user_spectrum=None):
    """hc(f): the power law A (f/f_1yr)^alpha, optionally with a turnover
    (f_1yr = 1/3.16e7 Hz as in the reference), or a user spectrum
    ``(F, 2)`` [freq_hz, hc], which overrides the power law.

    The user spectrum is interpolated in log-log space and clamped to its
    endpoint values outside the node range (the reference's ``extrap1d``,
    whose slope continuation is commented out). Strain values below 1e-30
    are floored to 1e-30 first, so that no -inf node enters the
    interpolation; the reference interpolates the raw values, so the
    floor warns when it engages. The count needs the values on the host:
    it is taken when the spectrum lies on the CPU (as the reference warns
    only where the values are concrete, not inside jit), never with a
    synchronisation of the card. Tensors in, tensor out; numpy (or
    numbers) in, float64 numpy out."""
    if not isinstance(f, torch.Tensor):
        return _np_characteristic_strain(f, log10_amplitude, spectral_index, turnover, f0,
                                         beta, power, user_spectrum)
    if user_spectrum is not None:
        spec = user_spectrum.to(dtype=f.dtype, device=f.device)
        raw = spec[:, 1]
        if spec.device.type == "cpu":
            n_floored = int(torch.count_nonzero(raw < 1e-30))
            if n_floored:
                warnings.warn(
                    f"user GWB spectrum: {n_floored} strain value(s) below 1e-30 were "
                    "floored to 1e-30 for log-log interpolation (the reference "
                    "interpolates the raw values); rescale the spectrum if the "
                    "ultra-low entries are intentional",
                    stacklevel=2,
                )
        logh = interp(torch.log10(f), torch.log10(spec[:, 0]),
                      torch.log10(torch.clamp(raw, min=1e-30)))
        return 10.0**logh
    amp = 10.0**log10_amplitude
    alpha = -0.5 * (spectral_index - 3.0)
    hcf = amp * (f / (1.0 / 3.16e7)) ** alpha
    if turnover:
        si = alpha - beta
        hcf = hcf / (1.0 + (f / f0) ** (power * si)) ** (1.0 / power)
    return hcf


def _np_characteristic_strain(f, log10_amplitude, spectral_index, turnover, f0, beta,
                              power, user_spectrum):
    f = np.asarray(f)
    if user_spectrum is not None:
        user_spectrum = np.asarray(user_spectrum)
        uf = np.asarray(user_spectrum[:, 0])
        raw = np.asarray(user_spectrum[:, 1])
        n_floored = int(np.count_nonzero(raw < 1e-30))
        if n_floored:
            warnings.warn(
                f"user GWB spectrum: {n_floored} strain value(s) below 1e-30 were "
                "floored to 1e-30 for log-log interpolation (the reference "
                "interpolates the raw values); rescale the spectrum if the "
                "ultra-low entries are intentional",
                stacklevel=3,
            )
        uh = np.maximum(raw, 1e-30)
        lf, luf, luh = np.log10(f), np.log10(uf), np.log10(uh)
        logh = np.interp(lf, luf, luh)
        return 10.0**logh
    amp = 10.0**log10_amplitude
    alpha = -0.5 * (spectral_index - 3.0)
    f1yr = 1.0 / 3.16e7
    hcf = amp * (f / f1yr) ** alpha
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


# ------------------------------------------------- oracle layer (numpy)

def gwb_time_series(w, M, C, dt_grid: float, npts: int):
    """Mix per-pulsar complex draws across pulsars and synthesize the time
    series on the common grid.

    w: (..., Np, Nf) complex draws; M: (Np, Np) Cholesky factor of the ORF;
    C: (Nf,) variance scaling. Returns (..., Np, npts) residual series.
    The DC and Nyquist bins are zeroed and the first 10 samples dropped
    (the FFT's wrap-around transient), matching the reference
    (red_noise.py:285).
    """
    res_f = np.einsum("ab,...bf->...af", M, w) * np.sqrt(C)
    nf = res_f.shape[-1]
    mask = np.concatenate([np.zeros(1), np.ones(nf - 2), np.zeros(1)])
    res_f = res_f * mask
    packed = np.concatenate([res_f, np.conj(res_f[..., -2:0:-1])], axis=-1)
    res_t = np.real(np.fft.ifft(packed, axis=-1) / dt_grid)
    return res_t[..., 10 : npts + 10]


def interp_to_toas(ut, series, toas_s):
    """Linear interpolation of a common-grid series onto one pulsar's TOAs."""
    return np.interp(np.asarray(toas_s), ut, series)


def add_gwb(
    psrs: list,
    log10_amplitude: float,
    spectral_index: float,
    no_correlations: bool = False,
    seed: int = None,
    turnover: bool = False,
    clm=None,
    lmax: int = 0,
    f0: float = 1e-9,
    beta: float = 1.0,
    power: float = 1.0,
    userSpec=None,
    npts: int = 600,
    howml: float = 10,
):
    """Inject a correlated stochastic GWB across a pulsar array.

    Matches the reference's parameterization and legacy draw order
    (red_noise.py:138-298): per pulsar, a real then an imaginary N(0,1)^Nf
    stream, drawn pulsar by pulsar after the ORF is assembled. ``clm`` /
    ``lmax`` give an anisotropic ORF (``ops/orf.py::assemble_orf``),
    ``no_correlations`` an uncorrelated common process, ``turnover`` /
    ``f0`` / ``beta`` / ``power`` a turnover spectrum, ``userSpec`` an
    (F, 2) [freq_hz, hc] spectrum that overrides the power law.
    """
    if clm is None:
        clm = [np.sqrt(4.0 * np.pi)]
    if seed is not None:
        np.random.seed(seed)

    npsr = len(psrs)
    start = float(min(p.toas.first_mjd for p in psrs) * DAY_IN_SEC - DAY_IN_SEC)
    stop = float(max(p.toas.last_mjd for p in psrs) * DAY_IN_SEC + DAY_IN_SEC)
    dur = stop - start
    if npts is None:
        npts = int(dur / (DAY_IN_SEC * 14))

    ut, dt_grid, f = gwb_grid(start, stop, npts, howml)

    if no_correlations:
        orf = 2.0 * np.eye(npsr)
    else:
        locs = np.zeros((npsr, 2))
        for i, p in enumerate(psrs):
            ra, dec = pulsar_ra_dec(p.loc, p.name)
            locs[i] = ra, np.pi / 2.0 - dec  # (phi, theta)
        orf = assemble_orf(locs, clm=clm, lmax=lmax)

    M = np.linalg.cholesky(np.asarray(orf, np.float64))

    nf = len(f)
    w = np.empty((npsr, nf), dtype=complex)
    for i in range(npsr):
        w[i] = np.random.randn(nf) + 1j * np.random.randn(nf)

    hcf = characteristic_strain(
        f,
        log10_amplitude,
        spectral_index,
        turnover=turnover,
        f0=f0,
        beta=beta,
        power=power,
        user_spectrum=userSpec,
    )
    C = residual_psd_coeff(hcf, f, dur, howml)
    res_grid = gwb_time_series(w, M, C, dt_grid, npts)

    for i, psr in enumerate(psrs):
        toas_s = psr.toas.get_mjds() * DAY_IN_SEC
        dt = interp_to_toas(ut, res_grid[i], toas_s)
        psr.inject(
            f"{psr.name}_gwb",
            {"amplitude": log10_amplitude, "spectral_index": spectral_index},
            dt,
        )
