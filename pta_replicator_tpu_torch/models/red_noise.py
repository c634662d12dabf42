"""Power-law red (timing) noise and chromatic noise via the rank-reduced
Fourier basis, on the per-pulsar oracle path.

Counterpart of ``pta_replicator_tpu/models/red_noise.py`` (reference
analog ``add_red_noise``, pta_replicator/red_noise.py:106-135). Host
float64 numpy on ``ops/fourier.py``'s numpy forms, the draws from numpy's
legacy global RNG in the reference's order: a seeded run equals the JAX
package's oracle bit for bit. The batched engine's twins are
``models/batched.py::red_noise_delays`` and ``chromatic_noise_delays``.
"""
from __future__ import annotations

import numpy as np

from ..constants import DAY_IN_SEC
from ..ops.fourier import fourier_basis, fourier_frequencies, powerlaw_prior
from ..simulate import SimulatedPulsar


# ----------------------------------------------------------------- pure math

def red_noise_delay(
    toas_s,
    log10_amplitude: float,
    gamma: float,
    eps,
    nmodes: int = 30,
    tspan_s: float = None,
    libstempo_convention: bool = False,
    modes=None,
):
    """Red-noise delay [s]: F @ (sqrt(prior) * eps), eps ~ N(0,1)^(2K).

    ``modes`` overrides the default k/T frequency grid with an explicit
    list (then K = len(modes) and eps must have 2*len(modes) entries).
    """
    t = np.asarray(toas_s)
    T = tspan_s if tspan_s is not None else float(t.max() - t.min())
    f = fourier_frequencies(T, nmodes=nmodes, modes=modes)
    F = fourier_basis(t, f, libstempo_convention=libstempo_convention)
    fdoubled = np.repeat(f, 2)
    prior = powerlaw_prior(fdoubled, log10_amplitude, gamma, T)
    return F @ (np.sqrt(prior) * eps)


# ------------------------------------------------------------- oracle layer

def add_red_noise(
    psr: SimulatedPulsar,
    log10_amplitude: float,
    spectral_index: float,
    components: int = 30,
    seed: int = None,
    modes=None,
    Tspan: float = None,
    libstempo_convention: bool = False,
):
    """Inject power-law red noise P(f) = A^2/(12 pi^2) (f yr)^-gamma yr^3.

    Draw order matches the reference (red_noise.py:118-127): one
    N(0,1)^(2*components) stream after optional seeding. Times are TOA
    epochs in seconds; ``libstempo_convention`` references them to the
    first TOA and orders the basis [cos, sin].

    Divergence from the reference: a caller-supplied ``Tspan`` is honored
    (for pinning a common span across pulsars); the reference accepts the
    argument but overwrites it from the TOAs (red_noise.py:124).
    """
    if seed is not None:
        np.random.seed(seed)

    toas_s = psr.toas.get_mjds() * DAY_IN_SEC
    tspan = float(Tspan) if Tspan is not None else float(toas_s.max() - toas_s.min())
    nmodes = components if modes is None else len(modes)
    eps = np.random.randn(2 * nmodes)
    dt = red_noise_delay(
        toas_s,
        log10_amplitude,
        spectral_index,
        eps,
        nmodes=nmodes,
        tspan_s=tspan,
        libstempo_convention=libstempo_convention,
        modes=modes,
    )
    psr.update_added_signals(
        f"{psr.name}_red_noise",
        {"amplitude": log10_amplitude, "spectral_index": spectral_index},
        dt,
    )
    psr.toas.adjust_seconds(dt)
    psr.update_residuals()


def add_chromatic_noise(
    psr: SimulatedPulsar,
    log10_amplitude: float,
    spectral_index: float,
    components: int = 30,
    chromatic_index: float = 2.0,
    ref_freq_mhz: float = 1400.0,
    seed: int = None,
    Tspan: float = None,
    signal_name: str = "chromatic_noise",
):
    """Inject chromatic (radio-frequency-dependent) power-law red noise:
    the achromatic Fourier-basis process scaled per TOA by
    ``(ref_freq_mhz / freq)^chromatic_index`` — index 2 is
    dispersion-measure noise, 4 scattering; the amplitude is defined at
    ``ref_freq_mhz``. Same draw layout as :func:`add_red_noise`; TOAs with
    frequency <= 0 (infinite frequency) get no chromatic delay.
    """
    if seed is not None:
        np.random.seed(seed)

    toas_s = psr.toas.get_mjds() * DAY_IN_SEC
    tspan = float(Tspan) if Tspan is not None else float(toas_s.max() - toas_s.min())
    eps = np.random.randn(2 * components)
    dt = red_noise_delay(
        toas_s,
        log10_amplitude,
        spectral_index,
        eps,
        nmodes=components,
        tspan_s=tspan,
    )
    if psr.toas.freqs_mhz is None:
        raise ValueError(
            f"{psr.name}: chromatic noise needs TOA observing frequencies "
            "(the tim data carries none)"
        )
    freqs = np.asarray(psr.toas.freqs_mhz, dtype=np.float64)
    scale = np.where(
        freqs > 0.0,
        (ref_freq_mhz / np.where(freqs > 0.0, freqs, 1.0)) ** chromatic_index,
        0.0,
    )
    dt = dt * scale
    psr.update_added_signals(
        f"{psr.name}_{signal_name}",
        {
            "amplitude": log10_amplitude,
            "spectral_index": spectral_index,
            "chromatic_index": chromatic_index,
            "ref_freq_mhz": ref_freq_mhz,
        },
        dt,
    )
    psr.toas.adjust_seconds(dt)
    psr.update_residuals()
