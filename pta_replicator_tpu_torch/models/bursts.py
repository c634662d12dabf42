"""Deterministic transient signals on the per-pulsar oracle path: GW
bursts, bursts with memory, and arbitrary noise transients.

Counterpart of ``pta_replicator_tpu/models/bursts.py`` (reference analogs
``add_burst``, ``add_noise_transient`` and ``add_gw_memory``,
pta_replicator/deterministic.py:718-884). Host float64 numpy, the JAX
package's operations in its order (its delays bit for bit); the batched
engine's twins are ``models/batched.py::burst_delays``,
``transient_delays`` and ``gw_memory_delays``.
"""
from __future__ import annotations

import numpy as np

from ..constants import DAY_IN_SEC
from ..models.cgw import _psr_phat, antenna_pattern
from ..simulate import SimulatedPulsar


# ----------------------------------------------------------------- pure math

def polarization_rotation(hplus, hcross, psi):
    """Rotate (h+, hx) by polarization angle psi along the propagation
    direction (Maggiore 2008 eq. 7.24-25)."""
    c2, s2 = np.cos(2.0 * psi), np.sin(2.0 * psi)
    return hplus * c2 - hcross * s2, hplus * s2 + hcross * c2


def quadratic_subtract(toas_s, res):
    """Remove the best-fit quadratic in time — mimics the absorption of a
    signal's low-order structure by an F0/F1 refit
    (reference deterministic.py:776-778)."""
    t = np.asarray(toas_s, dtype=np.float64)
    # column-scaled quadratic design for conditioning
    scale = np.maximum(np.max(np.abs(t)), 1.0)
    ts = t / scale
    M = np.stack([ts**2, ts, np.ones_like(ts)], axis=-1)
    coef, *_ = np.linalg.lstsq(M, res)
    return res - M @ coef


def memory_ramp(toas_s, t0_s, pol_amp, strain):
    """Burst-with-memory residual: a linear ramp pol*strain*(t-t0) after t0."""
    t = np.asarray(toas_s)
    return np.where(t < t0_s, 0.0, pol_amp * strain * (t - t0_s))


# ------------------------------------------------------------- oracle layer

def add_burst(
    psr: SimulatedPulsar,
    gwtheta,
    gwphi,
    waveform_plus,
    waveform_cross,
    psi: float = 0.0,
    tref=0,
    remove_quad: bool = False,
    signal_name: str = "burst",
):
    """Inject an arbitrary elliptically-polarized GW burst given waveform
    callables h+(t), hx(t) evaluated at t - tref [s]."""
    toas_s = psr.toas.get_mjds() * DAY_IN_SEC - tref
    fplus, fcross, _ = antenna_pattern(gwtheta, gwphi, _psr_phat(psr))
    hplus = np.asarray(waveform_plus(toas_s))
    hcross = np.asarray(waveform_cross(toas_s))
    rplus, rcross = polarization_rotation(hplus, hcross, psi)
    res = -fplus * rplus - fcross * rcross
    if remove_quad:
        res = quadratic_subtract(toas_s.astype(np.float64), res)
    psr.inject(
        f"{psr.name}_{signal_name}",
        {
            "gwtheta": gwtheta,
            "gwphi": gwphi,
            "waveform_plus": waveform_plus,
            "waveform_cross": waveform_cross,
            "psi": psi,
            "tref": tref,
            "remove_quad": remove_quad,
        },
        res,
    )


def add_noise_transient(
    psr: SimulatedPulsar,
    waveform,
    tref=0,
    signal_name: str = "noise_transient",
):
    """Inject an un-projected arbitrary waveform into one pulsar
    (glitch-like incoherent transient)."""
    toas_s = psr.toas.get_mjds() * DAY_IN_SEC - tref
    res = np.asarray(waveform(toas_s))
    psr.inject(
        f"{psr.name}_{signal_name}",
        {"waveform": waveform, "tref": tref},
        res,
    )


def add_gw_memory(
    psr: SimulatedPulsar,
    strain,
    gwtheta,
    gwphi,
    bwm_pol,
    t0_mjd,
    signal_name: str = "gw_memory",
):
    """Inject a burst with memory: a polarization-projected strain ramp
    starting at epoch t0_mjd."""
    fplus, fcross, _ = antenna_pattern(gwtheta, gwphi, _psr_phat(psr))
    pol_amp = np.cos(2.0 * bwm_pol) * fplus + np.sin(2.0 * bwm_pol) * fcross
    toas_s = psr.toas.get_mjds() * DAY_IN_SEC
    res = memory_ramp(toas_s, t0_mjd * DAY_IN_SEC, pol_amp, strain)
    psr.inject(
        f"{psr.name}_{signal_name}",
        {
            "strain": strain,
            "gwtheta": gwtheta,
            "gwphi": gwphi,
            "bwm_pol": bwm_pol,
            "t0_mjd": t0_mjd,
        },
        res,
    )
