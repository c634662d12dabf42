"""Continuous gravitational waves from SMBH binaries: the source geometry,
and the per-pulsar oracle's single sources and catalogs.

Counterpart of ``pta_replicator_tpu/models/cgw.py`` (reference analogs
``add_cgw`` and ``add_catalog_of_cws``, pta_replicator/deterministic.py:
13-561; Sesana et al. 2010 / Ellis et al. 2012, three evolution modes:
full 8/3-power chirp, phase approximation, monochromatic).
``principal_axes`` is the one home of the polarization-frame convention
that the CW-catalog planes (``ops/cw.py``, host float64 numpy), the burst
and memory antenna patterns (``models/batched.py::_batch_antenna``,
tensors) and the oracle below project onto the pulsar directions. The
oracle (``antenna_pattern``, ``cw_delay``, ``add_cgw``,
``add_catalog_of_cws``) is host float64 numpy, the JAX package's
operations in its order, so its delays equal that package's bit for bit;
the batched engine evaluates the same catalog on the card through B.1
(``models/batched.py::cgw_catalog_delays``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..constants import DAY_IN_SEC, KPC2S, MPC2S, SOLAR2S
from ..ops.coords import pulsar_theta_phi, unit_vector

if TYPE_CHECKING:
    from ..simulate import SimulatedPulsar


def principal_axes(gwtheta, gwphi):
    """GW principal axes m, n and propagation direction omhat (each
    (..., 3)) for source sky position(s): tensors for tensor angles (on
    their device, in their dtype), else float64 numpy arrays."""
    xp = torch if isinstance(gwtheta, torch.Tensor) else np
    ct, st = xp.cos(gwtheta), xp.sin(gwtheta)
    cp, sp_ = xp.cos(gwphi), xp.sin(gwphi)
    m = xp.stack([sp_, -cp, xp.zeros_like(cp)], axis=-1)
    n = xp.stack([-ct * cp, -ct * sp_, st], axis=-1)
    omhat = xp.stack([-st * cp, -st * sp_, -ct], axis=-1)
    return m, n, omhat


# ----------------------------------------------------- pure math (numpy)

def antenna_pattern(gwtheta, gwphi, phat):
    """Antenna responses F+, Fx and cos(mu) for source direction(s) against
    one pulsar direction ``phat`` (3,). Source angles may carry a leading
    source axis."""
    m, n, omhat = principal_axes(np.asarray(gwtheta), np.asarray(gwphi))

    mp = m @ phat
    np_ = n @ phat
    op = omhat @ phat
    fplus = 0.5 * (mp**2 - np_**2) / (1.0 + op)
    fcross = mp * np_ / (1.0 + op)
    cosmu = -op
    return fplus, fcross, cosmu


def cw_delay(
    toas_s,
    phat,
    gwtheta,
    gwphi,
    mc,
    dist,
    fgw,
    phase0,
    psi,
    inc,
    pdist=1.0,
    pphase=None,
    psr_term: bool = True,
    evolve: bool = True,
    phase_approx: bool = False,
    nan_to_zero: bool = False,
):
    """Per-source CW-induced residuals [s], shape (..., ntoa).

    Units follow the reference API: mc in solar masses, dist in Mpc, fgw in
    Hz (twice the orbital frequency), pdist in kpc, angles in radians,
    toas_s in seconds relative to the caller's tref. Source parameters may
    carry a leading source axis; the caller reduces over it.

    ``nan_to_zero`` applies the merged-binary guard of the catalog kernels
    (reference deterministic.py:433-438): chirp evolution past merger
    produces NaNs which are injected as zeros.
    """
    t = np.asarray(toas_s)

    mc_s = np.asarray(mc) * SOLAR2S
    dist_s = np.asarray(dist) * MPC2S
    w0 = np.pi * np.asarray(fgw)
    phi0_orb = np.asarray(phase0) / 2.0
    w053 = w0 ** (-5.0 / 3.0)

    sin2psi, cos2psi = np.sin(2 * np.asarray(psi)), np.cos(2 * np.asarray(psi))
    incfac1 = 0.5 * (3.0 + np.cos(2 * np.asarray(inc)))
    incfac2 = 2.0 * np.cos(np.asarray(inc))

    fplus, fcross, cosmu = antenna_pattern(gwtheta, gwphi, phat)

    chirp_rate = 256.0 / 5.0 * mc_s ** (5.0 / 3.0) * w0 ** (8.0 / 3.0)
    phase_norm = 1.0 / 32.0 / mc_s ** (5.0 / 3.0)
    amp_norm = mc_s ** (5.0 / 3.0) / dist_s

    if pphase is not None:
        pd_s = np.asarray(pphase) / (2.0 * np.pi * np.asarray(fgw) * (1.0 - cosmu))
    else:
        pd_s = np.asarray(pdist) * KPC2S

    def src(x):
        """Broadcast a per-source value against the TOA axis."""
        return np.asarray(x)[..., None]

    tp = t - src(pd_s * (1.0 - cosmu))

    if evolve:
        omega = src(w0) * (1.0 - src(chirp_rate) * t) ** (-3.0 / 8.0)
        omega_p = src(w0) * (1.0 - src(chirp_rate) * tp) ** (-3.0 / 8.0)
        phase = src(phi0_orb) + src(phase_norm) * (src(w053) - omega ** (-5.0 / 3.0))
        phase_p = src(phi0_orb) + src(phase_norm) * (src(w053) - omega_p ** (-5.0 / 3.0))
    elif phase_approx:
        omega = src(w0) * np.ones_like(t)
        omega_p = src(w0 * (1.0 + chirp_rate * pd_s * (1.0 - cosmu)) ** (-3.0 / 8.0)) * np.ones_like(t)
        phase = src(phi0_orb) + omega * t
        phase_p = (
            src(phi0_orb)
            + src(phase_norm) * (src(w053) - omega_p ** (-5.0 / 3.0))
            + omega_p * t
        )
    else:
        omega = src(w0) * np.ones_like(t)
        omega_p = omega
        phase = src(phi0_orb) + omega * t
        phase_p = src(phi0_orb) + omega * tp

    At = np.sin(2.0 * phase) * src(incfac1)
    Bt = np.cos(2.0 * phase) * src(incfac2)
    At_p = np.sin(2.0 * phase_p) * src(incfac1)
    Bt_p = np.cos(2.0 * phase_p) * src(incfac2)

    alpha = src(amp_norm) / omega ** (1.0 / 3.0)
    alpha_p = src(amp_norm) / omega_p ** (1.0 / 3.0)

    rplus = alpha * (At * src(cos2psi) + Bt * src(sin2psi))
    rcross = alpha * (-At * src(sin2psi) + Bt * src(cos2psi))
    rplus_p = alpha_p * (At_p * src(cos2psi) + Bt_p * src(sin2psi))
    rcross_p = alpha_p * (-At_p * src(sin2psi) + Bt_p * src(cos2psi))

    if psr_term:
        res = src(fplus) * (rplus_p - rplus) + src(fcross) * (rcross_p - rcross)
    else:
        res = -src(fplus) * rplus - src(fcross) * rcross

    if nan_to_zero:
        res = np.where(np.isnan(res), 0.0, res)
    return res


# ------------------------------------------------------------- oracle layer

def _psr_phat(psr) -> np.ndarray:
    theta, phi = pulsar_theta_phi(psr.loc, psr.name)
    return unit_vector(theta, phi)


def add_cgw(
    psr: SimulatedPulsar,
    gwtheta,
    gwphi,
    mc,
    dist,
    fgw,
    phase0,
    psi,
    inc,
    pdist=1.0,
    pphase=None,
    psrTerm: bool = True,
    evolve: bool = True,
    phase_approx: bool = False,
    tref=0,
    signal_name: str = "cw",
):
    """Inject one continuous wave (reference deterministic.py:13-185)."""
    toas_s = psr.toas.get_mjds() * DAY_IN_SEC - tref
    res = cw_delay(
        toas_s,
        _psr_phat(psr),
        gwtheta,
        gwphi,
        mc,
        dist,
        fgw,
        phase0,
        psi,
        inc,
        pdist=pdist,
        pphase=pphase,
        psr_term=psrTerm,
        evolve=evolve,
        phase_approx=phase_approx,
    )
    psr.inject(
        f"{psr.name}_{signal_name}",
        {
            "gwtheta": gwtheta,
            "gwphi": gwphi,
            "mc": mc,
            "dist": dist,
            "fgw": fgw,
            "phase0": phase0,
            "psi": psi,
            "inc": inc,
            "pdist": pdist,
            "pphase": pphase,
            "psrTerm": psrTerm,
            "evolve": evolve,
            "phase_approx": phase_approx,
            "tref": tref,
        },
        np.asarray(res),
    )


def add_catalog_of_cws(
    psr: SimulatedPulsar,
    gwtheta_list,
    gwphi_list,
    mc_list,
    dist_list,
    fgw_list,
    phase0_list,
    psi_list,
    inc_list,
    pdist=1.0,
    pphase=None,
    psrTerm: bool = True,
    evolve: bool = True,
    phase_approx: bool = False,
    tref=0,
    chunk_size: int = 10_000_000,
    signal_name: str = "cw_catalog",
):
    """Inject a catalog of N continuous waves in one summed pass
    (reference deterministic.py:188-318), merged binaries (NaN) as zeros.

    Sources are processed in chunks that bound the (sources x TOAs)
    workspace at ~2e7 elements; unlike the reference, arbitrarily large
    catalogs produce a single ledger entry (the reference's per-chunk
    ledger updates raise on the second chunk). ``pdist``/``pphase`` are
    scalars or per-source vectors, sliced with the chunk.
    """
    toas_s = (psr.toas.get_mjds() * DAY_IN_SEC - tref).astype(np.float64)
    phat = _psr_phat(psr).astype(np.float64)
    params = [
        np.atleast_1d(np.asarray(x, dtype=np.float64))
        for x in (gwtheta_list, gwphi_list, mc_list, dist_list, fgw_list,
                  phase0_list, psi_list, inc_list)
    ]
    nsrc = params[2].size
    ntoa = toas_s.size
    pdist_v = np.atleast_1d(np.asarray(pdist, dtype=np.float64))
    pphase_v = (
        None if pphase is None
        else np.atleast_1d(np.asarray(pphase, dtype=np.float64))
    )
    step = max(1, min(chunk_size, int(2e7) // max(ntoa, 1)))
    total = np.zeros(ntoa)
    for lo in range(0, nsrc, step):
        sl = slice(lo, min(lo + step, nsrc))
        res = cw_delay(
            toas_s,
            phat,
            *[p[sl] for p in params],
            pdist=pdist_v[sl] if pdist_v.size > 1 else pdist_v,
            pphase=(
                None if pphase_v is None
                else (pphase_v[sl] if pphase_v.size > 1 else pphase_v)
            ),
            psr_term=psrTerm,
            evolve=evolve,
            phase_approx=phase_approx,
            nan_to_zero=True,
        )
        total += res.sum(axis=0)

    psr.inject(
        f"{psr.name}_{signal_name}",
        {
            "gwtheta_list": params[0],
            "gwphi_list": params[1],
            "mc_list": params[2],
            "dist_list": params[3],
            "fgw_list": params[4],
            "phase0_list": params[5],
            "psi_list": params[6],
            "inc_list": params[7],
            "pdist": pdist,
            "pphase": pphase,
            "psrTerm": psrTerm,
            "evolve": evolve,
            "phase_approx": phase_approx,
            "tref": tref,
        },
        total,
    )
