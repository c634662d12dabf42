"""Minimal flat-LambdaCDM cosmology and SMBHB strain utilities.

Counterpart of ``pta_replicator_tpu/utils/cosmology.py``, copied so that
the port imports nothing of the JAX package: the same numpy arithmetic in
the same order, hence the same bits. The reference pipeline takes these
pieces from holodeck (``holodeck.utils``, ``holodeck.cosmo``); they are
implemented directly here, in cgs units, with Planck15 parameters to match
holodeck's default cosmology.
"""
from __future__ import annotations

import numpy as np

# Planck15 (holodeck's default cosmology)
H0_KM_S_MPC = 67.74
OMEGA_M = 0.3089

# cgs constants
C_CMS = 2.99792458e10
G_CGS = 6.6743e-8
MSOL_G = 1.98855e33
PC_CM = 3.0856775814913673e18
MPC_CM = PC_CM * 1e6

_H0_INV_CM = C_CMS / (H0_KM_S_MPC * 1e5 / MPC_CM)  # Hubble distance [cm]


def _efunc(z):
    return np.sqrt(OMEGA_M * (1.0 + z) ** 3 + (1.0 - OMEGA_M))


def comoving_distance_cm(z, npts: int = 256):
    """Comoving distance [cm] for flat LambdaCDM via fixed-order quadrature.

    Accurate to <0.01% against the standard integral for z < 10 (more than
    enough for SMBHB populations at z of a few).
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    # Gauss-Legendre on [0, z] per element
    x, wq = np.polynomial.legendre.leggauss(npts)
    half = z[:, None] / 2.0
    zz = half * (x[None, :] + 1.0)
    integral = half[:, 0] * np.sum(wq[None, :] / _efunc(zz), axis=1)
    out = _H0_INV_CM * integral
    return out if out.shape != (1,) else float(out[0])


def luminosity_distance_cm(z, npts: int = 256):
    """Luminosity distance [cm]: (1+z) * comoving distance (flat)."""
    return (1.0 + np.asarray(z)) * comoving_distance_cm(z, npts=npts)


def m1m2_from_mtmr(mtot, mrat):
    """Component masses from total mass and mass ratio q = m2/m1 <= 1."""
    mtot = np.asarray(mtot)
    mrat = np.asarray(mrat)
    m1 = mtot / (1.0 + mrat)
    return m1, mtot - m1


def chirp_mass(m1, m2):
    """Chirp mass (same units as inputs)."""
    m1 = np.asarray(m1)
    m2 = np.asarray(m2)
    return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2


def gw_strain_source(mchirp_g, dcom_cm, freq_orb_rest_hz):
    """Source strain amplitude of a circular binary (cgs inputs):

    h_s = (8/sqrt(10)) (G Mc)^(5/3) (2 pi f_orb)^(2/3) / (c^4 d_c)

    (holodeck-equivalent; the reference cross-checks this closed form in
    its population injector).
    """
    mchirp_g = np.asarray(mchirp_g, dtype=np.float64)
    return (
        8.0 / np.sqrt(10.0)
        * (G_CGS * mchirp_g) ** (5.0 / 3.0)
        * (2.0 * np.pi * np.asarray(freq_orb_rest_hz)) ** (2.0 / 3.0)
        / (C_CMS**4 * np.asarray(dcom_cm))
    )
