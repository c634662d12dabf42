"""Sky-coordinate utilities (pyephem replacement).

A copy of ``pta_replicator_tpu/ops/coords.py`` (the port imports nothing
of the JAX package), so that sky positions, and the batch's direction
vectors, agree with the JAX package bit for bit.

The reference converts pulsar sky locations with pyephem at five copy-pasted
sites (e.g. pta_replicator/red_noise.py:203-223,
pta_replicator/deterministic.py:76-91): RAJ is decimal hours
(* pi/12), DECJ decimal degrees (* pi/180); ELONG/ELAT are converted
ecliptic->equatorial with epoch B1950 if the pulsar name contains "B", else
J2000. pyephem is not available here, so the conversion is implemented
directly: a mean-obliquity rotation at J2000 plus an IAU-1976 precession to
B1950 when required (arcsecond-level differences from pyephem are irrelevant
to antenna patterns and ORFs, which vary over degrees).
"""
from __future__ import annotations

import numpy as np

#: Mean obliquity of the ecliptic at J2000 [rad] (IAU 2006, 23d26m21.406s)
OBLIQUITY_J2000 = np.deg2rad(23.4392911111)


def ecliptic_to_equatorial(lon_deg: float, lat_deg: float, epoch: str = "2000"):
    """Convert ecliptic (lon, lat) [deg] to equatorial (ra, dec) [rad].

    ``epoch`` selects the equinox of the returned coordinates ("2000" or
    "1950"), matching the reference's B-name epoch switch.
    """
    lam = np.deg2rad(lon_deg)
    beta = np.deg2rad(lat_deg)
    v_ecl = np.array(
        [np.cos(beta) * np.cos(lam), np.cos(beta) * np.sin(lam), np.sin(beta)]
    )
    ce, se = np.cos(OBLIQUITY_J2000), np.sin(OBLIQUITY_J2000)
    rot = np.array([[1.0, 0.0, 0.0], [0.0, ce, -se], [0.0, se, ce]])
    v_eq = rot @ v_ecl
    if str(epoch) == "1950":
        v_eq = _precession_matrix_j2000_to_b1950() @ v_eq
    ra = np.arctan2(v_eq[1], v_eq[0]) % (2 * np.pi)
    dec = np.arcsin(np.clip(v_eq[2], -1.0, 1.0))
    return float(ra), float(dec)


def _precession_matrix_j2000_to_b1950() -> np.ndarray:
    """IAU-1976 precession rotation from J2000.0 to B1950.0 equinox."""
    # Julian centuries from J2000 to B1950 (JD 2433282.4235)
    T = (2433282.4235 - 2451545.0) / 36525.0
    arcsec = np.pi / (180.0 * 3600.0)
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * arcsec
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * arcsec
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * arcsec

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])

    return rz(-z) @ ry(theta) @ rz(-zeta)


def equatorial_to_ecliptic(ra_rad: float, dec_rad: float, epoch: str = "2000"):
    """Inverse of :func:`ecliptic_to_equatorial`: equatorial (ra, dec)
    [rad] to ecliptic (lon, lat) [deg], with the same B-name epoch
    convention (round-trips exactly)."""
    v_eq = np.array([
        np.cos(dec_rad) * np.cos(ra_rad),
        np.cos(dec_rad) * np.sin(ra_rad),
        np.sin(dec_rad),
    ])
    if str(epoch) == "1950":
        v_eq = _precession_matrix_j2000_to_b1950().T @ v_eq
    ce, se = np.cos(OBLIQUITY_J2000), np.sin(OBLIQUITY_J2000)
    rot = np.array([[1.0, 0.0, 0.0], [0.0, ce, -se], [0.0, se, ce]])
    v_ecl = rot.T @ v_eq
    lam = np.arctan2(v_ecl[1], v_ecl[0]) % (2 * np.pi)
    beta = np.arcsin(np.clip(v_ecl[2], -1.0, 1.0))
    return float(np.rad2deg(lam)), float(np.rad2deg(beta))


def equatorial_to_ecliptic_tangent(
    ra_rad: float, dec_rad: float, epoch: str = "2000"
):
    """2x2 rotation taking local tangent-plane components from the
    equatorial basis (e_ra, e_dec) to the ecliptic basis (e_lon, e_lat)
    at the given position: ``(u_lon*, u_lat) = R @ (u_ra*, u_dec)``
    where starred components carry the cos(lat) factor (proper-motion
    convention). Used to write equatorial-basis fit updates back to
    ELONG/ELAT/PMELONG/PMELAT pars.

    ``epoch`` must match the equinox of the input (ra, dec) — "1950" for
    B-named pulsars, whose coordinates come from
    :func:`ecliptic_to_equatorial` with the 1950 switch. The ecliptic
    pole is then precessed into the same B1950 frame; mixing a B1950
    position with the J2000 pole skews the rotation by the ~0.6 deg
    precession angle."""
    p = np.array([
        np.cos(dec_rad) * np.cos(ra_rad),
        np.cos(dec_rad) * np.sin(ra_rad),
        np.sin(dec_rad),
    ])
    zhat = np.array([0.0, 0.0, 1.0])
    ce, se = np.cos(OBLIQUITY_J2000), np.sin(OBLIQUITY_J2000)
    n_ecl = np.array([0.0, -se, ce])  # ecliptic north pole, equatorial frame
    if str(epoch) == "1950":
        n_ecl = _precession_matrix_j2000_to_b1950() @ n_ecl

    def basis(nhat):
        e1 = np.cross(nhat, p)
        e1 = e1 / np.linalg.norm(e1)
        return e1, np.cross(p, e1)

    e_ra, e_dec = basis(zhat)
    e_lon, e_lat = basis(n_ecl)
    return np.array([
        [e_ra @ e_lon, e_dec @ e_lon],
        [e_ra @ e_lat, e_dec @ e_lat],
    ])


def ecliptic_epoch(name: str) -> str:
    """Equinox for a pulsar's ecliptic coordinates: "1950" for B-named
    pulsars, "2000" otherwise — the reference's pyephem epoch switch
    (red_noise.py:210-221). Single home for the rule; the same string
    feeds ecliptic_to_equatorial, equatorial_to_ecliptic and the
    tangent-plane rotation, which must all agree on the frame."""
    return "1950" if "B" in (name or "") else "2000"


def pulsar_ra_dec(loc: dict, name: str = ""):
    """Equatorial (ra, dec) [rad] from a reference-convention ``loc`` dict.

    RAJ is decimal hours, DECJ decimal degrees
    (pta_replicator/simulate.py:127-132); ELONG/ELAT are
    decimal degrees with the B-name 1950-epoch switch
    (pta_replicator/red_noise.py:210-221).
    """
    if "RAJ" in loc and "DECJ" in loc:
        return float(loc["RAJ"]) * np.pi / 12.0, float(loc["DECJ"]) * np.pi / 180.0
    if "ELONG" in loc and "ELAT" in loc:
        return ecliptic_to_equatorial(
            loc["ELONG"], loc["ELAT"], epoch=ecliptic_epoch(name)
        )
    raise AttributeError("loc must contain RAJ/DECJ or ELONG/ELAT")


def pulsar_theta_phi(loc: dict, name: str = ""):
    """(polar angle theta, azimuth phi) [rad] of the pulsar direction."""
    ra, dec = pulsar_ra_dec(loc, name)
    return np.pi / 2.0 - dec, ra


def unit_vector(theta: float, phi: float) -> np.ndarray:
    """Cartesian unit vector from polar/azimuthal angles."""
    return np.array(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
    )
