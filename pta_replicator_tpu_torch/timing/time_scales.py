"""Time-scale conversions and observatory geometry for the timing engine.

Counterpart of ``pta_replicator_tpu/timing/time_scales.py``, a copy (the
port imports nothing of the JAX package): the same operations in the same
order, so the same bits.

The reference delegates all of this to PINT (clock chains, TDB
conversion, topocentric-to-barycentric geometry; reference
simulate.py:155 ``get_TOAs(..., ephem='DE440', planets=True)``). This
module implements the closed-form core of that chain so the standalone
engine's model evaluation is accurate to the ~10 us level on real data
(measured in tests/test_timing_fidelity.py) instead of the ~1.5 ms it
carries with raw-UTC epochs and a geocentric-only Roemer term:

- UTC -> TT via the published leap-second table (TAI-UTC) + 32.184 s.
- TT -> TDB via the standard truncated Fairhead & Bretagnon series
  (seven terms, ~us accuracy over 1980-2040).
- Observatory ITRF coordinates (tempo2 observatory.dat values, public)
  rotated to the J2000 equatorial frame via GMST + IAU-1976 precession,
  giving the topocentric Roemer term (up to ~21 ms, diurnal) that a
  geocentric model cannot represent.

Accuracy stance: nutation, polar motion, and UT1-UTC are neglected —
each contributes ~<2 us through the diurnal term; the analytic Earth
*orbit* (components.earth_position_au) remains the dominant model-
evaluation error at the tens-of-us level. See
tests/test_timing_fidelity.py for the measured end-to-end bound.
"""
from __future__ import annotations

import numpy as np

from ..constants import DAY_IN_SEC

# --------------------------------------------------------------- leap seconds

#: (MJD the step takes effect, TAI-UTC seconds from that date) — the
#: complete published table since 1972 (no further leap seconds have
#: been scheduled as of the 2020s; the table is append-only).
_LEAP_TABLE = np.array([
    (41317.0, 10.0),  # 1972-01-01
    (41499.0, 11.0),  # 1972-07-01
    (41683.0, 12.0),  # 1973-01-01
    (42048.0, 13.0),  # 1974-01-01
    (42413.0, 14.0),  # 1975-01-01
    (42778.0, 15.0),  # 1976-01-01
    (43144.0, 16.0),  # 1977-01-01
    (43509.0, 17.0),  # 1978-01-01
    (43874.0, 18.0),  # 1979-01-01
    (44239.0, 19.0),  # 1980-01-01
    (44786.0, 20.0),  # 1981-07-01
    (45151.0, 21.0),  # 1982-07-01
    (45516.0, 22.0),  # 1983-07-01
    (46247.0, 23.0),  # 1985-07-01
    (47161.0, 24.0),  # 1988-01-01
    (47892.0, 25.0),  # 1990-01-01
    (48257.0, 26.0),  # 1991-01-01
    (48804.0, 27.0),  # 1992-07-01
    (49169.0, 28.0),  # 1993-07-01
    (49534.0, 29.0),  # 1994-07-01
    (50083.0, 30.0),  # 1996-01-01
    (50630.0, 31.0),  # 1997-07-01
    (51179.0, 32.0),  # 1999-01-01
    (53736.0, 33.0),  # 2006-01-01
    (54832.0, 34.0),  # 2009-01-01
    (56109.0, 35.0),  # 2012-07-01
    (57204.0, 36.0),  # 2015-07-01
    (57754.0, 37.0),  # 2017-01-01
])

TT_MINUS_TAI = 32.184


def tai_minus_utc(mjd_utc) -> np.ndarray:
    """TAI-UTC [s] at the given UTC MJDs (0 before the 1972 table)."""
    t = np.asarray(mjd_utc, dtype=np.float64)
    idx = np.searchsorted(_LEAP_TABLE[:, 0], t, side="right") - 1
    out = np.where(idx >= 0, _LEAP_TABLE[np.clip(idx, 0, None), 1], 0.0)
    return out


def tdb_minus_tt(mjd_tt) -> np.ndarray:
    """TDB-TT [s]: truncated Fairhead & Bretagnon 1990 series (the
    standard seven-coefficient form; ~us accuracy across decades)."""
    t = np.asarray(mjd_tt, dtype=np.float64)
    # Julian centuries from J2000: the 628.3076 rad/unit leading
    # argument is 100 cycles per unit, i.e. the ~annual solar anomaly
    ww = (t - 51544.5) / 36525.0
    return (
        0.001657 * np.sin(628.3076 * ww + 6.2401)
        + 0.000022 * np.sin(575.3385 * ww + 4.2970)
        + 0.000014 * np.sin(1256.6152 * ww + 6.1969)
        + 0.000005 * np.sin(606.9777 * ww + 4.0212)
        + 0.000005 * np.sin(52.9691 * ww + 0.4444)
        + 0.000002 * np.sin(21.3299 * ww + 5.5431)
        + 0.000010 * ww * np.sin(628.3076 * ww + 4.2490)
    )


def tdb_minus_utc(mjd_utc) -> np.ndarray:
    """TDB-UTC [s] (leap table + 32.184 + periodic TDB terms)."""
    d_tt = tai_minus_utc(mjd_utc) + TT_MINUS_TAI
    mjd_tt = np.asarray(mjd_utc, dtype=np.float64) + d_tt / DAY_IN_SEC
    return d_tt + tdb_minus_tt(mjd_tt)


# ----------------------------------------------------------- observatories

#: ITRF geocentric coordinates [m] (tempo2 observatory.dat / public
#: geodetic values), keyed by every alias the tim files use.
_SITES = {
    "arecibo": (2390490.0, -5564764.0, 1994727.0),
    "gbt": (882589.65, -4924872.32, 3943729.35),
    "vla": (-1601192.0, -5041981.4, 3554871.4),
    "parkes": (-4554231.5, 2816759.1, -3454036.3),
    "jodrell": (3822626.04, -154105.65, 5086486.04),
    "nancay": (4324165.81, 165927.11, 4670132.83),
    "effelsberg": (4033949.5, 486989.4, 4900430.8),
    "wsrt": (3828445.659, 445223.600, 5064921.568),
    "chime": (-2059166.313, -3621302.972, 4814304.113),
    "meerkat": (5109360.133, 2006852.586, -3238948.127),
    "lofar": (3826577.462, 461022.624, 5064892.526),
    "fast": (-1668557.0, 5506838.0, 2744934.0),
}
_ALIASES = {
    "ao": "arecibo", "3": "arecibo", "aoutc": "arecibo",
    "1": "gbt", "gb": "gbt",
    "6": "vla", "y": "vla",
    "7": "parkes", "pks": "parkes", "atnf": "parkes",
    "8": "jodrell", "jb": "jodrell", "jbdfb": "jodrell",
    "jbroach": "jodrell", "jbafb": "jodrell",
    "f": "nancay", "ncy": "nancay", "nuppi": "nancay",
    "g": "effelsberg", "eff": "effelsberg",
    "i": "wsrt",
    "chime": "chime",
    "m": "meerkat", "mk": "meerkat",
    "t": "lofar",
}


def site_itrf_m(code: str):
    """ITRF XYZ [m] for an observatory code, or None when unknown (the
    caller falls back to geocentric — e.g. fabricated 'AXIS' TOAs,
    barycentric '@'/'bat' TOAs)."""
    c = (code or "").strip().lower()
    c = _ALIASES.get(c, c)
    return _SITES.get(c)


def gmst_rad(mjd_ut) -> np.ndarray:
    """Greenwich mean sidereal time [rad] (IAU 1982; UT1~UTC is fine
    here — 0.9 s of UT error is a 7e-5 rad rotation, ~1.4 us through
    the 21 ms diurnal term)."""
    t = np.asarray(mjd_ut, dtype=np.float64)
    d = t - 51544.5
    T = d / 36525.0
    gmst_s = (
        67310.54841
        + (876600.0 * 3600.0 + 8640184.812866) * T
        + 0.093104 * T * T
        - 6.2e-6 * T * T * T
    )
    return (gmst_s % 86400.0) / 86400.0 * 2.0 * np.pi


def _precession_matrix(mjd_tt):
    """IAU-1976 precession angles (zeta_A, z_A, theta_A) [rad],
    vectorized over epochs."""
    T = (np.asarray(mjd_tt, dtype=np.float64) - 51544.5) / 36525.0
    arcsec = np.pi / 180.0 / 3600.0
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * arcsec
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * arcsec
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * arcsec
    return zeta, z, theta


def observatory_position_au(mjd_utc, codes) -> np.ndarray:
    """(N, 3) J2000-equatorial geocentric observatory positions [AU].

    Rows for unknown/barycentric codes are zero (pure geocenter). The
    chain is r_J2000 = P(T)^T . Rz(GMST) . r_ITRF: Earth rotation at
    GMST (true sidereal angle minus the ~1 s equation of equinoxes,
    ~2 us effect), then precession back from mean-of-date to J2000.
    """
    t = np.atleast_1d(np.asarray(mjd_utc, dtype=np.float64))
    n = len(t)
    xyz = np.zeros((n, 3))
    if isinstance(codes, str):
        codes = [codes] * n
    # resolve unique codes once; per-TOA loop would re-dict-lookup 7k times
    site_vec = {}
    for c in set(codes):
        s = site_itrf_m(c)
        if s is not None:
            site_vec[c] = np.asarray(s)
    if not site_vec:
        return xyz
    itrf = np.zeros((n, 3))
    have = np.zeros(n, dtype=bool)
    for i, c in enumerate(codes):
        v = site_vec.get(c)
        if v is not None:
            itrf[i] = v
            have[i] = True
    g = gmst_rad(t)
    cg, sg = np.cos(g), np.sin(g)
    # Rz(GMST) @ r_ITRF -> mean-of-date equatorial
    x = cg * itrf[:, 0] - sg * itrf[:, 1]
    y = sg * itrf[:, 0] + cg * itrf[:, 1]
    zc = itrf[:, 2]
    # Explicit IAU-1976 precession matrix P (r_date = P @ r_J2000;
    # Explanatory Supplement form, P = R3(-z) R2(theta) R3(-zeta));
    # we need r_J2000 = P^T @ r_date. Sanity anchors (tested):
    # P[2,0] = cos(zeta) sin(theta) > 0 (Dec of the J2000 equinox
    # increases with date), P[0,2] = -sin(theta) cos(z) < 0 (the J2000
    # pole trails toward date RA ~ 180 deg).
    zeta, zz, theta = _precession_matrix(t)
    cze, sze = np.cos(zeta), np.sin(zeta)
    cz, sz = np.cos(zz), np.sin(zz)
    ct, st = np.cos(theta), np.sin(theta)
    p00 = cze * ct * cz - sze * sz
    p01 = -sze * ct * cz - cze * sz
    p02 = -st * cz
    p10 = cze * ct * sz + sze * cz
    p11 = -sze * ct * sz + cze * cz
    p12 = -st * sz
    p20 = cze * st
    p21 = -sze * st
    p22 = ct
    # r_J2000 = P^T r_date: row i of P^T is column i of P
    x3 = p00 * x + p10 * y + p20 * zc
    y3 = p01 * x + p11 * y + p21 * zc
    z3 = p02 * x + p12 * y + p22 * zc
    au_m = 1.495978707e11
    out = np.stack([x3, y3, z3], axis=1) / au_m
    out[~have] = 0.0
    return out
