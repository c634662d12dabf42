"""Physical timing-model delay components and the full-model design matrix.

The reference delegates its post-injection refit to PINT's fitters over the
*full* timing model — binary, astrometry, DM, spin
(pta_replicator/simulate.py:44-69). This framework is
standalone, so the delay components that matter for absorbing injected
signal power are implemented here directly:

* **binary orbits** — ELL1 (Lange et al. 2001: low-eccentricity Roemer
  expansion + Shapiro), and BT/DD (full Kepler solve, Einstein gamma term,
  DD Shapiro). Both NANOGrav fixture binaries (B1855+09, J1909-3744) are
  ELL1.
* **dispersion** — K * DM(t) / f^2 against the per-TOA radio frequency.
* **astrometry** — Roemer delay (position, proper motion, parallax)
  against an *analytic* low-precision Earth orbit (Meeus-style mean
  elements; no solar-system ephemeris dependency), plus the topocentric
  Earth-rotation term and UTC->TDB time-scale chain (timing.time_scales).

Accuracy stance (documented, deliberate): the Earth orbit is good to
~1e-4 AU, so absolute astrometric delays carry ~10 ms error — far from
PINT's ns-level barycentering, and *not* sufficient to reproduce PINT's
pre-fit residuals on real data (that requires a numerical ephemeris,
whose DE440 data files are unavailable in this build environment).
What the synthesis framework needs is the design-matrix *column space*:
annual/semi-annual astrometric signatures, binary-orbital harmonics, and
1/f^2 dispersion trends with the correct time/frequency dependence, so a
post-injection refit absorbs the same signal power the reference's PINT
refit does. Binary and dispersion delays are exact closed forms (binary
phases referenced to topocentric TOAs, a ~5e-4-cycle approximation).

Measured bound (tests/test_timing_fidelity.py, real B1855+09 data —
7,758 TOAs, 166 active columns incl. 147 DMX windows, ELL1+Shapiro
binary, FD, flag-matched JUMP): perturbing 21 parameters spanning every
family by +3 of PINT's own published uncertainties and refitting
recovers each to better than 0.06 sigma (median 3e-4 sigma), with
post-fit residuals at 0.16 ns RMS. The Earth-rotation geometry is
anchored externally: hour angles implied by GMST + Arecibo ITRF
coordinates on the real observing epochs land inside the dish's
physical +-20 deg zenith window.

Counterpart of ``pta_replicator_tpu/timing/components.py``, a copy (the port
imports nothing of the JAX package), on numpy alone (the JAX package's
``xp`` switch is gone): the same operations in the same order, so the
same bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..constants import DAY_IN_SEC

#: Solar mass in geometric seconds (Shapiro range scale), IAU nominal.
TSUN_S = 4.925490947e-6
#: Astronomical unit light-travel time [s].
AU_S = 499.00478384
#: Dispersion constant: delay [s] = DM [pc cm^-3] / (K_DM * f_MHz^2).
K_DM = 2.41e-4  # the tempo/PINT convention value
#: Julian year [s] and days.
YEAR_DAYS = 365.25
#: Obliquity of the ecliptic at J2000 [rad].
OBLIQUITY = np.deg2rad(23.439291)


def _parf(par, key: str, default: Optional[float] = None) -> Optional[float]:
    """Float value of a par-file parameter (first token), or default."""
    from ..io.par import _parse_float

    tok = par.params.get(key)
    if not tok:
        return default
    try:
        return _parse_float(tok[0])
    except ValueError:
        return default


# ----------------------------------------------------------------- binaries

@dataclass
class BinaryModel:
    """Keplerian binary delay model (ELL1 or BT/DD parameterization).

    Units follow par-file conventions: PB in days, A1 in light-seconds,
    T0/TASC in MJD, OM in degrees, OMDOT in deg/yr, PBDOT dimensionless
    (or in the tempo 1e-12 convention — values > 1e-7 are auto-rescaled),
    A1DOT in ls/s, M2 in solar masses.
    """

    model: str = "ELL1"
    pb_days: float = 0.0
    a1_ls: float = 0.0
    tasc_mjd: Optional[float] = None  # ELL1 epoch of ascending node
    t0_mjd: Optional[float] = None    # BT/DD epoch of periastron
    eps1: float = 0.0   # e sin(omega)  (ELL1)
    eps2: float = 0.0   # e cos(omega)  (ELL1)
    ecc: float = 0.0    # (BT/DD)
    om_deg: float = 0.0  # (BT/DD)
    omdot_degyr: float = 0.0
    pbdot: float = 0.0
    a1dot: float = 0.0
    gamma_s: float = 0.0  # Einstein delay amplitude (BT/DD)
    m2_msun: float = 0.0
    sini: float = 0.0

    @classmethod
    def from_par(cls, par) -> Optional["BinaryModel"]:
        tok = par.params.get("BINARY")
        if not tok:
            return None
        name = str(tok[0]).upper()
        pbdot = _parf(par, "PBDOT", 0.0) or 0.0
        if abs(pbdot) > 1e-7:  # tempo's 1e-12 shorthand convention
            pbdot *= 1e-12
        kind = "ELL1" if name.startswith("ELL1") else "BT" if name == "BT" else "DD"
        if _parf(par, "TASC") is None and kind == "ELL1":
            kind = "DD"  # ELL1 without TASC: treat as DD via T0
        return cls(
            model=kind,
            pb_days=_parf(par, "PB", 0.0) or 0.0,
            a1_ls=_parf(par, "A1", 0.0) or 0.0,
            tasc_mjd=_parf(par, "TASC"),
            t0_mjd=_parf(par, "T0"),
            eps1=_parf(par, "EPS1", 0.0) or 0.0,
            eps2=_parf(par, "EPS2", 0.0) or 0.0,
            ecc=_parf(par, "ECC", _parf(par, "E", 0.0)) or 0.0,
            om_deg=_parf(par, "OM", 0.0) or 0.0,
            omdot_degyr=_parf(par, "OMDOT", 0.0) or 0.0,
            pbdot=pbdot,
            a1dot=_parf(par, "A1DOT", _parf(par, "XDOT", 0.0)) or 0.0,
            gamma_s=_parf(par, "GAMMA", 0.0) or 0.0,
            m2_msun=_parf(par, "M2", 0.0) or 0.0,
            sini=_parf(par, "SINI", 0.0) or 0.0,
        )

    # -- parameterization-aware access used by the numerical Jacobian
    def fit_param_names(self) -> List[str]:
        base = ["PB", "A1"]
        if self.model == "ELL1":
            base += ["TASC", "EPS1", "EPS2"]
        else:
            base += ["T0", "OM", "ECC"]
        if self.m2_msun and self.sini:
            base += ["M2", "SINI"]
        return base

    def get(self, name: str) -> float:
        return {
            "PB": self.pb_days, "A1": self.a1_ls, "TASC": self.tasc_mjd or 0.0,
            "T0": self.t0_mjd or 0.0, "OM": self.om_deg, "ECC": self.ecc,
            "EPS1": self.eps1, "EPS2": self.eps2, "M2": self.m2_msun,
            "SINI": self.sini, "PBDOT": self.pbdot, "A1DOT": self.a1dot,
            "GAMMA": self.gamma_s, "OMDOT": self.omdot_degyr,
        }[name]

    def replace(self, name: str, value: float) -> "BinaryModel":
        attr = {
            "PB": "pb_days", "A1": "a1_ls", "TASC": "tasc_mjd",
            "T0": "t0_mjd", "OM": "om_deg", "ECC": "ecc", "EPS1": "eps1",
            "EPS2": "eps2", "M2": "m2_msun", "SINI": "sini",
            "PBDOT": "pbdot", "A1DOT": "a1dot", "GAMMA": "gamma_s",
            "OMDOT": "omdot_degyr",
        }[name]
        import dataclasses

        return dataclasses.replace(self, **{attr: value})

    def delay_s(self, t_mjd):
        """Binary delay [s] at (topocentric) MJD epochs.

        ELL1: Lange et al. 2001 eq. A6 Roemer expansion to first order in
        eccentricity plus the standard Shapiro log; BT/DD: full Kepler
        solve with the Blandford-Teukolsky Roemer + Einstein gamma and
        the DD Shapiro argument.
        """
        t = np.asarray(t_mjd)
        pb_s = self.pb_days * DAY_IN_SEC
        if self.model == "ELL1":
            dt = (t - self.tasc_mjd) * DAY_IN_SEC
            orbits = dt / pb_s - 0.5 * self.pbdot * (dt / pb_s) ** 2
            phi = 2.0 * np.pi * orbits
            x = self.a1_ls + self.a1dot * dt
            roemer = x * (
                np.sin(phi)
                + 0.5 * self.eps2 * np.sin(2.0 * phi)
                - 0.5 * self.eps1 * np.cos(2.0 * phi)
            )
            shapiro = 0.0
            if self.m2_msun and self.sini:
                r = TSUN_S * self.m2_msun
                # floor the log argument: a fit iterate or Jacobian step
                # on a near-edge-on binary (SINI -> 1) can push it to or
                # past zero, and one NaN here poisons the whole fit
                shapiro = -2.0 * r * np.log(
                    np.maximum(1.0 - self.sini * np.sin(phi), 1e-12)
                )
            return roemer + shapiro

        # BT / DD
        dt = (t - self.t0_mjd) * DAY_IN_SEC
        orbits = dt / pb_s - 0.5 * self.pbdot * (dt / pb_s) ** 2
        M = 2.0 * np.pi * (orbits - np.floor(orbits))
        e = self.ecc
        E = M + e * np.sin(M)  # Newton iterations, quadratic convergence
        for _ in range(8):
            E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
        om = np.deg2rad(
            self.om_deg + self.omdot_degyr * dt / (YEAR_DAYS * DAY_IN_SEC)
        )
        x = self.a1_ls + self.a1dot * dt
        cE, sE = np.cos(E), np.sin(E)
        se = np.sqrt(1.0 - e**2)
        roemer = x * (np.sin(om) * (cE - e) + np.cos(om) * sE * se)
        einstein = self.gamma_s * sE
        shapiro = 0.0
        if self.m2_msun and self.sini:
            r = TSUN_S * self.m2_msun
            shapiro = -2.0 * r * np.log(
                np.maximum(
                    1.0 - e * cE
                    - self.sini
                    * (np.sin(om) * (cE - e) + np.cos(om) * sE * se),
                    1e-12,
                )
            )
        return roemer + einstein + shapiro


# -------------------------------------------------------------- dispersion

def dispersion_delay(
    freqs_mhz, dm, dm1: float = 0.0, t_mjd=None, dmepoch_mjd: float = 0.0,
):
    """Cold-plasma dispersion delay [s]: DM(t) / (K_DM * f^2).

    ``dm1`` [pc cm^-3 / yr] adds the linear DM trend around
    ``dmepoch_mjd``.
    """
    f = np.asarray(freqs_mhz)
    dmt = dm
    if dm1 and t_mjd is not None:
        dmt = dm + dm1 * (np.asarray(t_mjd) - dmepoch_mjd) / YEAR_DAYS
    return dmt / (K_DM * f**2)


# -------------------------------------------------------------- astrometry

def earth_position_au(t_mjd):
    """Analytic HELIOCENTRIC (Sun->Earth) position [AU], equatorial frame.

    Low-precision mean-element series (Meeus, Astronomical Algorithms
    ch. 25 truncation): good to ~1e-4 AU — sufficient for design-matrix
    columns (annual/semiannual signatures), NOT for ns-level
    barycentering (see module docstring). NOTE the frame origin: this is
    the SUN, not the SSB (they differ by the ~0.008 AU solar wobble).
    The Roemer/parallax terms only pick up that wobble as part of the
    documented ~1e-4-AU-class error, but the solar Shapiro and
    solar-wind terms in TimingModel.delays_s REQUIRE the heliocentric
    origin (their geometry degenerates near solar conjunction, where the
    Sun-vs-SSB distinction is larger than the impact parameter) — do
    not "upgrade" this function to true barycentric without giving
    those terms their own solar vector.
    """
    n = np.asarray(t_mjd) - 51544.5
    L = np.deg2rad(280.460 + 0.9856474 * n)
    g = np.deg2rad(357.528 + 0.9856003 * n)
    lam = L + np.deg2rad(1.915) * np.sin(g) + np.deg2rad(0.020) * np.sin(2 * g)
    R = 1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2 * g)
    ce, se = np.cos(OBLIQUITY), np.sin(OBLIQUITY)
    x = R * np.cos(lam)
    y = R * np.sin(lam) * ce
    z = R * np.sin(lam) * se
    return np.stack([x, y, z], axis=-1)


def astrometry_columns(
    t_mjd, ra_rad: float, dec_rad: float, posepoch_mjd: float
) -> Tuple[list, list]:
    """Design-matrix columns (delay [s] per unit parameter) for sky
    position offsets [rad], proper motion [rad/yr], and parallax [rad]:
    derivatives of the Roemer delay -r_earth . n_hat * AU_S.
    """
    r = earth_position_au(t_mjd)  # (N, 3)
    ca, sa = np.cos(ra_rad), np.sin(ra_rad)
    cd, sd = np.cos(dec_rad), np.sin(dec_rad)
    nhat = np.asarray([ca * cd, sa * cd, sd])
    dn_da = np.asarray([-sa * cd, ca * cd, 0.0])
    dn_dd = np.asarray([-ca * sd, -sa * sd, cd])
    tau_yr = (np.asarray(t_mjd) - posepoch_mjd) / YEAR_DAYS

    col_ra = -(r @ dn_da) * AU_S
    col_dec = -(r @ dn_dd) * AU_S
    col_pmra = col_ra * tau_yr
    col_pmdec = col_dec * tau_yr
    # parallax: annual curvature term |r_perp|^2 / (2) * AU_S per rad
    rn = r @ nhat
    col_px = 0.5 * (np.sum(r * r, axis=-1) - rn**2) * AU_S
    return (
        [col_ra, col_dec, col_pmra, col_pmdec, col_px],
        ["RAJ", "DECJ", "PMRA", "PMDEC", "PX"],
    )


# ------------------------------------------------------- full design matrix

#: relative steps for the numerical binary Jacobian, per parameter scale
_BINARY_STEPS = {
    "PB": 1e-8, "A1": 1e-7, "TASC": 1e-7, "T0": 1e-7, "OM": 1e-5,
    "ECC": 1e-9, "EPS1": 1e-9, "EPS2": 1e-9, "M2": 1e-4, "SINI": 1e-6,
}


def fd_column(freqs_mhz, k: int):
    """d(delay)/d(FDk) = ln(f_GHz)^k (PINT/tempo2 FD convention)."""
    return np.log(np.asarray(freqs_mhz) / 1000.0) ** k


def dmx_column(t_mjd, freqs_mhz, r1_mjd: float, r2_mjd: float):
    """d(delay)/d(DMX) = 1/(K_DM f^2) inside the [r1, r2] window
    (inclusive both ends, PINT's DMX range semantics), 0 outside — the
    per-window dispersion offsets of the NANOGrav DMX model (147-325
    windows on the real fixtures)."""
    t = np.asarray(t_mjd)
    f = np.asarray(freqs_mhz)
    # inclusive on both ends, matching PINT's DMX range semantics
    inside = (t >= r1_mjd) & (t <= r2_mjd)
    return np.where(inside, 1.0 / (K_DM * f**2), 0.0)


def jump_mask(flags, flag_name: str, flag_value: str) -> np.ndarray:
    """0/1 indicator of the TOAs a flag-matched JUMP applies to — the ONE
    matching rule shared by the delay model (TimingModel.delays_s) and
    the design matrix, so the fitted column always corrects exactly the
    delay it models."""
    return np.asarray(
        [str(f.get(flag_name)) == flag_value for f in flags],
        dtype=np.float64,
    )


def binary_columns(binary: BinaryModel, t_mjd) -> Tuple[list, list]:
    """Central-difference derivative columns d(delay)/d(param) for every
    fitted binary parameter (the reference gets these from PINT's
    analytic derivatives; numerical differences are exact to O(h^2) and
    parameterization-agnostic)."""
    cols, names = [], []
    for name in binary.fit_param_names():
        val = binary.get(name)
        scale = abs(val) if abs(val) > 1e-12 else 1.0
        h = scale * _BINARY_STEPS.get(name, 1e-7)
        hi = binary.replace(name, val + h).delay_s(t_mjd)
        lo = binary.replace(name, val - h).delay_s(t_mjd)
        cols.append((hi - lo) / (2.0 * h))
        names.append(name)
    return cols, names


def full_design_matrix(
    par,
    t_mjd,
    freqs_mhz=None,
    f0: Optional[float] = None,
    nspin: int = 2,
    include: str = "auto",
    flags=None,
) -> Tuple[np.ndarray, List[str]]:
    """Timing design matrix over the full model the par file declares:
    spin (offset + F0..Fn), astrometry (RAJ/DECJ/PM/PX when present),
    dispersion (per-window DMX columns when the par declares DMX, else
    global DM(+DM1) — fitting both would be rank-deficient), FD
    profile-evolution terms, binary parameters (numerical derivatives),
    and flag-matched JUMP indicator columns (named JUMP1..JUMPn in
    par-file order; require ``flags`` = per-TOA flag dicts).

    ``include``: 'auto' (everything the par file has), 'spin' (the
    spin-only columns), or a list of column names to keep. Returns
    ``(M (Ntoa, K), names)`` with delay-seconds columns (the solver
    column-normalizes, so heterogeneous parameter units are fine).
    """
    from .fit import design_matrix as spin_design_matrix

    t = np.asarray(t_mjd)
    f0 = f0 if f0 is not None else (par.f0 if par is not None else 1.0)
    pepoch = par.pepoch_mjd if par is not None else 0.0
    toas_s = (t - pepoch) * DAY_IN_SEC
    M_spin = spin_design_matrix(toas_s, f0, nspin=nspin)
    cols = [M_spin[..., k] for k in range(M_spin.shape[-1])]
    names = ["OFFSET"] + [f"F{k}" for k in range(nspin)]

    if include == "spin" or par is None:
        return np.stack(cols, axis=-1), names

    # Sky position: equatorial pars directly; ecliptic pars (all three real
    # NANOGrav fixtures are ELONG/ELAT) through the same conversion the
    # reference applies at every sky-position site
    # (pta_replicator/red_noise.py:210-221, B-name 1950 rule).
    # The fitted basis is the local 2-D tangent plane either way, so the
    # columns are reported under the equatorial names.
    radec = None
    if par.raj_hours is not None and par.decj_deg is not None:
        radec = (par.raj_hours * np.pi / 12.0, np.deg2rad(par.decj_deg))
    elif par.elong_deg is not None and par.elat_deg is not None:
        from ..ops.coords import pulsar_ra_dec

        radec = pulsar_ra_dec(par.loc, par.name)
    if radec is not None:
        ra, dec = radec
        posepoch = _parf(par, "POSEPOCH", pepoch) or pepoch
        acols, anames = astrometry_columns(t, ra, dec, posepoch)
        have = par.params
        pm_keys = ("PMRA", "PMDEC", "PMELONG", "PMELAT", "PMLAMBDA", "PMBETA")
        has_pm = any(k in have for k in pm_keys)
        keep = [
            i for i, nm in enumerate(anames)
            if nm in ("RAJ", "DECJ")
            or (nm in ("PMRA", "PMDEC") and has_pm)
            or (nm == "PX" and "PX" in have)
        ]
        cols += [acols[i] for i in keep]
        names += [anames[i] for i in keep]

    # every chromatic column family (DMX, DM, FD) needs more than one
    # observing frequency: on single-band data they all collapse to
    # constants collinear with OFFSET, and the rank-deficient solve
    # would persist arbitrary splits to the par (same degeneracy class
    # as an all-covering JUMP)
    multiband = (
        freqs_mhz is not None
        and np.unique(np.asarray(freqs_mhz)).size > 1
    )
    dmx = getattr(par, "dmx_windows", ()) if multiband else ()
    dmx_active = []
    if dmx:
        for label, _value, r1, r2 in dmx:
            col = dmx_column(t, freqs_mhz, r1, r2)
            # windows with no loaded TOAs contribute an all-zero column:
            # skip them (their values are unconstrained by this data)
            if float(np.sum(np.asarray(col) != 0.0)):
                cols.append(col)
                names.append(f"DMX_{label}")
                dmx_active.append(label)
    if multiband and "DM" in par.params and not dmx_active:
        # the global DM column is exactly the sum of all-covering DMX
        # columns — fitting both is rank-deficient, and the reference's
        # pars hold DM fixed when DMX is declared (no fit flag on DM,
        # fit flags on every DMX_xxxx) — so DM/DM1 columns only appear
        # on DMX-less models
        f = np.asarray(freqs_mhz)
        cols.append(1.0 / (K_DM * f**2))
        names.append("DM")
        if _parf(par, "DM1"):
            dmepoch = _parf(par, "DMEPOCH", pepoch) or pepoch
            cols.append(
                ((t - dmepoch) / YEAR_DAYS) / (K_DM * f**2)
            )
            names.append("DM1")

    if multiband:
        for k in range(1, len(getattr(par, "fd_terms", ())) + 1):
            cols.append(fd_column(freqs_mhz, k))
            names.append(f"FD{k}")

    # WAVE harmonic-whitening columns (tempo2/PINT model; also the
    # nuisance basis par.ensure_waves arms for absorbing smooth
    # unmodeled structure): d(delay)/d(WAVEk) = sin/cos(k om (t-epoch))
    wave_om = getattr(par, "wave_om", None)
    nwave = len(getattr(par, "waves", ()))
    if wave_om and nwave:
        wave_epoch = getattr(par, "wave_epoch", pepoch) or pepoch
        ph = wave_om * (np.asarray(t) - wave_epoch)
        for k in range(1, nwave + 1):
            cols.append(np.sin(k * ph))
            names.append(f"WAVE{k}_SIN")
            cols.append(np.cos(k * ph))
            names.append(f"WAVE{k}_COS")

    binary = BinaryModel.from_par(par)
    if binary is not None and binary.pb_days:
        bcols, bnames = binary_columns(binary, t)
        cols += bcols
        names += bnames

    # flag-matched JUMPs: the reference's PINT refit fits these on every
    # real NANOGrav fixture (JUMP -fe <receiver> lines); the column is
    # the indicator of the matching TOAs (d(delay)/d(JUMP) = 1 there)
    jumps = getattr(par, "jumps", ())
    if jumps and flags is not None:
        for k, (name, value, _offset) in enumerate(jumps):
            match = jump_mask(flags, name, value)
            # a jump covering none or ALL of the loaded TOAs is
            # degenerate (the all-ones case duplicates OFFSET — the fit
            # would split the mean arbitrarily and then persist that
            # arbitrary value to the par); skip it like PINT rejects
            # all-covering jumps. Names stay positional (JUMPk = k-th
            # par-file declaration) so write-back indexing is unaffected.
            if 0.0 < match.sum() < len(match):
                cols.append(np.asarray(match))
                names.append(f"JUMP{k + 1}")

    if isinstance(include, (list, tuple, set)):
        keep = [i for i, nm in enumerate(names) if nm in include or nm == "OFFSET"]
        cols = [cols[i] for i in keep]
        names = [names[i] for i in keep]

    return np.stack([np.asarray(c, dtype=M_spin.dtype) for c in cols], axis=-1), names
