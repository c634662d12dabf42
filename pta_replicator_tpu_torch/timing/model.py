"""Minimal standalone timing engine.

Counterpart of ``pta_replicator_tpu/timing/model.py``, a copy (the port
imports nothing of the JAX package): host numpy in longdouble and
float64, the same operations in the same order, so the same bits.

The reference delegates all timing-model physics to PINT
(pta_replicator/simulate.py:13-16,40-42); PINT is not a
dependency of this framework, so the pieces the simulation layer actually
relies on are implemented here directly:

* spin-down phase prediction (F0/F1/F2 Taylor expansion around PEPOCH),
* phase-wrapped, weighted-mean-subtracted timing residuals (the quantity
  PINT's ``Residuals.time_resids`` produces and ``make_ideal`` zeroes,
  pta_replicator/simulate.py:193-202),
* the residual fixed-point used by ``make_ideal``.

Approximation note (documented, deliberate): no barycentering chain (clock
corrections, Roemer/Shapiro/Einstein delays) is applied — this framework's
job is *synthesis*: datasets start from `make_ideal`'d (zero-residual) TOAs,
and every injected signal is tracked exactly by the provenance ledger, so
absolute pre-ideal residuals never enter any result. After ``make_ideal``
the phase-based residuals here agree with ledger-summed residuals to
O(F1/F0 * dt * Tspan) ~ 1e-12 s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import DAY_IN_SEC, MAS_TO_RAD
from ..io.par import ParModel


def weighted_mean(values: np.ndarray, errors_s: np.ndarray) -> float:
    """Error-weighted mean (weights 1/sigma^2), the constant PINT subtracts."""
    w = 1.0 / np.asarray(errors_s, dtype=np.float64) ** 2
    return float(np.sum(w * np.asarray(values, dtype=np.float64)) / np.sum(w))


@dataclass
class SpindownTiming:
    """Spin-down phase model phi(t) = F0 dt + F1 dt^2/2 + F2 dt^3/6."""

    f0: float
    f1: float = 0.0
    f2: float = 0.0
    pepoch_mjd: float = 0.0

    @classmethod
    def from_par(cls, par: ParModel) -> "SpindownTiming":
        return cls(f0=par.f0, f1=par.f1, f2=par.f2, pepoch_mjd=par.pepoch_mjd)

    def phase(self, mjd_ld: np.ndarray) -> np.ndarray:
        """Pulse phase (turns) at longdouble MJD epochs, longdouble precision."""
        dt = (np.asarray(mjd_ld, dtype=np.longdouble)
              - np.longdouble(self.pepoch_mjd)) * np.longdouble(DAY_IN_SEC)
        return (np.longdouble(self.f0) * dt
                + np.longdouble(self.f1) / 2 * dt * dt
                + np.longdouble(self.f2) / 6 * dt * dt * dt)

    def spin_frequency(self, mjd_ld: np.ndarray) -> np.ndarray:
        """Instantaneous spin frequency [Hz] (float64)."""
        dt = ((np.asarray(mjd_ld, dtype=np.longdouble)
               - np.longdouble(self.pepoch_mjd)) * DAY_IN_SEC).astype(np.float64)
        return self.f0 + self.f1 * dt + 0.5 * self.f2 * dt * dt


def phase_residuals(
    model,
    mjd_ld: np.ndarray,
    errors_s: np.ndarray,
    subtract_mean: bool = True,
    freqs_mhz: np.ndarray = None,
    flags=None,
    observatories=None,
) -> np.ndarray:
    """Phase-wrapped time residuals [s] of TOAs against a timing model.

    Fractional phase is wrapped to [-0.5, 0.5) turns and divided by the
    instantaneous spin frequency; the error-weighted mean is removed, as in
    PINT residuals consumed by the reference at
    pta_replicator/simulate.py:40-42.

    ``model`` is a :class:`SpindownTiming` or a :class:`TimingModel`; for
    the latter, the spin phase is evaluated in TDB at the delay-corrected
    emission time (binary/dispersion/astrometric/topocentric delays
    subtracted, with ``freqs_mhz`` feeding the dispersion term and
    ``observatories`` the Earth-rotation geometry). The bare
    :class:`SpindownTiming` path keeps raw epochs (no sky location, no
    delay model — absolute time-scale offsets cancel in make_ideal).
    """
    mjd = np.asarray(mjd_ld, dtype=np.longdouble)
    if hasattr(model, "delays_s"):
        from .time_scales import tdb_minus_utc

        t_utc = np.asarray(mjd_ld, dtype=np.float64)
        # phase is a TDB-side quantity (par UNITS TDB); the conversion is
        # applied in longdouble so the ~69 s offset does not cost epoch
        # precision
        off_s = tdb_minus_utc(t_utc)
        mjd = mjd + (off_s / DAY_IN_SEC).astype(np.longdouble)
        d = model.delays_s(t_utc, freqs_mhz=freqs_mhz, flags=flags,
                           observatories=observatories, tdb_offset_s=off_s)
        if d is not None:
            mjd = mjd - np.asarray(d, dtype=np.float64) / DAY_IN_SEC
    phase = model.phase(mjd)
    frac = phase - np.rint(phase)
    res = (frac / model.spin_frequency(mjd)).astype(np.float64)
    if subtract_mean:
        res = res - weighted_mean(res, errors_s)
    return res


@dataclass
class TimingModel:
    """Spin-down phase plus the physical delay components the reference
    gets from PINT (simulate.py:40-42): binary orbit, dispersion, and an
    approximate astrometric Roemer term (timing.components — see that
    module's accuracy stance: the column *shapes* are right; absolute
    barycentering is not ns-accurate without a numerical ephemeris).

    The pulse phase is the spin Taylor series evaluated at the
    delay-corrected emission time ``t - delays(t)``. ``make_ideal`` zeroes
    whatever this model predicts, so synthesis results depend only on the
    *differential* behavior (what a refit can absorb), which these
    components capture with the correct time/frequency dependence.
    """

    spin: SpindownTiming
    binary: object = None  # Optional[components.BinaryModel]
    dm: float = 0.0
    dm1: float = 0.0
    dmepoch_mjd: float = 0.0
    ra_rad: float = None
    dec_rad: float = None
    include_roemer: bool = True
    #: d(nhat)/dt [rad/yr] in the equatorial frame (proper motion); None
    #: when the par declares no PM. Mirrors astrometry_columns' PM
    #: columns so fitted PM values feed back into the forward model.
    pm_vec_rad_yr: tuple = None
    #: parallax [rad] (annual-curvature delay term, astrometry_columns)
    px_rad: float = 0.0
    posepoch_mjd: float = 0.0
    #: flag-matched JUMP offsets: ((flag_name, flag_value, offset_s), ...)
    #: — the reference's PINT model fits these on every real NANOGrav
    #: fixture (e.g. test_partim/par/B1855+09.par "JUMP -fe L-wide")
    jumps: tuple = ()
    #: FD profile-evolution coefficients (FD1.. [s]): delay =
    #: sum_k FDk * ln(f_GHz)^k
    fd: tuple = ()
    #: NANOGrav DMX dispersion windows: ((label, dmx, r1_mjd, r2_mjd), ...)
    dmx: tuple = ()
    #: tempo2/PINT WAVE harmonic-whitening model: fundamental [rad/day],
    #: reference epoch [MJD], ((A_sin, B_cos), ...) per harmonic [s]
    wave_om: float = 0.0
    wave_epoch_mjd: float = 0.0
    waves: tuple = ()
    #: solar-wind electron density at 1 AU [cm^-3] (par NE_SW; 0 = off)
    ne_sw: float = 0.0
    #: solar Shapiro delay (always on in tempo/PINT when a sky location
    #: exists; µs-scale, peaks at solar conjunction)
    include_solar_shapiro: bool = True

    # -- SpindownTiming-compatible surface (existing call sites)
    @property
    def f0(self):
        return self.spin.f0

    @property
    def f1(self):
        return self.spin.f1

    @property
    def f2(self):
        return self.spin.f2

    @property
    def pepoch_mjd(self):
        return self.spin.pepoch_mjd

    def phase(self, mjd_ld):
        return self.spin.phase(mjd_ld)

    def spin_frequency(self, mjd_ld):
        return self.spin.spin_frequency(mjd_ld)

    @classmethod
    def from_par(cls, par) -> "TimingModel":
        from ..ops.coords import (
            ecliptic_epoch,
            equatorial_to_ecliptic_tangent,
            pulsar_ra_dec,
        )
        from .components import BinaryModel, _parf

        ra = dec = None
        try:
            ra, dec = pulsar_ra_dec(par.loc, par.name)
        except AttributeError:  # no sky location in the par file
            pass
        # Proper motion / parallax: par values [mas/yr, mas] -> the
        # equatorial-frame quantities the delay evaluation uses (ecliptic
        # PM components rotate through the same local tangent-plane
        # rotation _apply_fit writes them back with)
        pm_vec = None
        px_rad = 0.0
        posepoch = 0.0
        if ra is not None:
            mas2rad = MAS_TO_RAD
            pm_star = None  # (mu_alpha*, mu_delta) [rad/yr]
            if "PMRA" in par.params or "PMDEC" in par.params:
                pm_star = np.array([
                    (_parf(par, "PMRA", 0.0) or 0.0),
                    (_parf(par, "PMDEC", 0.0) or 0.0),
                ]) * mas2rad
            elif any(
                k in par.params
                for k in ("PMELONG", "PMELAT", "PMLAMBDA", "PMBETA")
            ):
                pm_ecl = np.array([
                    (_parf(par, "PMELONG", None)
                     or _parf(par, "PMLAMBDA", 0.0) or 0.0),
                    (_parf(par, "PMELAT", None)
                     or _parf(par, "PMBETA", 0.0) or 0.0),
                ]) * mas2rad
                R = equatorial_to_ecliptic_tangent(
                    ra, dec, epoch=ecliptic_epoch(par.name)
                )
                pm_star = R.T @ pm_ecl  # orthonormal: inverse = transpose
            if pm_star is not None and np.any(pm_star):
                ca, sa = np.cos(ra), np.sin(ra)
                cd, sd = np.cos(dec), np.sin(dec)
                dn_da = np.array([-sa * cd, ca * cd, 0.0])
                dn_dd = np.array([-ca * sd, -sa * sd, cd])
                # mu_alpha* carries cos(dec); dn_da is d(nhat)/d(ra)
                # whose norm is cos(dec) — so dn/dt = mu_alpha*/cd * dn_da
                # + mu_delta * dn_dd
                v = pm_star[0] / cd * dn_da + pm_star[1] * dn_dd
                pm_vec = tuple(float(x) for x in v)
            px_rad = ((_parf(par, "PX", 0.0) or 0.0)) * mas2rad
            pepoch0 = par.pepoch_mjd or 0.0
            posepoch = _parf(par, "POSEPOCH", pepoch0) or pepoch0
        return cls(
            pm_vec_rad_yr=pm_vec,
            px_rad=px_rad,
            posepoch_mjd=posepoch,
            spin=SpindownTiming.from_par(par),
            binary=BinaryModel.from_par(par),
            dm=par.dm,
            dm1=_parf(par, "DM1", 0.0) or 0.0,
            dmepoch_mjd=_parf(par, "DMEPOCH", par.pepoch_mjd) or par.pepoch_mjd,
            ra_rad=ra,
            dec_rad=dec,
            jumps=tuple(tuple(j) for j in getattr(par, "jumps", ())),
            fd=tuple(getattr(par, "fd_terms", ())),
            dmx=tuple(tuple(w) for w in getattr(par, "dmx_windows", ())),
            wave_om=getattr(par, "wave_om", None) or 0.0,
            wave_epoch_mjd=getattr(par, "wave_epoch", 0.0) or 0.0,
            waves=tuple(tuple(w) for w in getattr(par, "waves", ())),
            ne_sw=_parf(par, "NE_SW", 0.0) or 0.0,
        )

    def delays_s(
        self, t_mjd: np.ndarray, freqs_mhz=None, flags=None,
        observatories=None, tdb_offset_s=None,
    ):
        """Total model delay [s] at the given (topocentric UTC) MJD epochs.

        ``flags``: per-TOA flag dicts (TOAData.flags) — required for the
        JUMP component to land on its flag-matched TOAs; without them
        jumps contribute nothing (they then cancel in make_ideal like
        every other absolute term).

        ``observatories``: per-TOA site codes (TOAData.observatories) —
        enables the topocentric Roemer term (Earth-rotation diurnal
        geometry, up to ~21 ms; time_scales.observatory_position_au).
        Unknown codes (fabricated 'AXIS' TOAs, barycentric '@') fall
        back to the geocenter.

        Time scales: epochs arrive as UTC (tim convention); orbital /
        dispersion-trend / DMX-window / Earth-orbit evaluation uses TDB
        (par convention, UNITS TDB) via time_scales.tdb_minus_utc, while
        the Earth-rotation angle uses UTC (~UT1).
        """
        from .components import AU_S, dispersion_delay, earth_position_au

        t = np.asarray(t_mjd, dtype=np.float64)
        if tdb_offset_s is None:  # phase_residuals precomputes and passes it
            from .time_scales import tdb_minus_utc

            tdb_offset_s = tdb_minus_utc(t)
        t_tdb = t + np.asarray(tdb_offset_s) / DAY_IN_SEC
        total = np.zeros_like(t)
        if self.jumps and flags is not None:
            from .components import jump_mask

            for name, value, offset in self.jumps:
                total = total + offset * jump_mask(flags, name, value)
        if self.binary is not None and self.binary.pb_days:
            total = total + self.binary.delay_s(t_tdb)
        if self.dm and freqs_mhz is not None:
            total = total + dispersion_delay(
                freqs_mhz, self.dm, dm1=self.dm1, t_mjd=t_tdb,
                dmepoch_mjd=self.dmepoch_mjd,
            )
        if self.dmx and freqs_mhz is not None:
            from .components import K_DM

            # windows are sorted and disjoint: one searchsorted pass
            # instead of n_windows full-array masks (147-325 on the real
            # fixtures, on the update_residuals hot path)
            starts = np.asarray([w[2] for w in self.dmx])
            ends = np.asarray([w[3] for w in self.dmx])
            vals = np.asarray([w[1] for w in self.dmx])
            idx = np.searchsorted(starts, t_tdb, side="right") - 1
            idx_c = np.clip(idx, 0, len(self.dmx) - 1)
            inside = (idx >= 0) & (t_tdb <= ends[idx_c])
            dmx_t = np.where(inside, vals[idx_c], 0.0)
            total = total + dmx_t / (K_DM * np.asarray(freqs_mhz) ** 2)
        if self.fd and freqs_mhz is not None:
            from .components import fd_column

            for k, coeff in enumerate(self.fd, start=1):
                total = total + coeff * fd_column(freqs_mhz, k)
        if self.waves and self.wave_om:
            # tempo2/PINT WAVE harmonic-whitening: sum_k A_k sin(k om
            # (t - epoch)) + B_k cos(...) [s]
            ph = self.wave_om * (t_tdb - self.wave_epoch_mjd)
            for k, (a, b) in enumerate(self.waves, start=1):
                if a or b:
                    total = total + a * np.sin(k * ph) + b * np.cos(k * ph)
        if self.include_roemer and self.ra_rad is not None:
            from .components import YEAR_DAYS

            r = earth_position_au(t_tdb)
            if observatories is not None:
                from .time_scales import observatory_position_au

                r = r + observatory_position_au(t, observatories)
            ca, sa = np.cos(self.ra_rad), np.sin(self.ra_rad)
            cd, sd = np.cos(self.dec_rad), np.sin(self.dec_rad)
            nhat = np.array([ca * cd, sa * cd, sd])
            rsq = np.sum(r * r, axis=-1)
            rn0 = r @ nhat  # shared by Roemer, parallax, and solar terms
            rn = rn0
            if self.pm_vec_rad_yr is not None:
                tau = (t_tdb - self.posepoch_mjd) / YEAR_DAYS
                rn = rn0 + (r @ np.asarray(self.pm_vec_rad_yr)) * tau
            total = total - rn * AU_S
            if self.px_rad:
                # annual-curvature parallax term (astrometry_columns'
                # PX column times the par value)
                total = total + self.px_rad * 0.5 * (
                    rsq - rn0**2
                ) * AU_S
            rmag = np.sqrt(rsq)
            # both solar terms need the heliocentric geometry: r from
            # earth_position_au is Sun->Earth (see its docstring — NOT
            # the SSB; the distinction is load-bearing near conjunction)
            if self.include_solar_shapiro:
                from .components import TSUN_S

                # solar Shapiro: -2 Tsun ln(|r| + r.nhat) [r in AU; the
                # log's unit constant is an absolute offset, absorbed].
                # Diverges toward solar conjunction (rn -> -|r|); the
                # floor caps it at the Sun's limb scale (~5e-3 AU)
                total = total - 2.0 * TSUN_S * np.log(
                    np.maximum(rmag + rn0, 5e-3)
                )
            if self.ne_sw and freqs_mhz is not None:
                from ..constants import AU_PC
                from .components import K_DM

                # solar-wind dispersion, n_e(r) = NE_SW (AU/r)^2:
                # DM = NE_SW * AU_pc * (pi - psi)/(|r| sin psi), psi the
                # Sun-Earth-pulsar elongation (tempo2/PINT closed form).
                # The divergence floor is the same solar-limb impact
                # parameter (~5e-3 AU) the Shapiro term uses — a smaller
                # floor would let a LOS through the Sun's disk inject an
                # unphysical ~0.3 s spike
                cpsi = np.clip(-rn0 / np.maximum(rmag, 1e-9), -1.0, 1.0)
                psi = np.arccos(cpsi)
                dm_sw = (
                    self.ne_sw * AU_PC * (np.pi - psi)
                    / (np.maximum(rmag * np.sin(psi), 5e-3))
                )
                total = total + dm_sw / (K_DM * np.asarray(freqs_mhz) ** 2)
        return total if total.any() else None
