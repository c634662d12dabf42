"""Pulsar state container and dataset lifecycle, on the host.

Counterpart of ``pta_replicator_tpu/simulate.py`` (the port imports
nothing of the JAX package): :class:`SimulatedPulsar` with its provenance
ledger and ``inject``, the per-pulsar oracle's refit
(``SimulatedPulsar.fit``, WLS or GLS over the full timing design, its
step damped on the fit's own objective, the fitted values and their
errors written back to the par) and ``to_enterprise``; ``simulate_pulsar``,
``load_pulsar``, ``load_from_directories`` (a thread pool, in a
deterministic order), ``make_ideal`` and ``write_partim``. The reference's
flow (pta_replicator/simulate.py:23-202, with PINT replaced by the
framework's own IO and timing engine): datasets are loaded (or fabricated)
and idealized here once, in numpy with longdouble epochs; the ``add_*``
operators of ``models/`` mutate them on the host, or ``batch.freeze``
turns them into the padded tensors that run on the card.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .constants import DAY_IN_SEC, RAD_TO_MAS
from .io.par import ParModel, read_par
from .obs import TRACER, counter, span, traced
from .io.tim import TOAData, fabricate_toas, read_tim, write_tim
from .timing.fit import design_matrix, gls_fit, wls_fit
from .timing.model import SpindownTiming, TimingModel, phase_residuals


class Residuals:
    """Timing residuals of a TOA set against the timing model.

    Mirrors the slice of PINT's ``Residuals`` the reference consumes:
    ``time_resids`` / ``resids_value`` are phase-wrapped, weighted-mean
    subtracted residuals in seconds.
    """

    def __init__(self, toas: TOAData, model):
        self.time_resids = phase_residuals(
            model, toas.mjd, toas.errors_s, freqs_mhz=toas.freqs_mhz,
            flags=toas.flags, observatories=toas.observatories,
        )

    @property
    def resids_value(self) -> np.ndarray:
        return self.time_resids


@dataclass
class SimulatedPulsar:
    """Holds one simulated pulsar: model, TOAs, residuals, provenance ledger.

    Reference analog: pta_replicator/simulate.py:23-95.
    """

    ephem: str = "DE440"
    par: ParModel = None
    model: SpindownTiming = None
    toas: TOAData = None
    residuals: Residuals = None
    name: str = None
    loc: dict = None
    added_signals: Optional[dict] = None
    added_signals_time: Optional[dict] = None

    def __repr__(self) -> str:
        return f"SimulatedPulsar({self.name})"

    def update_residuals(self) -> None:
        self.residuals = Residuals(self.toas, self.model)

    def update_added_signals(self, signal_name: str, param_dict: dict, dt=None) -> str:
        """Record an injected signal in the provenance ledger.

        ``added_signals`` maps signal name -> parameter dict;
        ``added_signals_time`` maps signal name -> per-TOA delay vector [s],
        enabling exact decomposition of total residuals by cause (a
        first-class feature of the reference, simulate.py:79-89).

        Repeated injections under the same name are disambiguated
        deterministically (``name`` -> ``name_2``, ``name_3``, ...) and the
        original name is recorded in the entry's parameter dict under
        ``disambiguated_from``, so injecting a signal twice keeps both
        delay vectors instead of colliding (two CW sources, or noise
        re-draws in sensitivity sweeps, are legitimate repeat injections).
        Returns the ledger name actually used.
        """
        if self.added_signals is None:
            raise ValueError(
                "make_ideal() must be called on SimulatedPulsar before adding new signals."
            )
        name = signal_name
        if name in self.added_signals:
            k = 2
            while f"{signal_name}_{k}" in self.added_signals:
                k += 1
            name = f"{signal_name}_{k}"
            param_dict = dict(param_dict, disambiguated_from=signal_name)
            counter("simulate.ledger_disambiguated").inc()
        self.added_signals[name] = param_dict
        if dt is not None:
            self.added_signals_time[name] = np.asarray(dt, dtype=np.float64)
        return name

    def inject(self, signal_name: str, param_dict: dict, dt_s: np.ndarray) -> str:
        """Ledger -> adjust TOAs -> re-residualize: the invariant operator
        contract shared by every injection (11 call sites in the reference).
        Returns the (possibly disambiguated) ledger name used."""
        name = self.update_added_signals(signal_name, param_dict, dt_s)
        self.toas.adjust_seconds(dt_s)
        self.update_residuals()
        return name

    @traced("oracle_fit")
    def fit(
        self,
        fitter: str = "auto",
        nspin: int = 2,
        cov: np.ndarray = None,
        params="full",
        recipe=None,
        psr_index: int = None,
        backend_names=None,
        niter: int = 1,
        max_step_halvings: int = 8,
    ) -> None:
        """Refit the timing model post-injection (WLS or GLS).

        For GLS, either pass ``cov`` directly or pass the ``recipe`` the
        dataset was synthesized with (plus ``psr_index``/``backend_names``
        when its tables are per-pulsar/per-backend) and the exact noise
        covariance is assembled via
        :func:`~.timing.fit.covariance_from_recipe` (the port's ``Recipe``,
        its tensors on any device).

        Reference analog: simulate.py:44-69, where PINT's fitters solve
        over the *full* model design matrix. Here ``params`` selects the
        column set: ``'full'`` (default — spin plus every astrometry /
        DM / binary parameter the par file declares, via
        timing.components.full_design_matrix), ``'spin'`` (the spin-only
        fit), or an explicit list of column names. 'wls'/'auto' run
        weighted least squares; 'gls'/'downhill' run generalized least
        squares with covariance ``cov`` (defaults to diag(errors^2);
        build realistic covariances with timing.fit.noise_covariance /
        covariance_from_recipe). PINT-specific fitter kwargs of the
        reference (e.g. max_chi2_increase) have no analog and are
        deliberately not accepted, so ported calls fail loudly instead of
        silently no-oping.

        Fitted parameter corrections are applied to the model *and*
        written back to the par representation, so ``write_partim``
        persists the fitted model (reference simulate.py:71-77).
        """
        if fitter not in ("wls", "gls", "downhill", "auto"):
            raise ValueError(f"fitter={fitter!r} must be one of 'wls', 'gls', 'downhill' or 'auto'")
        import copy

        from .timing.components import full_design_matrix

        if cov is None and recipe is not None and fitter not in ("wls", "auto"):
            from .timing.fit import covariance_from_recipe

            cov = covariance_from_recipe(
                self, recipe, psr_index=psr_index,
                backend_names=backend_names,
            )

        # step-acceptance objective: white chi^2 for WLS; the GLS
        # quadratic form r^T C^-1 r when a covariance is in play (gating
        # a GLS step on the white chi^2 can reject legitimate steps that
        # absorb correlated power — PINT's downhill GLS gates on the GLS
        # objective). The Cholesky factor is computed once per fit call.
        _gls_factor = None
        if cov is not None:
            from scipy.linalg import cho_factor

            _gls_factor = cho_factor(cov)

        def _chi2() -> float:
            r = self.residuals.time_resids
            if _gls_factor is not None:
                from scipy.linalg import cho_solve

                return float(r @ cho_solve(_gls_factor, r))
            return float(np.sum((r / self.toas.errors_s) ** 2))

        for _ in range(max(1, niter)):
            self.update_residuals()
            res = self.residuals.time_resids
            mjds = self.toas.get_mjds()
            if params == "spin" or self.par is None:
                toas_s = ((mjds - self.model.pepoch_mjd) * DAY_IN_SEC).astype(np.float64)
                M = design_matrix(toas_s, self.model.f0, nspin=nspin)
                names = ["OFFSET"] + [f"F{k}" for k in range(nspin)]
            else:
                include = "auto" if params == "full" else params
                M, names = full_design_matrix(
                    self.par, mjds, freqs_mhz=self.toas.freqs_mhz,
                    f0=self.model.f0, nspin=nspin, include=include,
                    flags=self.toas.flags,
                )
            if fitter in ("wls", "auto"):
                if recipe is not None or cov is not None:
                    raise ValueError(
                        "recipe/cov describe a GLS noise covariance; pass "
                        "fitter='gls' (a WLS fit would silently ignore them)"
                    )
                p, post, pcov = wls_fit(
                    res, self.toas.errors_s, M, return_cov=True
                )
            else:
                C = cov if cov is not None else np.diag(self.toas.errors_s**2)
                p, post, pcov = gls_fit(res, C, M, return_cov=True)
            p = np.asarray(p, dtype=np.float64)
            updates = dict(zip(names, p))

            # Damped Newton: the solve is exact for the *linearized*
            # model, but one full step from a large pre-fit offset can
            # overshoot on nonlinear parameters (binary, astrometry) and
            # *increase* chi^2 — PINT's downhill fitters guard the same
            # way. Halve the step until chi^2 does not get worse; the
            # last allowed halving is applied unconditionally, so a step
            # (at SOME scale) is always applied and fit_results always
            # reflects what was actually written to par/model.
            chi2_before = _chi2()
            saved = (
                copy.deepcopy(self.par),
                copy.deepcopy(self.model),
                copy.deepcopy(self.loc),
            )
            scale = 1.0
            for halving in range(max(0, max_step_halvings) + 1):
                scale = 0.5 ** halving
                self._apply_fit(
                    {k: v * scale for k, v in updates.items()}
                )
                self.update_residuals()
                if _chi2() <= chi2_before or halving == max(
                    0, max_step_halvings
                ):
                    break
                # full rollback: _apply_fit mutates par, model AND (for
                # ecliptic pars) self.loc — restoring only par/model
                # would make the next scaled attempt start from the
                # rejected step's sky position
                self.par, self.model, self.loc = (
                    copy.deepcopy(saved[0]),
                    copy.deepcopy(saved[1]),
                    copy.deepcopy(saved[2]),
                )
            self.fit_results = {k: v * scale for k, v in updates.items()}
        # 1-sigma parameter uncertainties from the final linearization's
        # (M^T C^-1 M)^-1 diagonal — what PINT's fitters report and
        # write_partim persists via the par error columns (reference
        # simulate.py:44-77). Internal units (rad, rad/yr, Hz, ...),
        # matching fit_results; the step-damping scale does NOT apply
        # (the covariance describes the solution, not the step taken).
        pcov = np.asarray(pcov, dtype=np.float64)
        sig = np.sqrt(np.clip(np.diag(pcov), 0.0, None))
        self.fit_uncertainties = dict(zip(names, sig))
        self._write_par_errors(self.fit_uncertainties, names=names,
                               pcov=pcov)
        self.update_residuals()

    def _write_par_errors(self, sigmas: dict, names=None,
                          pcov=None) -> None:
        """Persist 1-sigma fit uncertainties into the par's error columns,
        converting from the fit's internal units to each key's par-file
        display units with the SAME conversion rules _apply_fit uses for
        the values (a unit mismatch between value and error columns would
        silently corrupt downstream noise analyses).

        ``names``/``pcov`` (column labels + full parameter covariance)
        feed the ecliptic frame rotation its RAJ-DECJ / PMRA-PMDEC cross
        terms — diag(R Sigma R^T) needs them whenever the equatorial
        estimates are correlated (sparse/uneven sampling); without them
        the rotated sigmas can be tens of percent off. Only the OUTPUT
        ecliptic cross-correlation is dropped (par error columns are
        per-parameter).

        OFFSET (the phase nuisance) and WAVE harmonics are skipped — par
        files have no error column for either.
        """
        par = self.par
        if par is None or not sigmas:
            return
        rad2mas = RAD_TO_MAS

        def cross(k1: str, k2: str) -> float:
            if pcov is None or names is None:
                return 0.0
            try:
                return float(pcov[names.index(k1), names.index(k2)])
            except ValueError:  # column not fitted
                return 0.0

        for k in ("F0", "F1", "F2"):
            if k in sigmas:
                par.set_param_error(k, sigmas[k])

        ecliptic_par = (
            par.raj_hours is None
            and getattr(par, "elong_deg", None) is not None
        )
        if not ecliptic_par:
            if "RAJ" in sigmas and par.raj_hours is not None:
                # par displays RAJ sexagesimally; its error column is in
                # seconds of right ascension (rad -> hours -> seconds)
                par.set_param_error(
                    "RAJ", sigmas["RAJ"] * (12.0 / np.pi) * 3600.0
                )
            if "DECJ" in sigmas and par.decj_deg is not None:
                par.set_param_error(
                    "DECJ", np.degrees(sigmas["DECJ"]) * 3600.0
                )  # arcsec
            cosd = (
                np.cos(np.deg2rad(par.decj_deg))
                if par.decj_deg is not None else 1.0
            )
            if "PMRA" in sigmas:
                par.set_param_error("PMRA", sigmas["PMRA"] * cosd * rad2mas)
            if "PMDEC" in sigmas:
                par.set_param_error("PMDEC", sigmas["PMDEC"] * rad2mas)
        elif any(k in sigmas for k in ("RAJ", "DECJ", "PMRA", "PMDEC")):
            # Ecliptic par: rotate the tangent-plane variances into the
            # ecliptic basis (diagonal of R diag(var) R^T — correlations
            # are dropped, as par error columns are per-parameter)
            from .ops.coords import (
                ecliptic_epoch,
                equatorial_to_ecliptic_tangent,
                pulsar_ra_dec,
            )

            epoch = ecliptic_epoch(self.name)
            ra, dec = pulsar_ra_dec(self.loc, self.name or "")
            R = equatorial_to_ecliptic_tangent(ra, dec, epoch=epoch)
            cosd = np.cos(dec)
            elat = np.deg2rad(par.elat_deg or 0.0)

            def rotated_sigmas(k1: str, k2: str) -> np.ndarray:
                """sqrt(diag(R Sigma* R^T)) for the starred tangent pair
                (k1* = k1 cos(dec), k2), incl. the cross term."""
                s1 = sigmas.get(k1, 0.0) * cosd
                s2 = sigmas.get(k2, 0.0)
                c12 = cross(k1, k2) * cosd
                Sig = np.array([[s1**2, c12], [c12, s2**2]])
                return np.sqrt(
                    np.clip(np.diag(R @ Sig @ R.T), 0.0, None)
                )

            if "RAJ" in sigmas or "DECJ" in sigmas:
                s_lonstar, s_lat = rotated_sigmas("RAJ", "DECJ")
                # ELONG's error column is in degrees of plain longitude
                par.set_param_error(
                    "ELONG", np.degrees(s_lonstar / np.cos(elat))
                )
                par.set_param_error("ELAT", np.degrees(s_lat))
            if "PMRA" in sigmas or "PMDEC" in sigmas:
                s_pmlon, s_pmlat = rotated_sigmas("PMRA", "PMDEC") * rad2mas
                pm_lon_key = (
                    "PMELONG" if "PMELONG" in par.params else "PMLAMBDA"
                )
                pm_lat_key = (
                    "PMELAT" if "PMELAT" in par.params else "PMBETA"
                )
                if pm_lon_key in par.params:
                    par.set_param_error(pm_lon_key, s_pmlon)
                if pm_lat_key in par.params:
                    par.set_param_error(pm_lat_key, s_pmlat)

        if "PX" in sigmas:
            par.set_param_error("PX", sigmas["PX"] * rad2mas)
        for k in ("DM", "DM1"):
            if k in sigmas:
                par.set_param_error(k, sigmas[k])
        for k in range(1, len(par.fd_terms) + 1):
            if f"FD{k}" in sigmas:
                par.set_param_error(f"FD{k}", sigmas[f"FD{k}"])
        for label, _v, _r1, _r2 in par.dmx_windows:
            nm = f"DMX_{label}"
            if nm in sigmas:
                par.set_param_error(nm, sigmas[nm])
        for k in range(len(par.jumps)):
            nm = f"JUMP{k + 1}"
            if nm in sigmas:
                par.set_jump_error(k, sigmas[nm])
        from .timing.components import BinaryModel

        binary = BinaryModel.from_par(par)
        if binary is not None:
            for nm in binary.fit_param_names():
                if nm in sigmas:
                    par.set_param_error(nm, sigmas[nm])

    def _apply_fit(self, updates: dict) -> None:
        """Apply fitted parameter corrections to the model and par file.

        Sign conventions: spin columns are ``t^k/(k! F0)`` — the solved
        coefficient is the amount the *model* frequency exceeds the data,
        so spin params are decremented. Delay
        -parameter columns are ``d(delay)/d(param)`` and residuals are
        ``+ (true - model) * d(delay)/d(param)``, so those params are
        incremented.
        """
        spin = self.model.spin if isinstance(self.model, TimingModel) else self.model
        new_spin = SpindownTiming(
            f0=spin.f0 - updates.get("F0", 0.0),
            f1=spin.f1 - updates.get("F1", 0.0),
            f2=spin.f2 - updates.get("F2", 0.0),
            pepoch_mjd=spin.pepoch_mjd,
        )
        par = self.par
        if par is not None:
            par.set_param("F0", new_spin.f0)
            if "F1" in updates:
                par.set_param("F1", new_spin.f1)
            if "F2" in updates:
                par.set_param("F2", new_spin.f2)

            rad2mas = RAD_TO_MAS
            ecliptic_par = (
                par.raj_hours is None
                and getattr(par, "elong_deg", None) is not None
            )
            if not ecliptic_par:
                if "RAJ" in updates and par.raj_hours is not None:
                    par.set_param(
                        "RAJ", par.raj_hours + updates["RAJ"] * 12.0 / np.pi
                    )
                if "DECJ" in updates and par.decj_deg is not None:
                    par.set_param(
                        "DECJ", par.decj_deg + np.degrees(updates["DECJ"])
                    )
                cosd = (
                    np.cos(np.deg2rad(par.decj_deg))
                    if par.decj_deg is not None else 1.0
                )
                if "PMRA" in updates:
                    from .timing.components import _parf

                    par.set_param(
                        "PMRA", (_parf(par, "PMRA", 0.0) or 0.0)
                        + updates["PMRA"] * cosd * rad2mas
                    )
                if "PMDEC" in updates:
                    from .timing.components import _parf

                    par.set_param(
                        "PMDEC", (_parf(par, "PMDEC", 0.0) or 0.0)
                        + updates["PMDEC"] * rad2mas
                    )
            elif any(k in updates for k in ("RAJ", "DECJ", "PMRA", "PMDEC")):
                # Ecliptic par (every real NANOGrav fixture): the design
                # matrix reports tangent-plane columns under equatorial
                # names (timing/components.py full_design_matrix); write
                # the updates back in the frame the par actually uses —
                # position via the exact inverse conversion, proper
                # motion via the local tangent-plane rotation.
                from .ops.coords import (
                    ecliptic_epoch,
                    equatorial_to_ecliptic,
                    equatorial_to_ecliptic_tangent,
                    pulsar_ra_dec,
                )
                from .timing.components import _parf

                epoch = ecliptic_epoch(self.name)
                ra, dec = pulsar_ra_dec(self.loc, self.name or "")
                if "RAJ" in updates or "DECJ" in updates:
                    lon, lat = equatorial_to_ecliptic(
                        ra + updates.get("RAJ", 0.0),
                        dec + updates.get("DECJ", 0.0),
                        epoch=epoch,
                    )
                    par.set_param("ELONG", lon)
                    par.set_param("ELAT", lat)
                    self.loc = {"ELONG": lon, "ELAT": lat}
                if "PMRA" in updates or "PMDEC" in updates:
                    R = equatorial_to_ecliptic_tangent(ra, dec, epoch=epoch)
                    cosd = np.cos(dec)
                    dstar = np.array([
                        updates.get("PMRA", 0.0) * cosd,
                        updates.get("PMDEC", 0.0),
                    ]) * rad2mas
                    dlon, dlat = R @ dstar
                    pm_lon_key = (
                        "PMELONG" if "PMELONG" in par.params else "PMLAMBDA"
                    )
                    pm_lat_key = (
                        "PMELAT" if "PMELAT" in par.params else "PMBETA"
                    )
                    par.set_param(
                        pm_lon_key,
                        (_parf(par, pm_lon_key, 0.0) or 0.0) + dlon,
                    )
                    par.set_param(
                        pm_lat_key,
                        (_parf(par, pm_lat_key, 0.0) or 0.0) + dlat,
                    )
            if "PX" in updates:
                from .timing.components import _parf

                par.set_param(
                    "PX", (_parf(par, "PX", 0.0) or 0.0)
                    + updates["PX"] * rad2mas
                )
            if "DM" in updates:
                par.set_param("DM", par.dm + updates["DM"])
            if "DM1" in updates:
                from .timing.components import _parf

                par.set_param("DM1", (_parf(par, "DM1", 0.0) or 0.0) + updates["DM1"])
            # FD and DMX columns: plain single-key params, += convention
            for k, value in enumerate(par.fd_terms, start=1):
                if f"FD{k}" in updates:
                    par.set_param(f"FD{k}", value + updates[f"FD{k}"])
            for label, value, _r1, _r2 in par.dmx_windows:
                nm = f"DMX_{label}"
                if nm in updates:
                    par.set_param(nm, value + updates[nm])
            # flag-matched JUMP columns (indicator derivative, += like
            # every delay parameter); multi-line JUMPs edit by position
            for k, (_name, _val, offset) in enumerate(par.jumps):
                nm = f"JUMP{k + 1}"
                if nm in updates:
                    par.set_jump(k, offset + updates[nm])
            # WAVE harmonic amplitudes: two values per par line
            waves = par.waves
            for k, (a, b) in enumerate(waves):
                da = updates.get(f"WAVE{k + 1}_SIN", 0.0)
                db = updates.get(f"WAVE{k + 1}_COS", 0.0)
                if da or db:
                    par.set_wave(k, a + da, b + db)
            # binary parameters: numerical-derivative columns, += convention
            from .timing.components import BinaryModel

            binary = BinaryModel.from_par(par)
            if binary is not None:
                # physical-domain clamps: one linear Newton step from a
                # large pre-fit offset can overshoot (e.g. SINI past 1,
                # which NaNs the Shapiro log on the next evaluation);
                # later iterations re-solve from the clamped point
                bounds = {
                    "SINI": (-1.0 + 1e-9, 1.0 - 1e-9),
                    "ECC": (0.0, 1.0 - 1e-9),
                    "M2": (0.0, np.inf),
                }
                for nm in binary.fit_param_names():
                    if nm in updates:
                        new = binary.get(nm) + updates[nm]
                        lo, hi = bounds.get(nm, (-np.inf, np.inf))
                        par.set_param(nm, min(max(new, lo), hi))
            # rebuild the full model from the updated par (keeps binary/
            # DM/astrometry in sync with what write_partim persists)
            self.model = TimingModel.from_par(par)
            self.model.spin = new_spin
        else:
            self.model = new_spin

    def write_partim(
        self,
        outpar: str,
        outtim: str,
        tempo2: bool = False,
        reuse_static_tim_parts: bool = False,
    ) -> None:
        """Persist the mutated dataset (reference analog simulate.py:71-77).

        ``tempo2`` is accepted for reference API compatibility; this
        framework's tim writer always emits Tempo2 ``FORMAT 1``, which both
        PINT and Tempo2 read. ``reuse_static_tim_parts`` opts into the tim
        writer's epoch-invariant line cache (materialization sweeps —
        see io.tim.write_tim).
        """
        self.par.write(outpar)
        write_tim(self.toas, outtim, reuse_static_parts=reuse_static_tim_parts)

    def to_arrays(self):
        """Export (mjd_f64, residuals_s, errors_s, loc) for downstream
        analysis packages. The reference's ``to_enterprise``
        (simulate.py:91-95) requires `enterprise`, which is optional here."""
        return (
            self.toas.get_mjds(),
            self.residuals.resids_value.copy(),
            self.toas.errors_s.copy(),
            dict(self.loc),
        )

    def to_enterprise(
        self,
        ephem: str = "DE440",
        timing_package: str = "pint",
        tmpdir: str = None,
        **kwargs,
    ):
        """Convert to an ``enterprise.pulsar.Pulsar`` for downstream PTA
        analysis (reference analog simulate.py:91-95).

        ``enterprise`` is an *optional* dependency (it is not required by
        this standalone framework): when importable, the conversion
        round-trips through a freshly written par/tim pair — the same
        dataset ``write_partim`` persists, which is byte-equivalent to
        what the reference's mutated TOAs represent — and hands it to
        enterprise's loader (``timing_package='pint'`` to match the
        reference, or ``'tempo2'``/libstempo). When enterprise is absent,
        raises ImportError naming the manual equivalent. Extra ``kwargs``
        forward to ``enterprise.pulsar.Pulsar``.
        """
        try:
            from enterprise.pulsar import Pulsar
        except ImportError as exc:
            raise ImportError(
                "to_enterprise needs the optional 'enterprise-pulsar' "
                "package (with its PINT or libstempo backend). Manual "
                "equivalent: psr.write_partim(par, tim); "
                "enterprise.pulsar.Pulsar(par, tim)."
            ) from exc

        import os
        import tempfile

        with tempfile.TemporaryDirectory(dir=tmpdir) as d:
            parfile = os.path.join(d, f"{self.name or 'pulsar'}.par")
            timfile = os.path.join(d, f"{self.name or 'pulsar'}.tim")
            self.write_partim(parfile, timfile)
            return Pulsar(
                parfile,
                timfile,
                ephem=ephem,
                timing_package=timing_package,
                **kwargs,
            )


def _locate(par: ParModel) -> dict:
    return par.loc


def simulate_pulsar(
    parfile: str,
    obstimes,
    toaerr,
    freq: float = 1440.0,
    observatory: str = "AXIS",
    flags: dict = None,
    ephem: str = "DE440",
) -> SimulatedPulsar:
    """Create a SimulatedPulsar from a par file and fabricated TOAs.

    Reference analog: simulate.py:98-135 (obstimes in MJD, toaerr in us).
    """
    if not os.path.isfile(parfile):
        raise FileNotFoundError(f"par file does not exist: {parfile}")
    par = read_par(parfile)
    model = TimingModel.from_par(par)
    toas = fabricate_toas(obstimes, toaerr, freq_mhz=freq, observatory=observatory, flags=flags)
    psr = SimulatedPulsar(
        ephem=ephem, par=par, model=model, toas=toas, name=par.name, loc=_locate(par)
    )
    psr.update_residuals()
    return psr


def load_pulsar(parfile: str, timfile: str, ephem: str = "DE440") -> SimulatedPulsar:
    """Load a SimulatedPulsar from par and tim files (reference simulate.py:138-167)."""
    if not os.path.isfile(parfile):
        raise FileNotFoundError(f"par file does not exist: {parfile}")
    if not os.path.isfile(timfile):
        raise FileNotFoundError(f"tim file does not exist: {timfile}")
    par = read_par(parfile)
    model = TimingModel.from_par(par)
    toas = read_tim(timfile)
    psr = SimulatedPulsar(
        ephem=ephem, par=par, model=model, toas=toas, name=par.name, loc=_locate(par)
    )
    psr.update_residuals()
    return psr


def load_from_directories(
    pardir: str,
    timdir: str,
    ephem: str = "DE440",
    num_psrs: int = None,
    debug: bool = False,
    workers: int = None,
) -> list:
    """Load a pulsar array from directories of par and tim files.

    Reference analog: simulate.py:170-190 (".t2" par variants filtered
    out, sorted par/tim lists zipped pairwise) — but where the
    reference's 68-pulsar cold start is a serial PINT loop (its ingest
    hot path, SURVEY.md section 3.1), this loads pulsars concurrently:
    the native tim tokenizer releases the GIL during the C call, so a
    thread pool overlaps file scans. ``workers``: thread count (default
    min(8, n_pulsars); 1 = serial). Order is deterministic either way.
    """
    if not os.path.isdir(pardir):
        raise FileNotFoundError(f"par directory does not exist: {pardir}")
    if not os.path.isdir(timdir):
        raise FileNotFoundError(f"tim directory does not exist: {timdir}")
    pars = [p for p in sorted(glob.glob(os.path.join(pardir, "*.par"))) if ".t2" not in p]
    tims = sorted(glob.glob(os.path.join(timdir, "*.tim")))
    pairs = list(zip(pars, tims))
    if num_psrs:
        pairs = pairs[:num_psrs]

    def load_one(pt):
        # per-pair announcement so a load failure is attributable to the
        # file it came from (the point of the debug flag)
        if debug:
            print(f"loading par={pt[0]}, tim={pt[1]}", flush=True)
        return load_pulsar(pt[0], pt[1], ephem=ephem)

    if workers is None:
        workers = min(8, len(pairs)) or 1
    with span("load_pulsars", npsr=len(pairs), workers=workers):
        counter("simulate.pulsars_loaded").inc(len(pairs))
        if workers <= 1 or len(pairs) <= 1:
            return [load_one(pt) for pt in pairs]

        from concurrent.futures import ThreadPoolExecutor

        # span nesting is thread-local: the pool's workers take the
        # load_pulsars ancestry, so their read_par/read_tim spans nest
        # under it
        parent = TRACER.current_stack()

        def load_nested(pt):
            with TRACER.inherit(parent):
                return load_one(pt)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(load_nested, pairs))


def make_ideal(psr: SimulatedPulsar, iterations: int = 2) -> None:
    """Zero the residuals by absorbing them into the TOAs, then initialize
    the provenance ledger (reference analog simulate.py:193-202)."""
    with span("make_ideal", psr=psr.name, iterations=iterations):
        for _ in range(iterations):
            res = phase_residuals(
                psr.model, psr.toas.mjd, psr.toas.errors_s,
                freqs_mhz=psr.toas.freqs_mhz, flags=psr.toas.flags,
                observatories=psr.toas.observatories,
            )
            psr.toas.adjust_seconds(-res)
        psr.added_signals = {}
        psr.added_signals_time = {}
        psr.update_residuals()
