"""Pulsar state container and dataset lifecycle, on the host.

Counterpart of ``pta_replicator_tpu/simulate.py``'s loader and writer (the
port imports nothing of the JAX package): :class:`SimulatedPulsar` with
its provenance ledger and ``inject``, ``simulate_pulsar``, ``load_pulsar``,
``load_from_directories`` (a thread pool, in a deterministic order),
``make_ideal`` and ``write_partim``. The reference's flow (pta_replicator/
simulate.py:23-202, with PINT replaced by the framework's own IO and
timing engine): datasets are loaded (or fabricated) and idealized here
once, in numpy with longdouble epochs, then frozen by ``batch.freeze``
into the padded tensors that run on the card. The numpy oracle's refit
(``SimulatedPulsar.fit``) and ``to_enterprise`` wait for ROADMAP A.18.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .io.par import ParModel, read_par
from .io.tim import TOAData, fabricate_toas, read_tim, write_tim
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

    def fit(self, *args, **kwargs) -> None:
        """The numpy oracle's post-injection refit (the JAX package's
        ``SimulatedPulsar.fit``) is not ported yet: it waits for ROADMAP
        A.18, with the oracle noise covariance. The batched refit of the
        card runs through ``realize(..., fit=True)`` with a
        ``Recipe.fit_design`` from :func:`~.timing.fit.design_tensor`."""
        raise NotImplementedError(
            "SimulatedPulsar.fit (the numpy oracle's refit) is not ported yet: "
            "ROADMAP A.18. Refit on the card with realize(..., fit=True) and "
            "Recipe(fit_design=design_tensor(psrs)[0])"
        )

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

    def to_enterprise(self, *args, **kwargs):
        """Conversion to an ``enterprise.pulsar.Pulsar`` (the JAX package's
        ``to_enterprise``) is not ported yet: ROADMAP A.18. Its manual
        equivalent works: ``psr.write_partim(par, tim)``, then
        ``enterprise.pulsar.Pulsar(par, tim)``."""
        raise NotImplementedError(
            "SimulatedPulsar.to_enterprise is not ported yet (ROADMAP A.18); "
            "write the dataset with psr.write_partim(par, tim) and load it "
            "with enterprise.pulsar.Pulsar(par, tim)"
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
    if workers <= 1 or len(pairs) <= 1:
        return [load_one(pt) for pt in pairs]

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(load_one, pairs))


def make_ideal(psr: SimulatedPulsar, iterations: int = 2) -> None:
    """Zero the residuals by absorbing them into the TOAs, then initialize
    the provenance ledger (reference analog simulate.py:193-202)."""
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
