"""Fabricate an NG15-shaped par/tim dataset on the host.

A pulsar array with the structure of a NANOGrav 15-year release, from a
numpy seed: ragged TOA counts (the largest exactly ``ntoa_max``), four
backends named by the ``-f`` flag on two observatories (``AO``: ASP and
PUPPI at 430 and 1410 MHz; ``GBT``: GASP and GUPPI at 820 and 1500 MHz),
the older backend of each observatory before the switch-over and the newer
after it, sub-band TOAs per observation, spans of 8 to 16 years; and
par files with equatorial or ecliptic positions, proper motion, parallax,
F0/F1, DM with one DMX window per 40 days, FD1-2, a JUMP on each
non-first backend, an ELL1 binary on a third of the pulsars and a DD
binary on a sixth. The dataset is written through the package's own
``fabricate_toas``, ``ParModel`` and ``write_partim``; its TOAs are not
on the timing model until ``make_ideal`` zeroes their residuals.

    pulsars = ng15_like_pulsars(npsr=68, ntoa_max=7758, seed=0)
    write_dataset(pulsars, "par", "tim")
    json.dump(ng15_like_recipe(npsr=68), open("recipe.json", "w"))

:func:`ng15_like_recipe` is a JSON recipe for ``python -m
pta_replicator_tpu_torch realize``: the flagship workload's noise model
and CW catalog (``scenarios/compile.py::flagship_workload``, the same
numpy draws at seed 0), for a pulsar array of any size.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

#: (-f flag, observatory, receiver names, band centres [MHz], bandwidths [MHz])
BACKENDS = (
    ("ASP", "AO", ("430", "L-wide"), (430.0, 1410.0), (24.0, 64.0)),
    ("PUPPI", "AO", ("430", "L-wide"), (430.0, 1410.0), (24.0, 600.0)),
    ("GASP", "GBT", ("Rcvr_800", "Rcvr1_2"), (820.0, 1500.0), (64.0, 64.0)),
    ("GUPPI", "GBT", ("Rcvr_800", "Rcvr1_2"), (820.0, 1500.0), (180.0, 640.0)),
)
#: MJD of the first possible TOA, and of the older backends' retirement
#: (as a fraction of the full span)
MJD_START = 53000.0
SWITCH_FRACTION = 0.45
#: sub-band TOAs per observation, the data span [yr] and the DMX window
#: [days]
NSUB, YEARS, DMX_DAYS = 8, 16.0, 40.0
PEPOCH = 55000.0


@dataclass
class FabricatedPulsar:
    """One pulsar's par lines and TOA columns (epochs as longdouble MJD)."""

    name: str
    par_lines: List[str]
    mjd: np.ndarray
    errors_us: np.ndarray
    freqs_mhz: np.ndarray
    observatories: List[str]
    flags: List[dict]


def _sexagesimal(value: float, sign: bool) -> str:
    s = "-" if value < 0 else ("+" if sign else "")
    value = abs(value)
    a = int(value)
    b = int((value - a) * 60.0)
    c = ((value - a) * 60.0 - b) * 60.0
    return f"{s}{a:02d}:{b:02d}:{c:011.8f}"


def _par_lines(i: int, rng, backends, t0: float, t1: float):
    ra_h, dec_d = rng.uniform(0.0, 24.0), np.degrees(np.arcsin(rng.uniform(-0.9, 0.9)))
    ecliptic = i % 2 == 1
    # a B name on an ecliptic position takes the 1950 equinox (ops/coords.py)
    name = "{}{:02d}{:02d}{}{:02d}{:02d}".format(
        "B" if i % 12 == 3 else "J", int(ra_h), int((ra_h % 1) * 60),
        "+" if dec_d >= 0 else "-", int(abs(dec_d)), int((abs(dec_d) % 1) * 60))
    lines = [f"PSRJ\t\t{name}"]
    if ecliptic:
        lines += [f"ELONG\t\t{rng.uniform(0, 360):.12f}\t1", f"ELAT\t\t{rng.uniform(-60, 60):.12f}\t1",
                  f"PMELONG\t\t{rng.normal(0, 5):.6f}\t1", f"PMELAT\t\t{rng.normal(0, 5):.6f}\t1"]
    else:
        lines += [f"RAJ\t\t{_sexagesimal(ra_h, False)}\t1", f"DECJ\t\t{_sexagesimal(dec_d, True)}\t1",
                  f"PMRA\t\t{rng.normal(0, 5):.6f}\t1", f"PMDEC\t\t{rng.normal(0, 5):.6f}\t1"]
    lines += [
        f"PX\t\t{rng.uniform(0.2, 2.0):.6f}\t1",
        f"POSEPOCH\t{PEPOCH:.1f}",
        f"F0\t\t{rng.uniform(100.0, 600.0):.15f}\t1",
        f"F1\t\t{-10 ** rng.uniform(-16.0, -14.5):.6e}\t1",
        f"PEPOCH\t\t{PEPOCH:.1f}",
        f"DM\t\t{rng.uniform(5.0, 80.0):.8f}",
        f"DMEPOCH\t\t{PEPOCH:.1f}",
        f"DMX\t\t{DMX_DAYS:.1f}",
    ]
    nwin = int(np.ceil((t1 - t0) / DMX_DAYS))
    for k in range(nwin):
        r1 = t0 - 0.5 + k * DMX_DAYS
        lines += [f"DMX_{k + 1:04d}\t{rng.normal(0, 1e-3):.10e}\t1",
                  f"DMXR1_{k + 1:04d}\t{r1:.6f}", f"DMXR2_{k + 1:04d}\t{r1 + DMX_DAYS - 1e-3:.6f}"]
    lines += [f"FD1\t\t{rng.normal(0, 2e-5):.10e}\t1", f"FD2\t\t{rng.normal(0, 5e-6):.10e}\t1"]
    # orbits with NANOGrav's ratios of projected semi-major axis to period
    # (A1 / PB up to ~2 light-seconds a day)
    if i % 6 in (0, 1):
        pb = rng.uniform(0.5, 20.0)
        lines += ["BINARY\t\tELL1", f"PB\t\t{pb:.12f}\t1",
                  f"A1\t\t{pb * rng.uniform(0.1, 2.0):.10f}\t1",
                  f"TASC\t\t{PEPOCH + rng.uniform(0, 1):.10f}\t1",
                  f"EPS1\t\t{rng.normal(0, 1e-5):.10e}\t1", f"EPS2\t\t{rng.normal(0, 1e-5):.10e}\t1",
                  f"M2\t\t{rng.uniform(0.15, 0.4):.6f}\t1", f"SINI\t\t{rng.uniform(0.6, 0.95):.6f}\t1"]
    elif i % 6 == 2:
        pb = rng.uniform(10.0, 100.0)
        lines += ["BINARY\t\tDD", f"PB\t\t{pb:.12f}\t1",
                  f"A1\t\t{pb * rng.uniform(0.1, 1.2):.10f}\t1",
                  f"T0\t\t{PEPOCH + rng.uniform(0, 10):.10f}\t1",
                  f"ECC\t\t{rng.uniform(0.01, 0.2):.10f}\t1", f"OM\t\t{rng.uniform(0, 360):.8f}\t1"]
    for flag in backends[1:]:
        lines.append(f"JUMP\t\t-f {flag} {rng.normal(0, 2e-6):.10e} 1")
    lines += ["TZRMJD\t\t55000.0", "UNITS\t\tTDB", "EPHEM\t\tDE440", "CLK\t\tTT(BIPM2019)"]
    return name, lines


def ng15_like_pulsars(npsr: int = 68, ntoa_max: int = 7758, ntoa_min: int = 2000,
                      seed: int = 0) -> List[FabricatedPulsar]:
    """``npsr`` fabricated pulsars (see the module docstring): TOA counts
    drawn between ``ntoa_min`` and ``ntoa_max``, the last pulsar's exactly
    ``ntoa_max``; every value from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    full = YEARS * 365.25
    switch = MJD_START + SWITCH_FRACTION * full
    counts = rng.integers(ntoa_min, ntoa_max + 1, size=npsr)
    counts[-1] = ntoa_max
    out, names = [], set()
    for i in range(npsr):
        t1 = MJD_START + full
        t0 = t1 - rng.uniform(0.5, 1.0) * full
        # the AO pair, the GBT pair, or both
        sites = (("AO",), ("AO", "GBT"), ("GBT",))[i % 3]
        used = [b for b in BACKENDS if b[1] in sites and (b[0] in ("PUPPI", "GUPPI") or t0 < switch)]
        name, lines = _par_lines(i, rng, [b[0] for b in used], t0, t1)
        while name in names:  # two positions in one arc-minute cell
            name += "A"
            lines[0] = f"PSRJ\t\t{name}"
        names.add(name)
        n = int(counts[i])
        nobs = int(np.ceil(n / (2 * NSUB)))
        epochs = np.sort(rng.uniform(t0, t1 - 1.0, size=nobs))
        mjd, err, freq, obs, flags = [], [], [], [], []
        for e in epochs:
            live = [b for b in used if (b[0] in ("PUPPI", "GUPPI")) == (e >= switch)] or used
            flag, site, receivers, centres, widths = live[rng.integers(len(live))]
            for band in range(2):
                start = e + 0.3 * band + rng.uniform(0.0, 0.02)
                sub = np.linspace(-0.5, 0.5, NSUB) * widths[band] + centres[band]
                scale = 10 ** rng.uniform(-0.7, 0.3)
                for k in range(NSUB):
                    mjd.append(start + k * 1e-6)
                    err.append(scale * rng.lognormal(0.0, 0.3))
                    freq.append(sub[k])
                    obs.append(site)
                    flags.append({"f": flag, "fe": receivers[band], "be": flag,
                                  "pta": "NANOGrav"})
        order = np.argsort(np.asarray(mjd), kind="stable")[:n]
        out.append(FabricatedPulsar(
            name=name, par_lines=lines,
            mjd=np.asarray(mjd, dtype=np.longdouble)[order],
            errors_us=np.round(np.asarray(err)[order], 4),
            freqs_mhz=np.round(np.asarray(freq)[order], 6),
            observatories=[obs[j] for j in order], flags=[flags[j] for j in order],
        ))
    return out


def write_dataset(pulsars: List[FabricatedPulsar], pardir: str, timdir: str) -> None:
    """Write each pulsar as ``pardir/<name>.par`` and ``timdir/<name>.tim``
    through ``read_par``, ``fabricate_toas`` and ``write_partim``."""
    from ..io.par import read_par
    from ..io.tim import fabricate_toas
    from ..simulate import SimulatedPulsar

    os.makedirs(pardir, exist_ok=True)
    os.makedirs(timdir, exist_ok=True)
    for p in pulsars:
        parfile = os.path.join(pardir, f"{p.name}.par")
        with open(parfile, "w") as fh:
            fh.write("\n".join(p.par_lines) + "\n")
        par = read_par(parfile)
        toas = fabricate_toas(p.mjd, p.errors_us, freq_mhz=p.freqs_mhz)
        toas.observatories = list(p.observatories)
        toas.flags = [dict(f) for f in p.flags]
        psr = SimulatedPulsar(par=par, toas=toas, name=par.name, loc=par.loc)
        psr.write_partim(parfile, os.path.join(timdir, f"{p.name}.tim"))


def ng15_like_recipe(npsr: int, ncw: int = 100, gwb_npts: int = 600,
                     gwb_howml: float = 10.0) -> dict:
    """A JSON-ready recipe in the flagship's draw order (numpy seed 0): an
    ``ncw``-source CW catalog (``cgw_params``), per-backend EFAC, EQUAD and
    ECORR tables (npsr, 4), 30-mode red noise per pulsar, and a
    Hellings-Downs GWB (A = 1e-14, gamma = 4.33)."""
    from ..scenarios.compile import random_cw_catalog

    rng = np.random.default_rng(0)
    nbackend = len(BACKENDS)
    return {
        "cgw_params": random_cw_catalog(rng, ncw).tolist(),
        "efac": rng.uniform(0.9, 1.3, (npsr, nbackend)).tolist(),
        "log10_equad": rng.uniform(-7.5, -6.0, (npsr, nbackend)).tolist(),
        "log10_ecorr": rng.uniform(-7.5, -6.3, (npsr, nbackend)).tolist(),
        "rn_log10_amplitude": rng.uniform(-14.5, -13.0, npsr).tolist(),
        "rn_gamma": rng.uniform(2.0, 5.0, npsr).tolist(),
        "rn_nmodes": 30,
        "gwb_log10_amplitude": -14.0,
        "gwb_gamma": 4.33,
        "gwb_npts": gwb_npts,
        "gwb_howml": gwb_howml,
        "cgw_chunk": 100,
        "orf": "hd",
    }
