"""A small ragged par/tim dataset for the port's dataset-path tests
(tests/test_torch_*.py), written through either package.

The pulsars come from the port's ``utils/fabricate.py`` (numpy seeded):
4 pulsars with 150-400 TOAs, equatorial and ecliptic positions (one B
name on an ecliptic position), ELL1 and DD binaries, DMX windows, FD1-2,
JUMPs, proper motion and parallax, ASP/PUPPI/GASP/GUPPI backends on AO and
GBT, sub-band TOAs that bin into ECORR epochs. ``write_with`` writes them
through a package's own ``simulate_pulsar`` and ``write_partim``.
"""
import os

import numpy as np

from pta_replicator_tpu_torch.utils.fabricate import ng15_like_pulsars

SMALL = dict(npsr=4, ntoa_max=400, ntoa_min=150)


def small_pulsars(seed: int = 2, **kw):
    return ng15_like_pulsars(**{**SMALL, **kw}, seed=seed)


def write_with(simulate, pulsars, root) -> tuple:
    """Write ``pulsars`` under ``root/par`` and ``root/tim`` through the
    ``simulate`` module of either package (its ``simulate_pulsar`` with
    per-TOA frequencies and errors, then per-TOA observatories and flags,
    then ``write_partim``); returns ``(pardir, timdir)``."""
    pardir, timdir = os.path.join(root, "par"), os.path.join(root, "tim")
    os.makedirs(pardir, exist_ok=True)
    os.makedirs(timdir, exist_ok=True)
    for p in pulsars:
        parfile = os.path.join(pardir, f"{p.name}.par")
        with open(parfile, "w") as fh:
            fh.write("\n".join(p.par_lines) + "\n")
        psr = simulate.simulate_pulsar(parfile, np.array(p.mjd), p.errors_us,
                                       freq=p.freqs_mhz)
        psr.toas.observatories = list(p.observatories)
        psr.toas.flags = [dict(f) for f in p.flags]
        psr.write_partim(parfile, os.path.join(timdir, f"{p.name}.tim"))
    return pardir, timdir


def file_bytes(directory) -> dict:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}
