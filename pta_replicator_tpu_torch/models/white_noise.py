"""White measurement noise (EFAC/EQUAD) and correlated jitter (ECORR), on
the per-pulsar oracle path.

Counterpart of ``pta_replicator_tpu/models/white_noise.py`` (reference
analogs ``add_measurement_noise`` and ``add_jitter``, pta_replicator/
white_noise.py:47-198). Host float64 numpy: the draws come from numpy's
legacy global RNG in the reference's order, and the delay math is the
JAX package's operations in its order, so a seeded run equals the JAX
package's oracle bit for bit. The batched engine's twins are
``models/batched.py::white_noise_delays`` and ``jitter_delays``.
"""
from __future__ import annotations

import numpy as np

from ..ops.quantize import quantize
from ..simulate import SimulatedPulsar


# ----------------------------------------------------------------- pure math

def measurement_noise_delay(errors_s, efac_vec, equad_vec, eps_efac, eps_equad,
                            tnequad: bool = False):
    """Per-TOA white-noise delay [s].

    t2equad convention (default): EFAC scales both the nominal error and the
    EQUAD draw; tnequad convention: EFAC * sigma + EQUAD
    (reference white_noise.py:105-109).
    """
    dt = efac_vec * errors_s * eps_efac
    if tnequad:
        return dt + equad_vec * eps_equad
    return dt + efac_vec * equad_vec * eps_equad


def jitter_delay(epoch_index, ecorr_per_epoch, eps_epoch):
    """Per-TOA jitter delay [s]: every TOA in an epoch shares one draw,
    scaled by that epoch's ECORR rms."""
    per_epoch = ecorr_per_epoch * eps_epoch
    return np.take(per_epoch, epoch_index, axis=-1)


def expand_by_flags(values, flags, toa_flag_values, default=0.0):
    """Expand per-backend parameter values to a per-TOA (or per-epoch) vector.

    ``values`` aligned with ``flags``; positions whose flag value is not
    listed get ``default``.
    """
    out = np.full(len(toa_flag_values), default, dtype=np.float64)
    for val, flag in zip(values, flags):
        out[np.asarray(toa_flag_values) == flag] = val
    return out


# ------------------------------------------------------------- oracle layer

def _efac_equad_vectors(psr, efac, equad, flagid, flags):
    n = psr.toas.ntoas
    if flags is None:
        if not np.isscalar(efac) or not np.isscalar(equad):
            raise ValueError("If flags is None, efac and equad must be scalars")
        return np.full(n, efac, float), np.full(n, equad, float)
    toa_flags = psr.toas.get_flag(flagid)
    efac_l = np.full(len(flags), efac, float) if np.isscalar(efac) else np.asarray(efac, float)
    equad_l = np.full(len(flags), equad, float) if np.isscalar(equad) else np.asarray(equad, float)
    if len(efac_l) != len(flags) or len(equad_l) != len(flags):
        raise ValueError("flags must be same length as efac and log10_equad")
    return (
        expand_by_flags(efac_l, flags, toa_flags),
        expand_by_flags(equad_l, flags, toa_flags),
    )


def add_measurement_noise(
    psr: SimulatedPulsar,
    efac: float = 1.0,
    log10_equad: float = None,
    flagid: str = "f",
    flags: list = None,
    seed: int = None,
    tnequad: bool = False,
):
    """Inject EFAC/EQUAD white noise (reference white_noise.py:47-125).

    ``efac``/``log10_equad`` may be scalars, or per-backend lists aligned
    with ``flags`` (values of TOA flag ``flagid``); TOAs of an unlisted
    backend get no noise. Unlike the reference, a scalar parameter combined
    with ``flags`` broadcasts to all listed backends instead of silently
    injecting zeros.
    """
    equad_str = "tnequad" if tnequad else "t2equad"
    if log10_equad is not None:
        equad = (
            10.0 ** np.asarray(log10_equad, dtype=np.float64)
            if not np.isscalar(log10_equad)
            else 10.0 ** log10_equad
        )
    else:
        equad = 0.0
    if seed is not None:
        np.random.seed(seed)

    efacvec, equadvec = _efac_equad_vectors(psr, efac, equad, flagid, flags)

    # legacy draw order: efac stream first, then equad stream (always drawn)
    eps_efac = np.random.randn(psr.toas.ntoas)
    eps_equad = np.random.randn(psr.toas.ntoas)
    dt = measurement_noise_delay(
        psr.toas.errors_s, efacvec, equadvec, eps_efac, eps_equad, tnequad=tnequad
    )

    if flags is None:
        psr.update_added_signals(
            f"{psr.name}_measurement_noise",
            {"efac": efac, "log10_" + equad_str: log10_equad},
            dt,
        )
    else:
        psr.update_added_signals(f"{psr.name}_measurement_noise", {}, dt)
        for i, flag in enumerate(flags):
            psr.update_added_signals(
                f"{psr.name}_{flag}_measurement_noise",
                {
                    "efac": efac if np.isscalar(efac) else efac[i],
                    "log10_" + equad_str: (
                        log10_equad if log10_equad is None or np.isscalar(log10_equad)
                        else log10_equad[i]
                    ),
                },
            )
    psr.toas.adjust_seconds(dt)
    psr.update_residuals()


def add_jitter(
    psr: SimulatedPulsar,
    log10_ecorr: float,
    flagid: str = "f",
    flags: list = None,
    coarsegrain: float = 0.1,
    seed: int = None,
):
    """Inject epoch-correlated (ECORR) jitter noise
    (reference white_noise.py:128-198). ``coarsegrain`` is the epoch width
    in days; epochs come from :func:`~..ops.quantize.quantize`, split by
    backend when ``flags`` lists them."""
    ecorr = (
        10.0 ** np.asarray(log10_ecorr, dtype=np.float64)
        if not np.isscalar(log10_ecorr)
        else 10.0 ** log10_ecorr
    )
    if seed is not None:
        np.random.seed(seed)

    mjds = psr.toas.get_mjds()
    if flags is None:
        if not np.isscalar(ecorr):
            raise ValueError("If flags is None, jitter must be a scalar")
        bins = quantize(mjds, dt=coarsegrain)
        ecorrvec = np.full(bins.nepochs, ecorr, float)
    else:
        bins = quantize(mjds, flags=psr.toas.get_flag(flagid), dt=coarsegrain)
        ecorr_l = np.full(len(flags), ecorr, float) if np.isscalar(ecorr) else np.asarray(ecorr, float)
        if len(ecorr_l) != len(flags):
            raise ValueError("flags must be same length as jitter")
        ecorrvec = expand_by_flags(ecorr_l, flags, bins.ave_flags)

    eps = np.random.randn(bins.nepochs)
    dt = jitter_delay(bins.epoch_index, ecorrvec, eps)

    if flags is None:
        psr.update_added_signals(
            f"{psr.name}_jitter", {"log10_ecorr": log10_ecorr}, dt
        )
    else:
        psr.update_added_signals(f"{psr.name}_jitter", {}, dt)
        for i, flag in enumerate(flags):
            psr.update_added_signals(
                f"{psr.name}_{flag}_jitter",
                {"log10_ecorr": log10_ecorr if np.isscalar(log10_ecorr) else log10_ecorr[i]},
            )
    psr.toas.adjust_seconds(dt)
    psr.update_residuals()
