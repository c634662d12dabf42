"""The flagship workload: NG15-scale batch and full recipe.

Counterpart of ``random_cw_catalog`` and ``flagship_workload`` in
``pta_replicator_tpu/scenarios/compile.py``: the same numpy RNG call
order, hence the same arrays and the same 16-hex content fingerprint, so
both packages build the identical workload. :func:`deterministic_families`
draws a burst, a burst with memory and a transient as the reference's
scenario compiler draws its ``burst``, ``memory`` and ``transient``
sections, from numpy generators of the port's own seeding.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..batch import synthetic_batch
from ..device import resolve_device
from ..models.batched import Recipe
from ..ops.orf import hellings_downs_matrix

#: the JAX package's realization-stream version (its STREAM_VERSION),
#: hashed into the workload fingerprint so that both packages name the
#: same workload by the same fingerprint
WORKLOAD_STREAM_VERSION = 4


def random_cw_catalog(rng, ncw: int) -> np.ndarray:
    """(8, ncw) CW-catalog parameter stack in the order gwtheta, gwphi,
    mc [Msun], dist [Mpc], fgw [Hz], phase0, psi, inc — realistic SMBHB
    outlier ranges."""
    return np.stack(
        [
            np.arccos(rng.uniform(-1, 1, ncw)),
            rng.uniform(0, 2 * np.pi, ncw),
            10 ** rng.uniform(8, 9.5, ncw),
            rng.uniform(50, 1000, ncw),
            10 ** rng.uniform(-8.8, -7.6, ncw),
            rng.uniform(0, 2 * np.pi, ncw),
            rng.uniform(0, np.pi, ncw),
            np.arccos(rng.uniform(-1, 1, ncw)),
        ]
    )


def flagship_workload(npsr: int = 68, ntoa: int = 7758, nbackend: int = 4,
                      ncw: int = 100, with_fingerprint: bool = False,
                      dtype=torch.float32, device="cuda"):
    """The flagship realization workload: an NG15-scale synthetic batch
    (``dtype``) and a recipe with per-backend EFAC/EQUAD/ECORR, 30-mode
    red noise, a Hellings-Downs GWB (npts=600, howml=10) and an
    ``ncw``-source CW catalog, all on ``device``.

    The RNG call order below is the workload's definition.
    ``with_fingerprint=True`` also returns the content hash of the build
    parameters and of every host draw feeding the recipe."""
    device = resolve_device(device)
    batch = synthetic_batch(npsr=npsr, ntoa=ntoa, nbackend=nbackend, seed=0,
                            dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    phat = batch.phat.detach().cpu().numpy().astype(np.float64)
    locs = np.stack(
        [np.arctan2(phat[:, 1], phat[:, 0]),
         np.arccos(np.clip(phat[:, 2], -1, 1))],
        axis=1,
    )
    orf = hellings_downs_matrix(locs)
    draws = {
        "cgw_params": random_cw_catalog(rng, ncw),
        "efac": rng.uniform(0.9, 1.3, (npsr, nbackend)),
        "log10_equad": rng.uniform(-7.5, -6.0, (npsr, nbackend)),
        "log10_ecorr": rng.uniform(-7.5, -6.3, (npsr, nbackend)),
        "rn_log10_amplitude": rng.uniform(-14.5, -13.0, npsr),
        "rn_gamma": rng.uniform(2.0, 5.0, npsr),
        "orf_cholesky": np.linalg.cholesky(np.asarray(orf, np.float64)),
    }
    recipe = Recipe(
        **draws,
        gwb_log10_amplitude=np.array(-14.0),
        gwb_gamma=np.array(4.33),
        gwb_npts=600,
        gwb_howml=10.0,
        cgw_chunk=100,
    ).to(device)
    if not with_fingerprint:
        return batch, recipe

    h = hashlib.sha256()
    h.update(
        f"npsr={npsr};ntoa={ntoa};nbackend={nbackend};ncw={ncw};"
        f"seed=0;stream={WORKLOAD_STREAM_VERSION}".encode()
    )
    for name in sorted(draws):
        h.update(name.encode())
        h.update(np.ascontiguousarray(draws[name]).tobytes())
    return batch, recipe, h.hexdigest()[:16]


def _sine_gaussian(tg, t0, width, amp, rng):
    """Burst morphology: a Gaussian-windowed oscillation with a random
    cycle count and phase, and its quadrature, sampled on the grid."""
    env = amp * np.exp(-0.5 * ((tg - t0) / width) ** 2)
    ncyc = rng.uniform(0.5, 4.0)
    ph = rng.uniform(0.0, 2.0 * np.pi)
    arg = 2.0 * np.pi * ncyc * (tg - t0) / width + ph
    return env * np.cos(arg), env * np.sin(arg)


#: the families' amplitudes: the port's choice (the reference's compiler
#: takes each ``log10_amp``/``log10_strain`` from the spec, with no default)
BURST_LOG10_AMP, MEMORY_LOG10_STRAIN, TRANSIENT_LOG10_AMP = -7.0, -13.0, -6.5
#: the reference compiler's defaults: epoch and width as fractions of the
#: span, waveform grid points, and the array span behind the memory's epoch
T0_FRAC, WIDTH_FRAC, NGRID, SPAN_DAYS = 0.5, 0.05, 256, 365.25 * 16


def deterministic_families(batch, seed: int = 0, transient_psr: int = 0) -> dict:
    """Recipe fields of one burst, one burst with memory and one Gaussian
    transient (in pulsar ``transient_psr``), drawn as the reference's
    compiler draws them (``pta_replicator_tpu/scenarios/compile.py``, its
    burst, memory and transient sections at their default ``t0_frac``,
    ``width_frac`` and ``ngrid``): the sine-Gaussian burst with its sky
    and polarization, the memory's sky and polarization at epoch t0, the
    transient on a window of +-5 widths. Float64 numpy arrays; each family
    from ``np.random.default_rng((seed, family))``."""
    start_s, stop_s = float(batch.start_s), float(batch.stop_s)
    span_s = stop_s - start_s
    t0 = start_s + T0_FRAC * span_s
    width = WIDTH_FRAC * span_s
    g0, g1 = max(start_s, t0 - 5.0 * width), min(stop_s, t0 + 5.0 * width)
    tg = np.linspace(g0, g1, NGRID)

    rng = np.random.default_rng((seed, 0))
    hp, hc = _sine_gaussian(tg, t0, width, 10.0**BURST_LOG10_AMP, rng)
    burst_sky = np.array([np.arccos(rng.uniform(-1.0, 1.0)), rng.uniform(0.0, 2.0 * np.pi),
                          rng.uniform(0.0, np.pi)])
    rng = np.random.default_rng((seed, 1))
    t0_mjd = float(batch.tref_mjd) + (T0_FRAC - 0.5) * SPAN_DAYS
    gwm = np.array([10.0**MEMORY_LOG10_STRAIN, np.arccos(rng.uniform(-1.0, 1.0)),
                    rng.uniform(0.0, 2.0 * np.pi), rng.uniform(0.0, np.pi), t0_mjd])
    wf = 10.0**TRANSIENT_LOG10_AMP * np.exp(-0.5 * ((tg - t0) / width) ** 2)
    return dict(gwm_params=gwm, burst_sky=burst_sky, burst_hplus=hp, burst_hcross=hc,
                burst_grid=np.array([g0, g1]), transient_waveform=wf,
                transient_grid=np.array([g0, g1]), transient_psr=int(transient_psr))
