"""Realistic datasets from SMBHB populations: the loudest binaries as a CW
catalog, the remainder as a free-spectrum GWB.

Counterpart of ``pta_replicator_tpu/models/population.py`` (the Becsy,
Cornish & Kelley 2022 method; reference analog ``add_gwb_plus_outlier_cws``,
pta_replicator/deterministic.py:565-715): the binning and the split are
the same host numpy code, so their arrays are the JAX package's bit for
bit. Two entry points share them: :func:`add_gwb_plus_outlier_cws`, the
per-pulsar oracle (one legacy-RNG stream drives the GWB draws and then the
outliers' sky, phase and orientation draws), and :func:`population_recipe`,
whose recipe carries the remainder as a user GWB spectrum and the outliers
as the CW catalog, the two paths the batched engine runs on the card
(``models/batched.py::gwb_delays`` and the CW kernel through
``deterministic_delays``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..utils.cosmology import (
    MPC_CM,
    MSOL_G,
    chirp_mass,
    comoving_distance_cm,
    gw_strain_source,
    m1m2_from_mtmr,
)
from .batched import Recipe
from .cgw import add_catalog_of_cws
from .gwb import add_gwb


@dataclass
class PopulationSplit:
    """Binned population split into outlier CWs and a free-spectrum GWB."""

    #: frequency bin centers [Hz]
    f_centers: np.ndarray
    #: summed weighted h_c^2 per bin, outliers excluded
    free_spec: np.ndarray
    #: per-outlier observed GW frequency [Hz]
    outlier_fo: np.ndarray
    #: per-outlier weighted characteristic strain^2
    outlier_hs: np.ndarray
    #: per-outlier observer-frame chirp mass [Msol]
    outlier_mc: np.ndarray
    #: per-outlier luminosity distance [Mpc]
    outlier_dl: np.ndarray

    @property
    def user_spectrum(self) -> np.ndarray:
        """(F, 2) [freq, hc] table for the GWB injector."""
        return np.column_stack([self.f_centers, np.sqrt(self.free_spec)])


def split_population(vals, weights, fobs, T_obs, outlier_per_bin: int = 100) -> PopulationSplit:
    """Bin a binary population by observed GW frequency and split off the
    ``outlier_per_bin`` loudest (by weighted h_c^2) binaries per bin.

    ``vals`` = [Mtot_g, Mrat, redz, Fobs_gw_hz] per binary (cgs rest-frame
    masses), ``weights`` = number of binaries each entry represents,
    ``fobs`` = frequency bin edges [Hz], ``T_obs`` = observing time [s].
    """
    vals = [np.asarray(v, dtype=np.float64) for v in vals]
    weights = np.asarray(weights, dtype=np.float64)
    mtot, mrat, redz, fo = vals

    f_centers = 0.5 * (np.asarray(fobs)[1:] + np.asarray(fobs)[:-1])
    nbins = len(f_centers)

    mc_rest = chirp_mass(*m1m2_from_mtmr(mtot, mrat))  # grams, rest frame
    frst = fo * (1.0 + redz)  # rest-frame GW frequency
    dcom = comoving_distance_cm(redz)
    dlum = dcom * (1.0 + redz)
    hs = gw_strain_source(mc_rest, dcom, frst / 2.0)
    mc_obs = mc_rest * (1.0 + redz)

    # weighted characteristic strain^2 of each entry over the observation
    hc2 = weights * hs**2 * fo * T_obs

    bin_idx = np.digitize(fo, fobs) - 1
    # empty-bin floor: tiny but float32-representable as hc (a smaller
    # floor underflows to 0 in float32 and poisons the log-log
    # interpolation of the user spectrum with -inf)
    free_spec = np.full(nbins, 1e-40)
    out_hs, out_fo, out_mc, out_dl = [], [], [], []

    for k in range(nbins):
        sel = bin_idx == k
        if not np.any(sel):
            continue
        order = np.argsort(hc2[sel])[::-1]
        take = min(outlier_per_bin, len(order))
        # zero-strain entries (e.g. weight-0 entries) never become outliers
        loud = order[:take]
        loud = loud[hc2[sel][loud] > 0]
        rest = order[take:]
        out_hs.extend(hc2[sel][loud])
        out_fo.extend(fo[sel][loud])
        out_mc.extend(mc_obs[sel][loud] / MSOL_G)
        out_dl.extend(dlum[sel][loud] / MPC_CM)
        free_spec[k] += hc2[sel][rest].sum()

    return PopulationSplit(
        f_centers=f_centers,
        free_spec=free_spec,
        outlier_fo=np.asarray(out_fo),
        outlier_hs=np.asarray(out_hs),
        outlier_mc=np.asarray(out_mc),
        outlier_dl=np.asarray(out_dl),
    )


def _random_orientations(n):
    """Sky positions, phases, polarizations, inclinations for outliers —
    legacy global-RNG draws in the reference's order
    (deterministic.py:696-700)."""
    gwtheta = np.arccos(np.random.uniform(low=-1.0, high=1.0, size=n))
    gwphi = np.random.uniform(low=0.0, high=2 * np.pi, size=n)
    phase0 = np.random.uniform(low=0.0, high=2 * np.pi, size=n)
    psi = np.random.uniform(low=0.0, high=np.pi, size=n)
    inc = np.arccos(np.random.uniform(low=-1.0, high=1.0, size=n))
    return gwtheta, gwphi, phase0, psi, inc


def add_gwb_plus_outlier_cws(psrs, vals, weights, fobs, T_obs, outlier_per_bin: int = 100,
                             seed: int = None, howml: float = 10,
                             cw_tref_s: float = 53000 * 86400):
    """Inject a population-derived dataset on the oracle path: the
    free-spectrum GWB of the remainder, then the loudest binaries as one
    CW catalog in every pulsar (pulsar term, chirping).

    Returns the same tuple as the reference (deterministic.py:715):
    (f_centers, free_spec, outlier_fo, outlier_hs, outlier_mc, outlier_dl,
    gwthetas, gwphis, phases, psis, incs).
    """
    split = split_population(vals, weights, fobs, T_obs, outlier_per_bin)

    add_gwb(psrs, None, None, userSpec=split.user_spectrum, howml=howml, seed=seed)

    n_cw = split.outlier_fo.shape[0]
    gwtheta, gwphi, phase0, psi, inc = _random_orientations(n_cw)

    for psr in psrs:
        add_catalog_of_cws(
            psr,
            gwtheta_list=gwtheta,
            gwphi_list=gwphi,
            mc_list=split.outlier_mc,
            dist_list=split.outlier_dl,
            fgw_list=split.outlier_fo,
            phase0_list=phase0,
            psi_list=psi,
            inc_list=inc,
            pdist=1.0,
            pphase=None,
            psrTerm=True,
            evolve=True,
            phase_approx=False,
            tref=cw_tref_s,
        )

    return (
        split.f_centers,
        split.free_spec,
        split.outlier_fo,
        split.outlier_hs,
        split.outlier_mc,
        split.outlier_dl,
        gwtheta,
        gwphi,
        phase0,
        psi,
        inc,
    )


def population_recipe(vals, weights, fobs, T_obs, orf_cholesky, outlier_per_bin: int = 100,
                      seed: int = 0, howml: float = 10.0, gwb_npts: int = 600,
                      cw_tref_s: float = 53000 * 86400.0, base_recipe=None,
                      split: PopulationSplit = None, device="cuda"):
    """The population as a :class:`~.batched.Recipe` on ``device``: a
    user-spectrum GWB of the remainder and a CW catalog of the outliers,
    whose sky positions, phases, polarizations and inclinations are drawn
    from ``np.random.default_rng(seed)`` in the JAX package's order. Every
    field of ``base_recipe`` is kept unless the population sets it; the
    arrays keep their float64 (each op casts to the batch's dtype at use).

    ``split`` short-circuits the binning with a precomputed
    :class:`PopulationSplit`; ``vals``/``weights``/``fobs``/``T_obs`` are
    ignored then. A split with zero outliers leaves the CW catalog off."""
    device = resolve_device(device)
    if split is None:
        split = split_population(vals, weights, fobs, T_obs, outlier_per_bin)
    n_cw = split.outlier_fo.shape[0]
    rng = np.random.default_rng(seed)
    gwtheta = np.arccos(rng.uniform(-1.0, 1.0, n_cw))
    gwphi = rng.uniform(0.0, 2 * np.pi, n_cw)
    phase0 = rng.uniform(0.0, 2 * np.pi, n_cw)
    psi = rng.uniform(0.0, np.pi, n_cw)
    inc = np.arccos(rng.uniform(-1.0, 1.0, n_cw))

    kwargs = dict(vars(base_recipe)) if base_recipe is not None else {}
    kwargs.update(
        gwb_log10_amplitude=np.array(0.0),  # unused under the user spectrum
        gwb_gamma=np.array(0.0),
        gwb_user_spectrum=split.user_spectrum,
        orf_cholesky=np.asarray(orf_cholesky, np.float64),
        gwb_npts=gwb_npts,
        gwb_howml=howml,
    )
    if n_cw:
        kwargs.update(
            cgw_params=np.stack([gwtheta, gwphi, split.outlier_mc, split.outlier_dl,
                                 split.outlier_fo, phase0, psi, inc]),
            cgw_tref_s=cw_tref_s,
        )
    return Recipe(**kwargs).to(device)
