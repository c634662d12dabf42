"""Batched realization engine: every injection as a torch function.

Counterpart of ``pta_replicator_tpu/models/batched.py`` for the flagship
realization path. Each family maps ``(batch, params, draws) -> delays``
of shape (..., Np, Nt); the leading axes of the draws are realization
axes, written out in place of ``vmap``. A realization is the sum of the
families a :class:`Recipe` enables plus the realization-independent
:func:`deterministic_delays`, then a fit (:func:`finalize_residuals`).

Random numbers come from an explicit ``torch.Generator``, or are handed
in: every stochastic family takes its standard-normal tensor ``eps``, and
:func:`realize` takes a dict of per-family draws, so tests can feed the
port the JAX package's draws and compare element by element.

Per-backend parameters are (Np, n_backends) tables gathered per TOA or
epoch through the batch's int64 index tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..batch import PulsarBatch, _map_tensors
from ..covariance.structure import (
    BandedCov,
    CovOp,
    banded_combined_solver,
    dense_combined_solver,
    recipe_cov_s2,
)
from ..device import resolve_device
from ..ops.cw import cw_catalog_plane_tiles, cw_catalog_planes, cw_catalog_response
from ..ops.fourier import fourier_basis, fourier_frequencies, powerlaw_prior
from .cgw import principal_axes
from .gwb import (
    characteristic_strain,
    dft_synthesis_matrices,
    gwb_grid,
    residual_psd_coeff,
)


def _as(x, batch: PulsarBatch, dtype=None):
    """``x`` (number, array or tensor) as a tensor on the batch's device,
    in ``dtype`` (default: the batch's working dtype)."""
    return torch.as_tensor(x, dtype=dtype or batch.dtype, device=batch.device)


def _normal(generator, shape, batch: PulsarBatch):
    if generator is None:
        raise ValueError(
            "no explicit draws were given and no torch.Generator to draw them"
        )
    return torch.randn(
        shape, generator=generator, dtype=batch.dtype, device=batch.device
    )


def _check_backend_table(params, batch: PulsarBatch, name: str):
    """Fail loudly when a per-backend table is narrower than the batch's
    backend vocabulary (the gather would read past the table)."""
    nb = len(batch.backend_names)
    if params.ndim == 2 and nb and params.shape[1] < nb:
        raise ValueError(
            f"{name} table has {params.shape[1]} backend column(s) but "
            f"the batch carries {nb} backends ({batch.backend_names}); "
            "size per-backend tables to PulsarBatch.backend_names"
        )
    return params


def _per_toa(params, index, mask):
    """Gather per-backend parameters onto TOAs: (Np, NB) -> (Np, Nt)."""
    if params.ndim == 1:
        return params[:, None] * mask
    return torch.gather(params, 1, index) * mask


def _gather_last(values, index):
    """``values[..., index]`` per row: (..., Np, M) gathered by the
    (Np, N) ``index`` into (..., Np, N)."""
    return torch.gather(
        values, -1, index.expand(values.shape[:-1] + index.shape[-1:])
    )


# ------------------------------------------------------------- injection ops

def white_noise_delays(generator, batch: PulsarBatch, efac=1.0,
                       log10_equad=None, tnequad: bool = False, eps=None):
    """EFAC/EQUAD white noise: one normal per TOA at the combined per-TOA
    standard deviation. ``efac``/``log10_equad`` are scalars, (Np,)
    vectors or (Np, n_backends) tables; ``eps`` (..., Np, Nt) defaults to
    one draw from ``generator``."""
    if eps is None:
        eps = _normal(generator, batch.toas_s.shape, batch)
    ef = _check_backend_table(_as(efac, batch), batch, "efac")
    ef = ef.expand(batch.npsr) if ef.ndim == 0 else ef
    efac_t = _per_toa(ef, batch.backend_index, batch.mask)
    var = (efac_t * batch.errors_s) ** 2
    if log10_equad is not None:
        eq = 10.0 ** _check_backend_table(_as(log10_equad, batch), batch, "log10_equad")
        eq = eq.expand(batch.npsr) if eq.ndim == 0 else eq
        equad_t = _per_toa(eq, batch.backend_index, batch.mask)
        if not tnequad:
            equad_t = efac_t * equad_t
        var = var + equad_t**2
    return torch.sqrt(var) * eps * batch.mask


def jitter_delays(generator, batch: PulsarBatch, log10_ecorr, eps=None):
    """ECORR jitter: one draw per (pulsar, epoch), scaled per epoch and
    gathered onto TOAs. ``log10_ecorr``: scalar, (Np,) or (Np, NB);
    ``eps`` (..., Np, max_epochs)."""
    if eps is None:
        eps = _normal(generator, (batch.npsr, batch.max_epochs), batch)
    ec = 10.0 ** _check_backend_table(_as(log10_ecorr, batch), batch, "log10_ecorr")
    if ec.ndim == 0:
        per_epoch = ec * batch.epoch_mask
    elif ec.ndim == 1:
        per_epoch = ec[:, None] * batch.epoch_mask
    else:
        per_epoch = torch.gather(ec, 1, batch.epoch_backend_index) * batch.epoch_mask
    return _gather_last(per_epoch * eps, batch.epoch_index) * batch.mask


def red_noise_prior(batch: PulsarBatch, log10_amplitude, gamma,
                    nmodes: int = 30, modes=None, logf: bool = False,
                    fmin=None, fmax=None, tspan_s=None):
    """Mode frequencies and power-law prior of the rank-reduced red-noise
    basis, without the basis: ``(freqs (Np, K), prior (Np, 2K))``."""
    npsr = batch.npsr
    log10_amplitude = _as(log10_amplitude, batch).expand(npsr)
    gamma = _as(gamma, batch).expand(npsr)
    T = batch.tspan_s if tspan_s is None else _as(tspan_s, batch).expand(npsr)
    freqs = fourier_frequencies(
        T, nmodes=nmodes, logf=logf, fmin=fmin, fmax=fmax, modes=modes
    )
    freqs = freqs.expand(npsr, freqs.shape[-1])
    prior2 = powerlaw_prior(
        torch.repeat_interleave(freqs, 2, dim=-1), log10_amplitude, gamma, T
    )
    return freqs, prior2


def red_noise_basis_prior(batch: PulsarBatch, log10_amplitude, gamma,
                          nmodes: int = 30, modes=None, logf: bool = False,
                          fmin=None, fmax=None, phase_shift=None,
                          libstempo_convention: bool = False, tspan_s=None):
    """Per-pulsar Fourier basis and power-law prior: ``(F (..., Np, Nt, 2K),
    prior (Np, 2K))`` with sin/cos columns interleaved per frequency. A
    ``phase_shift`` with leading realization axes gives F those axes."""
    freqs, prior2 = red_noise_prior(
        batch, log10_amplitude, gamma, nmodes=nmodes, modes=modes, logf=logf,
        fmin=fmin, fmax=fmax, tspan_s=tspan_s,
    )
    shift = None
    if phase_shift is not None:
        shift = _as(phase_shift, batch)
        shift = shift.expand(shift.shape[:-2] + freqs.shape)
    F = fourier_basis(
        batch.toas_s, freqs, phase_shift=shift,
        libstempo_convention=libstempo_convention,
    )
    return F, prior2


def red_noise_delays(generator, batch: PulsarBatch, log10_amplitude, gamma,
                     nmodes: int = 30, modes=None, logf: bool = False,
                     fmin=None, fmax=None, pshift: bool = False,
                     phase_shift=None, libstempo_convention: bool = False,
                     tspan_s=None, eps=None):
    """Per-pulsar power-law red noise on the rank-reduced Fourier basis.

    ``eps`` (..., Np, 2K) is the coefficient draw; ``pshift`` draws random
    per-mode phase shifts, uniform on [0, 2 pi), from ``generator`` before
    the coefficients (or takes an explicit ``phase_shift`` (..., Np, K)).
    Per-realization shifts give every realization its own (Np, Nt, 2K)
    basis, so memory grows with the realization count in that mode."""
    if pshift and phase_shift is None:
        nm = nmodes if modes is None else len(modes)
        if generator is None:
            raise ValueError("pshift needs explicit phase_shift or a generator")
        phase_shift = 2.0 * math.pi * torch.rand(
            (batch.npsr, nm), generator=generator, dtype=batch.dtype,
            device=batch.device,
        )
    F, prior2 = red_noise_basis_prior(
        batch, log10_amplitude, gamma, nmodes=nmodes, modes=modes, logf=logf,
        fmin=fmin, fmax=fmax, phase_shift=phase_shift,
        libstempo_convention=libstempo_convention, tspan_s=tspan_s,
    )
    if eps is None:
        eps = _normal(generator, prior2.shape, batch)
    coeff = torch.sqrt(prior2) * eps
    return torch.einsum("...pnk,...pk->...pn", F, coeff) * batch.mask


def chromatic_noise_delays(generator, batch: PulsarBatch, log10_amplitude,
                           gamma, chromatic_index=2.0, nmodes: int = 30,
                           ref_freq_mhz: float = 1400.0, tspan_s=None,
                           eps=None):
    """Chromatic power-law red noise: the achromatic process scaled per
    TOA by ``(ref_freq/freq)^chromatic_index`` (2: dispersion measure,
    4: scattering). A frequency <= 0 marks an infinite-frequency TOA,
    whose chromatic delay is exactly zero."""
    if batch.freqs_mhz is None:
        raise ValueError(
            "chromatic noise needs batch.freqs_mhz (observing frequencies)"
        )
    idx = _as(chromatic_index, batch)
    if idx.ndim >= 1:  # per-pulsar exponent broadcasts over the TOA axis
        idx = idx[..., None]
    positive = batch.freqs_mhz > 0.0
    # 1.0 (not a tiny epsilon) in the untaken branch: ref/eps overflows f32
    safe = torch.where(positive, batch.freqs_mhz, 1.0)
    scale = torch.where(positive, (ref_freq_mhz / safe) ** idx, 0.0)
    return scale * red_noise_delays(
        generator, batch, log10_amplitude, gamma, nmodes=nmodes,
        tspan_s=tspan_s, eps=eps,
    )


def uniform_grid_interp(t, start, stop, series):
    """Linear interpolation of (..., Np, npts) series sampled on a uniform
    grid [start, stop] onto (Np, Nt) query times, by direct index
    arithmetic (the grid spacing is known)."""
    npts = series.shape[-1]
    pos = (t - start) / (stop - start) * (npts - 1)
    idx = torch.clamp(torch.floor(pos).to(torch.int64), 0, npts - 2)
    frac = torch.clamp(pos - idx, 0.0, 1.0)
    lo = _gather_last(series, idx)
    hi = _gather_last(series, idx + 1)
    return lo + frac * (hi - lo)


@functools.lru_cache(maxsize=8)
def _device_grid(start_s: float, stop_s: float, npts: int, howml: float,
                 dtype, device):
    """The GWB time and frequency grids on the device, built once per span:
    float64 on the host, cast last. Cached, so a chunked sweep copies
    nothing to the card per chunk; callers must not write into them."""
    ut, dt_grid, f = gwb_grid(start_s, stop_s, npts, howml)
    return (torch.as_tensor(ut, dtype=dtype, device=device),
            torch.as_tensor(f, dtype=dtype, device=device), dt_grid)


@functools.lru_cache(maxsize=8)
def _synthesis_tensors(nf: int, npts: int, dtype, device):
    """The DFT synthesis matrices on the device, built once per shape:
    float64 on the host, cast last."""
    cos_m, sin_m = dft_synthesis_matrices(nf, npts)
    return (torch.as_tensor(cos_m, dtype=dtype, device=device),
            torch.as_tensor(sin_m, dtype=dtype, device=device))


def gwb_delays(generator, batch: PulsarBatch, log10_amplitude, gamma,
               orf_cholesky, npts: int = 600, howml: float = 10,
               turnover: bool = False, f0: float = 1e-9, beta: float = 1.0,
               power: float = 1.0, user_spectrum=None, synthesis: str = "auto",
               eps=None):
    """Correlated GWB across the array: the one cross-pulsar op.

    ``eps`` (..., 2, Ncol, nf) holds the real and imaginary standard
    normals of the per-pulsar spectra, Ncol the ORF factor's column count.
    The complex mix with the real Cholesky factor is two real matmuls; the
    hermitian synthesis is a dense (nf x npts) matmul evaluating only the
    used samples (``"matmul"``, the default whenever it is smaller than the
    full inverse FFT) or ``torch.fft.irfft`` (``"fft"``). A
    ``user_spectrum`` (F, 2) [freq_hz, hc] replaces the power law
    (:func:`~.gwb.characteristic_strain`)."""
    dtype = batch.dtype
    ut, f, dt_grid = _device_grid(batch.start_s, batch.stop_s, npts, howml,
                                  dtype, batch.device)
    nf = f.shape[0]
    dur = batch.stop_s - batch.start_s
    M = _as(orf_cholesky, batch)
    if eps is None:
        eps = _normal(generator, (2, M.shape[1], nf), batch)

    opt = lambda x: None if x is None else _as(x, batch)
    hcf = characteristic_strain(
        f, opt(log10_amplitude), opt(gamma), turnover=turnover, f0=f0, beta=beta,
        power=power, user_spectrum=opt(user_spectrum),
    )
    # sqrt(C) with the DC and Nyquist bins zeroed (a 0/1 mask, so folding
    # it into the scale changes no value)
    weight = torch.sqrt(residual_psd_coeff(hcf, f, dur, howml))
    weight[0] = 0.0
    weight[-1] = 0.0
    res_re = torch.matmul(M, eps[..., 0, :, :]) * weight
    res_im = torch.matmul(M, eps[..., 1, :, :]) * weight
    if synthesis == "auto":
        synthesis = "matmul" if npts + 10 < 2 * nf - 2 else "fft"
    if synthesis == "matmul":
        cos_m, sin_m = _synthesis_tensors(nf, npts, dtype, batch.device)
        grid_series = (res_re @ cos_m - res_im @ sin_m) * (2.0 / ((2 * nf - 2) * dt_grid))
    elif synthesis == "fft":
        res_t = torch.fft.irfft(
            torch.complex(res_re, res_im), n=2 * nf - 2, dim=-1
        ) / dt_grid
        grid_series = res_t[..., 10:npts + 10]
    else:
        raise ValueError(f"unknown GWB synthesis {synthesis!r}")
    return uniform_grid_interp(batch.toas_s, ut[0], ut[-1], grid_series) * batch.mask


def cw_catalog_planes_for(batch: PulsarBatch, gwtheta, gwphi, mc, dist, fgw,
                          phase0, psi, inc, pdist=1.0, pphase=None,
                          evolve: bool = True, phase_approx: bool = False,
                          tref_s: float = 0.0):
    """Epoch-folded CW coefficient planes for this batch: ``(src (NC_SRC,
    Ns), psr (NC_PSR, Np, Ns), evolve)`` on the batch's device in its
    dtype, built in float64 on the host and cast last. The returned
    ``evolve`` is the flag the response must branch on."""
    host = lambda x: np.asarray(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64
    )
    params = (gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc)
    t_fold = batch.tref_mjd * 86400.0 - tref_s + batch.start_s
    src, psr = cw_catalog_planes(
        host(batch.phat), *[np.atleast_1d(host(x)) for x in params],
        pdist=host(pdist), pphase=None if pphase is None else host(pphase),
        t_fold=t_fold, evolve=evolve, phase_approx=phase_approx,
    )
    return _as(src, batch), _as(psr, batch), evolve


def cgw_catalog_delays_from_planes(batch: PulsarBatch, src, psr, evolve: bool,
                                   psr_term: bool = True, chunk: int = 64):
    """Summed CW-catalog response from precomputed planes: the kernel on
    a CUDA batch, the plain version (``chunk`` sources per block) on a CPU
    batch. ``evolve`` must be the flag the planes were built with."""
    u = batch.toas_s - _as(batch.start_s, batch)
    out = cw_catalog_response(u, src, psr, psr_term=psr_term, evolve=evolve,
                              chunk=chunk)
    return out * batch.mask


def cgw_catalog_delays(batch: PulsarBatch, gwtheta, gwphi, mc, dist, fgw,
                       phase0, psi, inc, pdist=1.0, pphase=None,
                       psr_term: bool = True, evolve: bool = True,
                       phase_approx: bool = False, tref_s: float = 0.0,
                       chunk: int = 64):
    """Summed response of a CW-source catalog: float64 host planes, then
    :func:`cgw_catalog_delays_from_planes`. ``pdist`` (kpc) is a scalar,
    (Ns,) or (Np, Ns); ``pphase`` ((Ns,) or (Np, Ns)) overrides it with
    explicit pulsar-term phases. Deterministic: parameters are data."""
    src, psr, evolve = cw_catalog_planes_for(
        batch, gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc, pdist=pdist,
        pphase=pphase, evolve=evolve, phase_approx=phase_approx, tref_s=tref_s,
    )
    return cgw_catalog_delays_from_planes(
        batch, src, psr, evolve=evolve, psr_term=psr_term, chunk=chunk
    )


def cw_catalog_plane_tiles_for(batch: PulsarBatch, gwtheta, gwphi, mc, dist, fgw,
                               phase0, psi, inc, pdist=1.0, pphase=None,
                               evolve: bool = True, phase_approx: bool = False,
                               tref_s: float = 0.0, chunk: int = 65536):
    """Streaming twin of :func:`cw_catalog_planes_for`: a generator of host
    numpy plane tiles ``(src (NC_SRC, cs), psr (NC_PSR, Np, cs))`` of at
    most ``chunk`` sources, float64 host math per tile, cast on the host to
    the batch's dtype; each tile bit for bit the column slice of the whole
    catalog's planes (``ops/cw.py::cw_catalog_plane_tiles``)."""
    host = lambda x: np.asarray(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64
    )
    params = (gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc)
    t_fold = batch.tref_mjd * 86400.0 - tref_s + batch.start_s
    return cw_catalog_plane_tiles(
        host(batch.phat), *[np.atleast_1d(host(x)) for x in params],
        pdist=host(pdist), pphase=None if pphase is None else host(pphase),
        t_fold=t_fold, evolve=evolve, phase_approx=phase_approx, chunk=chunk,
        dtype=torch.empty((), dtype=batch.dtype).numpy().dtype,
    )


def cw_stream_response(batch: PulsarBatch, tiles, evolve: bool, psr_term: bool = True,
                       prefetch_depth: int = 2, tiles_per_step: int = 8,
                       stall_timeout_s=900.0, chunk: int = 64, stats=None):
    """Summed CW response (Np, Nt) from a stream of host plane tiles,
    staged ahead (``parallel/prefetch.py::prefetch_to_device``): the next
    macro tile is built and copied to the card on a worker thread while
    the current one is folded and launched into the (Np, Nt) accumulator
    (the kernel's accumulating launch, ``ops/cw.py``'s ``out=``). No stage
    holds more than ``prefetch_depth`` macro tiles, and the whole catalog's
    planes never exist, on the host or the card.

    ``tiles`` yields ``(src, psr)`` in catalog order
    (:func:`cw_catalog_plane_tiles_for`, or the cache of
    ``parallel/prefetch.py::load_plane_tiles``), all of one width except an
    optionally narrower last tile: the reference's contract, so the same
    inputs raise in both packages. ``tiles_per_step`` consecutive tiles
    make one macro: their source windows joined, one fold and one launch.

    On the card the result is bit for bit the monolithic kernel's, at any
    tile width (each thread sums source by source in catalog order). On
    the CPU the plain version sums ``chunk`` sources a block, from the
    running sum: bit for bit the monolithic plain response when the tile
    width is a multiple of ``chunk``. The reference computes this path
    with its scan backend (``_cw_tile_response``); the port runs B.1,
    which computes the same function. ``stats`` receives the prefetcher's
    stats (the worker's build-and-stage seconds, the consumer's wait).
    Runs under a ``cw_stream_response`` span; the ``cw_stream.tiles_done``
    gauge counts the tiles launched (host counts, no readback)."""
    from ..obs import gauge, names, span
    from ..parallel.prefetch import prefetch_to_device

    if tiles_per_step < 1:
        raise ValueError(f"tiles_per_step must be >= 1 (got {tiles_per_step})")
    width = [None]  # set by the stream's first tile
    macro_tiles = []  # tiles joined into each macro, appended by the worker

    def macros():
        """Join ``tiles_per_step`` tiles per macro (on the prefetch worker,
        so the copy overlaps the card)."""
        buf_s, buf_p = [], []
        tail_seen = False
        for src, psr in tiles:
            src, psr = np.asarray(src), np.asarray(psr)
            if width[0] is None:
                width[0] = src.shape[-1]
            if tail_seen or src.shape[-1] > width[0]:
                raise ValueError(
                    f"plane tile of width {src.shape[-1]} after the stream established "
                    f"width {width[0]}; tiles must be uniform with an optional narrower "
                    "LAST tile"
                )
            tail_seen = src.shape[-1] < width[0]
            buf_s.append(src)
            buf_p.append(psr)
            if len(buf_s) == tiles_per_step:
                macro_tiles.append(len(buf_s))
                yield np.concatenate(buf_s, axis=-1), np.concatenate(buf_p, axis=-1)
                buf_s, buf_p = [], []
        if buf_s:
            macro_tiles.append(len(buf_s))
            yield np.concatenate(buf_s, axis=-1), np.concatenate(buf_p, axis=-1)

    u = batch.toas_s - _as(batch.start_s, batch)
    acc = torch.zeros_like(batch.toas_s)
    with span(names.SPAN_CW_STREAM_RESPONSE, depth=prefetch_depth) as sp:
        # the gauge counts tiles, not macros (the unit of the JAX package's)
        gauge(names.CW_STREAM_TILES_DONE).set(0)
        nmacros = ntiles = 0
        for src, psr in prefetch_to_device(macros(), depth=prefetch_depth,
                                           device=batch.device,
                                           stall_timeout_s=stall_timeout_s, stats=stats):
            acc = cw_catalog_response(u, src, psr, psr_term=psr_term, evolve=evolve,
                                      chunk=chunk, out=acc)
            ntiles += macro_tiles[nmacros]
            nmacros += 1
            gauge(names.CW_STREAM_TILES_DONE).set(ntiles)
        sp["macros"] = nmacros
        sp["tiles"] = ntiles
        sp["tiles_per_step"] = tiles_per_step
    # the streamed accumulator's health (site cw.stream_tile; identity,
    # and nothing read, while the observatory is disarmed)
    from ..obs import numerics

    return numerics.probe("cw.stream_tile", acc * batch.mask)


def cgw_catalog_delays_streamed(batch: PulsarBatch, gwtheta, gwphi, mc, dist, fgw,
                                phase0, psi, inc, pdist=1.0, pphase=None,
                                psr_term: bool = True, evolve: bool = True,
                                phase_approx: bool = False, tref_s: float = 0.0,
                                chunk: int = 65536, prefetch_depth: int = 2,
                                tiles_per_step: int = 8, stall_timeout_s=900.0,
                                plain_chunk: int = 64, stats=None):
    """Summed CW-catalog response through the streamed pipeline: tiled
    float64 host planes, prefetched to the card, accumulated by the
    kernel; host and device memory O(Np x chunk x tiles_per_step). On the
    card bit for bit :func:`cgw_catalog_delays`; on the CPU, when
    ``chunk`` is a multiple of ``plain_chunk`` (the plain version's block
    of sources)."""
    tiles = cw_catalog_plane_tiles_for(
        batch, gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc, pdist=pdist,
        pphase=pphase, evolve=evolve, phase_approx=phase_approx, tref_s=tref_s,
        chunk=chunk,
    )
    return cw_stream_response(batch, tiles, evolve=evolve, psr_term=psr_term,
                              prefetch_depth=prefetch_depth, tiles_per_step=tiles_per_step,
                              stall_timeout_s=stall_timeout_s, chunk=plain_chunk,
                              stats=stats)


def _batch_antenna(gwtheta, gwphi, phat):
    """F+, Fx of one source direction against every pulsar: (Np,) each,
    from :func:`~.cgw.principal_axes` on tensors in ``phat``'s dtype."""
    m, n, omhat = principal_axes(gwtheta, gwphi)
    mp, np_, op = phat @ m, phat @ n, phat @ omhat
    return 0.5 * (mp**2 - np_**2) / (1.0 + op), mp * np_ / (1.0 + op)


def gw_memory_delays(batch: PulsarBatch, strain, gwtheta, gwphi, bwm_pol, t0_mjd):
    """Burst with memory across the array: the polarization-projected
    strain ramp from epoch ``t0_mjd``, one masked (Np, Nt) ramp (the
    reference's per-TOA loop, written out)."""
    fplus, fcross = _batch_antenna(_as(gwtheta, batch), _as(gwphi, batch), batch.phat)
    pol = _as(bwm_pol, batch)
    proj = torch.cos(2.0 * pol) * fplus + torch.sin(2.0 * pol) * fcross
    t0_s = (_as(t0_mjd, batch) - batch.tref_mjd) * 86400.0
    ramp = torch.clamp(batch.toas_s - t0_s, min=0.0)
    return _as(strain, batch) * proj[:, None] * ramp * batch.mask


def burst_delays(batch: PulsarBatch, gwtheta, gwphi, hplus_grid, hcross_grid,
                 grid_start_s, grid_stop_s, psi=0.0):
    """Elliptically polarized burst across the array. The waveforms arrive
    pre-sampled on a uniform (G,) grid over [grid_start_s, grid_stop_s]
    (seconds from the batch epoch), are rotated by ``psi``, projected on
    each pulsar's antenna pattern and interpolated onto its TOAs
    (:func:`uniform_grid_interp`); zero outside the window."""
    hp, hc = _as(hplus_grid, batch), _as(hcross_grid, batch)
    psi = _as(psi, batch)
    c2, s2 = torch.cos(2.0 * psi), torch.sin(2.0 * psi)
    rp, rc = hp * c2 - hc * s2, hp * s2 + hc * c2
    fplus, fcross = _batch_antenna(_as(gwtheta, batch), _as(gwphi, batch), batch.phat)
    series = -fplus[:, None] * rp[None, :] - fcross[:, None] * rc[None, :]
    start, stop = _as(grid_start_s, batch), _as(grid_stop_s, batch)
    out = uniform_grid_interp(batch.toas_s, start, stop, series)
    inside = (batch.toas_s >= start) & (batch.toas_s <= stop)
    return torch.where(inside, out, 0.0) * batch.mask


def transient_delays(batch: PulsarBatch, psr_index: int, waveform_grid,
                     grid_start_s, grid_stop_s):
    """An un-projected transient in pulsar ``psr_index`` alone (glitch-like),
    pre-sampled as in :func:`burst_delays`: (Np, Nt), zero in every other
    row and outside the window."""
    if not 0 <= psr_index < batch.npsr:
        raise ValueError(
            f"transient_psr={psr_index} is outside the batch's {batch.npsr} pulsars"
        )
    t = batch.toas_s[psr_index]
    start, stop = _as(grid_start_s, batch), _as(grid_stop_s, batch)
    row = uniform_grid_interp(t, start, stop, _as(waveform_grid, batch))
    inside = (t >= start) & (t <= stop)
    out = torch.zeros_like(batch.toas_s)
    out[psr_index] = torch.where(inside, row, 0.0) * batch.mask[psr_index]
    return out


# ------------------------------------------------------------------ recipes

#: Recipe fields that hold arrays; they become tensors at construction
ARRAY_FIELDS = (
    "efac", "log10_equad", "log10_ecorr", "rn_log10_amplitude", "rn_gamma",
    "rn_modes", "rn_fmin", "rn_fmax", "rn_tspan_s", "chrom_log10_amplitude",
    "chrom_gamma", "chrom_index", "gwb_log10_amplitude", "gwb_gamma",
    "orf_cholesky", "gwb_user_spectrum", "cgw_params", "cgw_pdist",
    "cgw_pphase", "gwm_params", "burst_sky", "burst_hplus", "burst_hcross",
    "burst_grid", "transient_waveform", "transient_grid", "cov_log10_sigma",
    "fit_design",
)

@dataclass(frozen=True)
class Recipe:
    """Which signals to inject, with their (possibly per-backend) params.

    Array fields are tensors (array-likes are converted at construction)
    and keep their own dtype: each op casts them to the batch's dtype at
    use, and the CW parameters reach the host plane build in float64.
    ``to()`` and ``astype()`` move and cast every one, ``fit_design``
    included.
    """

    efac: Optional[torch.Tensor] = None
    log10_equad: Optional[torch.Tensor] = None
    log10_ecorr: Optional[torch.Tensor] = None
    rn_log10_amplitude: Optional[torch.Tensor] = None
    rn_gamma: Optional[torch.Tensor] = None
    #: explicit red-noise mode frequencies [Hz] (overrides rn_nmodes)
    rn_modes: Optional[torch.Tensor] = None
    #: red-noise frequency-grid bounds [Hz] (scalar or (Np,))
    rn_fmin: Optional[torch.Tensor] = None
    rn_fmax: Optional[torch.Tensor] = None
    #: common red-noise Tspan override [s] (scalar or (Np,))
    rn_tspan_s: Optional[torch.Tensor] = None
    #: chromatic red noise: amplitude at chrom_ref_freq_mhz, scaled per
    #: TOA by (ref/freq)^chrom_index (2.0 when unset)
    chrom_log10_amplitude: Optional[torch.Tensor] = None
    chrom_gamma: Optional[torch.Tensor] = None
    chrom_index: Optional[torch.Tensor] = None
    gwb_log10_amplitude: Optional[torch.Tensor] = None
    gwb_gamma: Optional[torch.Tensor] = None
    #: Cholesky factor of the ORF; None = uncorrelated common process
    orf_cholesky: Optional[torch.Tensor] = None
    #: (F, 2) [freq_hz, hc] user characteristic-strain spectrum; overrides
    #: the power law (gwb_log10_amplitude/gwb_gamma) when set
    gwb_user_spectrum: Optional[torch.Tensor] = None
    #: turnover-spectrum shape (used when gwb_turnover is set)
    gwb_f0: float = 1e-9
    #: Fourier modes of the GWB auto-term block of the GP noise model
    #: (gls_noise_model): the injected GWB weighted like a red-noise
    #: process with prior hc^2(f) / (12 pi^2 f^3 T)
    gwb_gls_nmodes: int = 30
    gwb_beta: float = 1.0
    gwb_power: float = 1.0
    #: (8, Ns) CW catalog (gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc)
    cgw_params: Optional[torch.Tensor] = None
    #: CW-catalog pulsar distances [kpc]: scalar, (Ns,) or (Np, Ns)
    cgw_pdist: Optional[torch.Tensor] = None
    #: explicit CW-catalog pulsar-term phases ((Ns,) or (Np, Ns))
    cgw_pphase: Optional[torch.Tensor] = None
    #: (5,) burst with memory (strain, gwtheta, gwphi, bwm_pol, t0_mjd)
    gwm_params: Optional[torch.Tensor] = None
    #: (3,) burst sky/polarization (gwtheta, gwphi, psi), its (G,)
    #: pre-sampled waveforms and the (2,) [start_s, stop_s] grid window
    burst_sky: Optional[torch.Tensor] = None
    burst_hplus: Optional[torch.Tensor] = None
    burst_hcross: Optional[torch.Tensor] = None
    burst_grid: Optional[torch.Tensor] = None
    #: (G,) single-pulsar transient waveform on the (2,) grid window,
    #: injected into pulsar ``transient_psr``
    transient_waveform: Optional[torch.Tensor] = None
    transient_grid: Optional[torch.Tensor] = None
    noise_cov: Optional[object] = None
    cov_log10_sigma: Optional[torch.Tensor] = None

    tnequad: bool = False
    gwb_turnover: bool = False
    rn_nmodes: int = 30
    rn_logf: bool = False
    rn_pshift: bool = False
    rn_libstempo: bool = False
    chrom_nmodes: int = 30
    chrom_ref_freq_mhz: float = 1400.0
    gwb_npts: int = 600
    gwb_howml: float = 10.0
    cgw_tref_s: float = 0.0
    #: sources per block of the plain CW response (CPU batches)
    cgw_chunk: int = 512
    #: sources per plane tile of the streamed CW catalog
    #: (cgw_catalog_delays_streamed); None builds the whole catalog's
    #: planes at once. On the card both give the same bits; on the CPU
    #: when it is a multiple of cgw_chunk
    cgw_stream_chunk: Optional[int] = None
    #: macro tiles the streamed catalog stages ahead (2: double buffering)
    cgw_prefetch_depth: int = 2
    cgw_psr_term: bool = True
    cgw_evolve: bool = True
    cgw_phase_approx: bool = False
    #: (Np, Nt, K) full-model design of the per-realization refit, padded
    #: with all-zero columns; None fits the quadratic
    fit_design: Optional[torch.Tensor] = None
    #: weight the design refit by the recipe's own noise model (GLS,
    #: gls_fit_subtract) instead of the white errors (WLS)
    fit_gls: bool = False
    #: the pulsar the transient is injected into
    transient_psr: int = 0

    def __post_init__(self):
        for name in ARRAY_FIELDS:
            value = getattr(self, name)
            if value is not None and not isinstance(value, torch.Tensor):
                object.__setattr__(self, name, torch.as_tensor(np.array(value)))
        _validate_recipe(self)

    def to(self, device) -> "Recipe":
        """Move every tensor, the ``noise_cov`` op's too, to ``device``."""
        out = _map_tensors(self, lambda x: x.to(device))
        if self.noise_cov is None:
            return out
        return dataclasses.replace(out, noise_cov=self.noise_cov.to(device))

    def astype(self, dtype) -> "Recipe":
        """Cast the floating tensors, the ``noise_cov`` op's too, to
        ``dtype``."""
        out = _map_tensors(
            self, lambda x: x.to(dtype) if x.is_floating_point() else x
        )
        if self.noise_cov is None:
            return out
        return dataclasses.replace(out, noise_cov=self.noise_cov.astype(dtype))


#: the fields a burst needs together
BURST_FIELDS = ("burst_sky", "burst_hplus", "burst_hcross", "burst_grid")


def _validate_recipe(r: Recipe):
    """Reject mutually inconsistent fields at construction, with a message
    naming the field: the reference's checks, on shapes only (no value is
    read back from the card)."""

    def need(cond: bool, msg: str):
        if not cond:
            raise ValueError(f"Recipe: {msg}")

    present = tuple(f for f in BURST_FIELDS if getattr(r, f) is not None)
    need(
        len(present) in (0, len(BURST_FIELDS)),
        f"a burst needs all of {BURST_FIELDS}, got only {present} (the "
        "sky/polarization triple, both pre-sampled waveforms, and the "
        "[start_s, stop_s] grid window travel together)",
    )
    need(
        (r.transient_waveform is None) == (r.transient_grid is None),
        "transient_waveform and transient_grid travel together (the "
        "pre-sampled waveform is meaningless without its [start_s, stop_s] "
        "grid window, and vice versa)",
    )

    need(
        r.cgw_params is not None or (r.cgw_pdist is None and r.cgw_pphase is None),
        "cgw_pdist/cgw_pphase describe the pulsar term of a CW catalog "
        "— set cgw_params too (or drop them)",
    )
    need(
        r.rn_gamma is not None or r.rn_log10_amplitude is None,
        "red noise needs rn_gamma alongside rn_log10_amplitude",
    )
    need(
        r.chrom_gamma is not None or r.chrom_log10_amplitude is None,
        "chromatic noise needs chrom_gamma alongside chrom_log10_amplitude",
    )
    need(
        r.gwb_log10_amplitude is None or r.gwb_gamma is not None
        or r.gwb_user_spectrum is not None,
        "a power-law GWB needs gwb_gamma alongside gwb_log10_amplitude "
        "(or a gwb_user_spectrum, which overrides the power law)",
    )
    need(
        r.cov_log10_sigma is None or r.noise_cov is not None,
        "cov_log10_sigma scales the correlated-noise block — set "
        "noise_cov too (covariance.structure builders), or drop it",
    )
    need(
        r.noise_cov is None or isinstance(r.noise_cov, CovOp),
        "noise_cov must be a pta_replicator_tpu_torch.covariance CovOp (carry "
        "one across from the JAX package with convert.covop_from_arrays), "
        f"got {type(r.noise_cov).__name__}",
    )
    if r.cgw_params is not None:
        shape = tuple(r.cgw_params.shape)
        need(
            len(shape) == 2 and shape[0] == 8,
            "cgw_params must be the (8, Ns) stacked catalog (gwtheta, gwphi, "
            f"mc, dist, fgw, phase0, psi, inc), got shape {shape}",
        )
        for name in ("cgw_pdist", "cgw_pphase"):
            value = getattr(r, name)
            if value is not None and value.ndim >= 1:
                need(
                    value.ndim <= 2 and value.shape[-1] == shape[1],
                    f"{name} has shape {tuple(value.shape)} but the catalog "
                    f"has {shape[1]} source(s); pass a scalar, (Ns,), or (Np, Ns)",
                )
    for name, want in (("gwm_params", (5,)), ("burst_sky", (3,)),
                       ("burst_grid", (2,)), ("transient_grid", (2,))):
        value = getattr(r, name)
        if value is not None:
            need(tuple(value.shape) == want,
                 f"{name} must have shape {want}, got {tuple(value.shape)}")
    if r.gwb_user_spectrum is not None:
        shape = tuple(r.gwb_user_spectrum.shape)
        need(len(shape) == 2 and shape[1] == 2 and shape[0] >= 2,
             f"gwb_user_spectrum must be (F, 2) [freq_hz, hc] with F >= 2, got {shape}")
    if r.fit_design is not None:
        need(r.fit_design.ndim == 3,
             f"fit_design must be the (Np, Nt, K) design, got shape {tuple(r.fit_design.shape)}")
    need(isinstance(r.transient_psr, (int, np.integer)) and not isinstance(r.transient_psr, bool)
         and r.transient_psr >= 0,
         f"transient_psr must be an int >= 0, got {r.transient_psr!r}")


# --------------------------------------------------------------- the engine

def _red_nmodes(recipe: Recipe) -> int:
    return recipe.rn_nmodes if recipe.rn_modes is None else len(recipe.rn_modes)


def _gwb_enabled(recipe: Recipe) -> bool:
    """The GWB is on with a power-law amplitude or a user spectrum."""
    return recipe.gwb_log10_amplitude is not None or recipe.gwb_user_spectrum is not None


def noise_shapes(batch: PulsarBatch, recipe: Recipe) -> dict:
    """Shape of one realization's draw of each enabled stochastic family,
    in the order :func:`draw_noise` draws them. ``red_phase`` (uniform on
    [0, 2 pi)) exists only with ``rn_pshift``; every other entry is
    standard normal."""
    shapes = {}
    if recipe.efac is not None or recipe.log10_equad is not None:
        shapes["white"] = (batch.npsr, batch.ntoa_max)
    if recipe.log10_ecorr is not None:
        shapes["ecorr"] = (batch.npsr, batch.max_epochs)
    if recipe.rn_log10_amplitude is not None:
        if recipe.rn_pshift:
            shapes["red_phase"] = (batch.npsr, _red_nmodes(recipe))
        shapes["red"] = (batch.npsr, 2 * _red_nmodes(recipe))
    if recipe.chrom_log10_amplitude is not None:
        shapes["chromatic"] = (batch.npsr, 2 * recipe.chrom_nmodes)
    if _gwb_enabled(recipe):
        nf = gwb_grid(batch.start_s, batch.stop_s, recipe.gwb_npts, recipe.gwb_howml)[2].shape[0]
        ncol = batch.npsr if recipe.orf_cholesky is None else recipe.orf_cholesky.shape[1]
        shapes["gwb"] = (2, ncol, nf)
    if recipe.noise_cov is not None:
        # drawn last, so that every other family's stream is unchanged
        op = recipe.noise_cov
        if (op.npsr, op.ntoa) != (batch.npsr, batch.ntoa_max):
            raise ValueError(
                f"noise_cov covers {op.npsr} pulsars x {op.ntoa} TOAs but the batch "
                f"is {batch.npsr} x {batch.ntoa_max}"
            )
        shapes.update(op.draw_shapes())
    return shapes


def draw_noise(generator, batch: PulsarBatch, recipe: Recipe, nreal: int,
               noise=None) -> dict:
    """Every enabled family's draws for ``nreal`` realizations, each with
    a leading ``nreal`` axis (shapes: :func:`noise_shapes`).

    A family present in ``noise`` is taken from it (cast to the batch's
    dtype and device, shape-checked); the others are drawn from
    ``generator``, one call per family, in this fixed order: white, ecorr,
    red_phase, red, chromatic, gwb, cov, cov_lowrank."""
    noise = noise or {}
    unknown = set(noise) - set(noise_shapes(batch, recipe))
    if unknown:
        raise ValueError(f"noise has draws for families the recipe does not enable: {sorted(unknown)}")
    draws = {}
    for name, shape in noise_shapes(batch, recipe).items():
        shape = (nreal,) + shape
        if name in noise:
            draw = _as(noise[name], batch)
            if tuple(draw.shape) != shape:
                raise ValueError(f"noise[{name!r}] has shape {tuple(draw.shape)}, want {shape}")
        elif name == "red_phase":
            if generator is None:
                raise ValueError("no red_phase draws were given and no torch.Generator")
            draw = 2.0 * math.pi * torch.rand(
                shape, generator=generator, dtype=batch.dtype, device=batch.device
            )
        else:
            draw = _normal(generator, shape, batch)
        draws[name] = draw
    return draws


#: Recipe fields whose leading axis is the pulsar axis when they have one
#: (the JAX package's ``parallel/mesh.py::_PSR_MAJOR_RECIPE_FIELDS``, with
#: the port's ``cov_log10_sigma``): a pulsar window slices them. By name,
#: not by shape: an unrelated leaf whose leading size happens to equal
#: the pulsar count (``rn_modes``, the (8, Ns) catalog) is not sliced
PSR_MAJOR_RECIPE_FIELDS = frozenset({
    "efac", "log10_equad", "log10_ecorr", "rn_log10_amplitude", "rn_gamma", "rn_fmin",
    "rn_fmax", "rn_tspan_s", "chrom_log10_amplitude", "chrom_gamma", "chrom_index",
    "orf_cholesky", "fit_design", "cov_log10_sigma",
})
#: per pulsar only in their (Np, Ns) form; (Ns,) and scalars are common
PSR_MAJOR_IF_2D_FIELDS = frozenset({"cgw_pdist", "cgw_pphase"})


def recipe_window(recipe: Recipe, batch: PulsarBatch, start: int, stop: int) -> Recipe:
    """The recipe of pulsars ``start:stop`` of ``batch`` (the whole
    array's), beside :meth:`PulsarBatch.window`: per-pulsar fields sliced,
    the ``noise_cov`` op windowed, the ORF factor cut to its rows (all of
    its columns stay: the GWB mix of a window is the window's rows of the
    whole draw's mix). An uncorrelated GWB gets the whole array's
    ``sqrt(2) I`` factor first, so that a window mixes its own columns.
    Raises on a per-pulsar field whose leading size is not the pulsar
    count."""
    npsr = batch.npsr
    changes = {}
    for name in PSR_MAJOR_RECIPE_FIELDS | PSR_MAJOR_IF_2D_FIELDS:
        value = getattr(recipe, name)
        if value is None or value.ndim == 0 or (name in PSR_MAJOR_IF_2D_FIELDS and value.ndim != 2):
            continue
        if value.shape[0] != npsr:
            raise ValueError(f"Recipe.{name} has leading dim {value.shape[0]}, expected "
                             f"npsr={npsr} for a pulsar window")
        changes[name] = value[start:stop]
    if _gwb_enabled(recipe) and recipe.orf_cholesky is None:
        eye = torch.eye(npsr, dtype=batch.dtype, device=batch.device)
        changes["orf_cholesky"] = (math.sqrt(2.0) * eye)[start:stop]
    if recipe.noise_cov is not None:
        if recipe.noise_cov.npsr != npsr:
            raise ValueError(f"noise_cov covers {recipe.noise_cov.npsr} pulsars, expected "
                             f"npsr={npsr} for a pulsar window")
        changes["noise_cov"] = recipe.noise_cov.window(start, stop)
    return dataclasses.replace(recipe, **changes)


def draws_window(draws: dict, real: tuple, psr: tuple) -> dict:
    """Realizations ``real`` = (start, stop) and pulsars ``psr`` of a
    chunk's draws (:func:`draw_noise`), as views: every family is per
    pulsar on axis 1 except the GWB's ``(R, 2, Ncol, nf)`` spectra, which
    a pulsar window keeps whole (its mix takes the window's rows of the
    ORF factor, :func:`recipe_window`)."""
    (r0, r1), (p0, p1) = real, psr
    return {name: x[r0:r1] if name == "gwb" else x[r0:r1, p0:p1] for name, x in draws.items()}


def realization_delays(batch: PulsarBatch, recipe: Recipe, draws: dict):
    """(..., Np, Nt) summed stochastic delays of the enabled families,
    from explicit ``draws`` (:func:`draw_noise`), whose leading axes are
    the realization axes.

    Each family's output passes through an identity probe
    (``obs/numerics.py::probe_realizations``, sites ``realization.white``,
    ``.ecorr``, ``.red``, ``.chromatic``, ``.gwb``, ``.covariance``), so an
    overflow is named at the family that produced it. Disarmed the probe
    returns its argument; inside ``realize`` it reads nothing."""
    from ..obs import numerics

    probe = numerics.probe_realizations
    total = torch.zeros_like(batch.toas_s)
    if recipe.efac is not None or recipe.log10_equad is not None:
        total = total + probe("realization.white", white_noise_delays(
            None, batch, efac=recipe.efac if recipe.efac is not None else 1.0,
            log10_equad=recipe.log10_equad, tnequad=recipe.tnequad,
            eps=draws["white"],
        ))
    if recipe.log10_ecorr is not None:
        total = total + probe("realization.ecorr", jitter_delays(
            None, batch, recipe.log10_ecorr, eps=draws["ecorr"]))
    if recipe.rn_log10_amplitude is not None:
        total = total + probe("realization.red", red_noise_delays(
            None, batch, recipe.rn_log10_amplitude, recipe.rn_gamma,
            nmodes=recipe.rn_nmodes, modes=recipe.rn_modes, logf=recipe.rn_logf,
            fmin=recipe.rn_fmin, fmax=recipe.rn_fmax,
            phase_shift=draws.get("red_phase"),
            libstempo_convention=recipe.rn_libstempo,
            tspan_s=recipe.rn_tspan_s, eps=draws["red"],
        ))
    if recipe.chrom_log10_amplitude is not None:
        total = total + probe("realization.chromatic", chromatic_noise_delays(
            None, batch, recipe.chrom_log10_amplitude, recipe.chrom_gamma,
            chromatic_index=(recipe.chrom_index if recipe.chrom_index is not None else 2.0),
            nmodes=recipe.chrom_nmodes, ref_freq_mhz=recipe.chrom_ref_freq_mhz,
            eps=draws["chromatic"],
        ))
    if _gwb_enabled(recipe):
        if recipe.orf_cholesky is None:
            # uncorrelated common process: ORF = 2 I
            orf_chol = math.sqrt(2.0) * torch.eye(batch.npsr, dtype=batch.dtype, device=batch.device)
        else:
            orf_chol = recipe.orf_cholesky
        total = total + probe("realization.gwb", gwb_delays(
            None, batch, recipe.gwb_log10_amplitude, recipe.gwb_gamma, orf_chol,
            npts=recipe.gwb_npts, howml=recipe.gwb_howml,
            turnover=recipe.gwb_turnover, f0=recipe.gwb_f0,
            beta=recipe.gwb_beta, power=recipe.gwb_power,
            user_spectrum=recipe.gwb_user_spectrum, eps=draws["gwb"],
        ))
    if recipe.noise_cov is not None:
        sample = recipe.noise_cov.sample(draws, s2=recipe_cov_s2(recipe, batch.dtype))
        total = total + probe("realization.covariance", sample.to(batch.dtype) * batch.mask)
    return total


#: a card's last-axis sums (:func:`row_sums`): the fewest rows, and the
#: row stride's multiple in elements (16 bytes of float32)
SUM_MIN_ROWS, SUM_ROW_ALIGN = 16, 4


def row_sums(x, weight=None):
    """``(x * weight).sum(-1, keepdim=True)`` (``weight`` broadcast; None:
    ``x.sum``), each row summed in an order fixed by the row's length alone.

    On a card PyTorch's reduction lays its lanes out by the row count below
    16 rows and shifts each row by its start's 16-byte alignment, so a
    window of pulsars or realizations (a mesh shard) would round its sums
    unlike the whole array's. There the rows are written into a buffer of
    at least ``SUM_MIN_ROWS`` rows, each starting 16-byte aligned, and
    summed from it; the order then holds for rows shorter than 32,768
    entries (longer rows split across blocks by the row count). On the CPU
    it is the plain sum."""
    shape = x.shape if weight is None else torch.broadcast_shapes(x.shape, weight.shape)
    if x.device.type != "cuda":
        return (x if weight is None else x * weight).sum(-1, keepdim=True)
    n, rows = shape[-1], math.prod(shape[:-1])
    buf = torch.empty((max(rows, SUM_MIN_ROWS), -(-n // SUM_ROW_ALIGN) * SUM_ROW_ALIGN),
                      dtype=torch.result_type(x, weight) if weight is not None else x.dtype,
                      device=x.device)[:, :n]
    body = buf[:rows].view(shape)
    if weight is None:
        body.copy_(x)
    else:
        torch.mul(x, weight, out=body)
    buf[rows:].zero_()
    return buf.sum(-1)[:rows].view(shape[:-1] + (1,))


def residualize(delays, batch: PulsarBatch):
    """Delays -> residuals: subtract the per-pulsar error-weighted mean
    over valid TOAs (:func:`row_sums`, so a mesh shard's means are the
    whole array's, bit for bit)."""
    w = batch.mask / batch.errors_s**2
    mean = row_sums(delays, w) / row_sums(w)
    return (delays - mean) * batch.mask


def quadratic_design(batch: PulsarBatch):
    """(Np, Nt, 3) quadratic timing design [1, t/T, (t/T)^2] per pulsar:
    the columns :func:`quadratic_fit_subtract` projects out, and the
    design a likelihood of fitted residuals marginalizes."""
    t = batch.toas_s / torch.clamp(batch.tspan_s[:, None], min=1.0)
    return torch.stack([torch.ones_like(t), t, t**2], dim=-1)


def quadratic_fit_subtract(delays, batch: PulsarBatch):
    """Project out the weighted best-fit quadratic in time per pulsar (the
    batched analog of the post-injection F0/F1 refit).

    The products run in IEEE float32 on a float32 batch: a reduced-precision
    fit (TF32 here, bf16 on the TPU) leaves a visible un-projected mean
    (:func:`realize` refuses TF32). The (Np, 3, 3) Gram matrix depends only
    on the batch and is formed in float64, cast last: cuBLAS's float32
    accumulation over 7,758 TOAs put ~6e-5 of relative error on it on an
    H100, which the solve turned into a weighted residual mean of ~3e-3 of
    the residual RMS. The solve does not check for a singular Gram matrix
    (that would wait for the card); a pulsar with fewer than three TOAs
    gets non-finite residuals, as in the reference."""
    M = quadratic_design(batch)
    w = batch.mask / batch.errors_s**2
    Mw = M * w[..., None]
    MtWM = torch.einsum("pni,pnj->pij", Mw.double(), M.double()).to(delays.dtype)
    MtWr = torch.einsum("pni,...pn->...pi", Mw, delays)
    coef = torch.linalg.solve_ex(MtWM, MtWr[..., None])[0][..., 0]
    model = torch.einsum("pni,...pi->...pn", M, coef)
    return (delays - model) * batch.mask


def finalize_residuals(delays, batch: PulsarBatch, recipe: Recipe, fit: bool,
                       system=None):
    """Fit (``fit``) and residualize: the shared tail of every realization.

    With ``recipe.fit_design`` the fit is the design refit, WLS or, with
    ``recipe.fit_gls``, GLS weighted by the recipe's own noise model, then
    the weighted-mean subtraction (a design need not span a constant).
    ``system`` is its assembled :class:`FitSystem` (:func:`fit_system`),
    built here when not given, and refused when it was built for another
    kind of fit or another design shape. Without a design it is the quadratic fit,
    after which no mean subtraction is needed: the constant column absorbs
    it. Leading axes of ``delays`` are realizations; the GLS fit's C0 solve
    takes them as right-hand sides of one launch."""
    if not fit:
        return residualize(delays, batch)
    if recipe.fit_design is not None:
        if system is None:
            system = fit_system(batch, recipe, dtype=delays.dtype)
        else:
            system.require_fits(recipe)
        return residualize(system.subtract(delays), batch)
    return quadratic_fit_subtract(delays, batch)


def deterministic_delays(batch: PulsarBatch, recipe: Recipe, device="cuda"):
    """Realization-independent delays (the CW catalog, then a burst with
    memory, a burst and a transient, in the reference's order), computed
    once per batch and shared by every realization: (Np, Nt) on
    ``device``. With ``recipe.cgw_stream_chunk`` the catalog goes through
    the streamed pipeline (:func:`cgw_catalog_delays_streamed`)."""
    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)
    total = torch.zeros_like(batch.toas_s)
    if recipe.cgw_params is not None:
        kwargs = dict(
            pdist=recipe.cgw_pdist if recipe.cgw_pdist is not None else 1.0,
            pphase=recipe.cgw_pphase, psr_term=recipe.cgw_psr_term,
            evolve=recipe.cgw_evolve, phase_approx=recipe.cgw_phase_approx,
            tref_s=recipe.cgw_tref_s,
        )
        params = recipe.cgw_params.cpu().unbind(0)
        if recipe.cgw_stream_chunk is not None:
            # the streamed pipeline: tiled host planes, staged ahead, one
            # accumulating launch per macro tile
            total = total + cgw_catalog_delays_streamed(
                batch, *params, chunk=recipe.cgw_stream_chunk,
                prefetch_depth=recipe.cgw_prefetch_depth,
                plain_chunk=recipe.cgw_chunk, **kwargs,
            )
        else:
            total = total + cgw_catalog_delays(batch, *params, chunk=recipe.cgw_chunk,
                                               **kwargs)
    if recipe.gwm_params is not None:
        total = total + gw_memory_delays(batch, *recipe.gwm_params.unbind(0))
    if recipe.burst_sky is not None:
        sky, grid = recipe.burst_sky, recipe.burst_grid
        total = total + burst_delays(batch, sky[0], sky[1], recipe.burst_hplus,
                                     recipe.burst_hcross, grid[0], grid[1], psi=sky[2])
    if recipe.transient_waveform is not None:
        grid = recipe.transient_grid
        total = total + transient_delays(batch, int(recipe.transient_psr),
                                         recipe.transient_waveform, grid[0], grid[1])
    return total


def realize_block(draws: dict, batch: PulsarBatch, recipe: Recipe, fit: bool,
                  static, nreal: int, system=None):
    """The per-block pipeline: ``realization_delays + static ->
    finalize_residuals`` for ``nreal`` realizations of ``draws``, the
    realizations leading (``system``: the design refit's assembly)."""
    delays = realization_delays(batch, recipe, draws) + static
    delays = delays.expand((nreal,) + batch.toas_s.shape)
    return finalize_residuals(delays, batch, recipe, fit, system=system)


def _require_ieee_float32(device: torch.device):
    """The GWB mix and synthesis and the fits (quadratic, WLS and GLS) are
    float32 matmuls that must run in IEEE float32 (the port runs no cuDNN
    op, so only cuBLAS's TF32 switch matters)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul.allow_tf32): "
            "the GWB synthesis and the fits need IEEE float32 products; set "
            "the flag to False"
        )


def realize(generator, batch: PulsarBatch, recipe: Recipe, nreal: int,
            fit: bool = False, static=None, noise=None, device="cuda",
            system=None):
    """Batch of independent realizations: (nreal, Np, Nt) residuals on
    ``device``.

    Draws come from ``noise`` (a dict of per-family draws with a leading
    ``nreal`` axis, :func:`noise_shapes`) where given, else from
    ``generator`` (a ``torch.Generator`` on ``device``) in the fixed order
    of :func:`draw_noise`. ``static`` is a precomputed
    :func:`deterministic_delays` result and ``system`` a precomputed
    :func:`fit_system` (with ``fit`` and ``recipe.fit_design``): a caller
    that realizes in chunks computes both once and passes them to every
    chunk; without them each call builds its own, once. Returns without
    synchronizing; read the result back to wait for it (the numerics
    observatory's probes, armed, queue their stats without reading them:
    ``obs/numerics.py``'s collector mode)."""
    device = resolve_device(device)
    _require_ieee_float32(device)
    batch, recipe = batch.to(device), recipe.to(device)
    if static is None:
        static = deterministic_delays(batch, recipe, device=device)
    draws = draw_noise(generator, batch, recipe, nreal, noise)
    from ..obs import numerics

    # armed, the families' probes stage their stats on the card and the
    # block queues them for the sweep's drain: no read to the host here
    with numerics.collecting(nreal):
        return realize_block(draws, batch, recipe, fit, static, nreal, system=system)


# ---------------------------------------------------- the GP noise model

def _white_variance(batch: PulsarBatch, recipe: Recipe):
    """(Np, Nt) white per-TOA variance (EFAC sigma)^2 + EQUAD^2, with the
    recipe's t2equad/tnequad convention: what white_noise_delays injects."""
    if recipe.efac is not None:
        ef = _check_backend_table(_as(recipe.efac, batch), batch, "efac")
        ef = ef.expand(batch.npsr) if ef.ndim == 0 else ef
        efac_t = _per_toa(ef, batch.backend_index, batch.mask)
    else:
        efac_t = batch.mask
    sigma2 = (efac_t * batch.errors_s) ** 2
    if recipe.log10_equad is not None:
        eq = 10.0 ** _check_backend_table(_as(recipe.log10_equad, batch), batch, "log10_equad")
        eq = eq.expand(batch.npsr) if eq.ndim == 0 else eq
        equad_t = _per_toa(eq, batch.backend_index, batch.mask)
        if not recipe.tnequad:
            equad_t = efac_t * equad_t
        sigma2 = sigma2 + equad_t**2
    return sigma2


def _ecorr_variance(batch: PulsarBatch, recipe: Recipe):
    """(Np, E) per-epoch ECORR variance, or None without ECORR."""
    if recipe.log10_ecorr is None:
        return None
    ec = 10.0 ** _check_backend_table(_as(recipe.log10_ecorr, batch), batch, "log10_ecorr")
    if ec.ndim == 0:
        return ec**2 * batch.epoch_mask
    if ec.ndim == 1:
        return ec[:, None] ** 2 * batch.epoch_mask
    return torch.gather(ec, 1, batch.epoch_backend_index) ** 2 * batch.epoch_mask


def _gp_blocks(batch: PulsarBatch, recipe: Recipe) -> list:
    """The recipe's low-rank GP blocks in column order (red, chromatic,
    GWB auto-term), each ``(freqs (Np, K), prior (Np, 2K), libstempo,
    row_scale (Np, Nt) or None)``. The priors need no basis, so a
    hyperparameter point prices them in O(Np K)."""
    blocks = []
    if recipe.rn_log10_amplitude is not None:
        freqs, prior = red_noise_prior(
            batch, recipe.rn_log10_amplitude, recipe.rn_gamma,
            nmodes=recipe.rn_nmodes, modes=recipe.rn_modes, logf=recipe.rn_logf,
            fmin=recipe.rn_fmin, fmax=recipe.rn_fmax, tspan_s=recipe.rn_tspan_s,
        )
        blocks.append((freqs, prior, recipe.rn_libstempo, None))
    if recipe.chrom_log10_amplitude is not None:
        if batch.freqs_mhz is None:
            raise ValueError("chromatic noise needs batch.freqs_mhz (observing frequencies)")
        freqs, prior = red_noise_prior(
            batch, recipe.chrom_log10_amplitude, recipe.chrom_gamma,
            nmodes=recipe.chrom_nmodes,
        )
        idx = _as(recipe.chrom_index if recipe.chrom_index is not None else 2.0, batch)
        if idx.ndim >= 1:
            idx = idx[..., None]
        positive = batch.freqs_mhz > 0.0
        safe = torch.where(positive, batch.freqs_mhz, 1.0)
        scale = torch.where(positive, (recipe.chrom_ref_freq_mhz / safe) ** idx, 0.0)
        blocks.append((freqs, prior, False, scale))
    if _gwb_enabled(recipe):
        # The injected GWB's per-pulsar auto-covariance, weighted like a
        # red-noise process: phi = hc^2(f) / (12 pi^2 f^3 T) per sin/cos
        # coefficient. Cross-pulsar correlations are not modelled.
        T = batch.tspan_s
        fg = fourier_frequencies(T, nmodes=recipe.gwb_gls_nmodes)

        def per_pulsar(x):
            """A scalar, or an (Np,) value as (Np, 1); None stays None."""
            if x is None:
                return None
            x = _as(x, batch)
            return x[..., None] if x.ndim >= 1 else x

        user = recipe.gwb_user_spectrum
        hc = characteristic_strain(
            fg, per_pulsar(recipe.gwb_log10_amplitude), per_pulsar(recipe.gwb_gamma),
            turnover=recipe.gwb_turnover, f0=recipe.gwb_f0, beta=recipe.gwb_beta,
            power=recipe.gwb_power, user_spectrum=None if user is None else _as(user, batch),
        )
        phig = hc**2 / (12.0 * math.pi**2 * fg**3 * T[:, None])
        blocks.append((fg, torch.repeat_interleave(phig, 2, dim=-1), False, None))
    return blocks


def gls_prior(batch: PulsarBatch, recipe: Recipe):
    """The stacked GP prior variances phi (Np, R) of the recipe's noise
    model (None without a GP block): the ``phi`` of
    :func:`gls_noise_model`, without building its (Np, Nt, R) basis."""
    blocks = _gp_blocks(batch, recipe)
    return torch.cat([b[1] for b in blocks], dim=-1) if blocks else None


def gls_noise_model(batch: PulsarBatch, recipe: Recipe):
    """Rank-reduced per-pulsar noise model ``(sigma2, ecorr2, U, phi)``:

    - ``sigma2`` (Np, Nt): white per-TOA variance;
    - ``ecorr2`` (Np, E) or None: per-epoch ECORR variance (the epoch
      indicator block is applied analytically, :func:`white_ecorr_parts`);
    - ``U`` (Np, Nt, R) / ``phi`` (Np, R), or (None, None): the stacked
      low-rank Fourier blocks (red noise; chromatic noise, the basis
      row-scaled by (ref/f)^idx; the GWB auto-term) and their prior
      variances.

    C = N + U_ec diag(ecorr2) U_ec^T + U diag(phi) U^T."""
    sigma2 = _white_variance(batch, recipe)
    ecorr2 = _ecorr_variance(batch, recipe)
    blocks = _gp_blocks(batch, recipe)
    if not blocks:
        return sigma2, ecorr2, None, None
    bases = []
    for freqs, _prior, libstempo, scale in blocks:
        rows = batch.mask if scale is None else scale * batch.mask
        F = fourier_basis(batch.toas_s, freqs, libstempo_convention=libstempo)
        bases.append(F * rows[..., None])
    U = torch.cat(bases, dim=-1)
    phi = torch.cat([b[1] for b in blocks], dim=-1)
    return sigma2, ecorr2, U, phi


def _epoch_table(batch: PulsarBatch):
    """(Np, E, K) int64 TOA indices of each epoch's valid members in TOA
    order, padded with Nt (the index of an appended zero row); K is the
    largest epoch. Padding and masked TOAs join no epoch (their terms are
    zero): a ragged array's padding rows all carry epoch index 0, and
    counting them would make K the padding's length. Built on the host
    from ``batch.epoch_index`` and ``batch.mask``."""
    index = batch.epoch_index.cpu().numpy()
    valid = batch.mask.cpu().numpy() > 0
    npsr, ntoa = index.shape
    nep = batch.max_epochs
    key = np.where(valid, index, nep)  # a sentinel epoch past the last
    order = np.argsort(key, axis=1, kind="stable")
    members = np.take_along_axis(key, order, axis=1)
    counts = np.zeros((npsr, nep + 1), np.int64)
    np.add.at(counts, (np.arange(npsr)[:, None], key), 1)
    start = np.cumsum(counts, axis=1) - counts
    rank = np.arange(ntoa)[None, :] - np.take_along_axis(start, members, axis=1)
    table = np.full((npsr, nep, max(int(counts[:, :nep].max()), 1)), ntoa, np.int64)
    psr, pos = np.nonzero(members < nep)
    table[psr, members[psr, pos], rank[psr, pos]] = order[psr, pos]
    return torch.as_tensor(table, device=batch.device)


def white_ecorr_parts(batch: PulsarBatch, sigma2, ecorr2, dtype):
    """The analytic white+ECORR pieces ``(winv, seg_sum, gain,
    logdet_c0)``: the masked N^-1 diagonal (Np, Nt), the epoch segment
    sum ``(..., Np, Nt, Q) -> (..., Np, E, Q)``, the per-epoch Woodbury
    gain (Np, E) (None without ECORR) and the (Np,) log det C0 over valid
    TOAs. Shared by :func:`white_ecorr_solver` and the fused Woodbury
    assembly, so the two price the same C0.

    The segment sum gathers each epoch's members through a fixed table
    and sums them in TOA order: the same bits on every run and device
    (a scatter-add would take the card's atomics in a varying order)."""
    sigma2 = sigma2.to(dtype)
    mask = batch.mask.to(dtype)
    winv = torch.where(mask > 0, 1.0 / sigma2, 0.0)
    table = _epoch_table(batch)
    rows = torch.arange(batch.npsr, device=batch.device)[:, None, None]

    def seg_sum(x):
        """Per-pulsar epoch segment sum over TOAs, (..., Np, Nt, Q) ->
        (..., Np, E, Q)."""
        x = torch.nn.functional.pad(x * mask[..., None], (0, 0, 0, 1))
        return x[..., rows, table, :].sum(dim=-2)

    safe_sigma2 = torch.where(mask > 0, sigma2, 1.0)
    logdet_c0 = torch.sum(torch.log(safe_sigma2) * mask, dim=-1)
    gain = None
    if ecorr2 is not None:
        ecorr2 = ecorr2.to(dtype)
        s_e = seg_sum(winv[..., None])[..., 0]  # U_ec^T N^-1 U_ec diagonal
        gain = ecorr2 / (1.0 + ecorr2 * s_e)  # k / (1 + k s), 0 at k = 0
        # ecorr2 is 0 at padded epochs, so their log1p terms vanish
        logdet_c0 = logdet_c0 + torch.sum(
            torch.log1p(ecorr2 * s_e) * batch.epoch_mask.to(dtype), dim=-1
        )
    return winv, seg_sum, gain, logdet_c0


def pick_epochs(values, batch: PulsarBatch):
    """Per-epoch ``values`` (..., Np, E, Q) gathered onto TOAs: (..., Np,
    Nt, Q)."""
    index = batch.epoch_index[..., None]
    index = index.reshape((1,) * (values.ndim - 3) + index.shape)
    return torch.take_along_dim(values, index, dim=-2)


def white_ecorr_solver(batch: PulsarBatch, sigma2, ecorr2, dtype,
                       extra=None, extra_s2=None):
    """C0 = N + U_ec diag(ecorr2) U_ec^T as ``(winv, c0inv_mat,
    logdet_c0)``: the masked N^-1 diagonal, a map ``(..., Np, Nt, Q) ->
    (..., Np, Nt, Q)`` applying C0^-1 by the per-epoch Woodbury identity
    (epochs are disjoint, so no (Nt, E) one-hot is formed), and the (Np,)
    log det C0 over valid TOAs.

    ``extra`` generalizes C0 beyond the diagonal: a structured CovOp (a
    Recipe's ``noise_cov``) scaled by ``extra_s2`` joins the block, C0 = N
    + ECORR + s2 X. A :class:`BandedCov` without ECORR folds the white
    diagonal into its block-tridiagonal factor (O(Nt b^2)); every other
    combination (Kronecker, dense or low-rank extras, or banded + ECORR)
    materializes C0 and pays one blocked dense Cholesky. ``winv`` stays
    the white diagonal's inverse even then."""
    # probes (identity; sites solver.winv and solver.logdet_c0): N^-1
    # overflows float32 first when a sigma2 underflows, and logdet_c0 is the
    # scalar that would turn a pulsar's likelihood NaN, so a corrupt solve
    # is named here, not at the downstream log L
    from ..obs import numerics

    if extra is not None:
        if not isinstance(extra, CovOp):
            raise TypeError(f"extra must be a covariance CovOp, got {type(extra).__name__}")
        winv = numerics.probe("solver.winv",
                              torch.where(batch.mask > 0, 1.0 / sigma2, 0.0).to(dtype))
        safe_sigma2 = torch.where(batch.mask > 0, sigma2, 1.0)
        if isinstance(extra, BandedCov) and ecorr2 is None:
            c0inv_mat, logdet_c0 = banded_combined_solver(extra, safe_sigma2, extra_s2, dtype)
        else:
            c0inv_mat, logdet_c0 = dense_combined_solver(
                batch, safe_sigma2, ecorr2, extra, extra_s2, dtype)
        return winv, c0inv_mat, numerics.probe("solver.logdet_c0", logdet_c0)
    winv, seg_sum, gain, logdet_c0 = white_ecorr_parts(batch, sigma2, ecorr2, dtype)
    winv = numerics.probe("solver.winv", winv)

    def c0inv_mat(X):
        """(N + ECORR)^-1 X, per-epoch Woodbury."""
        y = winv[..., None] * X
        if gain is None:
            return y
        picked = pick_epochs(gain[..., None] * seg_sum(y), batch)
        return y - winv[..., None] * picked

    return winv, c0inv_mat, numerics.probe("solver.logdet_c0", logdet_c0)


# ------------------------------------------------------ the design refit
#
# The full-model refit of an arbitrary (Np, Nt, K) design: WLS
# (design_fit_subtract) or GLS weighted by the recipe's own noise model
# (gls_fit_subtract). Its delay-independent half, the column-normalized
# normal matrix A, its norms and padding columns, and the C^-1 operator
# with C0's factor inside it, is a FitSystem: assembled once per realize
# call (once per sweep by utils/sweep.py), and applied to every chunk. A and
# the norms are formed in float64 and the (K, K) solve runs in float64
# whatever the delays' dtype (on the card, cuBLAS's float32 accumulation
# over 7,758 TOAs put ~6e-5 of relative error on a Gram matrix, ROADMAP
# C.1). Both applies run in float64 up to the model, cast to the delays'
# dtype last (gls_cinv says why for GLS; a timing design's near-collinear
# columns for both), and the GLS apply of float64 delays takes one step of
# iterative refinement (FitSystem.subtract).

_F64 = torch.float64
#: the column-normalized normal equations' ridge (the reference's default)
_RIDGE = 1e-10


def _lu_solve(lu, pivots, B, vec: bool = False):
    """``A^-1 B`` from ``A``'s (Np, n, n) LU factor for B (..., Np, n, Q),
    or (..., Np, n) with ``vec``: the leading axes fold into the
    right-hand sides, so the factor is never broadcast over them. Runs in
    the factor's dtype; returns B's."""
    X = B[..., None] if vec else B
    lead, (npsr, n, q) = X.shape[:-3], X.shape[-3:]
    Xf = X.reshape((-1, npsr, n, q)).permute(1, 2, 0, 3).reshape(npsr, n, -1)
    Z = torch.linalg.lu_solve(lu, pivots, Xf.to(lu.dtype)).to(B.dtype)
    Z = Z.reshape(npsr, n, -1, q).permute(2, 0, 1, 3).reshape(lead + (npsr, n, q))
    return Z[..., 0] if vec else Z


def _lu(A):
    """LU factor and pivots of a batched square ``A``, with no host
    synchronisation (a singular A gives non-finite solves, as the
    reference's ``jnp.linalg.solve`` does)."""
    lu, pivots, _info = torch.linalg.lu_factor_ex(A)
    return lu, pivots


def gls_cinv(batch: PulsarBatch, recipe: Recipe, dtype=_F64):
    """C^-1 of the recipe's noise model, C = C0 + U diag(phi) U^T
    (:func:`gls_noise_model`, C0 with the recipe's ``noise_cov`` through
    :func:`white_ecorr_solver`), as a map over (..., Np, Nt, Q) of
    ``dtype``: float64 for the fit; float32 only to measure what the
    float64 apply buys.
    C is never formed: C0^-1 is the analytic per-epoch Woodbury, the
    block-tridiagonal solve (B.4/B.5) or the dense rung (B.2), and the
    low-rank blocks go through the nested Woodbury identity over the (R, R)
    system S = U^T C0^-1 U + Phi^-1, factored once. phi = 0 modes are made
    exactly inert by zeroing their basis columns (the limit phi -> 0 is an
    infinite 1/phi, not the unit variance phi_safe = 1 would give); the
    unit diagonal then only keeps S nonsingular.

    Float64 at every batch dtype: for residuals dominated by red noise,
    C0^-1 r and its Woodbury correction cancel most of each other, and a
    float32 apply left ~1e-4 of the residual's C^-1-norm un-projected by
    the fit (4 x 256 on the CPU; float64: ~5e-10, the ridge's)."""
    # the recipe without its design, which the assembly casts itself
    bt = batch.astype(dtype)
    sigma2, ecorr2, U, phi = gls_noise_model(
        bt, dataclasses.replace(recipe, fit_design=None).astype(dtype))
    _w, c0inv, _ld = white_ecorr_solver(bt, sigma2, ecorr2, dtype, extra=recipe.noise_cov,
                                        extra_s2=recipe_cov_s2(recipe, dtype))
    if U is None:
        return c0inv
    U = U * (phi > 0)[:, None, :].to(dtype)
    G = c0inv(U)  # C0^-1 U, (Np, Nt, R)
    phi_safe = torch.where(phi > 0, phi, 1.0)
    lu, pivots = _lu(torch.einsum("pnr,pns->prs", U, G) + torch.diag_embed(1.0 / phi_safe))

    def cinv_mat(X):
        """C^-1 X, nested Woodbury: C0^-1 X - G S^-1 U^T C0^-1 X."""
        X0 = c0inv(X)
        inner = torch.einsum("pnr,...pnq->...prq", U, X0)
        return X0 - torch.einsum("pnr,...prq->...pnq", G, _lu_solve(lu, pivots, inner))

    return cinv_mat


@dataclass(frozen=True)
class FitSystem:
    """The delay-independent half of a design refit (:func:`fit_system`):
    apply it to any number of (..., Np, Nt) delays of ``dtype`` with
    :meth:`subtract`. Built once, it gives the same bits as a rebuild."""

    #: GLS (``cinv_mat`` set) or WLS
    gls: bool
    #: the delays' dtype it applies to
    dtype: torch.dtype
    #: WLS: the weighted, column-normalized design Mn = M w / norms; GLS:
    #: the masked design M; float64 either way
    design: torch.Tensor
    #: (Np, K) float64 column norms (1 at padding columns)
    norms: torch.Tensor
    #: the LU factor of the (Np, K, K) float64 column-normalized normal
    #: matrix A, with a unit row per padding column and the ridge
    lu: torch.Tensor
    pivots: torch.Tensor
    #: (Np, Nt) valid-TOA mask in ``dtype``
    mask: torch.Tensor
    #: WLS: the square-root weights mask / errors (Np, Nt), float64
    w: Optional[torch.Tensor] = None
    #: GLS: C^-1 over (..., Np, Nt, Q), float64 (:func:`gls_cinv`)
    cinv_mat: Optional[object] = None
    #: the ridge on A's diagonal (the GLS refinement step's residual needs it)
    ridge: float = 0.0

    def require_fits(self, recipe: Recipe):
        """Refuse a ``recipe`` whose design refit this system was not
        assembled for: WLS for GLS or back, or another design shape."""
        want = ("GLS" if recipe.fit_gls else "WLS", tuple(recipe.fit_design.shape))
        have = ("GLS" if self.gls else "WLS", tuple(self.design.shape))
        if have != want:
            raise ValueError(f"the fit system was assembled for a {have[0]} fit of a {have[1]} "
                             f"design; the recipe asks for a {want[0]} fit of a {want[1]} design")

    def subtract(self, delays):
        """``delays`` (..., Np, Nt) minus their best fit of the design,
        masked; leading axes are realizations."""
        if delays.dtype != self.dtype:
            raise TypeError(
                f"the fit system was assembled for {self.dtype} delays, got {delays.dtype}"
            )
        M = self.design
        # float64 up to the residual, cast to dtype last: a float32 M^T W r,
        # or a float32 model subtracted in float32, put ~1e-3 (WLS) and
        # ~1e-6 (GLS, projection) of the fitted residual into a timing
        # design's near-collinear directions (cond(A) ~ 1e7); the GLS apply
        # is float64 anyway (gls_cinv)
        d64 = delays.to(_F64)
        if self.gls:
            Cir = self.cinv_mat(d64[..., None])[..., 0]
            b = torch.einsum("pnk,...pn->...pk", M, Cir) / self.norms
            x = _lu_solve(self.lu, self.pivots, b, vec=True)
            if self.dtype == _F64:
                # float64 delays take one step of iterative refinement
                # against a fresh C^-1 apply to the fitted residual: A
                # carries C^-1 M's rounding, which the same columns turn
                # into ~1e-9 of the fitted residual, and the step into
                # ~2e-11. Float32 delays keep one apply: their cast of the
                # residual limits the fit first
                post = d64 - torch.einsum("pnk,...pk->...pn", M, x / self.norms)
                rb = torch.einsum("pnk,...pn->...pk", M,
                                  self.cinv_mat(post[..., None])[..., 0]) / self.norms
                x = x + _lu_solve(self.lu, self.pivots, rb - self.ridge * x, vec=True)
            model = torch.einsum("pnk,...pk->...pn", M, x / self.norms)
        else:
            b = torch.einsum("pnk,...pn->...pk", M, d64 * self.w)
            coef = _lu_solve(self.lu, self.pivots, b, vec=True)
            model = torch.einsum("pnk,...pk->...pn", M, coef) / torch.where(
                self.w.abs() > 0, self.w, 1.0)
        return ((d64 - model) * self.mask).to(self.dtype)


def _normal_matrix(gram, zero_col, ridge):
    """A = gram + a unit diagonal at padding columns (their right-hand
    side is zero, so they solve to exactly 0) + the ridge (columns are
    unit-normalized, so it costs ~ridge relative; exactly duplicated
    columns would otherwise make A singular and NaN the pulsar)."""
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    return gram + eye * zero_col[:, None, :].to(gram.dtype) + ridge * eye


def _wls_system(batch: PulsarBatch, design, ridge, dtype) -> FitSystem:
    """The WLS refit's assembly: the design weighted by 1/errors and
    column-normalized (all-zero padding columns neutralized), A = Mn^T Mn,
    formed in float64."""
    w = (batch.mask / batch.errors_s).to(_F64)
    Mw = torch.as_tensor(design).to(device=batch.device, dtype=_F64) * w[..., None]
    norms = torch.sqrt(torch.sum(Mw**2, dim=-2))
    zero_col = norms == 0.0
    norms = torch.where(zero_col, 1.0, norms)
    Mn = Mw / norms[:, None, :]
    del Mw
    A = _normal_matrix(torch.einsum("pnk,pnl->pkl", Mn, Mn), zero_col, ridge)
    lu, pivots = _lu(A)
    return FitSystem(gls=False, dtype=dtype, design=Mn, norms=norms, lu=lu,
                     pivots=pivots, mask=batch.mask.to(dtype), w=w)


def _gls_design_system(batch: PulsarBatch, design, recipe: Recipe, ridge):
    """The GLS refit's assembly ``(A, norms, zero_col, cinv_mat, design)``,
    all float64: A = N^-1 (M^T C^-1 M) N^-1 with the column norms N =
    sqrt(diag(M^T C^-1 M)) (plus padding-column unit rows and the ridge),
    ``cinv_mat`` (:func:`gls_cinv`) and the masked design M. One assembly
    serves :func:`gls_fit_subtract` and :func:`gls_fit_uncertainties`, so
    the two price the same system."""
    cinv = gls_cinv(batch, recipe)
    M64 = torch.as_tensor(design).to(device=batch.device, dtype=_F64) * batch.mask.to(_F64)[..., None]
    CiM = cinv(M64)
    norms = torch.sqrt(torch.clamp(torch.einsum("pnk,pnk->pk", M64, CiM), min=0.0))
    zero_col = norms == 0.0
    norms = torch.where(zero_col, 1.0, norms)
    gram = torch.einsum("pnk,pnl->pkl", M64, CiM) / norms[:, :, None] / norms[:, None, :]
    del CiM
    return _normal_matrix(gram, zero_col, ridge), norms, zero_col, cinv, M64


def _gls_system(batch: PulsarBatch, design, recipe: Recipe, ridge, dtype) -> FitSystem:
    A, norms, _zero_col, cinv, M = _gls_design_system(batch, design, recipe, ridge)
    lu, pivots = _lu(A)
    return FitSystem(gls=True, dtype=dtype, design=M, norms=norms, lu=lu, pivots=pivots,
                     mask=batch.mask.to(dtype), cinv_mat=cinv, ridge=ridge)


def fit_system(batch: PulsarBatch, recipe: Recipe, dtype=None):
    """The assembled design refit of ``recipe.fit_design`` for delays of
    ``dtype`` (default: the batch's): GLS with ``recipe.fit_gls``, else
    WLS. It does not depend on the delays, so a caller that fits in chunks
    builds it once and passes it to each (:func:`realize`'s ``system``)."""
    if recipe.fit_design is None:
        raise ValueError("fit_system needs a recipe with fit_design")
    dtype = dtype or batch.dtype
    if recipe.fit_gls:
        return _gls_system(batch, recipe.fit_design, recipe, _RIDGE, dtype)
    return _wls_system(batch, recipe.fit_design, _RIDGE, dtype)


def design_fit_subtract(delays, batch: PulsarBatch, design, ridge=_RIDGE):
    """Project out the weighted (1/errors^2) best fit of an arbitrary
    (Np, Nt, K) design per pulsar: the full-model refit's WLS form.
    Padding columns are all zero and neutralized; the column-normalized
    normal equations carry a ``ridge``. No weighted-mean subtraction
    (:func:`finalize_residuals` adds it)."""
    return _wls_system(batch, design, ridge, delays.dtype).subtract(delays)


def gls_fit_subtract(delays, batch: PulsarBatch, design, recipe: Recipe, ridge=_RIDGE):
    """Subtract the C^-1-weighted best fit of the design columns, C the
    recipe's own noise model (white, ECORR, the GP blocks and the
    ``noise_cov`` block; :func:`gls_cinv`): the device form of the
    reference's PINT GLS refit. C is never materialized."""
    return _gls_system(batch, design, recipe, ridge, delays.dtype).subtract(delays)


def gls_fit_uncertainties(batch: PulsarBatch, design, recipe: Recipe, ridge=_RIDGE,
                          dtype=None):
    """Per-parameter 1-sigma uncertainties of the GLS refit, sqrt(diag((M^T
    C^-1 M)^-1)), (Np, K) in ``dtype``, 0 at padding columns. Independent
    of the delays, so a sweep prices it once. ``dtype`` defaults to the
    batch's, the dtype :func:`gls_fit_subtract` assembles at for
    batch-dtype delays; a caller whose delays have another dtype passes
    it, so that the sigmas describe the system those residuals were fit
    with."""
    dtype = dtype or batch.dtype
    # A and the norms are float64 at every dtype: only the result is cast
    A, norms, zero_col, _cinv, _M = _gls_design_system(batch, design, recipe, ridge)
    var = torch.clamp(torch.diagonal(torch.linalg.inv_ex(A)[0], dim1=-2, dim2=-1), min=0.0)
    return torch.where(zero_col, 0.0, torch.sqrt(var) / norms).to(dtype)
