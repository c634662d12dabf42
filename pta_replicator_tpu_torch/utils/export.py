"""Materialize realizations as on-disk par/tim datasets.

Counterpart of ``pta_replicator_tpu/utils/export.py``, on the port's own
draw layout. The reference's end product is a *mutated dataset* persisted
with ``write_partim`` (pta_replicator/simulate.py:71-77) that downstream
pipelines (PINT/Tempo2/enterprise) consume; the card produces realization
*arrays*. This module closes the loop: take the (Np, Nt) pre-fit injected
delays of a realization and write a complete par/tim dataset per pulsar
through the ``adjust_seconds`` injection primitive, then restore the
pulsars bit for bit, so the ingested array stays a reusable clean
template. Epochs stay longdouble on the host; only the delays come from
the card.

The written datasets carry the raw injected delays (no fit): like the
reference's datasets, consumers run their own timing fit.

Dataset r carries exactly the delays behind row r of the matching
residual cube, because :func:`materialize_realizations` rebuilds the
engine's draws: for ``realize``, one ``draw_noise`` of ``nreal``
realizations from the caller's generator, seeded with ``seed``; for a
``sweep`` of chunk ``c``, chunk i's ``draw_noise`` of ``c`` realizations
from its generator, seeded with ``chunk_seed(seed, i)``. Drawing with
any other layout (another chunk size, fewer realizations) would draw
other numbers.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["write_realization_partim", "materialize_realizations"]

#: realizations whose delays are formed on the card at once
BLOCK = 16


def write_realization_partim(psrs, delays, outdir: str, tempo2: bool = False):
    """Write one realization's (Np, Nt_max) padded delay array [s] as a
    par/tim dataset: ``outdir/<psr>.par`` + ``outdir/<psr>.tim``.

    ``psrs`` must be the same (ordered) list the batch was frozen from.
    Each pulsar's TOA epochs are shifted by its delay row (the
    ``adjust_seconds`` injection primitive), written, then restored
    bitwise (epochs are saved and reassigned, not re-adjusted, so
    repeated materializations cannot accumulate longdouble round-off
    into the template). Residuals and the in-memory ledger are left
    untouched — neither is serialized into par/tim, and recomputing
    residuals per write would triple the cost of a materialization
    sweep; callers wanting an in-memory record use ``psr.inject``.
    """
    os.makedirs(outdir, exist_ok=True)
    if isinstance(delays, torch.Tensor):
        delays = delays.detach().cpu().numpy()
    delays = np.asarray(delays, dtype=np.float64)
    if delays.ndim != 2 or delays.shape[0] != len(psrs):
        raise ValueError(
            f"delays must be (npsr={len(psrs)}, ntoa_max), got {delays.shape}"
        )
    for i, psr in enumerate(psrs):
        n = psr.toas.ntoas
        d = delays[i, :n]
        mjd0 = psr.toas.mjd.copy()
        psr.toas.adjust_seconds(d)
        try:
            psr.write_partim(
                os.path.join(outdir, f"{psr.name}.par"),
                os.path.join(outdir, f"{psr.name}.tim"),
                tempo2=tempo2,
                # only the epochs change between realizations, which is
                # exactly the tim writer's static-parts cache contract
                reuse_static_tim_parts=True,
            )
        finally:
            psr.toas.mjd = mjd0


def _draw_blocks(seed: int, batch, recipe, nreal: int, count: int, sweep_chunk, device):
    """``(first row, rows, draws)`` triples covering rows ``0 .. count - 1``
    of the engine's draws, at most ``BLOCK`` rows each; one draw (the
    direct path's, or one sweep chunk's) is held at a time."""
    from ..models.batched import draw_noise
    from .sweep import chunk_seed

    if sweep_chunk is None:
        size, seeds = nreal, [int(seed)]
    else:
        if nreal % sweep_chunk:
            raise ValueError(f"nreal={nreal} must be a multiple of chunk={sweep_chunk}")
        size, seeds = sweep_chunk, [chunk_seed(seed, i) for i in range(-(-count // sweep_chunk))]
    for i, chunk_seed_i in enumerate(seeds):
        generator = torch.Generator(device=device).manual_seed(chunk_seed_i)
        draws = draw_noise(generator, batch, recipe, size)
        first = i * size
        stop = min(count - first, size)
        for s in range(0, stop, BLOCK):
            e = min(stop, s + BLOCK)
            yield first + s, e - s, {k: v[s:e] for k, v in draws.items()}


def materialize_realizations(psrs, batch, recipe, seed: int, nreal: int, outdir: str,
                             write_max=None, sweep_chunk=None, static=None,
                             tempo2: bool = False, device="cuda"):
    """Write the first ``min(nreal, write_max)`` realizations as complete
    datasets: ``outdir/real{r:05d}/<psr>.{par,tim}``.

    ``seed``, ``nreal`` and ``sweep_chunk`` name the engine run whose
    residual cube the datasets match: ``realize`` with a generator seeded
    ``seed`` drawing ``nreal`` realizations (``sweep_chunk=None``), or
    ``sweep(seed, ..., nreal, chunk=sweep_chunk)``. The dataset written
    for r carries exactly the injected delays behind row r of that cube,
    before its fit (stochastic families plus ``static``, the
    :func:`~..models.batched.deterministic_delays`, computed here when not
    given). Delays are formed on ``device`` ``BLOCK`` realizations at a
    time and streamed to disk. Returns the directories written."""
    from ..device import resolve_device
    from ..models.batched import deterministic_delays, realization_delays

    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)
    count = nreal if write_max is None else min(nreal, int(write_max))
    if static is None:
        static = deterministic_delays(batch, recipe, device=device)
    dirs = []
    for first, n, draws in _draw_blocks(seed, batch, recipe, nreal, count, sweep_chunk, device):
        delays = realization_delays(batch, recipe, draws) + static
        block = delays.expand((n,) + tuple(batch.toas_s.shape)).cpu().numpy()
        for j in range(n):
            rdir = os.path.join(outdir, f"real{first + j:05d}")
            write_realization_partim(psrs, block[j], rdir, tempo2=tempo2)
            dirs.append(rdir)
    return dirs
