"""Grid and bank evaluation of the rank-reduced GP likelihood.

Counterpart of ``pta_replicator_tpu/likelihood/infer.py``: evaluation
over hyperparameter grids (the :class:`~.gp.ReducedGP` fast path whenever
the grid holds the white noise fixed, else the direct per-point rebuild)
and over realization banks. The reference's ``vmap`` engines become batch
axes written out: the G points' priors phi are computed in a host loop
(O(Np R) each), S is factored once per (point, pulsar) as one batched
(G, Np, R, R) Cholesky, and every realization is solved against that one
factor.

Hyperparameter axes are named Recipe array fields with scalar values: a
grid is ``{"rn_log10_amplitude": (G,) values, ...}`` with every axis of
one length G (:func:`grid_cartesian` flattens a product of 1-D axes).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..batch import PulsarBatch
from ..device import resolve_device
from ..models.batched import ARRAY_FIELDS, Recipe
from . import gp

#: Recipe fields that feed only the GP priors phi
PHI_FIELDS = frozenset({
    "rn_log10_amplitude", "rn_gamma", "chrom_log10_amplitude", "chrom_gamma",
    "gwb_log10_amplitude", "gwb_gamma",
})


def _check_axes(names: Tuple[str, ...]):
    for name in names:
        if name not in Recipe.__dataclass_fields__:
            raise ValueError(f"{name!r} is not a Recipe field")
        if name not in ARRAY_FIELDS:
            raise ValueError(
                f"{name!r} is a static Recipe switch — it changes the basis or "
                "the program and cannot be a hyperparameter axis"
            )


def _replace(recipe: Recipe, names: Tuple[str, ...], values) -> Recipe:
    return dataclasses.replace(recipe, **dict(zip(names, values)))


def grid_cartesian(axes: Dict[str, object]) -> Tuple[dict, tuple]:
    """Cartesian product of 1-D axes -> aligned flat arrays + the mesh
    shape (to reshape the flat (G,) results back into the grid)."""
    names = tuple(axes)
    arrs = [np.atleast_1d(np.asarray(axes[k])) for k in names]
    mesh = np.meshgrid(*arrs, indexing="ij")
    shape = mesh[0].shape if mesh else ()
    return {k: m.reshape(-1) for k, m in zip(names, mesh)}, shape


def _reducible(names: Tuple[str, ...], recipe: Recipe) -> bool:
    """True when the grid can ride the ReducedGP fast path: every moving
    field feeds only the priors phi of a block the recipe enables (a
    moving amplitude of a disabled block would change the basis). A C0
    axis (``gp.WHITE_NOISE_FIELDS``, ``cov_log10_sigma`` among them) is
    never reducible: each point refactors C0 on the direct route."""
    if set(names) & gp.WHITE_NOISE_FIELDS or not set(names) <= PHI_FIELDS:
        return False
    if any(getattr(recipe, name) is None for name in names):
        return False
    # a GWB block is on with a power-law amplitude or a user spectrum
    return any(getattr(recipe, name) is not None for name in (
        "rn_log10_amplitude", "chrom_log10_amplitude", "gwb_log10_amplitude",
        "gwb_user_spectrum"))


def _theta_block(grid: Dict[str, object], dtype, device) -> Tuple[tuple, torch.Tensor]:
    """Sorted axis names and the aligned (G, P) point block."""
    names = tuple(sorted(grid))
    _check_axes(names)
    cols = [np.atleast_1d(np.asarray(grid[k], np.float64)) for k in names]
    if len({c.shape for c in cols}) != 1 or cols[0].ndim != 1:
        raise ValueError(
            "grid axes must be aligned 1-D arrays of one length, got "
            f"{ {k: c.shape for k, c in zip(names, cols)} } — use grid_cartesian "
            "to flatten a product grid"
        )
    theta = torch.as_tensor(np.stack(cols, axis=-1), dtype=dtype, device=device)
    return names, theta


def _reduced_points(theta, names, reduced: gp.ReducedGP, proj: gp.GPProjection,
                    batch: PulsarBatch, recipe: Recipe, per_pulsar: bool = False):
    """log L at each of the (G, P) points ``theta`` from a projection:
    phi per point in a host loop, then one batched evaluation."""
    phi = torch.stack([
        gp.phi_for_recipe(batch, _replace(recipe, names, th)) for th in theta
    ])
    return reduced.loglikelihood(proj, phi, per_pulsar=per_pulsar)


def grid_loglikelihood(residuals, batch: PulsarBatch, recipe: Recipe,
                       grid: Dict[str, object], design=None,
                       per_pulsar: bool = False, chunk: Optional[int] = None,
                       fused: bool = False, precision: str = "highest",
                       tile: Optional[int] = None, device="cuda"):
    """log L of one residual vector (Np, Nt) over a hyperparameter grid:
    (G,) totals, or (G, Np) with ``per_pulsar``, on ``device``.

    A grid moving only GP amplitudes/slopes of enabled blocks rides the
    ReducedGP fast path (one Nt-sized precompute, then O(R^3) per point,
    ``chunk`` points per batched evaluation); any other grid pays the
    full rebuild per point. ``fused=True`` (reducible grids only) builds
    the precompute with the fused Woodbury assembly; ``tile`` sets only
    the plain version's Nt tile on the CPU."""
    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)
    residuals = torch.as_tensor(residuals).to(device)
    dtype = residuals.dtype
    gp.require_precision_ready(precision)
    names, theta = _theta_block(grid, dtype, device)
    reducible = _reducible(names, recipe)
    if fused and not reducible:
        raise ValueError(
            f"fused=True requires a reducible grid (phi-only axes of enabled GP "
            f"blocks); got {names} — the fused build accelerates the ReducedGP "
            "precompute, which this grid cannot use"
        )
    if not reducible:
        return torch.stack([
            gp.loglikelihood(residuals, batch, _replace(recipe, names, th),
                             design=design, per_pulsar=per_pulsar)
            for th in theta
        ])
    if fused:
        reduced, proj = gp.ReducedGP.build_fused(
            batch, recipe, residuals=residuals, design=design, dtype=dtype, tile=tile)
    else:
        reduced = gp.ReducedGP.build(batch, recipe, design=design, dtype=dtype)
        proj = reduced.project(residuals, batch)
    step = theta.shape[0] if not chunk else max(1, int(chunk))
    return torch.cat([
        _reduced_points(theta[lo:lo + step], names, reduced, proj, batch, recipe,
                        per_pulsar=per_pulsar)
        for lo in range(0, theta.shape[0], step)
    ])


def bank_loglikelihood(bank, batch: PulsarBatch, recipe: Recipe,
                       grid: Optional[Dict[str, object]] = None, design=None,
                       fused: bool = False, precision: str = "highest",
                       tile: Optional[int] = None, device="cuda"):
    """log L of every realization of a residual bank: (R,) without a
    grid, (G, R) with one, on ``device`` in the batch's dtype. ``bank`` is
    an (R, Np, Nt) array or tensor, or a :class:`~.serve.RealizationBank`
    (projected chunk by chunk).

    The bank projects once through the ReducedGP precompute (the only
    pass over the TOA axis); each grid point then prices all R
    realizations from the projections. ``fused=True`` builds the
    precompute with the fused Woodbury assembly, and each row is then
    projected by the direct O(Nt) apply."""
    from .serve import RealizationBank, project_bank

    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)
    gp.require_precision_ready(precision)
    if grid is not None:
        names, theta = _theta_block(grid, batch.dtype, device)
        if not _reducible(names, recipe):
            raise ValueError(
                f"bank grids support phi-only axes (GP amplitudes/slopes of "
                f"enabled blocks); got {names} — evaluate white-noise axes per "
                "realization via grid_loglikelihood instead"
            )
    reduced = gp.ReducedGP.build(batch, recipe, design=design, fused=fused, tile=tile)
    if isinstance(bank, RealizationBank):
        proj = project_bank(bank, reduced, batch)
    else:
        bank = torch.as_tensor(bank).to(device=device, dtype=batch.dtype)
        if bank.ndim != 3:
            raise ValueError(f"bank must be (R, Np, Nt), got {tuple(bank.shape)}")
        proj = reduced.project(bank, batch)
    if grid is None:
        return reduced.loglikelihood(proj, gp.phi_for_recipe(batch, recipe))
    return _reduced_points(theta, names, reduced, proj, batch, recipe)
