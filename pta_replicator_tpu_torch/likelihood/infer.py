"""Grid and bank evaluation of the rank-reduced GP likelihood, and the
MAP fit.

Counterpart of ``pta_replicator_tpu/likelihood/infer.py``: evaluation
over hyperparameter grids (the :class:`~.gp.ReducedGP` fast path whenever
the grid holds the white noise fixed, else the direct per-point rebuild),
over realization banks, and a damped-Newton MAP fit with Fisher-matrix
uncertainties (:func:`map_fit`). The reference's ``vmap`` engines become batch
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
from ..covariance.structure import BandedCov
from ..device import resolve_device
from ..models.batched import ARRAY_FIELDS, Recipe
from ..ops.gp import TRIDIAG_STAGED_MAX_BLOCK
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


def _resolve_fused(recipe: Recipe, fused: bool, precision, numerics_capture):
    """Validate ``precision`` against the numerics ledger (bf16 is
    refused without a capture that clears the fused sites) and resolve
    the route: a precision other than "highest" forces the fused build.
    Returns ``(fused, precision)``."""
    precision = gp.require_precision_ready(precision, numerics_capture)
    fused = bool(fused) or precision != "highest"
    if fused and recipe.noise_cov is not None:
        raise ValueError(
            "fused=True prices the analytic white/ECORR C0 only; a recipe with a "
            "structured noise_cov block must use the composed path (fused=False)"
        )
    return fused, precision


def grid_loglikelihood(residuals, batch: PulsarBatch, recipe: Recipe,
                       grid: Dict[str, object], design=None,
                       per_pulsar: bool = False, chunk: Optional[int] = None,
                       fused: bool = False, precision: str = "highest",
                       tile: Optional[int] = None, numerics_capture=None,
                       device="cuda"):
    """log L of one residual vector (Np, Nt) over a hyperparameter grid:
    (G,) totals, or (G, Np) with ``per_pulsar``, on ``device``.

    A grid moving only GP amplitudes/slopes of enabled blocks rides the
    ReducedGP fast path (one Nt-sized precompute, then O(R^3) per point,
    ``chunk`` points per batched evaluation); any other grid pays the
    full rebuild per point. ``fused=True`` (reducible grids only) builds
    the precompute with the fused Woodbury assembly. ``precision="bf16"``
    runs that assembly in bf16 with float32 sums (and forces
    ``fused``), refused unless ``numerics_capture`` holds a ladder
    verdict that clears the fused sites (:func:`~.gp.require_precision_ready`).
    ``tile=None`` takes the assembly's knob from ``likelihood/tuner.py``'s
    cache (the untuned defaults without one); a ``tile`` sets only the
    plain version's Nt step on the CPU."""
    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)
    residuals = torch.as_tensor(residuals).to(device)
    dtype = residuals.dtype
    fused, precision = _resolve_fused(recipe, fused, precision, numerics_capture)
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
            batch, recipe, residuals=residuals, design=design, dtype=dtype,
            precision=precision, tile=tile)
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
                       tile: Optional[int] = None, numerics_capture=None,
                       device="cuda"):
    """log L of every realization of a residual bank: (R,) without a
    grid, (G, R) with one, on ``device`` in the batch's dtype. ``bank`` is
    an (R, Np, Nt) array or tensor, or a :class:`~.serve.RealizationBank`
    (projected chunk by chunk).

    The bank projects once through the ReducedGP precompute (the only
    pass over the TOA axis); each grid point then prices all R
    realizations from the projections. ``fused=True`` builds the
    precompute with the fused Woodbury assembly, and each row is then
    projected by the direct O(Nt) apply. ``precision``, ``tile`` and
    ``numerics_capture`` act as in :func:`grid_loglikelihood`."""
    from .serve import RealizationBank, project_bank

    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)
    fused, precision = _resolve_fused(recipe, fused, precision, numerics_capture)
    if grid is not None:
        names, theta = _theta_block(grid, batch.dtype, device)
        if not _reducible(names, recipe):
            raise ValueError(
                f"bank grids support phi-only axes (GP amplitudes/slopes of "
                f"enabled blocks); got {names} — evaluate white-noise axes per "
                "realization via grid_loglikelihood instead"
            )
    reduced = gp.ReducedGP.build(batch, recipe, design=design, fused=fused,
                                 precision=precision, tile=tile)
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


# ----------------------------------------------------------- MAP/Fisher

#: damped Newton: the starting damping, its floor, its factors on an
#: accepted and a rejected step, and the tries per iteration
MAP_LAMBDA0, MAP_LAMBDA_MIN, MAP_SHRINK, MAP_GROW, MAP_TRIES = 1e-3, 1e-12, 3.0, 10.0, 12


@dataclasses.dataclass
class MapResult:
    """MAP fit and Fisher-matrix uncertainties."""

    #: hyperparameter names, in the order of every array below
    names: Tuple[str, ...]
    #: (P,) MAP point
    x: np.ndarray
    #: log L at the MAP point
    loglikelihood: float
    #: (P, P) observed Fisher information (-Hessian of log L)
    fisher: np.ndarray
    #: (P, P) covariance (the Fisher inverse), NaN when singular
    covariance: np.ndarray
    #: (P,) 1-sigma uncertainties sqrt(diag covariance)
    sigma: np.ndarray
    #: max |gradient| fell below gtol
    converged: bool
    #: Newton iterations
    iterations: int

    def as_dict(self) -> dict:
        return {
            "names": list(self.names),
            "x": [float(v) for v in self.x],
            "loglikelihood": float(self.loglikelihood),
            "sigma": [float(v) for v in self.sigma],
            "converged": bool(self.converged),
            "iterations": int(self.iterations),
        }


def _check_card_cov(recipe: Recipe, device: torch.device) -> None:
    """Refuse, before any work, a banded ``noise_cov`` whose blocks the
    card's factor-adjoint kernels do not take: without ECORR the banded rung
    differentiates its factor with ``ops/gp.py::tridiag_factor_adjoint``,
    which launches for blocks of at most ``TRIDIAG_STAGED_MAX_BLOCK`` only."""
    cov = recipe.noise_cov
    if (device.type == "cuda" and isinstance(cov, BandedCov) and recipe.log10_ecorr is None
            and cov.block > TRIDIAG_STAGED_MAX_BLOCK):
        raise ValueError(
            f"a banded noise_cov of block {cov.block} has no factor-adjoint kernel on the "
            f"card (blocks of at most {TRIDIAG_STAGED_MAX_BLOCK}); build it with a smaller "
            "block or fit it with device='cpu'"
        )


def map_objective(residuals, batch: PulsarBatch, recipe: Recipe, names: Tuple[str, ...],
                  design=None, device="cuda"):
    """``(value_and_grad, hessian)`` of ``-log L`` over the Recipe fields
    ``names`` at a numpy point: the value as a float, the gradient and
    Hessian as float64 numpy arrays, from autograd through the direct
    :func:`~.gp.loglikelihood` in float64 on ``device``."""
    f64 = torch.float64
    device = resolve_device(device)
    _check_card_cov(recipe, device)
    batch, recipe = batch.to(device).astype(f64), recipe.to(device).astype(f64)
    residuals = torch.as_tensor(residuals).to(device=device, dtype=f64)
    design = None if design is None else torch.as_tensor(design).to(device=device, dtype=f64)

    def neg_ll(xv):
        return -gp.loglikelihood(residuals, batch, _replace(recipe, names, list(xv)),
                                 design=design)

    def value_and_grad(xv):
        xt = torch.tensor(xv, dtype=f64, device=device, requires_grad=True)
        f = neg_ll(xt)
        (g,) = torch.autograd.grad(f, xt)
        return float(f.detach()), g.cpu().numpy()

    def hessian(xv):
        xt = torch.tensor(xv, dtype=f64, device=device)
        return torch.autograd.functional.hessian(neg_ll, xt).cpu().numpy()

    return value_and_grad, hessian


def map_fit(residuals, batch: PulsarBatch, recipe: Recipe, params: Dict[str, float],
            design=None, maxiter: int = 50, gtol: float = 1e-4, device="cuda") -> MapResult:
    """MAP hyperparameter fit with Fisher-matrix uncertainties: climb to
    the peak of log L over the Recipe fields ``params`` (name -> start)
    and read the curvature there.

    Damped Newton (Levenberg), as the reference: each step solves ``(H +
    lam I) dx = -g`` for ``-log L``'s gradient g and Hessian H, ``lam``
    shrinking by 3 on an accepted step (to at least 1e-12) and growing by
    10 on a rejected one, at most 12 tries an iteration; converged when
    max |g| < ``gtol``. g and H come from autograd through the direct
    :func:`~.gp.loglikelihood`, in float64 whatever the batch's dtype
    (float32 cannot resolve the differences near the peak). The
    objective is the flat-prior log-likelihood; degenerate curvature
    reports NaN sigmas rather than raising.

    A recipe with a structured ``noise_cov`` differentiates through C0's
    solver: on the banded rung the block-tridiagonal sweeps' autograd
    Functions (``ops/gp.py``: each substitution sweep's backward is the
    other sweep, the factor's is the adjoint kernel and that kernel's the
    second-order kernel of ``csrc/block_tridiag.cu``), on the dense rung
    the blocked Cholesky with the SYRK update's Function
    (``ops/cw.py::CovSyrkUpdate``); on the CPU the same Functions run the
    plain versions. On the card the banded rung takes blocks of at most 32
    and refuses a larger block with ValueError before any work."""
    names = tuple(sorted(params))
    _check_axes(names)
    device = resolve_device(device)
    value_and_grad, hessian = map_objective(residuals, batch, recipe, names, design, device)
    x = np.asarray([float(params[k]) for k in names], np.float64)
    lam = MAP_LAMBDA0
    f, g = value_and_grad(x)
    it = 0
    converged = bool(np.max(np.abs(g)) < gtol)
    while it < maxiter and not converged:
        it += 1
        H = hessian(x)
        accepted = False
        for _ in range(MAP_TRIES):  # grow the damping until the step helps
            try:
                dx = np.linalg.solve(H + lam * np.eye(len(x)), -g)
            except np.linalg.LinAlgError:
                lam *= MAP_GROW
                continue
            f_new, g_new = value_and_grad(x + dx)
            if np.isfinite(f_new) and f_new <= f:
                x, f, g = x + dx, f_new, g_new
                lam = max(lam / MAP_SHRINK, MAP_LAMBDA_MIN)
                accepted = True
                break
            lam *= MAP_GROW
        if not accepted:
            break  # damping exhausted: report the best point found
        converged = bool(np.max(np.abs(g)) < gtol)

    fisher = hessian(x)
    try:
        cov = np.linalg.inv(fisher)
        with np.errstate(invalid="ignore"):
            sigma = np.sqrt(np.where(np.diag(cov) > 0, np.diag(cov), np.nan))
    except np.linalg.LinAlgError:
        cov = np.full_like(fisher, np.nan)
        sigma = np.full(len(names), np.nan)
    return MapResult(names=names, x=x, loglikelihood=-f, fisher=fisher, covariance=cov,
                     sigma=sigma, converged=converged, iterations=it)
