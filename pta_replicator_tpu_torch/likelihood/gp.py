"""Rank-reduced Gaussian-process PTA log-likelihood.

Counterpart of ``pta_replicator_tpu/likelihood/gp.py``. The residuals'
covariance is the rank-reduced model of ``models.batched.gls_noise_model``,

    C = N + U_ec diag(ecorr2) U_ec^T + s2 X + U diag(phi) U^T,

priced through the Woodbury identity with the timing model marginalized
exactly (flat prior):

    log L = -1/2 [ r^T C^-1 r - b^T A^-1 b + log det C + log det A
                   + (n - k) log 2pi ],   A = M^T C^-1 M,  b = M^T C^-1 r

with M the column-normalized design and k its non-padding column count.
C0 = N + U_ec diag(ecorr2) U_ec^T + s2 X is the white/ECORR block plus
the recipe's structured ``noise_cov`` X, scaled by s2 = 10^(2
cov_log10_sigma) (``models.batched.white_ecorr_solver``).

* :func:`loglikelihood` evaluates one residual vector directly.
* :class:`ReducedGP` is the serving path: with the white/ECORR noise held
  fixed, every Nt-sized contraction is formed once (``T^T C0^-1 T`` over
  the stacked columns T = [M, U], and per residual vector ``T^T C0^-1 r``
  and ``r^T C0^-1 r``); a hyperparameter point then costs one (R, R)
  Cholesky per pulsar. Its fused build (:meth:`ReducedGP.build_fused`)
  forms the blocks with the fused Woodbury assembly
  (``ops/gp.py::fused_woodbury_update``, a CUDA kernel on the card).
  ``precision="bf16"`` runs that assembly on bf16 operands with float32
  sums, and the reduced algebra then runs in float32; it is refused
  unless a numerics capture clears the fused sites
  (:func:`require_precision_ready`).

Every function runs on the device and in the dtype of its tensors; the
tested configuration is float64 (the Gram entries reach Nt / sigma^2 ~
1e16 against 1/phi on the diagonal). The factorizations and the fused
blocks pass through identity probes of the numerics ledger
(``obs/numerics.py``), which record only while it is armed.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

import torch

from ..batch import PulsarBatch
from ..covariance.kernels import _chol_logdet, _cholesky
from ..covariance.structure import recipe_cov_s2
from ..models.batched import (
    Recipe,
    gls_noise_model,
    gls_prior,
    pick_epochs,
    white_ecorr_parts,
    white_ecorr_solver,
)
from ..obs import numerics
from ..ops import gp as ops_gp

_LOG_2PI = math.log(2.0 * math.pi)

#: Recipe fields that change the white/ECORR/correlated-noise block C0: a
#: :class:`ReducedGP` precompute is only valid while these are fixed, so
#: grids over any of them take the direct route (likelihood/infer.py).
#: ``cov_log10_sigma`` scales the structured ``noise_cov`` block, which
#: lives inside C0.
WHITE_NOISE_FIELDS = frozenset(
    {"efac", "log10_equad", "log10_ecorr", "tnequad", "cov_log10_sigma"}
)


#: the numerics-ledger sites of the fused assembly's outputs: the bf16
#: policy is refused unless a capture's ladder verdict clears every one
FUSED_PRECISION_SITES = ("gp.fused_tnt", "gp.fused_d", "gp.fused_rnr")


class PrecisionNotReady(RuntimeError):
    """``precision='bf16'`` was asked for without a numerics capture whose
    ladder verdict clears every fused site. The remedy: run the fused
    path armed (``numerics.arm()``, then ``numerics.write(dir)``) on
    representative data, and pass that capture as ``numerics_capture=``."""


def require_precision_ready(precision, numerics_capture=None) -> str:
    """Validate a ``precision=`` policy against the numerics ledger.

    ``"highest"`` (or None) always passes. ``"bf16"`` needs
    ``numerics_capture``: a ``numerics.json`` (or its directory) written
    by an armed run of the fused path, whose
    :func:`~pta_replicator_tpu_torch.obs.numerics.ladder_verdict` marks
    every :data:`FUSED_PRECISION_SITES` entry ready; otherwise
    :class:`PrecisionNotReady` names the sites and reasons. Returns the
    validated policy."""
    if precision in (None, "highest"):
        return "highest"
    if precision != "bf16":
        raise ValueError(
            f"unknown precision policy {precision!r}: expected one of {ops_gp.PRECISIONS}"
        )
    if numerics_capture is None:
        raise PrecisionNotReady(
            "precision='bf16' needs evidence: pass numerics_capture= a numerics.json "
            "(or its directory) written by an armed run of the fused path, so the "
            f"ladder verdict for {FUSED_PRECISION_SITES} can be checked"
        )
    path = os.fspath(numerics_capture)
    if os.path.isdir(path):
        path = os.path.join(path, "numerics.json")
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as exc:
        raise PrecisionNotReady(
            f"numerics capture {path!r} is unreadable ({exc}); rerun the fused path "
            "armed and write a fresh capture"
        ) from exc
    verdict = numerics.ladder_verdict(doc)
    missing = [s for s in FUSED_PRECISION_SITES if s not in verdict]
    if missing:
        raise PrecisionNotReady(
            f"numerics capture {path!r} never observed fused sites {missing} — it "
            "must come from an armed run of the fused path itself, not an "
            "unrelated capture"
        )
    blocked = {s: verdict[s]["reasons"] for s in FUSED_PRECISION_SITES if not verdict[s]["ready"]}
    if blocked:
        raise PrecisionNotReady(f"ladder verdict refuses bf16 for {sorted(blocked)}: {blocked}")
    return "bf16"


def _stack_columns(batch: PulsarBatch, design, U, dtype):
    """The stacked columns [Mn, U] (Np, Nt, Q), the padding flags of the
    design's columns, their count ktm, and the degrees of freedom."""
    cols, zero_col, ktm = [], None, 0
    if design is not None:
        Mn, zero_col = _tm_columns(batch, design, dtype)
        ktm = Mn.shape[-1]
        cols.append(Mn)
    if U is not None:
        cols.append(U.to(dtype))
    if not cols:
        raise ValueError(
            "ReducedGP needs at least one low-rank block (a GP noise term in "
            "the recipe or a design tensor) — a white-noise-only likelihood "
            "has no reduced basis; call loglikelihood directly"
        )
    ndof = batch.ntoas.to(dtype)
    if zero_col is not None:
        ndof = ndof - torch.sum((~zero_col).to(dtype), dim=-1)
    return torch.cat(cols, dim=-1), zero_col, ktm, ndof


def _fused_assembly(T, winv, gain, seg_sum, r, tile, precision, nsplit):
    """``T^T C0^-1 T``, ``T^T C0^-1 r`` and ``r^T C0^-1 r`` without
    forming C0^-1 T: the fused Woodbury assembly prices the diagonal N
    (``precision`` and the knobs ``tile``, ``nsplit`` go to it), then the
    per-epoch ECORR correction is exact O(E Q^2) algebra applied here,
    through the same segment sum the composed solver uses, in the
    assembly's accumulator dtype (its inputs formed in the input dtype)."""
    tnt, d, rnr = ops_gp.fused_woodbury_update(T, winv, r, tile=tile, precision=precision,
                                               nsplit=nsplit)
    if gain is not None:
        acc = tnt.dtype
        S = seg_sum(winv[..., None] * T).to(acc)  # (Np, E, Q)
        s_r = seg_sum((winv * r)[..., None])[..., 0].to(acc)
        g = gain.to(acc)
        tnt = tnt - torch.einsum("peq,pe,pes->pqs", S, g, S)
        d = d - torch.einsum("peq,pe->pq", S, g * s_r)
        rnr = rnr - torch.sum(g * s_r * s_r, dim=-1)
    # the blocks the reduced likelihood consumes: the ledger's evidence
    # for the bf16 verdict (identity unless armed)
    return (numerics.probe("gp.fused_tnt", tnt), numerics.probe("gp.fused_d", d),
            numerics.probe("gp.fused_rnr", rnr))


def _tm_columns(batch: PulsarBatch, design, dtype):
    """Masked, column-normalized timing design ``(Mn, zero_col)``. Norms
    are unweighted, so the constant they fold into log L cannot drift
    across a grid; all-zero padding columns get unit norms and are made
    inert by the callers."""
    M = torch.as_tensor(design, dtype=dtype, device=batch.device) * batch.mask[..., None]
    norms = torch.sqrt(torch.sum(M * M, dim=-2))
    zero_col = norms == 0.0
    norms = torch.where(zero_col, 1.0, norms)
    return M / norms[:, None, :], zero_col


def _cho_solve(L, B):
    """S^-1 B from the lower Cholesky factor L of S."""
    return torch.cholesky_solve(B, L, upper=False)


def loglikelihood(residuals, batch: PulsarBatch, recipe: Recipe, design=None,
                  per_pulsar: bool = False):
    """Rank-reduced GP log-likelihood of ``residuals`` (Np, Nt) under the
    recipe's own noise model, on the residuals' device.

    ``design``: optional (Np, Nt, K) timing design to marginalize (flat
    prior); all-zero padding columns are inert. ``per_pulsar`` returns
    the (Np,) per-pulsar terms instead of their sum (cross-pulsar GWB
    correlations are not modelled)."""
    residuals = torch.as_tensor(residuals)
    dtype = residuals.dtype
    sigma2, ecorr2, U, phi = gls_noise_model(batch, recipe)
    _winv, c0inv, logdet = white_ecorr_solver(
        batch, sigma2, ecorr2, dtype,
        extra=recipe.noise_cov, extra_s2=recipe_cov_s2(recipe, dtype))
    r = residuals.to(batch.device) * batch.mask
    x0 = c0inv(r[..., None])[..., 0]  # C0^-1 r
    quad = torch.einsum("pn,pn->p", r, x0)

    if U is not None:
        # phi = 0 modes are exactly inert: zeroed columns, unit diagonal
        active = (phi > 0).to(dtype)
        U = U.to(dtype) * active[:, None, :]
        G = c0inv(U)  # C0^-1 U
        phi_safe = torch.where(phi > 0, phi, 1.0).to(dtype)
        S = torch.einsum("pnr,pns->prs", U, G) + torch.diag_embed(1.0 / phi_safe)
        L = numerics.probe_cholesky("gp.chol_rank", _cholesky(S))
        b = torch.einsum("pnr,pn->pr", U, x0)
        z = torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]
        quad = quad - torch.sum(z * z, dim=-1)
        # log det C = log det C0 + log det S + log det Phi
        logdet = logdet + _chol_logdet(L) + torch.sum(torch.log(phi_safe) * active, dim=-1)

        def cinv_mat(X):
            X0 = c0inv(X)
            inner = torch.einsum("pnr,pnq->prq", U, X0)
            return X0 - torch.einsum("pnr,prq->pnq", G, _cho_solve(L, inner))

        w = x0 - torch.einsum("pnr,pr->pn", G, _cho_solve(L, b[..., None])[..., 0])
    else:
        cinv_mat = c0inv
        w = x0

    ndof = batch.ntoas.to(dtype)
    if design is not None:
        Mn, zero_col = _tm_columns(batch, design, dtype)
        A = torch.einsum("pnk,pnl->pkl", Mn, cinv_mat(Mn))
        A = A + torch.diag_embed(zero_col.to(dtype))
        La = numerics.probe_cholesky("gp.chol_tm", _cholesky(A))
        bm = torch.einsum("pnk,pn->pk", Mn, w)
        zm = torch.linalg.solve_triangular(La, bm[..., None], upper=False)[..., 0]
        quad = quad - torch.sum(zm * zm, dim=-1)
        logdet = logdet + _chol_logdet(La)
        ndof = ndof - torch.sum((~zero_col).to(dtype), dim=-1)

    ll = -0.5 * (quad + logdet + ndof * _LOG_2PI)
    return ll if per_pulsar else torch.sum(ll)


# ----------------------------------------------------------- serving path

@dataclass
class GPProjection:
    """A residual vector's Nt-sized reductions against a
    :class:`ReducedGP`'s fixed C0 and basis; a bank's projections carry a
    leading realization axis."""

    #: (..., Np) r^T C0^-1 r
    rNr: torch.Tensor
    #: (..., Np, Q) T^T C0^-1 r over the stacked columns [Mn, U]
    d: torch.Tensor


@dataclass
class ReducedGP:
    """Precomputed rank-reduced likelihood with fixed white/ECORR noise.

    Build once per (batch, recipe, design); :meth:`project` each residual
    vector once (the only Nt-sized work); then :meth:`loglikelihood`
    prices any red-noise/GWB/chromatic hyperparameter point from the
    precomputed blocks: one (R, R) Cholesky per pulsar. The basis is
    fixed at build time; only the prior variances phi move."""

    #: (Np, Q, Q) T^T C0^-1 T over the stacked columns [Mn, U]
    TNT: torch.Tensor
    #: (Np, Nt, Q) C0^-1 T; None on the fused build, which never forms it
    CiT: Optional[torch.Tensor]
    #: (Np,) masked log det C0
    logdet_c0: torch.Tensor
    #: (Np, Nt) white variance and (Np, E) ECORR variance (None without
    #: ECORR): the C0 inputs, kept so :meth:`project` rebuilds the same C0
    sigma2: torch.Tensor
    ecorr2: Optional[torch.Tensor]
    #: (Np, ktm) True where a timing column is padding
    zero_col: Optional[torch.Tensor]
    #: (Np,) valid-TOA count minus fitted timing columns
    ndof: torch.Tensor
    #: (Np, Nt, Q) stacked columns, kept only by the fused build
    T: Optional[torch.Tensor] = None
    #: number of leading timing-model columns in the stack
    ktm: int = 0
    #: built by :meth:`build_fused`
    fused: bool = False
    #: the recipe's structured ``noise_cov`` and its frozen amplitude
    #: 10^(2 cov_log10_sigma): part of C0, kept so :meth:`project` rebuilds
    #: the same solver (grids over cov_log10_sigma take the direct route)
    extra: Optional[object] = None
    extra_s2: Optional[torch.Tensor] = None
    #: the fused assembly's policy ("highest" or "bf16"); "highest" off
    #: the fused build. With "bf16" the blocks are float32
    precision: str = "highest"

    @classmethod
    def build(cls, batch: PulsarBatch, recipe: Recipe, design=None, dtype=None,
              fused: bool = False, precision: str = "highest",
              tile: Optional[int] = None) -> "ReducedGP":
        """Precompute every Nt-sized block on the batch's device:
        ``C0^-1 T`` and ``T^T C0^-1 T`` as two contractions (composed), or
        with ``fused=True`` (or a precision other than "highest") through
        :meth:`build_fused`. The caller gates ``precision`` first
        (:func:`require_precision_ready`; likelihood/infer.py does)."""
        if fused or precision != "highest":
            return cls.build_fused(batch, recipe, design=design, dtype=dtype,
                                   precision=precision, tile=tile)[0]
        dtype = dtype or batch.dtype
        sigma2, ecorr2, U, _phi = gls_noise_model(batch, recipe)
        extra, extra_s2 = recipe.noise_cov, recipe_cov_s2(recipe, dtype)
        _winv, c0inv, logdet_c0 = white_ecorr_solver(
            batch, sigma2, ecorr2, dtype, extra=extra, extra_s2=extra_s2)
        T, zero_col, ktm, ndof = _stack_columns(batch, design, U, dtype)
        CiT = c0inv(T)
        TNT = torch.einsum("pnq,pns->pqs", T, CiT)
        return cls(
            TNT=TNT, CiT=CiT, logdet_c0=logdet_c0, sigma2=sigma2.to(dtype),
            ecorr2=None if ecorr2 is None else ecorr2.to(dtype),
            zero_col=zero_col, ndof=ndof, ktm=ktm, extra=extra, extra_s2=extra_s2,
        )

    @classmethod
    def build_fused(cls, batch: PulsarBatch, recipe: Recipe, residuals=None,
                    design=None, dtype=None, precision: str = "highest",
                    tile: Optional[int] = None):
        """The fused build: one pass of the fused Woodbury assembly forms
        ``T^T C0^-1 T`` and, when ``residuals`` (Np, Nt) is given, its
        projection in the same pass, without the (Np, Nt, Q) ``C0^-1 T``.
        Returns ``(ReducedGP, GPProjection or None)``.

        ``precision="bf16"`` runs the assembly on bf16 operands with
        float32 sums, so the blocks are float32; the caller gates it
        first (:func:`require_precision_ready`). ``tile=None`` asks
        ``likelihood/tuner.py`` for the cached knob of this assembly (the
        plain version's tile on the CPU, the kernel's TOA splits on the
        card), else the untuned defaults. Only the analytic white/ECORR
        C0 is fusable: a recipe with a structured ``noise_cov`` raises
        (the composed :meth:`build` prices it)."""
        if recipe.noise_cov is not None:
            raise ValueError(
                "the fused Woodbury rung prices the analytic white/"
                "ECORR C0 only; a recipe with a structured noise_cov "
                "block must use the composed ReducedGP.build"
            )
        dtype = dtype or batch.dtype
        sigma2, ecorr2, U, _phi = gls_noise_model(batch, recipe)
        winv, seg_sum, gain, logdet_c0 = white_ecorr_parts(batch, sigma2, ecorr2, dtype)
        winv = numerics.probe("solver.winv", winv)
        logdet_c0 = numerics.probe("solver.logdet_c0", logdet_c0)
        T, zero_col, ktm, ndof = _stack_columns(batch, design, U, dtype)
        if tile is None:
            from .tuner import woodbury_knob

            knob = woodbury_knob(T, precision)
        else:
            knob = {"tile": int(tile)}
        if residuals is None:
            r = torch.zeros(batch.mask.shape, dtype=dtype, device=batch.device)
        else:
            r = torch.as_tensor(residuals).to(device=batch.device, dtype=dtype) * batch.mask
        TNT, d, rNr = _fused_assembly(T, winv, gain, seg_sum, r,
                                      knob.get("tile", ops_gp.DEFAULT_WOODBURY_TILE),
                                      precision, knob.get("nsplit"))
        reduced = cls(
            TNT=TNT, CiT=None, logdet_c0=logdet_c0, sigma2=sigma2.to(dtype),
            ecorr2=None if ecorr2 is None else ecorr2.to(dtype),
            zero_col=zero_col, ndof=ndof, T=T, ktm=ktm, fused=True, precision=precision,
        )
        return reduced, (None if residuals is None else GPProjection(rNr=rNr, d=d))

    @property
    def ngp(self) -> int:
        return int(self.TNT.shape[-1]) - self.ktm

    def project(self, residuals, batch: PulsarBatch) -> GPProjection:
        """The Nt-sized reductions of residuals (..., Np, Nt); leading axes
        (a bank's realizations) carry through to the projection. The C0^-1
        apply is rebuilt from the retained variances through the same
        solver pieces the build used. On the bf16 build the projection is
        cast to float32, the assembly's dtype, so banked and build-time
        projections agree."""
        if self.fused:
            # C0^-1 r by the O(Nt) direct apply, then one contraction
            # against the retained T
            dtype = self.T.dtype
            r = torch.as_tensor(residuals).to(device=batch.device, dtype=dtype) * batch.mask
            winv, seg_sum, gain, _ld = white_ecorr_parts(batch, self.sigma2, self.ecorr2, dtype)
            y = winv * r
            if gain is not None:
                s_r = seg_sum(y[..., None])
                y = y - winv * pick_epochs(gain[..., None] * s_r, batch)[..., 0]
            rNr = torch.einsum("...pn,...pn->...p", r, y)
            d = torch.einsum("pnq,...pn->...pq", self.T, y)
            if self.precision == "bf16":
                rNr, d = rNr.float(), d.float()
            return GPProjection(rNr=numerics.probe("gp.fused_rnr", rNr),
                                d=numerics.probe("gp.fused_d", d))
        dtype = self.TNT.dtype
        r = torch.as_tensor(residuals).to(device=batch.device, dtype=dtype) * batch.mask
        _winv, c0inv, _ld = white_ecorr_solver(batch, self.sigma2, self.ecorr2, dtype,
                                               extra=self.extra, extra_s2=self.extra_s2)
        y = c0inv(r[..., None])[..., 0]
        # C0^-1 is symmetric: T^T C0^-1 r == (C0^-1 T)^T r
        return GPProjection(rNr=torch.einsum("...pn,...pn->...p", r, y),
                            d=torch.einsum("pnq,...pn->...pq", self.CiT, r))

    def loglikelihood(self, proj: GPProjection, phi, per_pulsar: bool = False):
        """log L at GP prior ``phi`` (Np, ngp) of a projection (Np, ...).

        Written out over two batch axes: ``phi`` may carry a leading grid
        axis (G, Np, ngp) and ``proj`` a leading realization axis (R, Np,
        ...). S = TNT_uu + Phi^-1 is factored once per (point, pulsar) and
        every realization is solved against that factor. The result has
        the axes (G, R) in that order, each only where the input has it,
        then (Np,) with ``per_pulsar``; nothing in it is proportional to
        Nt.

        On the bf16 build this algebra runs in float32 (the blocks'
        dtype), with log det C0 and the degrees of freedom in the build
        dtype, as the reference's promotion gives; S and A are
        symmetrized, (X + X^T) / 2, before their factors, as the
        reference's Cholesky does (its bf16 T^T W T is not symmetric, and
        this Cholesky reads only the lower triangle)."""
        dtype, k = self.TNT.dtype, self.ktm
        phi = torch.as_tensor(phi).to(device=self.TNT.device, dtype=dtype)
        grid_axis, real_axis = phi.ndim == 3, proj.rNr.ndim == 2
        phi = phi if grid_axis else phi[None]  # (G, Np, R)
        rNr = proj.rNr if real_axis else proj.rNr[None]  # (Rr, Np)
        dd = proj.d if real_axis else proj.d[None]  # (Rr, Np, Q)
        dd = dd.permute(1, 2, 0)[None]  # (1, Np, Q, Rr)

        active = (phi > 0).to(dtype)
        phi_safe = torch.where(phi > 0, phi, 1.0)
        TNT_uu = self.TNT[:, k:, k:] * (active[..., :, None] * active[..., None, :])
        sym = _symmetrized if self.precision == "bf16" else (lambda x: x)
        L = _cholesky(sym(TNT_uu + torch.diag_embed(1.0 / phi_safe)))  # (G, Np, R, R)
        L = numerics.probe_cholesky("gp.reduced_chol_rank", L)
        d_u = dd[:, :, k:] * active[..., None]  # (G, Np, R, Rr)
        z = torch.linalg.solve_triangular(L, d_u, upper=False)
        quad = rNr.T[None] - torch.sum(z * z, dim=-2)  # (G, Np, Rr)
        logdet = self.logdet_c0 + _chol_logdet(L) + torch.sum(torch.log(phi_safe) * active, dim=-1)
        if k:
            # with V = L^-1 TNT_um: A = TNT_mm - TNT_mu S^-1 TNT_um = TNT_mm
            # - V^T V and b = d_m - TNT_mu S^-1 d_u = d_m - V^T z
            TNT_mu = self.TNT[:, :k, k:] * active[..., None, :]  # (G, Np, k, R)
            V = torch.linalg.solve_triangular(L, TNT_mu.transpose(-1, -2), upper=False)
            A = self.TNT[:, :k, :k] - V.transpose(-1, -2) @ V
            A = A + torch.diag_embed(self.zero_col.to(dtype))
            La = numerics.probe_cholesky("gp.reduced_chol_tm", _cholesky(sym(A)))
            bm = dd[:, :, :k] - V.transpose(-1, -2) @ z  # (G, Np, k, Rr)
            zm = torch.linalg.solve_triangular(La, bm, upper=False)
            quad = quad - torch.sum(zm * zm, dim=-2)
            logdet = logdet + _chol_logdet(La)
        ll = -0.5 * (quad + logdet[..., None] + (self.ndof * _LOG_2PI)[:, None])  # (G, Np, Rr)
        ll = ll.permute(0, 2, 1)  # (G, Rr, Np)
        if not real_axis:
            ll = ll[:, 0]
        if not grid_axis:
            ll = ll[0]
        return ll if per_pulsar else torch.sum(ll, dim=-1)


def _symmetrized(x):
    return 0.5 * (x + x.transpose(-1, -2))


def phi_for_recipe(batch: PulsarBatch, recipe: Recipe):
    """The stacked GP prior variances (Np, R) of the recipe's noise model:
    the only piece a hyperparameter point moves when the white noise and
    the basis are fixed. O(Np R): no basis is built."""
    phi = gls_prior(batch, recipe)
    if phi is None:
        raise ValueError(
            "recipe has no GP noise block (red noise, chromatic, or GWB) — "
            "nothing for phi_for_recipe to evaluate"
        )
    return phi
