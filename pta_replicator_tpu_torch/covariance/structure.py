"""Structured beyond-diagonal noise-covariance representations.

Counterpart of ``pta_replicator_tpu/covariance/structure.py``: covariance
*structures* with one interface (:class:`CovOp`),

* ``matvec(x, s2)``   -- apply ``s2 * C``
* ``solve(x, s2)``    -- apply ``(s2 * C)^-1``
* ``logdet(s2)``      -- masked ``log det (s2 * C)`` over valid TOAs
* ``sample(draws, s2)`` -- ``N(0, s2 * C)`` from explicit standard normals
* ``dense()``         -- the numpy-float64 dense matrix

and four concrete structures: :class:`DenseCov` (dense per pulsar),
:class:`BandedCov` (block-tridiagonal inter-epoch correlation, O(Nt b^2)
solves), :class:`KroneckerCov` (time (x) frequency channel, the solar-wind
shape) and :class:`LowRankCov` (low rank over any base op, by Woodbury).

An op is a frozen dataclass of tensors with ``.to(device)`` and
``.astype(dtype)``; it rides inside a ``Recipe`` as ``noise_cov``. The
builders run on the host in float64 and store both the structure and its
Cholesky factor, cast last to the requested dtype, so sampling is a cheap
structured product and never a factorization. Ops are unit-normalized
(unit diagonal at valid TOAs) and scaled at evaluation time by ``s2 =
10^(2 cov_log10_sigma)`` from the Recipe.

Random draws: where the reference folds a key into the realization key,
the port takes explicit standard normals (``draw_shapes`` names them):
``"cov"`` (..., Np, Nt) for the structure and, for :class:`LowRankCov`,
``"cov_lowrank"`` (..., Np, R); a low-rank op nested ``d`` levels down
(a low-rank op's base that is itself low rank) names its draw
``"cov_lowrank_d"``. Leading axes are realizations.

Padding convention: stored structure blocks are zero on padding rows and
columns; factors are of the structure plus identity at padding
(decoupled unit rows that price ``log 1 = 0`` and solve to ``x``).
``nvalid`` makes the ``s2`` scaling of ``logdet`` exact under masking.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import kernels as K


def _as_np64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _wendland(r):
    """Compact-support Wendland-C2 taper: (1-r)^4 (4r+1) for r < 1,
    exactly 0 beyond."""
    rc = np.clip(r, 0.0, 1.0)
    return np.where(r < 1.0, (1.0 - rc) ** 4 * (4.0 * rc + 1.0), 0.0)


def _np_block_tridiag_cholesky(D, E, valid_blocks):
    """Host float64 block-tridiagonal Cholesky of the unit op (D plus the
    padding identity), run once per construction."""
    npsr, nb, b, _ = D.shape
    Ld = np.zeros_like(D)
    M = np.zeros_like(D)
    eye = np.eye(b)
    prev = None
    for k in range(nb):
        S = D[:, k] + np.einsum("ij,pj->pij", eye, 1.0 - valid_blocks[:, k])
        if k:
            Mk = np.swapaxes(np.linalg.solve(prev, np.swapaxes(E[:, k - 1], -1, -2)), -1, -2)
            M[:, k] = Mk
            S = S - Mk @ np.swapaxes(Mk, -1, -2)
        Ld[:, k] = np.linalg.cholesky(S)
        prev = Ld[:, k]
    return Ld, M


def _s2_arr(s2, like: torch.Tensor):
    """An s2 operand as a tensor in ``like``'s dtype and device: None ->
    1.0, else a scalar or per-pulsar (Np,)."""
    if s2 is None:
        return torch.ones((), dtype=like.dtype, device=like.device)
    return torch.as_tensor(s2).to(dtype=like.dtype, device=like.device)


def _bcol(s2, extra_dims: int):
    """Broadcast a scalar-or-(Np,) s2 against (Np, ...) operands."""
    if s2.ndim == 0:
        return s2
    return s2.reshape(s2.shape + (1,) * extra_dims)


def _solve_2d(solve3, x):
    """Lift a (Np, Nt, Q) map over (Np, Nt) vectors too."""
    if x.ndim == 2:
        return solve3(x[..., None])[..., 0]
    return solve3(x)


def _map_op(op, fn):
    """Copy of a frozen op with ``fn`` applied to every tensor field and
    the map applied to every nested op (a low-rank op's base)."""
    changes = {}
    for f in dataclasses.fields(op):
        value = getattr(op, f.name)
        if isinstance(value, torch.Tensor):
            changes[f.name] = fn(value)
        elif isinstance(value, CovOp):
            changes[f.name] = _map_op(value, fn)
    return dataclasses.replace(op, **changes)


class CovOp:
    """Interface mixin: concrete structures implement ``matvec``,
    ``solve``, ``logdet``, ``sample``, ``dense``, ``dense_device`` and
    ``draw_shapes``; ``to`` and ``astype`` come from here."""

    def to(self, device):
        """Move every tensor (a nested op's too) to ``device``."""
        return _map_op(self, lambda x: x.to(device))

    def astype(self, dtype):
        """Cast the floating tensors (a nested op's too) to ``dtype``."""
        return _map_op(self, lambda x: x.to(dtype) if x.is_floating_point() else x)

    def draw_shapes(self) -> dict:
        """Shape of one realization's standard normals, by family name."""
        return {"cov": (self.npsr, self.ntoa)}

    def matvec(self, x, s2=None):
        raise NotImplementedError

    def solve(self, x, s2=None):
        raise NotImplementedError

    def logdet(self, s2=None):
        raise NotImplementedError

    def sample(self, draws, s2=None):
        raise NotImplementedError

    def dense(self, pad_identity: bool = True) -> np.ndarray:
        raise NotImplementedError

    def dense_device(self, dtype):
        raise NotImplementedError


def _draw(draws, name, like):
    return torch.as_tensor(draws[name]).to(dtype=like.dtype, device=like.device)


def lowrank_draw_name(depth: int) -> str:
    """The draw of the low-rank op ``depth`` levels down a nest of
    :class:`LowRankCov` (0: the outermost)."""
    return "cov_lowrank" if depth == 0 else f"cov_lowrank_{depth}"


# ------------------------------------------------------------- dense

@dataclass(frozen=True)
class DenseCov(CovOp):
    """Dense per-pulsar covariance: ``mat`` (Np, n, n) pure signal part
    (zero padding rows), ``L`` its host-f64 Cholesky factor (with identity
    at padding), ``valid`` (Np, n) 1/0 mask, ``nvalid`` (Np,) counts."""

    mat: torch.Tensor
    L: torch.Tensor
    valid: torch.Tensor
    nvalid: torch.Tensor

    @property
    def npsr(self) -> int:
        return int(self.valid.shape[0])

    @property
    def ntoa(self) -> int:
        return int(self.valid.shape[1])

    @classmethod
    def from_dense(cls, mat, mask=None, dtype=torch.float64, device="cuda"):
        """Wrap an explicit (Np, n, n) SPD matrix (host-f64 factor)."""
        device = resolve_device(device)
        m = _as_np64(mat)
        npsr, n, _ = m.shape
        valid = np.ones((npsr, n)) if mask is None else (_as_np64(mask) > 0).astype(np.float64)
        m = m * valid[:, :, None] * valid[:, None, :]
        L = np.linalg.cholesky(m + np.einsum("ij,pj->pij", np.eye(n), 1.0 - valid))
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(mat=t(m), L=t(L), valid=t(valid), nvalid=t(valid.sum(axis=-1)))

    def matvec(self, x, s2=None):
        out = torch.einsum("pij,pj...->pi...", self.mat, x)
        return out * _bcol(_s2_arr(s2, x), out.ndim - 1)

    def solve(self, x, s2=None):
        s2 = _s2_arr(s2, x)
        return _solve_2d(lambda xx: K.cholesky_solve(self.L, xx) / _bcol(s2, 2), x)

    def logdet(self, s2=None):
        return K._chol_logdet(self.L) + self.nvalid * torch.log(_s2_arr(s2, self.L))

    def sample(self, draws, s2=None):
        z = _draw(draws, "cov", self.L)
        out = torch.einsum("pij,...pj->...pi", self.L, z)
        return out * self.valid * _bcol(torch.sqrt(_s2_arr(s2, self.L)), 1)

    def dense(self, pad_identity: bool = True) -> np.ndarray:
        m = _as_np64(self.mat)
        if pad_identity:
            m = m + np.einsum("ij,pj->pij", np.eye(m.shape[-1]), 1.0 - _as_np64(self.valid))
        return m

    def dense_device(self, dtype):
        return self.mat.to(dtype)


def dense_from_times(toas_s, mask, corr_s, nugget: float = 0.05,
                     dtype=torch.float64, device="cuda") -> DenseCov:
    """Unit-diagonal squared-exponential temporal covariance over the full
    TOA set: ``C = (K_SE(dt; corr_s) + nugget I) / (1 + nugget)``, SPD for
    any geometry."""
    t = _as_np64(toas_s)
    dt = t[:, :, None] - t[:, None, :]
    n = t.shape[1]
    C = (np.exp(-0.5 * (dt / float(corr_s)) ** 2) + float(nugget) * np.eye(n)[None]) / (1.0 + float(nugget))
    return DenseCov.from_dense(C, mask=mask, dtype=dtype, device=device)


# ------------------------------------------------------------ banded

@dataclass(frozen=True)
class BandedCov(CovOp):
    """Block-tridiagonal inter-epoch correlation: ``D`` (Np, nb, b, b)
    diagonal and ``E`` (Np, nb-1, b, b) sub-diagonal blocks of the pure
    signal part (unit diagonal at valid TOAs, zero padding), ``Ld``/``M``
    the host-f64 factor of the unit op, ``valid`` (Np, nb*b) the padded-
    grid mask, ``nvalid`` valid counts, ``nt`` the unpadded TOA count."""

    D: torch.Tensor
    E: torch.Tensor
    Ld: torch.Tensor
    M: torch.Tensor
    valid: torch.Tensor
    nvalid: torch.Tensor
    nt: int = 0

    @property
    def block(self) -> int:
        return int(self.D.shape[-1])

    @property
    def npsr(self) -> int:
        return int(self.D.shape[0])

    @property
    def ntoa(self) -> int:
        return self.nt

    def _grid(self, x):
        """(Np, Nt, Q) -> zero-padded (Np, nb, b, Q)."""
        npsr, nt, q = x.shape
        x = torch.nn.functional.pad(x, (0, 0, 0, self.valid.shape[1] - nt))
        return x.reshape(npsr, -1, self.block, q)

    def _ungrid(self, xg):
        return xg.reshape(xg.shape[0], -1, xg.shape[-1])[:, : self.nt]

    def matvec(self, x, s2=None):
        s2 = _s2_arr(s2, x)
        return _solve_2d(lambda xx: self._ungrid(
            K.block_tridiag_matvec(self.D, self.E, self._grid(xx))) * _bcol(s2, 2), x)

    def solve(self, x, s2=None):
        s2 = _s2_arr(s2, x)
        return _solve_2d(lambda xx: self._ungrid(
            K.block_tridiag_solve(self.Ld, self.M, self._grid(xx))) / _bcol(s2, 2), x)

    def logdet(self, s2=None):
        return K.block_tridiag_logdet(self.Ld) + self.nvalid * torch.log(_s2_arr(s2, self.Ld))

    def sample(self, draws, s2=None):
        z = _draw(draws, "cov", self.Ld)
        lead = z.shape[:-2]
        z = torch.nn.functional.pad(z, (0, self.valid.shape[1] - self.nt))
        s = K.block_tridiag_matmul_factor(
            self.Ld, self.M, z.reshape(lead + (self.npsr, -1, self.block)))
        s = s.reshape(lead + (self.npsr, -1))[..., : self.nt]
        return s * self.valid[:, : self.nt] * _bcol(torch.sqrt(_s2_arr(s2, self.Ld)), 1)

    def dense(self, pad_identity: bool = True) -> np.ndarray:
        D, E = _as_np64(self.D), _as_np64(self.E)
        npsr, nb, b, _ = D.shape
        C = np.zeros((npsr, nb * b, nb * b))
        for k in range(nb):
            k0 = k * b
            C[:, k0:k0 + b, k0:k0 + b] = D[:, k]
            if k:
                C[:, k0:k0 + b, k0 - b:k0] = E[:, k - 1]
                C[:, k0 - b:k0, k0:k0 + b] = np.swapaxes(E[:, k - 1], -1, -2)
        C = C[:, : self.nt, : self.nt]
        if pad_identity:
            v = _as_np64(self.valid)[:, : self.nt]
            C = C + np.einsum("ij,pj->pij", np.eye(self.nt), 1.0 - v)
        return C

    def dense_device(self, dtype):
        """Dense materialization of the pure part on the op's device (the
        combined solver's fallback when ECORR shares the covariance)."""
        npsr, nb, b, _ = self.D.shape
        C = torch.zeros((npsr, nb * b, nb * b), dtype=dtype, device=self.D.device)
        for k in range(nb):
            k0 = k * b
            C[:, k0:k0 + b, k0:k0 + b] = self.D[:, k]
            if k:
                C[:, k0:k0 + b, k0 - b:k0] = self.E[:, k - 1]
                C[:, k0 - b:k0, k0:k0 + b] = self.E[:, k - 1].transpose(-1, -2)
        return C[:, : self.nt, : self.nt]


def banded_from_times(toas_s, mask, rho, corr_s, block: int = 32,
                      dtype=torch.float64, device="cuda") -> BandedCov:
    """Unit-diagonal block-tridiagonal inter-epoch correlation from TOA
    times (host float64):

    ``R = I + (rho / max_row_mass) * W_tridiag(dt; corr_s)``

    with ``W`` the compact-support Wendland taper restricted to the block-
    tridiagonal sparsity and the coupling normalized by the largest off-
    diagonal row mass, so ``rho < 1`` makes ``R`` strictly diagonally
    dominant, hence SPD, for any cadence."""
    device = resolve_device(device)
    t = _as_np64(toas_s)
    m = (_as_np64(mask) > 0).astype(np.float64)
    npsr, nt = t.shape
    nb = -(-nt // block)
    ntp = nb * block
    tpad = np.pad(t, ((0, 0), (0, ntp - nt)))
    vpad = np.pad(m, ((0, 0), (0, ntp - nt)))
    tg = tpad.reshape(npsr, nb, block)
    vg = vpad.reshape(npsr, nb, block)

    r = float(corr_s)
    Wd = _wendland(np.abs(tg[:, :, :, None] - tg[:, :, None, :]) / r) * (vg[:, :, :, None] * vg[:, :, None, :])
    Wd = Wd * (1.0 - np.eye(block)[None, None])  # zero diagonal: W is pure coupling
    Wo = _wendland(np.abs(tg[:, 1:, :, None] - tg[:, :-1, None, :]) / r) * (vg[:, 1:, :, None] * vg[:, :-1, None, :])

    # off-diagonal row mass: within-block + both adjacent-block sides
    rows = Wd.sum(axis=-1)
    rows[:, 1:] += Wo.sum(axis=-1)
    rows[:, :-1] += Wo.sum(axis=-2)
    denom = np.maximum(rows.reshape(npsr, -1).max(axis=-1), 1e-12)
    coup = (np.broadcast_to(_as_np64(rho), (npsr,)) / denom)[:, None, None, None]

    D = coup * Wd + np.einsum("ij,pkj->pkij", np.eye(block), vg)
    E = coup * Wo
    Ld, M = _np_block_tridiag_cholesky(D, E, vg)
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return BandedCov(D=t_(D), E=t_(E), Ld=t_(Ld), M=t_(M), valid=t_(vpad),
                     nvalid=t_(m.sum(axis=-1)), nt=nt)


# --------------------------------------------------------- Kronecker

@dataclass(frozen=True)
class KroneckerCov(CovOp):
    """Time (x) frequency-channel Kronecker covariance ``Ct (x) Cf`` over
    an epoch-major (ne, nc) TOA grid: ``Ct`` (Np, ne, ne) epoch-level
    temporal factor, ``Cf`` (Np, nc, nc) channel factor, their host-f64
    Cholesky factors, ``nvalid`` (Np,) counts. Needs a full grid (every
    TOA valid, ``Nt = ne * nc`` in time order)."""

    Ct: torch.Tensor
    Cf: torch.Tensor
    Lt: torch.Tensor
    Lf: torch.Tensor
    nvalid: torch.Tensor

    @property
    def shape_grid(self):
        return int(self.Ct.shape[-1]), int(self.Cf.shape[-1])

    @property
    def npsr(self) -> int:
        return int(self.Ct.shape[0])

    @property
    def ntoa(self) -> int:
        ne, nc = self.shape_grid
        return ne * nc

    def matvec(self, x, s2=None):
        ne, nc = self.shape_grid
        s2 = _s2_arr(s2, x)

        def s3(xx):
            npsr, nt, q = xx.shape
            Y = torch.einsum("pij,pjcq->picq", self.Ct, xx.reshape(npsr, ne, nc, q))
            out = torch.einsum("pcd,pidq->picq", self.Cf, Y)
            return out.reshape(npsr, nt, q) * _bcol(s2, 2)

        return _solve_2d(s3, x)

    def solve(self, x, s2=None):
        s2 = _s2_arr(s2, x)
        return _solve_2d(lambda xx: K.kron_solve(self.Lt, self.Lf, xx) / _bcol(s2, 2), x)

    def logdet(self, s2=None):
        return K.kron_logdet(self.Lt, self.Lf) + self.nvalid * torch.log(_s2_arr(s2, self.Lt))

    def sample(self, draws, s2=None):
        ne, nc = self.shape_grid
        z = _draw(draws, "cov", self.Lt)
        lead = z.shape[:-2]
        s = K.kron_sample_map(self.Lt, self.Lf, z.reshape(lead + (self.npsr, ne, nc)))
        return s.reshape(lead + (self.npsr, ne * nc)) * _bcol(torch.sqrt(_s2_arr(s2, self.Lt)), 1)

    def dense(self, pad_identity: bool = True) -> np.ndarray:
        Ct, Cf = _as_np64(self.Ct), _as_np64(self.Cf)
        return np.stack([np.kron(Ct[p], Cf[p]) for p in range(Ct.shape[0])])

    def dense_device(self, dtype):
        ne, nc = self.shape_grid
        C = torch.einsum("pij,pcd->picjd", self.Ct.to(dtype), self.Cf.to(dtype))
        return C.reshape(self.npsr, ne * nc, ne * nc)


def kron_time_channel(toas_s, channels: int, time_ell_s, chan_rho,
                      nugget: float = 0.05, dtype=torch.float64, device="cuda",
                      mask=None) -> KroneckerCov:
    """Kronecker time (x) channel covariance from TOA times: consecutive
    groups of ``channels`` TOAs form one epoch (Nt must divide evenly);
    the temporal factor is a unit-diagonal squared-exponential kernel over
    epoch mean times (+ nugget), the channel factor an AR(1) correlation
    ``chan_rho^|a-b|``. The structure has no padding escape: pass ``mask``
    to have the builder refuse a masked TOA."""
    device = resolve_device(device)
    if mask is not None and not np.all(_as_np64(mask) > 0):
        raise ValueError(
            "KroneckerCov needs a FULL TOA grid (every TOA valid): the "
            "time (x) channel structure cannot decouple masked TOAs; "
            "use BandedCov/DenseCov for ragged batches"
        )
    t = _as_np64(toas_s)
    npsr, nt = t.shape
    nc = int(channels)
    if nt % nc:
        raise ValueError(f"Kronecker grid needs ntoa ({nt}) divisible by channels ({nc})")
    ne = nt // nc
    tg = t.reshape(npsr, ne, nc).mean(axis=-1)
    Ct = np.exp(-0.5 * ((tg[:, :, None] - tg[:, None, :]) / float(time_ell_s)) ** 2)
    Ct = (Ct + float(nugget) * np.eye(ne)[None]) / (1.0 + float(nugget))
    ab = np.abs(np.arange(nc)[:, None] - np.arange(nc)[None, :])
    Cf = np.broadcast_to(_as_np64(chan_rho), (npsr,))[:, None, None] ** ab[None]
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return KroneckerCov(Ct=t_(Ct), Cf=t_(Cf), Lt=t_(np.linalg.cholesky(Ct)),
                        Lf=t_(np.linalg.cholesky(Cf)), nvalid=t_(np.full(npsr, float(nt))))


# ------------------------------------------------- low-rank + base

@dataclass(frozen=True)
class LowRankCov(CovOp):
    """Low-rank-plus-structured: ``C = base + U diag(phi) U^T`` over any
    base op, solved by the Woodbury identity through the base's own
    structured solve (an (R, R) Cholesky on top)."""

    base: CovOp
    U: torch.Tensor
    phi: torch.Tensor

    @property
    def nvalid(self):
        return self.base.nvalid

    @property
    def npsr(self) -> int:
        return self.base.npsr

    @property
    def ntoa(self) -> int:
        return self.base.ntoa

    def draw_shapes(self, depth: int = 0) -> dict:
        """The base's draws, then this op's own low-rank draw
        (:func:`lowrank_draw_name`); a low-rank base names its draws one
        level deeper. The reference splits the key (base, low rank) at
        each level; the draws here are those two subkeys' normals."""
        base = (self.base.draw_shapes(depth + 1) if isinstance(self.base, LowRankCov)
                else self.base.draw_shapes())
        return {**base, lowrank_draw_name(depth): tuple(self.phi.shape)}

    def matvec(self, x, s2=None):
        s2 = _s2_arr(s2, self.U)

        def s3(xx):
            inner = torch.einsum("pnr,pnq->prq", self.U, xx)
            lowr = torch.einsum("pnr,prq->pnq", self.U, inner * self.phi[:, :, None])
            return self.base.matvec(xx, s2=s2) + lowr * _bcol(s2, 2)

        return _solve_2d(s3, x)

    def _woodbury(self):
        G = self.base.solve(self.U)  # base^-1 U, (Np, Nt, R)
        S = torch.einsum("pnr,pns->prs", self.U, G)
        S = S + torch.diag_embed(1.0 / self.phi)
        return G, K._cholesky(S)

    def solve(self, x, s2=None):
        s2 = _s2_arr(s2, self.U)

        def s3(xx):
            G, L = self._woodbury()
            y = self.base.solve(xx)
            inner = torch.einsum("pnr,pnq->prq", self.U, y)
            z = y - torch.einsum("pnr,prq->pnq", G, torch.cholesky_solve(inner, L, upper=False))
            return z / _bcol(s2, 2)

        return _solve_2d(s3, x)

    def logdet(self, s2=None):
        _G, L = self._woodbury()
        return (self.base.logdet() + K._chol_logdet(L) + torch.sum(torch.log(self.phi), dim=-1)
                + self.nvalid * torch.log(_s2_arr(s2, self.U)))

    def sample(self, draws, s2=None, depth: int = 0):
        z = _draw(draws, lowrank_draw_name(depth), self.U)
        lr = torch.einsum("pnr,...pr->...pn", self.U, torch.sqrt(self.phi) * z)
        base = (self.base.sample(draws, depth=depth + 1) if isinstance(self.base, LowRankCov)
                else self.base.sample(draws))
        return (base + lr) * _bcol(torch.sqrt(_s2_arr(s2, self.U)), 1)

    def dense(self, pad_identity: bool = True) -> np.ndarray:
        U, phi = _as_np64(self.U), _as_np64(self.phi)
        return self.base.dense(pad_identity=pad_identity) + np.einsum("pnr,pr,pmr->pnm", U, phi, U)

    def dense_device(self, dtype):
        U = self.U.to(dtype)
        return self.base.dense_device(dtype) + torch.einsum(
            "pnr,pr,pmr->pnm", U, self.phi.to(dtype), U)


# ------------------------------------------- recipe-facing helpers

def recipe_cov_s2(recipe, dtype=None):
    """The evaluation-time amplitude of a recipe's correlated-noise block:
    ``10^(2 cov_log10_sigma)``, or None when the recipe carries no
    amplitude (the op's built-in unit scale applies)."""
    ls = getattr(recipe, "cov_log10_sigma", None)
    if ls is None:
        return None
    ls = torch.as_tensor(ls)
    if dtype is not None:
        ls = ls.to(dtype)
    return 10.0 ** (2.0 * ls)


def _fold_rhs(c0inv_mat):
    """Lift a (Np, Nt, Q) solve over (..., Np, Nt, Q): leading
    (realization) axes fold into the right-hand-side axis, so the factor is
    never broadcast over them."""
    def apply(X):
        if X.ndim == 3:
            return c0inv_mat(X)
        lead, (npsr, nt, q) = X.shape[:-3], X.shape[-3:]
        Xf = X.reshape(-1, npsr, nt, q).permute(1, 2, 0, 3).reshape(npsr, nt, -1)
        Z = c0inv_mat(Xf).reshape(npsr, nt, -1, q).permute(2, 0, 1, 3)
        return Z.reshape(lead + (npsr, nt, q))

    return apply


def banded_c0_blocks(op: BandedCov, safe_sigma2, s2, dtype):
    """The block-tridiagonal ``(D, E)`` of ``C0 = diag(sigma2) + s2 *
    R_banded``: the white diagonal folded into the diagonal blocks, 1 on
    the block grid's padding tail."""
    npsr, nb, b, _ = op.D.shape
    sig = torch.nn.functional.pad(safe_sigma2.to(dtype), (0, nb * b - safe_sigma2.shape[1]),
                                  value=1.0)
    sc = _bcol(_s2_arr(s2, sig), 3)
    return op.D.to(dtype) * sc + torch.diag_embed(sig.reshape(npsr, nb, b)), op.E.to(dtype) * sc


def banded_combined_solver(op: BandedCov, safe_sigma2, s2, dtype):
    """Structured solver for ``C0 = diag(sigma2) + s2 * R_banded``: the
    white diagonal folds into the block-tridiagonal diagonal blocks, so the
    combined factor stays O(Nt b^2). Padding rows (masked TOAs, whose safe
    sigma2 is 1, and the block-grid tail) stay exact identity. Returns
    ``(c0inv_mat, logdet)``: a map over (..., Np, Nt, Q) and the (Np,)
    log-determinant. One factorization (the forward kernel's factor sweep
    on the card), then each apply is one forward and one backward
    substitution sweep."""
    npsr, nb, b, _ = op.D.shape
    ntp = nb * b
    Ld, M = K.block_tridiag_cholesky(*banded_c0_blocks(op, safe_sigma2, s2, dtype))
    logdet = K.block_tridiag_logdet(Ld)

    def c0inv_mat(X):
        _, nt, q = X.shape
        Xp = torch.nn.functional.pad(X, (0, 0, 0, ntp - nt))
        Z = K.block_tridiag_solve(Ld, M, Xp.reshape(npsr, nb, b, q))
        return Z.reshape(npsr, ntp, q)[:, :nt]

    return _fold_rhs(c0inv_mat), logdet


def dense_c0(batch, safe_sigma2, ecorr2, extra, s2, dtype):
    """The dense (Np, Nt, Nt) ``C0 = diag(sigma2) + U_ec diag(ecorr2)
    U_ec^T + s2 * X`` on the batch's device. The ECORR block adds
    ``ecorr2[e]`` where two valid TOAs share epoch e, the value the
    reference's one-hot product gives."""
    C = torch.diag_embed(safe_sigma2.to(dtype))
    if extra is not None:
        C = C + extra.dense_device(dtype) * _bcol(_s2_arr(s2, C), 2)
    if ecorr2 is not None:
        mask = batch.mask.to(dtype)
        per_toa = torch.gather(ecorr2.to(dtype), 1, batch.epoch_index) * mask
        same = batch.epoch_index[:, :, None] == batch.epoch_index[:, None, :]
        C = C + torch.where(same, per_toa[:, :, None] * mask[:, None, :], 0.0)
    return C


def dense_combined_solver(batch, safe_sigma2, ecorr2, extra, s2, dtype):
    """Dense fallback for C0 (:func:`dense_c0`) with any structured extra:
    materialize, factor with the dense-Cholesky dispatcher (blocked, with
    the SYRK kernel, on the card), solve by triangular substitution.
    O(Nt^3) per pulsar; correct for every structure and ECORR
    combination."""
    L = K.dense_cholesky(dense_c0(batch, safe_sigma2, ecorr2, extra, s2, dtype))
    logdet = K._chol_logdet(L)
    return _fold_rhs(lambda X: K.cholesky_solve(L, X)), logdet
