"""PulsarBatch: the frozen, padded tensor form of a pulsar array.

Counterpart of ``pta_replicator_tpu/batch.py``: the same fields and static
metadata. Times are seconds relative to ``tref_mjd`` so that float32
keeps sub-millisecond resolution; data-dependent structure (ECORR epochs,
backend flags, ragged TOA counts) is resolved into int64 index tensors,
the index type ``torch.gather`` takes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .constants import DAY_IN_SEC
from .device import resolve_device
from .ops.coords import pulsar_theta_phi, unit_vector
from .ops.quantize import quantize


def _map_tensors(obj, fn):
    """Copy of a frozen dataclass with ``fn`` applied to every tensor field."""
    changes = {
        f.name: fn(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    }
    return dataclasses.replace(obj, **changes)


@dataclass(frozen=True)
class PulsarBatch:
    """Padded/masked tensors describing Np pulsars with up to Nt TOAs."""

    #: (Np, Nt) TOA epochs [s relative to tref_mjd]
    toas_s: torch.Tensor
    #: (Np, Nt) TOA uncertainties [s] (1.0 in padding)
    errors_s: torch.Tensor
    #: (Np, Nt) 1.0 for real TOAs, 0.0 for padding
    mask: torch.Tensor
    #: (Np, 3) pulsar direction unit vectors
    phat: torch.Tensor
    #: (Np, Nt) int64 ECORR epoch index (local per pulsar)
    epoch_index: torch.Tensor
    #: (Np, max_epochs) 1.0 for real epochs
    epoch_mask: torch.Tensor
    #: (Np, max_epochs) int64 backend index of each epoch
    epoch_backend_index: torch.Tensor
    #: (Np, Nt) int64 backend/flag-group index
    backend_index: torch.Tensor
    #: (Np,) observation span [s] of each pulsar
    tspan_s: torch.Tensor
    #: (Np,) int64 number of valid TOAs
    ntoas: torch.Tensor
    #: (Np, Nt) observing radio frequency [MHz]; None when unknown
    freqs_mhz: Optional[torch.Tensor] = None

    # static metadata
    tref_mjd: float = 0.0
    names: tuple = ()
    backend_names: tuple = ()
    start_s: float = 0.0
    stop_s: float = 0.0

    @property
    def npsr(self) -> int:
        return self.toas_s.shape[0]

    @property
    def ntoa_max(self) -> int:
        return self.toas_s.shape[1]

    @property
    def max_epochs(self) -> int:
        return self.epoch_mask.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.toas_s.dtype

    @property
    def device(self) -> torch.device:
        return self.toas_s.device

    def astype(self, dtype) -> "PulsarBatch":
        """Cast the floating tensors (times stay in their relative frame)."""
        return _map_tensors(
            self, lambda x: x.to(dtype) if x.is_floating_point() else x
        )

    def to(self, device) -> "PulsarBatch":
        """Move every tensor to ``device``."""
        return _map_tensors(self, lambda x: x.to(device))


def synthetic_batch(npsr: int = 68, ntoa: int = 7758, nbackend: int = 4,
                    span_days: float = 365.25 * 16, toaerr_s: float = 0.5e-6,
                    epoch_days: float = 14.0, seed: int = 0,
                    dtype=torch.float32, device="cuda") -> PulsarBatch:
    """NG15-scale synthetic PulsarBatch (random sky positions, ~epoch_days
    cadence with several TOAs per epoch across nbackend backends). The
    numpy RNG call order is the JAX package's, so the arrays are bitwise
    equal to its ``synthetic_batch`` at the same dtype."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    nepoch = max(1, int(span_days / epoch_days))
    per_epoch = max(1, ntoa // nepoch)
    nepoch = (ntoa + per_epoch - 1) // per_epoch

    epoch_times = np.sort(rng.uniform(0.0, span_days, size=(npsr, nepoch)), axis=1)
    offsets = rng.uniform(0.0, 0.2, size=(npsr, nepoch, per_epoch))
    toas_d = (epoch_times[:, :, None] + offsets).reshape(npsr, -1)[:, :ntoa]
    toas_d = np.sort(toas_d, axis=1)
    toas_s = (toas_d - span_days / 2.0) * DAY_IN_SEC

    epoch_idx = (np.arange(ntoa) // per_epoch)[None, :].repeat(npsr, axis=0)
    nep = int(epoch_idx.max()) + 1
    epoch_mask = np.ones((npsr, nep))
    epoch_backend = rng.integers(0, nbackend, size=(npsr, nep))
    backend_idx = np.take_along_axis(epoch_backend, epoch_idx, axis=1)

    costheta = rng.uniform(-1, 1, npsr)
    phi = rng.uniform(0, 2 * np.pi, npsr)
    sintheta = np.sqrt(1 - costheta**2)
    phat = np.stack(
        [sintheta * np.cos(phi), sintheta * np.sin(phi), costheta], axis=1
    )

    # per-backend observing bands with a little per-TOA bandwidth scatter
    band_centers = np.linspace(430.0, 2300.0, nbackend)
    freqs = band_centers[backend_idx] * rng.uniform(0.9, 1.1, size=backend_idx.shape)

    real = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    index = lambda a: torch.as_tensor(a, dtype=torch.int64).to(device)
    return PulsarBatch(
        toas_s=real(toas_s),
        errors_s=torch.full((npsr, ntoa), toaerr_s, dtype=dtype, device=device),
        mask=torch.ones((npsr, ntoa), dtype=dtype, device=device),
        phat=real(phat),
        epoch_index=index(epoch_idx),
        epoch_mask=real(epoch_mask),
        epoch_backend_index=index(epoch_backend),
        backend_index=index(backend_idx),
        tspan_s=real(toas_s.max(axis=1) - toas_s.min(axis=1)),
        ntoas=torch.full((npsr,), ntoa, dtype=torch.int64, device=device),
        freqs_mhz=real(freqs),
        tref_mjd=55000.0,
        names=tuple(f"SYN{i:04d}" for i in range(npsr)),
        backend_names=tuple(f"backend{i}" for i in range(nbackend)),
        start_s=float(toas_s.min() - DAY_IN_SEC),
        stop_s=float(toas_s.max() + DAY_IN_SEC),
    )


def freeze(psrs: List, flagid: str = "f", coarsegrain: float = 0.1,
           tref_mjd: Optional[float] = None, dtype=torch.float32,
           device="cuda") -> PulsarBatch:
    """Freeze a list of :class:`~.simulate.SimulatedPulsar` (or anything
    with ``.toas``/``.loc``/``.name``: the JAX package's pulsars too) into
    a PulsarBatch on ``device``.

    Counterpart of ``pta_replicator_tpu/batch.py::freeze``, bit for bit in
    float64: ragged TOA sets are padded to the max count (padding rows
    repeat the last TOA, with unit errors and zero mask), ECORR epochs are
    binned (greedy ``coarsegrain``-day buckets by :func:`~.ops.quantize.
    quantize`), and per-TOA ``-flagid`` flags become integer groups shared
    across the array, the vocabulary growing in order of first appearance;
    each epoch's backend is that of its time-first TOA. Epochs leave
    longdouble only here: ``tref_mjd`` is subtracted from the float64 MJDs
    and the difference scaled to seconds on the host, before any tensor
    exists. Index tensors are int64 (int32 in the JAX package).

    Runs under a ``freeze`` span with the ``batch.freezes`` and
    ``batch.toas_frozen`` counters (counted from the host TOA sets)."""
    from .obs import counter, span

    with span("freeze", npsr=len(psrs)) as sp:
        batch = _freeze_impl(psrs, flagid, coarsegrain, tref_mjd, dtype, device)
        sp["ntoa_max"] = batch.ntoa_max
        sp["max_epochs"] = batch.max_epochs
        counter("batch.freezes").inc()
        counter("batch.toas_frozen").inc(int(sum(p.toas.ntoas for p in psrs)))
        return batch


def _freeze_impl(psrs: List, flagid: str, coarsegrain: float, tref_mjd: Optional[float],
                 dtype, device) -> PulsarBatch:
    device = resolve_device(device)
    npsr = len(psrs)
    ntoas = np.array([p.toas.ntoas for p in psrs], dtype=np.int64)
    nt = int(ntoas.max())

    mjds = [p.toas.get_mjds() for p in psrs]
    if tref_mjd is None:
        tref_mjd = float(
            0.5 * (min(m.min() for m in mjds) + max(m.max() for m in mjds))
        )

    toas = np.zeros((npsr, nt))
    errors = np.ones((npsr, nt))
    mask = np.zeros((npsr, nt))
    # observing frequencies feed chromatic noise; if ANY pulsar lacks
    # them the whole field stays None so the chromatic op raises loudly
    # instead of silently treating a 1400 MHz fill as real physics
    have_freqs = all(
        getattr(p.toas, "freqs_mhz", None) is not None for p in psrs
    )
    freqs = np.full((npsr, nt), 1400.0)  # benign padding (no div-by-zero)
    backend_idx = np.zeros((npsr, nt), dtype=np.int64)
    epoch_idx = np.zeros((npsr, nt), dtype=np.int64)
    phat = np.zeros((npsr, 3))
    tspan = np.zeros(npsr)

    # global backend vocabulary across pulsars
    backend_names: List[str] = []
    epoch_counts = []
    epoch_indices = []
    for i, p in enumerate(psrs):
        n = p.toas.ntoas
        rel = (mjds[i] - tref_mjd) * DAY_IN_SEC
        toas[i, :n] = rel
        toas[i, n:] = rel[-1] if n else 0.0  # benign padding values
        errors[i, :n] = p.toas.errors_s
        if have_freqs:
            freqs[i, :n] = p.toas.freqs_mhz
        mask[i, :n] = 1.0
        tspan[i] = rel[:n].max() - rel[:n].min() if n else 0.0
        theta, phi = pulsar_theta_phi(p.loc, p.name)
        phat[i] = unit_vector(theta, phi)

        flags = p.toas.get_flag(flagid)
        # the global vocabulary grows in order of first appearance (TOA
        # order within each pulsar), so re-freezing a dataset reproduces
        # the backend_names ordering of any tables built against it
        flags_arr = np.asarray([str(v) for v in flags])
        uniq, first, inv = np.unique(
            flags_arr, return_index=True, return_inverse=True
        )
        local_to_global = np.empty(len(uniq), dtype=np.int64)
        for u_i in np.argsort(first):
            val = str(uniq[u_i])  # plain str, not np.str_
            if val not in backend_names:
                backend_names.append(val)
            local_to_global[u_i] = backend_names.index(val)
        backend_idx[i, :n] = local_to_global[inv]

        bins = quantize(mjds[i], flags=flags, dt=coarsegrain)
        epoch_indices.append(bins.epoch_index)
        epoch_counts.append(bins.nepochs)

    max_epochs = int(max(epoch_counts)) if epoch_counts else 1
    epoch_mask = np.zeros((npsr, max_epochs))
    epoch_backend = np.zeros((npsr, max_epochs), dtype=np.int64)
    for i, p in enumerate(psrs):
        idx, cnt = epoch_indices[i], epoch_counts[i]
        epoch_idx[i, : len(idx)] = idx
        epoch_mask[i, :cnt] = 1.0
        # backend of each epoch = backend of its (time-)first TOA
        order = np.argsort(mjds[i], kind="stable")
        uniq_e, first_pos = np.unique(idx[order], return_index=True)
        epoch_backend[i, uniq_e] = backend_idx[i, order[first_pos]]

    start = float(min(m.min() for m in mjds) - 1.0) * DAY_IN_SEC
    stop = float(max(m.max() for m in mjds) + 1.0) * DAY_IN_SEC

    real = lambda a: torch.from_numpy(a).to(dtype=dtype, device=device)
    index = lambda a: torch.from_numpy(a).to(device)
    return PulsarBatch(
        toas_s=real(toas),
        errors_s=real(errors),
        mask=real(mask),
        phat=real(phat),
        epoch_index=index(epoch_idx),
        epoch_mask=real(epoch_mask),
        epoch_backend_index=index(epoch_backend),
        backend_index=index(backend_idx),
        tspan_s=real(tspan),
        ntoas=index(ntoas),
        freqs_mhz=real(freqs) if have_freqs else None,
        tref_mjd=tref_mjd,
        names=tuple(p.name for p in psrs),
        backend_names=tuple(backend_names),
        start_s=start - tref_mjd * DAY_IN_SEC,
        stop_s=stop - tref_mjd * DAY_IN_SEC,
    )
