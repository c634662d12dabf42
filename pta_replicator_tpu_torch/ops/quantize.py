"""Epoch quantization for ECORR (correlated jitter) noise.

Counterpart of ``pta_replicator_tpu/ops/quantize.py``, a copy (the port
imports nothing of the JAX package), so that ``freeze`` bins epochs as the
JAX package does, bit for bit. The reference (``quantize_fast``,
pta_replicator/white_noise.py:7-44) materializes a dense (ntoa x nepoch)
0/1 exploder matrix U; here the binning yields an integer *epoch index*
per TOA instead, so applying per-epoch draws on the card is a gather
(``draws[epoch_idx]``). The data-dependent binning runs once, on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EpochBins:
    """Greedy time-binning of TOAs."""

    #: epoch index of each TOA, shape (ntoa,)
    epoch_index: np.ndarray
    #: mean TOA time per epoch, shape (nepoch,)
    ave_times: np.ndarray
    #: representative flag value per epoch (first member), or None
    ave_flags: np.ndarray = None

    @property
    def nepochs(self) -> int:
        return len(self.ave_times)

    def exploder(self) -> np.ndarray:
        """Dense (ntoa, nepoch) 0/1 matrix, for tests/interop only."""
        U = np.zeros((len(self.epoch_index), self.nepochs))
        U[np.arange(len(self.epoch_index)), self.epoch_index] = 1.0
        return U


def quantize(times: np.ndarray, flags=None, dt: float = 1.0) -> EpochBins:
    """Greedy-bin TOAs into epochs of width ``dt`` (same units as times).

    A new epoch starts when a (time-sorted) TOA lies >= dt after the *first*
    TOA of the current epoch — matching the reference's bucketing rule so
    epoch structures agree exactly.
    """
    times = np.asarray(times, dtype=np.float64)
    n = len(times)
    order = np.argsort(times, kind="stable")
    ts = times[order]

    # boundary walk: one searchsorted per epoch (O(E log N)) instead of a
    # Python append per TOA
    bounds = [0]
    i = 0
    while i < n:
        i = int(np.searchsorted(ts, ts[i] + dt, side="left"))
        bounds.append(i)
    bounds = np.asarray(bounds)
    sizes = np.diff(bounds)
    nep = len(sizes)

    epoch_of = np.empty(n, dtype=np.int64)
    epoch_of[order] = np.repeat(np.arange(nep), sizes)
    ave = np.add.reduceat(ts, bounds[:-1]) / sizes if n else np.zeros(0)
    aveflags = None
    if flags is not None:
        aveflags = np.asarray(flags)[order[bounds[:-1]]]
    return EpochBins(epoch_index=epoch_of, ave_times=ave, ave_flags=aveflags)
