"""Gravitational-wave source geometry.

Counterpart of ``principal_axes`` in ``pta_replicator_tpu/models/cgw.py``:
the one home of the polarization-frame convention that the CW-catalog
planes (``ops/cw.py``, host float64 numpy) and the burst and memory
antenna patterns (``models/batched.py::_batch_antenna``, tensors) project
onto the pulsar directions.
"""
from __future__ import annotations

import numpy as np
import torch


def principal_axes(gwtheta, gwphi):
    """GW principal axes m, n and propagation direction omhat (each
    (..., 3)) for source sky position(s): tensors for tensor angles (on
    their device, in their dtype), else float64 numpy arrays."""
    xp = torch if isinstance(gwtheta, torch.Tensor) else np
    ct, st = xp.cos(gwtheta), xp.sin(gwtheta)
    cp, sp_ = xp.cos(gwphi), xp.sin(gwphi)
    m = xp.stack([sp_, -cp, xp.zeros_like(cp)], axis=-1)
    n = xp.stack([-ct * cp, -ct * sp_, st], axis=-1)
    omhat = xp.stack([-st * cp, -st * sp_, -ct], axis=-1)
    return m, n, omhat
