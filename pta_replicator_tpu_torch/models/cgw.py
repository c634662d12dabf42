"""Continuous-wave source geometry, on the host in float64.

Counterpart of ``principal_axes`` in ``pta_replicator_tpu/models/cgw.py``:
the one home of the polarization-frame convention that the CW-catalog
planes (``ops/cw.py``) project onto the pulsar directions.
"""
from __future__ import annotations

import numpy as np


def principal_axes(gwtheta, gwphi):
    """GW principal axes m, n and propagation direction omhat (each
    (..., 3)) for source sky position(s)."""
    ct, st = np.cos(gwtheta), np.sin(gwtheta)
    cp, sp_ = np.cos(gwphi), np.sin(gwphi)
    m = np.stack([sp_, -cp, np.zeros_like(cp)], axis=-1)
    n = np.stack([-ct * cp, -ct * sp_, st], axis=-1)
    omhat = np.stack([-st * cp, -st * sp_, -ct], axis=-1)
    return m, n, omhat
