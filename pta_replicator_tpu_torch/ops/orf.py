"""Hellings-Downs overlap reduction function, on the host in float64.

Counterpart of ``hellings_downs`` / ``hellings_downs_matrix`` in
``pta_replicator_tpu/ops/orf.py``. The ORF depends only on the pulsar sky
positions, so it is built once per dataset in numpy; its Cholesky factor
is what the GWB mix puts on the device.
"""
from __future__ import annotations

import numpy as np


def hellings_downs(zeta, same_pulsar: bool = False):
    """Closed-form Hellings-Downs correlation with Gamma(0+) = 1/2; for
    coincident pulsars the pulsar term doubles the value to 1."""
    x = (1.0 - np.cos(zeta)) / 2.0
    # guard log(0) at zeta=0; the x*log(x) limit is 0 there
    safe = np.where(x > 0, x, 1.0)
    val = 0.5 - x / 4.0 + 1.5 * x * np.log(safe)
    if same_pulsar:
        return np.ones_like(val)
    return val


def hellings_downs_matrix(psr_phi_theta: np.ndarray) -> np.ndarray:
    """Np x Np Hellings-Downs ORF matrix (diag = 2, off-diag =
    2 * Gamma_HD) from (Np, 2) pulsar (phi, theta) positions."""
    phi = np.asarray(psr_phi_theta[:, 0])
    theta = np.asarray(psr_phi_theta[:, 1])
    n = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        axis=-1,
    )
    zeta = np.arccos(np.clip(n @ n.T, -1.0, 1.0))
    off = 2.0 * hellings_downs(zeta)
    eye = np.eye(len(psr_phi_theta))
    return off * (1.0 - eye) + 2.0 * eye
