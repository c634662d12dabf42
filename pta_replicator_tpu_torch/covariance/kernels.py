"""Covariance kernels: the helpers the likelihood needs so far.

Counterpart of ``pta_replicator_tpu/covariance/kernels.py``. The blocked
and block-tridiagonal Cholesky kernels arrive with ROADMAP.md item A.10.
"""
from __future__ import annotations

import torch


def _chol_logdet(L):
    """log det from a (batched) Cholesky factor: 2 sum log diag."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
