"""Beyond-diagonal noise covariance: structured representations
(:mod:`.structure`) and their blocked, block-tridiagonal and Kronecker
solve kernels (:mod:`.kernels`).

Counterpart of ``pta_replicator_tpu/covariance``: a :class:`CovOp` rides
inside a ``Recipe`` as ``noise_cov``; ``realize`` samples correlated noise
from it and the GP likelihood prices it inside C0. Two names of the
reference's package are not here: the numpy oracle
``dense_noise_covariance`` (the tests call the reference's), and
``COV_STREAM_FOLD``, the key-fold index of the reference's draw (the port
takes its draws as explicit standard normals, ``noise["cov"]``).
"""
from .structure import (  # noqa: F401
    BandedCov,
    CovOp,
    DenseCov,
    KroneckerCov,
    LowRankCov,
    banded_from_times,
    dense_from_times,
    kron_time_channel,
    recipe_cov_s2,
)
from . import kernels  # noqa: F401
