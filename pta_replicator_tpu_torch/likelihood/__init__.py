"""Rank-reduced GP likelihood: direct evaluation, the ReducedGP serving
path, grid and bank evaluation, the MAP fit, request-batched serving, and
the launch-plan tuner of the fused Woodbury assembly (``tuner``)."""
from . import tuner
from .gp import (
    FUSED_PRECISION_SITES,
    GPProjection,
    PrecisionNotReady,
    ReducedGP,
    loglikelihood,
    phi_for_recipe,
)
from .infer import MapResult, bank_loglikelihood, grid_cartesian, grid_loglikelihood, map_fit
from .serve import (
    DeadlineExpired,
    LikelihoodServer,
    RealizationBank,
    ServerSaturated,
    project_bank,
)

__all__ = [
    "DeadlineExpired", "FUSED_PRECISION_SITES", "GPProjection", "LikelihoodServer",
    "MapResult", "PrecisionNotReady", "RealizationBank", "ReducedGP", "ServerSaturated",
    "bank_loglikelihood", "grid_cartesian", "grid_loglikelihood", "loglikelihood",
    "map_fit", "phi_for_recipe", "project_bank", "tuner",
]
