"""Rank-reduced GP likelihood: direct evaluation, the ReducedGP serving
path, grid and bank evaluation, and request-batched serving."""
from .gp import GPProjection, ReducedGP, loglikelihood, phi_for_recipe
from .infer import bank_loglikelihood, grid_cartesian, grid_loglikelihood
from .serve import (
    DeadlineExpired,
    LikelihoodServer,
    RealizationBank,
    ServerSaturated,
    project_bank,
)

__all__ = [
    "DeadlineExpired", "GPProjection", "LikelihoodServer", "RealizationBank",
    "ReducedGP", "ServerSaturated", "bank_loglikelihood", "grid_cartesian",
    "grid_loglikelihood", "loglikelihood", "phi_for_recipe", "project_bank",
]
