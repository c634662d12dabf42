"""The standalone timing engine on the host: time scales, the timing model
and its delay components, the full-model design and the least-squares
fits (counterpart of ``pta_replicator_tpu/timing``)."""
from .model import SpindownTiming, phase_residuals, weighted_mean
from .fit import design_matrix, wls_fit, gls_fit

__all__ = [
    "SpindownTiming",
    "phase_residuals",
    "weighted_mean",
    "design_matrix",
    "wls_fit",
    "gls_fit",
]
