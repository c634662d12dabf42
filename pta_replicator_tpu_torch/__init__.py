"""pta_replicator_tpu_torch: the PyTorch/CUDA port of pta_replicator_tpu.

Simulated pulsar-timing-array datasets on an NVIDIA GPU: the flagship
realization path (white, ECORR, red and chromatic noise, a
Hellings-Downs-correlated GW background with a power-law or user
spectrum, a CW catalog through a hand-written CUDA kernel, bursts, bursts
with memory and transients, and the refit: the quadratic, or a full
design by WLS or by GLS weighted by the recipe's own noise model),
batched over pulsars and realizations; and the rank-reduced GP likelihood that prices a bank
of realizations over a hyperparameter grid or through a request-batched
server (``likelihood/``), its Woodbury assembly a hand-written CUDA
kernel with a bf16 tensor-core rung gated by the numerics ledger
(``obs/numerics.py``), a launch-plan tuner and a MAP fit; and structured noise covariances (``covariance/``: banded,
dense, Kronecker, low rank) that ``realize`` samples and the likelihood
prices inside C0, on hand-written block-tridiagonal and blocked-Cholesky
kernels; and the resumable sweep that writes realizations in chunks to a
checkpoint in the reference's format (``utils/sweep.py``), with the
card's readback overlapped by a stage-graph executor (``parallel/``) and
a CW catalog too large to build at once streamed in plane tiles onto the
kernel's accumulating launch; and the declarative scenario path
(``scenarios/``): a JSON or TOML :class:`ScenarioSpec` compiled by
:func:`compile_spec` to the JAX package's batch and recipe bit for bit
(SMBHB population splits and anisotropic ORFs included), and run through
the sweep by ``python -m pta_replicator_tpu_torch scenario``; and the
dataset path: par/tim directories loaded (``io/``, the native tim reader
built from ``csrc/fast_tim.cpp``), idealized by the standalone timing
engine (``timing/``, ``simulate.py``, host numpy with longdouble epochs),
frozen onto the card (:func:`freeze`), realized and refit with their full
timing design (``timing/fit.py::design_tensor``), and written back out as
datasets (``utils/export.py``), through ``python -m
pta_replicator_tpu_torch info|realize``; and the per-pulsar oracle path:
the reference's mutate-and-ledger API (``add_measurement_noise``,
``add_jitter``, ``add_red_noise``, ``add_chromatic_noise``, ``add_gwb``,
``add_cgw``, ``add_catalog_of_cws``, ``add_burst``, ``add_gw_memory``,
``add_noise_transient``, ``add_gwb_plus_outlier_cws``) in host float64
numpy on numpy's legacy RNG in the reference's draw order, the refit
``SimulatedPulsar.fit`` (WLS, or GLS weighted by the dense covariance of
``timing/fit.py::covariance_from_recipe``) and ``to_enterprise``, which
equals the JAX package's oracle bit for bit and against which the batched
engine on the card is held. The JAX
package stays the reference; this
package imports nothing of it, and nothing of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .batch import PulsarBatch, freeze, synthetic_batch
from .likelihood import FUSED_PRECISION_SITES, MapResult, PrecisionNotReady, map_fit, tuner
from .models import (
    add_burst, add_catalog_of_cws, add_cgw, add_chromatic_noise, add_gw_memory, add_gwb,
    add_gwb_plus_outlier_cws, add_jitter, add_measurement_noise, add_noise_transient,
    add_red_noise, population_recipe, split_population,
)
from .models.batched import Recipe, deterministic_delays, realize
from .scenarios import ScenarioSpec, compile_spec, load_spec
from .scenarios.compile import flagship_workload
from .simulate import (
    Residuals, SimulatedPulsar, load_from_directories, load_pulsar, make_ideal,
    simulate_pulsar,
)

__all__ = [
    "FUSED_PRECISION_SITES", "MapResult", "PrecisionNotReady", "PulsarBatch", "Recipe",
    "Residuals", "ScenarioSpec", "SimulatedPulsar", "add_burst", "add_catalog_of_cws",
    "add_cgw", "add_chromatic_noise", "add_gw_memory", "add_gwb", "add_gwb_plus_outlier_cws",
    "add_jitter", "add_measurement_noise", "add_noise_transient", "add_red_noise",
    "compile_spec", "deterministic_delays", "flagship_workload", "freeze",
    "load_from_directories", "load_pulsar", "load_spec", "make_ideal", "map_fit",
    "population_recipe", "realize", "simulate_pulsar", "split_population",
    "synthetic_batch", "tuner",
]
