"""Signal models: the batched engine (``batched.py``, tensors on the card)
and the per-pulsar oracle's ``add_*`` operators (host float64 numpy, the
reference's mutate-and-ledger API and legacy-RNG draw order)."""
from .white_noise import add_measurement_noise, add_jitter
from .red_noise import add_chromatic_noise, add_red_noise
from .gwb import add_gwb
from .cgw import add_cgw, add_catalog_of_cws
from .bursts import add_burst, add_noise_transient, add_gw_memory
from .population import add_gwb_plus_outlier_cws, population_recipe, split_population

__all__ = [
    "add_measurement_noise",
    "add_jitter",
    "add_chromatic_noise",
    "add_red_noise",
    "add_gwb",
    "add_cgw",
    "add_catalog_of_cws",
    "add_burst",
    "add_noise_transient",
    "add_gw_memory",
    "add_gwb_plus_outlier_cws",
    "population_recipe",
    "split_population",
]
