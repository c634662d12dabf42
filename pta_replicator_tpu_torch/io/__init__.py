"""Par, tim and noise-dictionary files (counterpart of
``pta_replicator_tpu/io``): host numpy, TOA epochs in longdouble."""
from .par import ParModel, read_par
from .tim import TOAData, read_tim, write_tim
from .noise_dict import parse_noise_dict

__all__ = [
    "ParModel",
    "read_par",
    "TOAData",
    "read_tim",
    "write_tim",
    "parse_noise_dict",
]
