"""Carry a batch and a recipe across from the JAX package.

The JAX package's ``PulsarBatch`` and ``Recipe`` are frozen dataclasses
whose array leaves convert to numpy. These functions take their fields as
a mapping (``vars(obj)``, arrays as numpy or anything with ``__array__``)
and build the port's objects, without importing the JAX package. Every
array is copied: the numpy view of a JAX array is read-only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batch import PulsarBatch
from .device import resolve_device
from .models.batched import Recipe

_INDEX_FIELDS = ("epoch_index", "epoch_backend_index", "backend_index", "ntoas")
_STATIC_FIELDS = ("tref_mjd", "names", "backend_names", "start_s", "stop_s")

#: JAX-only Recipe knobs with no counterpart in the port: the CW backend
#: choice and the synthesis precision (the port has one CW dispatch and
#: always synthesizes in IEEE float32), the streamed pipeline's prefetch
#: depth and the transient's pulsar (inert without its unported feature)
JAX_ONLY_RECIPE_FIELDS = frozenset({
    "cgw_backend", "gwb_synthesis_precision", "cgw_prefetch_depth",
    "transient_psr",
})


def _tensor(value, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=dtype))


def batch_from_arrays(fields, device="cuda") -> PulsarBatch:
    """The port's PulsarBatch from a JAX PulsarBatch's fields; index
    arrays become int64, floating arrays keep their dtype."""
    device = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(PulsarBatch):
        value = fields[f.name]
        if f.name in _INDEX_FIELDS:
            value = _tensor(value, np.int64)
        elif f.name not in _STATIC_FIELDS and value is not None:
            value = _tensor(value)
        kwargs[f.name] = value
    return PulsarBatch(**kwargs).to(device)


def recipe_from_arrays(fields, device="cuda") -> Recipe:
    """The port's Recipe from a JAX Recipe's fields. JAX-only knobs
    (:data:`JAX_ONLY_RECIPE_FIELDS`) are dropped; an unported feature
    that is set raises ``NotImplementedError``; an unknown field raises
    ``TypeError``."""
    device = resolve_device(device)
    kwargs = {
        name: _tensor(value) if hasattr(value, "__array__") else value
        for name, value in fields.items()
        if name not in JAX_ONLY_RECIPE_FIELDS
    }
    return Recipe(**kwargs).to(device)
