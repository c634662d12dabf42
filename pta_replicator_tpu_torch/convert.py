"""Carry a batch, a recipe and a covariance op across from the JAX package.

The JAX package's ``PulsarBatch``, ``Recipe`` and covariance ops are
dataclasses whose array leaves convert to numpy. These functions take
their fields as a mapping (``vars(obj)``, arrays as numpy or anything with
``__array__``) and build the port's objects, without importing the JAX
package. Every array is copied: the numpy view of a JAX array is
read-only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batch import PulsarBatch
from .covariance.structure import BandedCov, CovOp, DenseCov, KroneckerCov, LowRankCov
from .device import resolve_device
from .models.batched import Recipe

_INDEX_FIELDS = ("epoch_index", "epoch_backend_index", "backend_index", "ntoas")
_STATIC_FIELDS = ("tref_mjd", "names", "backend_names", "start_s", "stop_s")

#: JAX-only Recipe knobs with no counterpart in the port: the CW backend
#: choice and the synthesis precision (the port has one CW dispatch and
#: always synthesizes in IEEE float32). The ``bench_flagship`` scenario
#: preset accepts them as parameters and drops them the same way
#: (``scenarios/compile.py``)
JAX_ONLY_RECIPE_FIELDS = frozenset({"cgw_backend", "gwb_synthesis_precision"})


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


#: each covariance op by its field set (the reference's dataclass fields)
_COVOP_FIELDS = {
    frozenset({"mat", "L", "valid", "nvalid"}): DenseCov,
    frozenset({"D", "E", "Ld", "M", "valid", "nvalid", "nt"}): BandedCov,
    frozenset({"Ct", "Cf", "Lt", "Lf", "nvalid"}): KroneckerCov,
    frozenset({"base", "U", "phi"}): LowRankCov,
}


def covop_from_arrays(fields, device="cuda") -> CovOp:
    """The port's covariance op from a JAX op's fields (``vars(op)``),
    chosen by the field set; a low-rank op's ``base`` is carried across
    the same way. The stored factors are the JAX package's host-float64
    ones, cast as it stored them; nothing is refactored."""
    device = resolve_device(device)
    cls = _COVOP_FIELDS.get(frozenset(fields))
    if cls is None:
        raise TypeError(f"no covariance op has the fields {sorted(fields)}")
    kwargs = {}
    for name, value in fields.items():
        if name == "base":
            value = covop_from_arrays(vars(value), device)
        elif name == "nt":
            value = int(value)
        else:
            value = _tensor(value).to(device)
        kwargs[name] = value
    return cls(**kwargs)


def recipe_from_arrays(fields, device="cuda") -> Recipe:
    """The port's Recipe from a JAX Recipe's fields. JAX-only knobs
    (:data:`JAX_ONLY_RECIPE_FIELDS`) are dropped; every other field is
    carried across (each array copied once to the host, then moved to
    ``device``); a ``noise_cov`` op is carried across by
    :func:`covop_from_arrays`, a nested low-rank op's bases too; an unknown
    field raises ``TypeError``."""
    device = resolve_device(device)
    kwargs = {
        name: _tensor(value) if hasattr(value, "__array__") else value
        for name, value in fields.items()
        if name not in JAX_ONLY_RECIPE_FIELDS
    }
    if kwargs.get("noise_cov") is not None:
        kwargs["noise_cov"] = covop_from_arrays(vars(kwargs["noise_cov"]), device)
    return Recipe(**kwargs).to(device)
