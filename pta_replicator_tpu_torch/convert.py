"""Carry a batch, a recipe, a covariance op and a pulsar across from the
JAX package.

The JAX package's ``PulsarBatch``, ``Recipe`` and covariance ops are
dataclasses whose array leaves convert to numpy. These functions take
their fields as a mapping (``vars(obj)``, arrays as numpy or anything with
``__array__``) and build the port's objects, without importing the JAX
package. Every array is copied: the numpy view of a JAX array is
read-only. :func:`pulsar_from_jax` carries a JAX ``SimulatedPulsar``
(host numpy, longdouble epochs) across by its attributes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batch import PulsarBatch
from .covariance.structure import BandedCov, CovOp, DenseCov, KroneckerCov, LowRankCov
from .device import resolve_device
from .models.batched import Recipe
from .simulate import SimulatedPulsar

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


def pulsar_from_jax(psr) -> SimulatedPulsar:
    """The port's SimulatedPulsar from a JAX package's one (or anything
    with its attributes): the par model re-parsed from its verbatim lines,
    the TOA columns copied (epochs stay longdouble, bit for bit), the
    timing model rebuilt from its fields, the provenance ledger copied,
    and the residuals recomputed (the same operations, so the same bits)."""
    import copy

    from .io.par import parse_par_lines
    from .io.tim import TOAData
    from .utils.checkpoint import _rebuild_model

    toas = psr.toas
    out = SimulatedPulsar(
        ephem=psr.ephem,
        par=parse_par_lines(list(psr.par.lines), path=psr.par.path),
        model=_rebuild_model(dataclasses.asdict(psr.model)),
        toas=TOAData(
            mjd=np.array(toas.mjd, dtype=np.longdouble),
            errors_s=np.array(toas.errors_s, dtype=np.float64),
            freqs_mhz=np.array(toas.freqs_mhz, dtype=np.float64),
            observatories=list(toas.observatories),
            flags=[dict(f) for f in toas.flags],
            labels=list(toas.labels),
        ),
        name=psr.name,
        loc=dict(psr.loc),
        added_signals=copy.deepcopy(psr.added_signals),
        added_signals_time=(None if psr.added_signals_time is None else
                            {k: np.array(v) for k, v in psr.added_signals_time.items()}),
    )
    out.update_residuals()
    return out
