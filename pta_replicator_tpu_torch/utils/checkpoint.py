"""State persistence beyond par/tim round-trips, in the JAX package's
formats (``pta_replicator_tpu/utils/checkpoint.py``): a file written by
either package loads in the other.

* :func:`save_pulsar` / :func:`load_pulsar_checkpoint` — one
  :class:`~..simulate.SimulatedPulsar` with its provenance ledger (params
  and per-TOA delays): an npz of the split epochs (int day + float64
  fraction, rejoined in longdouble), errors, frequencies and ledger
  vectors, and a ``meta`` member holding the rest as JSON;
* :func:`save_batch` / :func:`load_batch` — a frozen
  :class:`~..batch.PulsarBatch`: one member per tensor field (as numpy,
  by field name; an absent optional field has no member) and a
  ``static`` member holding the static metadata as JSON.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..batch import PulsarBatch
from ..device import resolve_device
from ..io.par import ParModel
from ..io.tim import TOAData
from ..simulate import SimulatedPulsar
from ..timing.components import BinaryModel
from ..timing.model import SpindownTiming, TimingModel

#: PulsarBatch's static metadata (the reference marks these fields static)
STATIC_FIELDS = ("tref_mjd", "names", "backend_names", "start_s", "stop_s")
#: index fields: int64 in this package, whatever integer type the file holds
INDEX_FIELDS = ("epoch_index", "epoch_backend_index", "backend_index", "ntoas")


def save_pulsar(psr: SimulatedPulsar, path: str) -> None:
    """Persist a SimulatedPulsar (model, TOAs, flags, ledger) to one npz."""
    meta = {
        "name": psr.name,
        "ephem": psr.ephem,
        "loc": psr.loc,
        "model": dataclasses.asdict(psr.model),
        "par_lines": psr.par.lines if psr.par else [],
        "flags": psr.toas.flags,
        "observatories": psr.toas.observatories,
        "labels": psr.toas.labels,
        "added_signals": _jsonable(psr.added_signals),
        "ledger_keys": list((psr.added_signals_time or {}).keys()),
    }
    arrays = {
        "mjd_day": np.floor(psr.toas.mjd).astype(np.int64),
        "mjd_frac": (psr.toas.mjd - np.floor(psr.toas.mjd)).astype(np.float64),
        "errors_s": psr.toas.errors_s,
        "freqs_mhz": psr.toas.freqs_mhz,
    }
    for i, key in enumerate(meta["ledger_keys"]):
        arrays[f"ledger_{i}"] = psr.added_signals_time[key]
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_pulsar_checkpoint(path: str) -> SimulatedPulsar:
    """The SimulatedPulsar saved at ``path`` (either package's file), its
    residuals recomputed. As in the JAX package, the par model keeps its
    verbatim lines only (``write`` reproduces them; the typed fields are
    not re-parsed) and the timing model is rebuilt from its saved fields."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        mjd = data["mjd_day"].astype(np.longdouble) + data["mjd_frac"].astype(np.longdouble)
        toas = TOAData(
            mjd=mjd,
            errors_s=data["errors_s"],
            freqs_mhz=data["freqs_mhz"],
            observatories=list(meta["observatories"]),
            flags=[dict(f) for f in meta["flags"]],
            labels=list(meta["labels"]),
        )
        ledger = {key: data[f"ledger_{i}"] for i, key in enumerate(meta["ledger_keys"])}
    par = ParModel()
    par.lines = list(meta["par_lines"])
    psr = SimulatedPulsar(
        ephem=meta["ephem"],
        par=par,
        model=_rebuild_model(meta["model"]),
        toas=toas,
        name=meta["name"],
        loc=meta["loc"],
        added_signals=meta["added_signals"],
        added_signals_time=ledger,
    )
    psr.update_residuals()
    return psr


def _rebuild_model(meta_model: dict):
    """Rebuild the timing model from its ``dataclasses.asdict`` form.

    Composite :class:`TimingModel` checkpoints carry a nested ``spin``
    dict and an optional ``binary`` dict; flat dicts are
    :class:`SpindownTiming` checkpoints.
    """
    if "spin" not in meta_model:
        return SpindownTiming(**meta_model)
    kwargs = dict(meta_model)
    kwargs["spin"] = SpindownTiming(**kwargs["spin"])
    if kwargs.get("binary") is not None:
        kwargs["binary"] = BinaryModel(**kwargs["binary"])
    if kwargs.get("jumps"):  # JSON round-trips tuples as lists
        kwargs["jumps"] = tuple(
            (str(n), str(v), float(o)) for n, v, o in kwargs["jumps"]
        )
    if kwargs.get("fd"):
        kwargs["fd"] = tuple(float(c) for c in kwargs["fd"])
    if kwargs.get("dmx"):
        kwargs["dmx"] = tuple(
            (str(l), float(v), float(a), float(b)) for l, v, a, b in kwargs["dmx"]
        )
    return TimingModel(**kwargs)


def _jsonable(obj):
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)):
        return obj
    return repr(obj)  # callables (burst waveforms) recorded by name


def save_batch(batch: PulsarBatch, path: str) -> None:
    """Write ``batch`` (tensors and static metadata) to the npz ``path``."""
    arrays, static = {}, {}
    for f in dataclasses.fields(PulsarBatch):
        val = getattr(batch, f.name)
        if f.name in STATIC_FIELDS:
            static[f.name] = list(val) if isinstance(val, tuple) else val
        elif val is not None:
            arrays[f.name] = val.detach().cpu().numpy()
    np.savez_compressed(path, static=json.dumps(static), **arrays)


def load_batch(path: str, dtype=None, device="cuda") -> PulsarBatch:
    """The batch saved at ``path``, on ``device``; ``dtype`` (a torch
    dtype) casts its floating tensors."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        static = json.loads(str(data["static"]))
        kwargs = {}
        for f in dataclasses.fields(PulsarBatch):
            if f.name in STATIC_FIELDS:
                val = static[f.name]
                kwargs[f.name] = tuple(val) if isinstance(val, list) else val
            elif f.name in data.files:
                t = torch.from_numpy(np.array(data[f.name]))
                if f.name in INDEX_FIELDS:
                    t = t.to(torch.int64)
                elif dtype is not None and t.is_floating_point():
                    t = t.to(dtype)
                kwargs[f.name] = t
    return PulsarBatch(**kwargs).to(device)
