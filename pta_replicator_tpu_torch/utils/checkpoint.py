"""Batch persistence: a frozen :class:`~..batch.PulsarBatch` in one npz.

Counterpart of ``save_batch`` / ``load_batch`` in
``pta_replicator_tpu/utils/checkpoint.py``, in its format: one member per
tensor field (as numpy, by field name; an absent optional field has no
member) and a ``static`` member holding the static metadata as JSON. A
file written by either package loads in the other. ``save_pulsar`` /
``load_pulsar_checkpoint`` need the simulated pulsar of the numpy oracle
path (ROADMAP.md item A.18).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..batch import PulsarBatch
from ..device import resolve_device

#: PulsarBatch's static metadata (the reference marks these fields static)
STATIC_FIELDS = ("tref_mjd", "names", "backend_names", "start_s", "stop_s")
#: index fields: int64 in this package, whatever integer type the file holds
INDEX_FIELDS = ("epoch_index", "epoch_backend_index", "backend_index", "ntoas")


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
