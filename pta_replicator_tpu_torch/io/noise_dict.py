"""NANOGrav-style noise-dictionary parsing.

Counterpart of ``pta_replicator_tpu/io/noise_dict.py``, a copy (the port
imports nothing of the JAX package).

The reference ships ``noise_dicts/ng15_dict.json`` (785 keys over 69 pulsars,
keyed ``{PSR}_{backend}_{param}``) and parses it ad hoc in the example
notebook (examples/add_noise.ipynb cells 5-6). Here that
convention is a first-class API: :func:`parse_noise_dict` returns, per
pulsar, the per-backend flag values and aligned parameter vectors ready to
feed the flagged white-noise/jitter operators.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict


_WN_PARAMS = ("efac", "log10_t2equad", "log10_tnequad", "log10_ecorr")
_PSR_PARAMS = ("red_noise_gamma", "red_noise_log10_A")


def parse_noise_dict(src) -> Dict[str, dict]:
    """Parse a noise dict (path or mapping) into per-pulsar structures.

    Returns ``{psr_name: {"backends": [...], "efac": [...],
    "log10_t2equad": [...], "log10_ecorr": [...],
    "red_noise_gamma": g, "red_noise_log10_A": a}}`` where the per-backend
    lists are aligned with ``backends`` and missing entries are ``None``.
    """
    if isinstance(src, (str, os.PathLike)):
        with open(src) as fh:
            raw = json.load(fh)
    else:
        raw = dict(src)

    per_psr: Dict[str, dict] = defaultdict(
        lambda: {
            "backends": [],
            **{p: [] for p in _WN_PARAMS},
            **{p: None for p in _PSR_PARAMS},
        }
    )

    for key, value in raw.items():
        psr, rest = key.split("_", 1)
        entry = per_psr[psr]
        matched = False
        for param in _PSR_PARAMS:
            if rest == param:
                entry[param] = value
                matched = True
                break
        if matched:
            continue
        for param in _WN_PARAMS:
            suffix = "_" + param
            if rest.endswith(suffix):
                backend = rest[: -len(suffix)]
                if backend not in entry["backends"]:
                    entry["backends"].append(backend)
                    for p in _WN_PARAMS:
                        entry[p].append(None)
                idx = entry["backends"].index(backend)
                entry[param][idx] = value
                matched = True
                break
        if not matched:
            entry.setdefault("extra", {})[rest] = value

    return dict(per_psr)
