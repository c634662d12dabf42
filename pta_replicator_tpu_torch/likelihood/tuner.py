"""Launch-plan tuner of the fused Woodbury assembly.

Counterpart of ``pta_replicator_tpu/likelihood/tuner.py``. The assembly
(``ops/gp.py::fused_woodbury_update``) has one knob on each device:

* on the CPU, the plain version's TOA tile (the reference's knob; 128,
  256 or 512);
* on the card, the kernel's TOA split count, which
  ``ops/gp.py::woodbury_plan`` otherwise sizes from the SM count. The
  search scores 1, the plan's choice, its half and its double, and the
  most a launch takes, by CUDA-event time at the search shape.

A choice is cached under a fingerprint of everything that would make it
wrong: the tuner's schema, the route (plain or cuda), the shape bucket
(pulsars, TOAs and, on the card, the 64-column panels of the basis,
which set the kernel's pairs), the device's kind and the kernel variant
(dtype and precision).

* :func:`woodbury_knob` is the lookup the fused build calls with
  ``tile=None``: it never searches. A hit returns the tuned knob; a miss
  (no file, an unreadable or wrong-schema file, another fingerprint)
  returns ``{}``, and the build keeps the untuned defaults, with the bits
  they give.
* :func:`autotune` is the search, run on purpose; it writes the cache
  through a temporary file and a rename, merged over the entries already
  there.

The cache is ``PTA_GP_TUNER_CACHE`` or ``_build/gp_tuner_cache.json`` in
the package (gitignored), or a path the caller gives.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import gp as ops_gp

#: the plain version's TOA tiles the CPU search scores
WOODBURY_CANDIDATES = (128, 256, 512)

#: bump when the knob's meaning changes: every cached entry goes at once
TUNER_SCHEMA_VERSION = 1

DEFAULT_CACHE_PATH = Path(__file__).resolve().parent.parent / "_build" / "gp_tuner_cache.json"


def _cache_path(cache_path: Optional[str]) -> str:
    if cache_path is not None:
        return os.fspath(cache_path)
    return os.environ.get("PTA_GP_TUNER_CACHE", str(DEFAULT_CACHE_PATH))


def _pow2_bucket(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def shape_bucket(npsr: int, ntoa: int, q: Optional[int] = None) -> str:
    """Coarse shape key: pulsars and TOAs rounded up to powers of two, and
    with ``q`` the basis's 64-column panels (the kernel's split count
    depends on its panel pairs; the plain tile does not)."""
    bucket = f"np{_pow2_bucket(npsr)}_nt{_pow2_bucket(ntoa)}"
    if q is not None:
        bucket += f"_panels{-(-(int(q) + 1) // ops_gp.WOODBURY_PANEL)}"
    return bucket


def device_kind(device) -> str:
    """``cpu``, or the CUDA card's name."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def fingerprint(route: str, bucket: str, dtype, precision: str, kind: str) -> str:
    """The cache key of one tuned choice: sha256 over the tuner's schema,
    the route (``plain`` or ``cuda``), the shape bucket, the device kind
    and the kernel variant (dtype, precision)."""
    blob = json.dumps({
        "schema": TUNER_SCHEMA_VERSION, "kernel": "fused_woodbury", "route": route,
        "bucket": bucket, "device_kind": kind,
        "dtype": str(dtype).replace("torch.", ""), "precision": precision,
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def load_cache(cache_path: Optional[str] = None) -> dict:
    """The cache's ``entries`` ({fingerprint: choice}); {} for a missing,
    unreadable or wrong-schema file: corruption reads as no cache."""
    try:
        with open(_cache_path(cache_path), encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("schema") != TUNER_SCHEMA_VERSION:
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


def save_cache(entries: dict, cache_path: Optional[str] = None) -> str:
    """Write ``entries`` merged over what the file holds, through a
    temporary file and a rename: a crash leaves the old cache whole."""
    from ..utils.sweep import atomic_write

    path = _cache_path(cache_path)
    merged = dict(load_cache(path))
    merged.update(entries)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = json.dumps({"schema": TUNER_SCHEMA_VERSION, "entries": merged}, indent=2,
                      sort_keys=True) + "\n"
    atomic_write(lambda tmp: Path(tmp).write_text(text, encoding="utf-8"), path, ".json")
    return path


def _key(T, precision: str):
    """``(route, knob name, fingerprint)`` of the assembly of basis ``T``."""
    npsr, ntoa, q = T.shape
    cuda = T.device.type == "cuda"
    route, knob = ("cuda", "nsplit") if cuda else ("plain", "tile")
    bucket = shape_bucket(npsr, ntoa, q if cuda else None)
    return route, knob, fingerprint(route, bucket, T.dtype, precision, device_kind(T.device))


def woodbury_knob(T, precision: str = "highest", cache_path: Optional[str] = None) -> dict:
    """The cached knob of the fused assembly of basis ``T`` (Np, Nt, Q):
    ``{"tile": n}`` on the CPU, ``{"nsplit": n}`` on the card, or ``{}``
    when nothing is tuned for this fingerprint. A pure lookup."""
    from ..obs import counter, names

    route, knob, key = _key(T, precision)
    entry = load_cache(cache_path).get(key)
    if isinstance(entry, dict) and isinstance(entry.get(knob), int):
        counter(names.TUNER_CACHE_HITS, backend=route).inc()
        return {knob: int(entry[knob])}
    return {}


def _median_s(fn, reps: int) -> float:
    """Median host seconds of ``reps`` calls after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _cuda_s(fn, reps: int) -> float:
    """Mean device seconds of ``reps`` back-to-back calls (CUDA events,
    after a warm-up call)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def autotune(T, w, r, precision: str = "highest", candidates: Optional[Sequence[int]] = None,
             reps: int = 5, cache_path: Optional[str] = None, write: bool = True) -> dict:
    """Time the fused assembly of ``(T, w, r)`` at each candidate knob on
    their device, and cache the fastest (``write``). The candidates are
    :data:`WOODBURY_CANDIDATES` tiles on the CPU (median host time) and
    ``ops/gp.py::woodbury_split_candidates`` split counts on the card
    (CUDA-event time), unless given. Returns the choice record cached.
    The search runs under a ``gp_tune`` span and counts in
    ``tuner.searches``; :func:`woodbury_knob` counts its hits in
    ``tuner.cache_hits``."""
    from ..obs import counter, names, span

    route, knob, key = _key(T, precision)
    npsr, ntoa, q = T.shape
    if candidates is None:
        if route == "cuda":
            sms = torch.cuda.get_device_properties(T.device).multi_processor_count
            candidates = ops_gp.woodbury_split_candidates(npsr, ntoa, q, sms, precision)
        else:
            candidates = WOODBURY_CANDIDATES
    scored = []
    bucket = shape_bucket(npsr, ntoa, q if route == "cuda" else None)
    with span(names.SPAN_GP_TUNE, backend=route, bucket=bucket):
        counter(names.TUNER_SEARCHES, backend=route).inc()
        for value in candidates:
            kw = {knob: int(value)}
            run = lambda: ops_gp.fused_woodbury_update(T, w, r, precision=precision, **kw)
            seconds = _cuda_s(run, reps) if route == "cuda" else _median_s(run, reps)
            scored.append({knob: int(value), "seconds": seconds})
    best = min(scored, key=lambda s: s["seconds"])
    choice = {
        knob: best[knob], "route": route,
        "bucket": bucket,
        "device_kind": device_kind(T.device), "dtype": str(T.dtype).replace("torch.", ""),
        "precision": precision, "seconds": best["seconds"],
        "candidates": [int(c) for c in candidates], "scored": scored,
    }
    if write:
        save_cache({key: choice}, cache_path)
    return choice
