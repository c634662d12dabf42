"""The precision ledger of the numerics observatory.

Counterpart of the ledger half of ``pta_replicator_tpu/obs/numerics.py``:
health probes on the likelihood's tensors, the per-site rollup they feed,
its ``numerics.json`` capture and the bf16-readiness verdict read from it
(``ladder_verdict``), which gates the bf16 rung of the fused Woodbury
assembly (``likelihood/gp.py::require_precision_ready``).

* :func:`probe` and :func:`probe_cholesky` are identity on the data
  path. Disarmed (the default) they are literally ``return x``: no
  reduction and no host synchronisation. Armed, they reduce the raveled
  leading :data:`PROBE_SAMPLE_CAP` elements to a non-finite count, max
  |x| and min non-zero |x| and read them to the host (one synchronisation
  a call, paid only when armed), as the reference's callback mode does.
* :func:`snapshot`, :func:`write`, :func:`ladder_verdict` and
  :func:`render_report` keep the reference's JSON schema
  (:data:`NUMERICS_SCHEMA_VERSION`), so a capture written by either
  package is read by the other.

Not ported here (ROADMAP A.16.3): the collector mode, drift sampling
(``sample_drift``, ``on_drain``, ``scan_block``), the heartbeat block, and
the counters, gauges and events ``_record`` emits. A capture of this
module holds no drift samples, so a site that maps to a drift family
(``realization.*``, ``cw.*``) reads as not ready.
"""
from __future__ import annotations

import json
import math
import os
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

NUMERICS_SCHEMA_VERSION = 1

#: bits of dynamic range left to the dtype's finfo.max that a probe site
#: must keep to be judged ready for the bf16 rung
LADDER_HEADROOM_BITS = 8.0

#: consecutive clean probe calls at a site before an open non-finite
#: episode clears
EPISODE_CLEAR_AFTER = 3

#: elements a probe reduces: the leading ones of the raveled tensor
PROBE_SAMPLE_CAP = 65536

_LOCK = threading.RLock()
_ARMED = False
#: per-probe-site rollups; bounded by the static set of probe sites
_SITES: Dict[str, dict] = {}


def is_armed() -> bool:
    return _ARMED


def arm() -> None:
    """Arm the ledger: probes start accumulating."""
    global _ARMED
    with _LOCK:
        _ARMED = True


def disarm() -> None:
    """Disarm: probes return at once; the ledger keeps what it holds until
    :func:`reset`."""
    global _ARMED
    with _LOCK:
        _ARMED = False


def arm_from_env(env: Optional[dict] = None) -> bool:
    """Arm when ``PTA_NUMERICS`` is ``1``, ``true`` or ``on``; returns
    whether it armed."""
    env = os.environ if env is None else env
    if env.get("PTA_NUMERICS", "").strip() not in ("1", "true", "on"):
        return False
    arm()
    return True


def reset() -> None:
    """Clear the ledger and disarm."""
    global _ARMED
    with _LOCK:
        _ARMED = False
        _SITES.clear()


# ----------------------------------------------------------------- probes

def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``float64``), as JAX writes it."""
    return str(dtype).replace("torch.", "")


def probe(name: str, x):
    """Tensor-health probe at site ``name``: returns ``x`` itself.

    Armed, a floating ``x`` is reduced over its leading
    :data:`PROBE_SAMPLE_CAP` raveled elements (non-finite count, max |x|
    over the finite ones, min non-zero |x|) and the three numbers are read
    to the host and recorded. The reduction runs on a detached view, so
    gradients pass through the probe untouched."""
    if not _ARMED or not torch.is_tensor(x) or not x.is_floating_point():
        return x
    s = x.detach().reshape(-1)[:PROBE_SAMPLE_CAP]
    finite = torch.isfinite(s)
    ax = s.abs()
    nf, amax, amin = torch.stack([  # one read to the host
        torch.sum(~finite).to(s.dtype),
        torch.cat([torch.where(finite, ax, 0.0), s.new_zeros(1)]).max(),
        torch.cat([torch.where(finite & (ax > 0), ax, math.inf), s.new_full((1,), math.inf)]).min(),
    ]).tolist()
    _record(name, int(s.numel()), math.log2(float(torch.finfo(x.dtype).max)),
            _dtype_name(x.dtype), int(nf), amax, amin)
    return x


def probe_cholesky(name: str, L):
    """Probe a Cholesky factor through its diagonal (a failed factor has
    NaN there, and the diagonal's range is the factor's conditioning);
    returns ``L`` itself."""
    if not _ARMED:
        return L
    probe(name, torch.diagonal(L, dim1=-2, dim2=-1))
    return L


def _record(site: str, elements: int, max_log2: float, dtype: str,
            nonfinite: int, absmax: float, minnz: float) -> None:
    """Fold one probe call into the site's rollup."""
    if not _ARMED:
        return
    headroom = max_log2 - math.log2(absmax) if absmax > 0.0 else math.inf
    with _LOCK:
        rec = _SITES.get(site)
        if rec is None:
            rec = _SITES[site] = {
                "calls": 0, "elements": 0, "nonfinite": 0,
                "episodes": 0, "episode_active": False,
                "clean_streak": 0, "max_abs": 0.0,
                "min_nonzero": math.inf, "headroom_bits": math.inf,
                "dtype": dtype,
            }
        rec["calls"] += 1
        rec["elements"] += int(elements)
        rec["max_abs"] = max(rec["max_abs"], absmax)
        rec["min_nonzero"] = min(rec["min_nonzero"], minnz)
        rec["headroom_bits"] = min(rec["headroom_bits"], headroom)
        rec["dtype"] = dtype
        if nonfinite:
            rec["nonfinite"] += int(nonfinite)
            rec["clean_streak"] = 0
            if not rec["episode_active"]:
                rec["episode_active"] = True
                rec["episodes"] += 1
        else:
            rec["clean_streak"] += 1
            if rec["episode_active"] and rec["clean_streak"] >= EPISODE_CLEAR_AFTER:
                rec["episode_active"] = False


# ------------------------------------------------------------ persistence

def snapshot() -> dict:
    """The ledger as a JSON-ready document (the ``numerics.json`` shape)."""
    with _LOCK:
        sites = {}
        for site, rec in _SITES.items():
            sites[site] = {
                "calls": rec["calls"],
                "elements": rec["elements"],
                "nonfinite": rec["nonfinite"],
                "episodes": rec["episodes"],
                "episode_active": rec["episode_active"],
                "max_abs": rec["max_abs"],
                "min_nonzero": rec["min_nonzero"] if math.isfinite(rec["min_nonzero"]) else None,
                "headroom_bits": (rec["headroom_bits"]
                                  if math.isfinite(rec["headroom_bits"]) else None),
                "dtype": rec["dtype"],
            }
        episodes_active = sorted(site for site, rec in _SITES.items() if rec["episode_active"])
    return {
        "schema_version": NUMERICS_SCHEMA_VERSION,
        "armed": _ARMED,
        "sites": sites,
        "drift": {},  # nothing here samples drift (A.16.3)
        "nonfinite_total": sum(s["nonfinite"] for s in sites.values()),
        "episodes_active": episodes_active,
    }


def write(directory: str) -> str:
    """Write the ledger to ``DIR/numerics.json`` through a temporary file
    and a rename, so a reader never sees a torn file; returns the path."""
    from ..utils.sweep import atomic_write

    path = os.path.join(os.fspath(directory), "numerics.json")
    text = json.dumps(snapshot(), indent=1, sort_keys=True, default=repr)
    atomic_write(lambda tmp: Path(tmp).write_text(text), path, ".json")
    return path


# ------------------------------------------------------ verdict and report

def _site_family(site: str) -> Optional[str]:
    """The drift family a probe site is judged against (``realization.white``
    -> ``white``, ``cw.*`` -> ``cw``); None for solver and factor sites,
    judged on headroom and non-finites alone."""
    leaf = site.rsplit(".", 1)[-1]
    if site.startswith("realization."):
        return leaf
    if site.startswith("cw."):
        return "cw"
    return None


def ladder_verdict(doc: Optional[dict] = None,
                   headroom_bits: float = LADDER_HEADROOM_BITS) -> dict:
    """Per-site bf16 readiness from a ledger document (default: the live
    ledger): ``ready`` iff the site saw no non-finite element, kept at
    least ``headroom_bits`` bits of margin to its dtype's largest value,
    and, where a drift family maps to it, stayed within that family's
    tolerance."""
    doc = snapshot() if doc is None else doc
    drift = doc.get("drift") or {}
    verdict = {}
    for site, rec in sorted((doc.get("sites") or {}).items()):
        reasons = []
        if rec.get("nonfinite"):
            reasons.append(f"{rec['nonfinite']} non-finite element(s)")
        hb = rec.get("headroom_bits")
        if hb is not None and hb < headroom_bits:
            reasons.append(f"headroom {hb:.1f} bits < {headroom_bits:g}")
        family = _site_family(site)
        d = drift.get(family) if family else None
        if d is not None and d.get("tolerance") is not None:
            if d["worst"] > d["tolerance"]:
                reasons.append(f"drift {d['worst']:.3g} > tolerance {d['tolerance']:g} ({family})")
        elif family is not None:
            reasons.append(f"no drift samples for family {family!r}")
        verdict[site] = {"ready": not reasons, "reasons": reasons, "family": family}
    return verdict


def render_report(directory: str) -> str:
    """The ledger of ``DIR/numerics.json`` as text: the per-site table,
    the drift by family, and the bf16 verdict."""
    path = os.path.join(os.fspath(directory), "numerics.json")
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError:
        return (f"no numerics.json in {directory} — the run was captured without "
                "the ledger armed (set PTA_NUMERICS=1, or call numerics.arm())")
    except json.JSONDecodeError as exc:
        return f"numerics.json unreadable: {exc}"
    parts = [f"numerics ledger: {directory}"]
    sites = doc.get("sites") or {}
    if not sites:
        parts.append("  (no probe sites recorded)")
    else:
        parts.append(f"  {'site':<28} {'dtype':<9} {'calls':>7} {'nonfinite':>9} "
                     f"{'max|x|':>10} {'headroom':>9}")
        for site in sorted(sites):
            rec = sites[site]
            hb = rec.get("headroom_bits")
            parts.append(
                f"  {site:<28} {rec.get('dtype', '?'):<9} {rec.get('calls', 0):>7} "
                f"{rec.get('nonfinite', 0):>9} {rec.get('max_abs', 0.0):>10.3g} "
                + (f"{hb:>8.1f}b" if hb is not None else f"{'inf':>9}"))
    drift = doc.get("drift") or {}
    if drift:
        parts += ["", "drift vs the f64 shadow oracle (worst sampled):"]
        for family in sorted(drift):
            d = drift[family]
            tol = d.get("tolerance")
            parts.append(f"  {family:<12} {d.get('worst', 0.0):.3g} over "
                         f"{d.get('samples', 0)} sample(s)"
                         + (f"  (tolerance {tol:g})" if tol is not None else ""))
    active = doc.get("episodes_active") or []
    if active:
        parts += ["", "NON-FINITE EPISODE ACTIVE at: " + ", ".join(active)]
    parts += ["", f"bf16 ladder readiness (headroom >= {LADDER_HEADROOM_BITS:g} bits, "
                  "zero non-finites, drift within family tolerance):"]
    verdict = ladder_verdict(doc)
    if not verdict:
        parts.append("  (no sites to judge)")
    for site, v in verdict.items():
        parts.append(f"  {site:<28} ladder-ready" if v["ready"]
                     else f"  {site:<28} NOT READY: " + "; ".join(v["reasons"]))
    return "\n".join(parts)
