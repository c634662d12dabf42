"""The numerics observatory: tensor-health probes, the drain-side
non-finite scan, shadow-oracle drift samples and the precision ledger.

Counterpart of ``pta_replicator_tpu/obs/numerics.py``.

* :func:`probe` and :func:`probe_cholesky` are identity on the data
  path. Disarmed (the default) they are literally ``return x``: no
  reduction and no host synchronisation. Armed, outside a collector, they
  reduce the raveled leading :data:`PROBE_SAMPLE_CAP` elements to a
  non-finite count, max |x| and min non-zero |x| and read the three to
  the host (one synchronisation a call), as the reference's callback mode
  does: the likelihood's, the fits' and the covariance factors' probes.
  :func:`probe_cholesky_steps` reads a block-tridiagonal factor's pivots
  block column by block column (one record a column from one read), as
  the reference's probe inside its scan step records them.
* **Collector mode** (:class:`collecting`, entered by
  ``models/batched.py::realize`` while armed): :func:`probe_realizations`
  keeps each family's leading :data:`PROBE_SAMPLE_CAP_COLLECT`-element
  slab of every realization on the device and reads nothing. When the
  block ends, its slabs are stacked; on the card up to
  :data:`_GROUP_BLOCKS` blocks are reduced together and the sites'
  scalars copied into pinned host memory behind one CUDA event and
  queued (:func:`stash_step_stats`; :func:`snapshot` and :func:`flush`
  reduce a partial group), so an armed sweep launches the reductions
  once in that many chunks, not once a chunk; the sweep's drain
  folds the queued entries whose event has completed
  (``torch.cuda.Event.query``, which does not wait) and :func:`flush`
  folds the rest. One call a site a block, ``elements`` = slab x
  realizations, as the reference's collector records them.
* :func:`on_drain` is the sweep's per-chunk drain hook: it folds the ready
  stats, scans the fetched block on the host for non-finites
  (:func:`scan_block`, the only layer that sees a fault-injected ``nan``)
  and, on one chunk in ``drift_every`` (seeded, :func:`should_sample`),
  replays realization 0 of the chunk through the fuzz harness's batched
  families and its host float64 oracle (:func:`sample_drift`), recording
  each family's relative drift.
* :func:`snapshot`, :func:`write`, :func:`heartbeat_block`,
  :func:`ladder_verdict` and :func:`render_report` keep the reference's
  JSON schema (:data:`NUMERICS_SCHEMA_VERSION`), so a capture written by
  either package is read by the other. The report needs no torch.

Every fold emits the reference's metrics: ``numerics.nonfinite`` (with
and without ``site=``), the ``numerics.headroom_bits`` and
``numerics.max_abs`` gauges, ``numerics.drift{family=}`` and the
``numerics.nonfinite_episode`` event.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import random
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import names
from .metrics import counter, gauge
from .trace import event

NUMERICS_SCHEMA_VERSION = 1

#: bits of dynamic range left to the dtype's finfo.max that a probe site
#: must keep to be judged ready for the bf16 rung
LADDER_HEADROOM_BITS = 8.0

#: consecutive clean probe calls at a site before an open non-finite
#: episode clears
EPISODE_CLEAR_AFTER = 3

#: the default shadow-oracle sampling rate: one chunk in N
DRIFT_EVERY = 16

#: elements a per-call probe reduces: the leading ones of the raveled tensor
PROBE_SAMPLE_CAP = 65536

#: a collector's slab of ONE realization's family output: its leading
#: pulsars' rows, cut to this many elements (pulsar 0's first 1,024 TOAs
#: at the flagship), the reference's Collector.add
PROBE_SAMPLE_CAP_COLLECT = 1024

#: queued blocks of un-fetched stats past which the oldest is folded
#: (waiting for it) so that the queue stays bounded
_PENDING_MAX = 512

_LOCK = threading.RLock()
_ARMED = False
_DRIFT_EVERY = DRIFT_EVERY
_DRIFT_SEED = 0
#: per-probe-site rollups; bounded by the static set of probe sites
_SITES: Dict[str, dict] = {}
#: per-family worst relative drift against the f64 oracle
_DRIFT: Dict[str, dict] = {}
#: queued collector stats: ([(sites, element counts, (max_log2, dtype)
#: per site)] of the blocks in order, their host stats (n, 3), event or
#: None)
_PENDING: List[tuple] = []
#: collector blocks staged, not yet reduced: (device, stream,
#: row size, dtype), the stream, the block's (sites, counts, meta) and
#: its rows
_GROUP: List[tuple] = []
#: a group's most blocks on the card and on the host (where a block is
#: reduced when it ends), and its most bytes of rows (the memory it holds)
_GROUP_BLOCKS = 8
_GROUP_BLOCKS_HOST = 1
_GROUP_BYTES = 64 << 20
#: the active collector of this thread
_TLS = threading.local()
#: pinned host buffers of folded blocks, by (shape, dtype), reused by
#: the next blocks' copies (bounded by the queue's length)
_PINNED: Dict[tuple, list] = {}


def is_armed() -> bool:
    return _ARMED


def arm(drift_every: Optional[int] = None, drift_seed: int = 0) -> None:
    """Arm the observatory: probes record, the drain scans and samples
    drift. ``drift_every`` sets the 1-in-N sampling rate (None keeps the
    current one, :data:`DRIFT_EVERY` at first), ``drift_seed`` the seeded
    chunk offset."""
    global _ARMED, _DRIFT_EVERY, _DRIFT_SEED
    with _LOCK:
        _ARMED = True
        if drift_every is not None:
            _DRIFT_EVERY = max(1, int(drift_every))
        _DRIFT_SEED = int(drift_seed)


def disarm() -> None:
    """Disarm: probes return at once; the ledger keeps what it holds until
    :func:`reset`."""
    global _ARMED
    with _LOCK:
        _ARMED = False


def arm_from_env(env: Optional[dict] = None) -> bool:
    """Arm when ``PTA_NUMERICS`` is ``1``, ``true`` or ``on``, with the
    rate ``PTA_NUMERICS_DRIFT_EVERY`` and the seed ``PTA_NUMERICS_SEED``;
    returns whether it armed."""
    env = os.environ if env is None else env
    if env.get("PTA_NUMERICS", "").strip() not in ("1", "true", "on"):
        return False
    every = env.get("PTA_NUMERICS_DRIFT_EVERY")
    arm(drift_every=int(every) if every else None,
        drift_seed=int(env.get("PTA_NUMERICS_SEED", "0") or 0))
    return True


def reset() -> None:
    """Clear the ledger, the drift and the queued stats, put the sampling
    rate and seed back to their defaults (the reference keeps the last
    rate), and disarm."""
    global _ARMED, _DRIFT_EVERY, _DRIFT_SEED
    with _LOCK:
        _ARMED = False
        _DRIFT_EVERY = DRIFT_EVERY
        _DRIFT_SEED = 0
        _SITES.clear()
        _DRIFT.clear()
        _PENDING.clear()
        _GROUP.clear()


# ----------------------------------------------------------------- probes

@functools.lru_cache(maxsize=None)
def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``float64``), as JAX writes it."""
    return str(dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _max_log2(dtype) -> float:
    import torch

    return math.log2(float(torch.finfo(dtype).max))


def _row_stats(rows):
    """The three statistics of each row of ``rows`` (n, L), L > 0: (n, 3)
    float64 on its device: the non-finite count, the largest finite |x|
    (0 without one) and the smallest non-zero finite |x| (inf without
    one). Twelve kernels: ``|x| < inf`` is the finite mask (false for a
    NaN), and ``|x| > 0`` alone masks the minimum, an infinite |x| being
    the fill itself (``torch.isfinite`` costs four kernels)."""
    import torch

    ax = rows.abs()
    finite = ax < math.inf
    ext = torch.stack([torch.amax(torch.where(finite, ax, 0.0), dim=1),
                       torch.amin(torch.where(ax > 0, ax, math.inf), dim=1)], dim=1)
    # the count in float64: exact past a half-precision dtype's 2**8 or 2**11
    nonfinite = torch.sum(~finite, dim=1, dtype=torch.float64)
    return torch.cat([nonfinite[:, None], ext.double()], dim=1)


def _floating(x) -> bool:
    import torch

    return torch.is_tensor(x) and x.is_floating_point()


def probe(name: str, x):
    """Tensor-health probe at site ``name``: returns ``x`` itself.

    Armed, a floating ``x`` is reduced over its leading
    :data:`PROBE_SAMPLE_CAP` raveled elements and the three numbers are read
    to the host and recorded. The reduction runs on a detached view, so
    gradients pass through the probe untouched."""
    if not _ARMED or not _floating(x):
        return x
    s = x.detach().reshape(1, -1)[:, :PROBE_SAMPLE_CAP]
    if s.numel():
        nf, amax, amin = _row_stats(s)[0].tolist()  # one read to the host
    else:
        nf, amax, amin = 0, 0.0, math.inf
    _record(name, int(s.numel()), _max_log2(x.dtype), _dtype_name(x.dtype), int(nf), amax, amin)
    return x


def probe_cholesky(name: str, L):
    """Probe a Cholesky factor through its diagonal (a failed factor has
    NaN there, and the diagonal's range is the factor's conditioning);
    returns ``L`` itself."""
    if not _ARMED:
        return L
    import torch

    probe(name, torch.diagonal(L, dim1=-2, dim2=-1))
    return L


def probe_cholesky_steps(name: str, Ld):
    """Probe the diagonal blocks ``Ld`` (Np, nb, b, b) of a block-column
    factorization one block column at a time: ``nb`` records of the (Np,
    b) diagonal each (its leading :data:`PROBE_SAMPLE_CAP` elements), from
    one read to the host. The reference probes inside its scan step, so a
    late block column driven indefinite is named at its own record.
    Returns ``Ld`` itself."""
    if not _ARMED or not _floating(Ld):
        return Ld
    import torch

    d = torch.diagonal(Ld.detach(), dim1=-2, dim2=-1).transpose(0, 1)  # (nb, Np, b)
    s = d.reshape(d.shape[0], -1)[:, :PROBE_SAMPLE_CAP]
    rows = _row_stats(s).tolist()  # one read to the host
    max_log2, dtype = _max_log2(Ld.dtype), _dtype_name(Ld.dtype)
    for nf, amax, amin in rows:
        _record(name, int(s.shape[1]), max_log2, dtype, int(nf), amax, amin)
    return Ld


# --------------------------------------------------------- collector mode

def _slab(x, lead: int):
    """The reference collector's slab of each realization's output: ``x``
    (leading ``lead`` realization axes) cut along its first per-realization
    axis, then its last, to at most :data:`PROBE_SAMPLE_CAP_COLLECT`
    elements a realization."""
    for index in _slab_cuts(tuple(x.shape), lead):
        x = x[index]
    return x


@functools.lru_cache(maxsize=256)
def _slab_cuts(shape: tuple, lead: int) -> tuple:
    """The indexings, applied in turn, that cut a ``shape`` output to its
    :func:`_slab` (a sweep's chunks repeat one shape: worked out once)."""
    shape = shape[lead:]
    cap = PROBE_SAMPLE_CAP_COLLECT
    size = math.prod(shape)
    cuts = []
    if len(shape) >= 1 and size > cap:
        inner = max(1, size // shape[0])
        keep = max(1, cap // inner)
        cuts.append((slice(None),) * lead + (slice(0, keep),))
        shape = (min(keep, shape[0]),) + shape[1:]
        size = math.prod(shape)
        if size > cap:
            per_row = max(1, size // shape[-1])
            cuts.append((Ellipsis, slice(0, max(1, cap // per_row))))
    return tuple(cuts)


class Collector:
    """The slabs of one collecting block: per probe call, the site and its
    slab (every realization's; a view, copied once when the block's slabs
    are stacked), reduced together when the block ends (one set of
    reductions for every site, not one a site); and per site the slab's
    elements a realization, log2 of its dtype's largest value and the
    dtype's name."""

    def __init__(self):
        self.slabs: List[tuple] = []
        self.meta: Dict[str, tuple] = {}

    def add(self, name: str, x, lead: int) -> None:
        s = _slab(x.detach(), lead)
        if s.numel() == 0:
            return
        self.meta[name] = (math.prod(s.shape[lead:]), _max_log2(x.dtype), _dtype_name(x.dtype))
        self.slabs.append((name, s))


class collecting:
    """Context manager: while it is active on this thread,
    :func:`probe_realizations` stages its stats in a :class:`Collector`
    (``nreal`` realizations a block); on a clean exit the block's stats are
    queued for the drain (:func:`stash_step_stats`). Inactive unless
    armed."""

    def __init__(self, nreal: int):
        self._nreal = int(nreal)
        self._col = None

    def __enter__(self):
        if _ARMED:
            self._prev = getattr(_TLS, "collector", None)
            self._col = _TLS.collector = Collector()
        return self._col

    def __exit__(self, exc_type, *exc):
        if self._col is None:
            return False
        _TLS.collector = self._prev
        if exc_type is None:
            stash_step_stats(self._col, self._nreal)
        return False


def probe_realizations(name: str, x):
    """Probe a family's output ``x`` (..., Np, Nt), whose leading axes are
    realizations: staged in the thread's collector (no host read) inside
    :class:`collecting`, else the per-call :func:`probe`. Returns ``x``."""
    if not _ARMED or not _floating(x):
        return x
    col = getattr(_TLS, "collector", None)
    if col is None:
        return probe(name, x)
    col.add(name, x, max(0, x.ndim - 2))
    return x


def stash_step_stats(col: Collector, nreal: int) -> None:
    """Queue a collector's stats without reading them: the slabs are
    stacked into one (sites, elements) block of rows on their device (one
    copy when they share a size and dtype, as the families' outputs do)
    and reduced there. Blocks of one device, stream, row size and dtype
    are staged (on the card :data:`_GROUP_BLOCKS` of them, on the host
    :data:`_GROUP_BLOCKS_HOST`, at most :data:`_GROUP_BYTES`) and reduced
    together, on the card their stats copied into pinned host memory
    behind one CUDA event (no synchronisation): one set of launches for
    the group, not one a block, each block's rows still its own records;
    the drain folds them once the event has completed."""
    if not col.slabs:
        return
    import torch

    sites = [name for name, _ in col.slabs]
    slabs = [s for _, s in col.slabs]
    counts = {s: col.meta[s][0] * max(1, int(nreal)) for s in col.meta}
    block = (sites, counts, {s: col.meta[s][1:] for s in col.meta})
    if len({(s.shape, s.dtype) for s in slabs}) == 1:
        # the views stacked: one copy of each, the only copy of the slabs
        rows = torch.stack(slabs).reshape(len(slabs), -1)
    elif len({(s.numel(), s.dtype) for s in slabs}) == 1:
        rows = torch.stack([s.reshape(-1) for s in slabs])
    else:
        _flush_group()  # keep the queue in block order
        _queue([block], torch.cat([_row_stats(s.reshape(1, -1)) for s in slabs]))
        return
    cuda = rows.device.type == "cuda"
    stream = torch.cuda.current_stream(rows.device) if cuda else None
    key = (rows.device, stream.cuda_stream if cuda else None, rows.shape[1], rows.dtype)
    with _LOCK:
        group = _take_group() if _GROUP and _GROUP[0][0] != key else None
    if group:
        _reduce_group(group)
    with _LOCK:
        _GROUP.append((key, stream, block, rows))
        full = (len(_GROUP) >= (_GROUP_BLOCKS if cuda else _GROUP_BLOCKS_HOST)
                or sum(g[3].numel() * g[3].element_size() for g in _GROUP) >= _GROUP_BYTES)
        group = _take_group() if full else None
    if group:
        _reduce_group(group)


def _take_group() -> list:
    """The staged blocks, taken out of the group (call under ``_LOCK``)."""
    group = list(_GROUP)
    _GROUP.clear()
    return group


def _reduce_group(group: list) -> None:
    """Reduce a group of staged blocks on the stream that made them and
    queue their stats behind one event."""
    import torch

    _key, stream, _block, rows = group[0]
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        rows = rows if len(group) == 1 else torch.cat([g[3] for g in group])
        _queue([g[2] for g in group], _row_stats(rows))


def _flush_group() -> None:
    """Reduce the blocks still staged, without waiting for them."""
    with _LOCK:
        group = _take_group()
    if group:
        _reduce_group(group)


def _queue(blocks: list, dev) -> None:
    """Queue the stats ``dev`` (one row a site of each of ``blocks``, in
    order) for the drain: on the card copied into pinned host memory on
    the current stream behind a CUDA event, on the host as they are."""
    import torch

    ev = None
    if dev.device.type == "cuda":
        with _LOCK:
            free = _PINNED.get((tuple(dev.shape), dev.dtype))
            host = free.pop() if free else None
        if host is None:
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev.device))
    else:
        host = dev
    with _LOCK:
        _PENDING.append((blocks, host, ev))
        overflow = len(_PENDING) - _PENDING_MAX
        oldest = _PENDING[:overflow] if overflow > 0 else []
        if overflow > 0:
            del _PENDING[:overflow]
    for old in oldest:
        _fold_pending(old)


def _fold_pending(item) -> None:
    """Record one queued item, block by block: a site probed twice in a
    block is merged into one call (the counts summed, the extremes kept),
    as the reference merges it in the graph."""
    blocks, host, ev = item
    if ev is not None and not ev.query():
        ev.synchronize()
    rows = iter(host.tolist())
    if ev is not None:
        with _LOCK:
            free = _PINNED.setdefault((tuple(host.shape), host.dtype), [])
            if len(free) < _PENDING_MAX:
                free.append(host)
    for sites, counts, meta in blocks:
        merged: Dict[str, list] = {}
        for site, (nf, amax, amin) in zip(sites, rows):
            m = merged.get(site)
            if m is None:
                merged[site] = [nf, amax, amin]
            else:
                m[0] += nf
                m[1] = max(m[1], amax)
                m[2] = min(m[2], amin)
        for site, (nf, amax, amin) in merged.items():
            max_log2, dtype = meta[site]
            _record(site, counts[site], max_log2, dtype, int(nf), amax, amin)


def _drain_pending(only_ready: bool = False) -> None:
    """Fold queued collector stats into the ledger, oldest first. With
    ``only_ready`` stop at the first whose event has not completed (never
    wait for a chunk the pipeline has not finished)."""
    while True:
        with _LOCK:
            if not _PENDING:
                return
            item = _PENDING[0]
            if only_ready and item[2] is not None and not item[2].query():
                return
            del _PENDING[0]
        _fold_pending(item)


def flush() -> None:
    """Reduce the staged blocks and fold every queued collector block,
    waiting for those still in flight (the end of a sweep; tests)."""
    if not _ARMED:
        return
    _flush_group()
    _drain_pending()


def _record(site: str, elements: int, max_log2: float, dtype: str,
            nonfinite: int, absmax: float, minnz: float) -> None:
    """Fold one probe call into the site's rollup and emit its metrics."""
    if not _ARMED:
        return
    nf = int(nonfinite)
    amax, amin = float(absmax), float(minnz)
    headroom = max_log2 - math.log2(amax) if amax > 0.0 else math.inf
    opened = False
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
        rec["max_abs"] = max(rec["max_abs"], amax)
        rec["min_nonzero"] = min(rec["min_nonzero"], amin)
        rec["headroom_bits"] = min(rec["headroom_bits"], headroom)
        rec["dtype"] = dtype
        if nf:
            rec["nonfinite"] += nf
            rec["clean_streak"] = 0
            if not rec["episode_active"]:
                rec["episode_active"] = True
                rec["episodes"] += 1
                opened = True
        else:
            rec["clean_streak"] += 1
            if rec["episode_active"] and rec["clean_streak"] >= EPISODE_CLEAR_AFTER:
                rec["episode_active"] = False
        worst_headroom, max_abs = rec["headroom_bits"], rec["max_abs"]
    if nf:
        counter(names.NUMERICS_NONFINITE).inc(nf)
        counter(names.NUMERICS_NONFINITE, site=site).inc(nf)
    if opened:
        event(names.EVENT_NUMERICS_EPISODE, site=site, count=nf)
    if math.isfinite(headroom):
        gauge(names.NUMERICS_HEADROOM_BITS, site=site).set(min(headroom, worst_headroom))
    gauge(names.NUMERICS_MAX_ABS, site=site).set(max_abs)


# ------------------------------------------------ drain hook and nan scan

def scan_block(site: str, block) -> int:
    """Host-side non-finite scan of a fetched chunk block (a numpy array
    or a tensor, read whole): the last line of defense, after every probe
    (a fault-injected ``nan`` is only visible here). Records at ``site``
    and returns the non-finite count."""
    if not _ARMED:
        return 0
    if not isinstance(block, np.ndarray) and hasattr(block, "detach"):
        block = block.detach().cpu().numpy()
    arr = np.asarray(block)
    if not np.issubdtype(arr.dtype, np.floating):
        return 0
    ax = np.abs(arr)
    amax = float(np.max(ax, initial=0.0))
    # masked reductions: no boolean-indexed copy of a full cube
    if math.isfinite(amax):  # no NaN and no inf: nothing to mask but zeros
        nf = 0
        amin = float(np.min(ax, where=ax > 0, initial=np.inf))
    else:
        finite = np.isfinite(arr)
        nf = int(arr.size - np.count_nonzero(finite))
        amax = float(np.max(ax, where=finite, initial=0.0))
        amin = float(np.min(ax, where=finite & (ax > 0), initial=np.inf))
    _record(site, int(arr.size), float(math.log2(float(np.finfo(arr.dtype).max))),
            str(arr.dtype), nf, amax, amin)
    return nf


def drift_offset(every: Optional[int] = None, seed: Optional[int] = None) -> int:
    """The seeded chunk offset the sampler fires on (a resumed sweep
    samples the same chunks)."""
    every = _DRIFT_EVERY if every is None else max(1, int(every))
    seed = _DRIFT_SEED if seed is None else int(seed)
    return random.Random(seed * 1_000_003).randrange(every)


def should_sample(chunk_index: int) -> bool:
    """True when the armed sampler replays this chunk's realization 0
    through the f64 oracle (one chunk in ``drift_every``, seeded)."""
    if not _ARMED:
        return False
    return int(chunk_index) % _DRIFT_EVERY == drift_offset()


class _DriftShim:
    """The surface of a compiled scenario that the fuzz harness's family
    functions read (``batch``, ``recipe``)."""

    def __init__(self, batch, recipe):
        self.batch = batch
        self.recipe = recipe


def replay_draws(batch, recipe, seed: int, chunk_index: int, nreal: int, noise=None) -> dict:
    """Realization 0's draws of sweep chunk ``chunk_index`` (``nreal``
    realizations a chunk): chunk ``i``'s ``noise(i)`` when the sweep was
    given one, else its generator redrawn from ``chunk_seed(seed, i)``,
    exactly the draws behind cube row 0 of the chunk."""
    import torch

    from ..models.batched import draw_noise
    from ..utils.sweep import chunk_seed

    if noise is not None:
        draws = draw_noise(None, batch, recipe, nreal, noise(int(chunk_index)))
    else:
        generator = torch.Generator(device=batch.device).manual_seed(
            chunk_seed(seed, int(chunk_index)))
        draws = draw_noise(generator, batch, recipe, nreal)
    return {k: v[0] for k, v in draws.items()}


def sample_drift(batch, recipe, draws: dict) -> Dict[str, float]:
    """Replay ONE realization's ``draws`` through the batched families and
    the host float64 oracle of ``scenarios/fuzz.py`` and record each
    family's relative drift (max |deviation| over the oracle's RMS) in the
    ledger and the ``numerics.drift{family=}`` gauge."""
    from ..scenarios import fuzz

    shim = _DriftShim(batch, recipe)
    dev = fuzz.batched_family_delays(shim, draws)
    oracle = fuzz.oracle_family_delays(shim, draws)
    out: Dict[str, float] = {}
    for family, dev_arr in dev.items():
        if family not in oracle:
            continue
        rel = fuzz._rel(dev_arr, oracle[family])
        out[family] = rel
        tol = fuzz.FAMILY_TOLERANCES.get(family)
        with _LOCK:
            rec = _DRIFT.get(family)
            if rec is None:
                rec = _DRIFT[family] = {"worst": 0.0, "samples": 0, "tolerance": tol}
            rec["worst"] = max(rec["worst"], rel)
            rec["samples"] += 1
            rec["tolerance"] = tol
        gauge(names.NUMERICS_DRIFT, family=family).set(rel)
    return out


def on_drain(chunk_index: int, block=None, *, batch=None, recipe=None, seed=None,
             nreal: Optional[int] = None, noise=None, site: str = "drain") -> None:
    """The sweep's per-chunk drain hook (disarmed: one flag check).

    Armed: fold the collector stats whose event completed (never waiting
    for a chunk still in flight), scan the fetched ``block`` at ``site``,
    and on a sampled chunk, when the sweep passed its inputs (``batch``,
    ``recipe``, ``seed``, ``nreal`` = the chunk's realizations, ``noise``),
    replay realization 0 of the chunk through the shadow oracle."""
    if not _ARMED:
        return
    _drain_pending(only_ready=True)
    if block is not None:
        scan_block(site, block)
    if (batch is not None and recipe is not None and (seed is not None or noise is not None)
            and nreal and should_sample(chunk_index)):
        from .trace import span

        with span(names.SPAN_NUMERICS_DRIFT, chunk=int(chunk_index)):
            sample_drift(batch, recipe,
                         replay_draws(batch, recipe, seed, chunk_index, nreal, noise))


# ------------------------------------------------------------ persistence

def snapshot() -> dict:
    """The ledger as a JSON-ready document (the ``numerics.json`` shape):
    the staged blocks are reduced, and what has completed is folded."""
    _flush_group()
    _drain_pending(only_ready=True)
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
        drift = {family: dict(rec) for family, rec in _DRIFT.items()}
        episodes_active = sorted(site for site, rec in _SITES.items() if rec["episode_active"])
    return {
        "schema_version": NUMERICS_SCHEMA_VERSION,
        "armed": _ARMED,
        "sites": sites,
        "drift": drift,
        "nonfinite_total": sum(s["nonfinite"] for s in sites.values()),
        "episodes_active": episodes_active,
    }


def heartbeat_block() -> dict:
    """The compact block a heartbeat embeds: armed, the non-finite total,
    the open episodes and the worst headroom."""
    with _LOCK:
        nonfinite = sum(r["nonfinite"] for r in _SITES.values())
        active = sum(1 for r in _SITES.values() if r["episode_active"])
        headrooms = [r["headroom_bits"] for r in _SITES.values()
                     if math.isfinite(r["headroom_bits"])]
    return {
        "armed": _ARMED,
        "nonfinite": nonfinite,
        "episodes_active": active,
        "worst_headroom_bits": min(headrooms) if headrooms else None,
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
    the drift by family, and the bf16 verdict (no torch needed)."""
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
