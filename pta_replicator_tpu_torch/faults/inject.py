"""Deterministic, seedable fault injection at named sites.

Counterpart of ``pta_replicator_tpu/faults/inject.py``. The recovery
machinery of the port (the sweep's supervised chunk retry, the prefetch
staging retry, the server's engine retry, the drain deadline, the atomic
checkpoint layer) is trusted only where it can be exercised on demand:
this module fires scheduled faults at named sites inside the stage spans
they perturb, so a chaos run is reproducible down to the chunk index.

* **Zero overhead disarmed.** Every site is one module-global ``None``
  check (:func:`fire` and :func:`poison` return at once): no schedule
  parsing, no telemetry import, no lock. Arming is explicit: :func:`arm`
  / :func:`armed` in code, or ``PTA_FAULTS`` / ``--faults`` through
  :func:`arm_from_env` and the CLI.
* **Deterministic.** Triggers are a chunk index (``chunk=K``, which a
  tile index matches too), the nth call at the site (``call=N``), or a
  seeded probability (``p=P``, one ``random.Random`` per spec from the
  schedule seed): the same schedule, seed and workload fire the same
  faults at the same points on every run.
* **Observable.** Every firing bumps ``faults.injected{site,kind}`` and
  emits a ``faults.fired`` event, and :func:`fired` keeps the last 256
  records.

Sites (:data:`SITES`): ``dispatch``, ``drain``, ``io_write`` (the sweep's
stages), ``cw_stream_stage`` (the prefetcher's staging),
``checkpoint_write`` / ``checkpoint_fsync`` (the atomic checkpoint layer,
the only sites of ``torn``, which truncates the temporary file before it
raises) and ``likelihood_batch`` (the server's engine call).

Schedule grammar (``;``-separated, one fault a spec)::

    site:kind[=param]@trigger[xN]

    kinds    raise | fatal | stall=SECONDS | torn | enospc |
             device_lost | nan
    triggers chunk=K | call=N | p=P
    xN       fire up to N times (default 1)

``nan`` is the one kind that raises nothing: :func:`poison` overwrites one
seeded element of a COPY of the chunk block at the ``drain`` site with
NaN. No retry layer can absorb it (there is no exception to classify); the
numerics observatory's drain scan (``obs/numerics.py::scan_block``) is the
layer that names it.

Standard library and numpy only (torch only for a tensor handed to
:func:`poison`, imported there); the telemetry imports are deferred to the
firing branch.
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

SITE_DISPATCH = "dispatch"
SITE_DRAIN = "drain"
SITE_IO_WRITE = "io_write"
SITE_PREFETCH_STAGE = "cw_stream_stage"
SITE_CHECKPOINT_WRITE = "checkpoint_write"
SITE_CHECKPOINT_FSYNC = "checkpoint_fsync"
SITE_SERVER_ENGINE = "likelihood_batch"

SITES = frozenset({
    SITE_DISPATCH, SITE_DRAIN, SITE_IO_WRITE, SITE_PREFETCH_STAGE,
    SITE_CHECKPOINT_WRITE, SITE_CHECKPOINT_FSYNC, SITE_SERVER_ENGINE,
})

KINDS = frozenset({
    "raise", "fatal", "stall", "torn", "enospc", "device_lost", "nan",
})


class InjectedFault(RuntimeError):
    """A scheduled fault fired. ``transient`` drives the shared classifier
    (``faults/retry.py::is_transient``): transient faults are what the
    recovery machinery must absorb, fatal ones re-raise through every
    retry layer unchanged."""

    def __init__(self, site: str, kind: str, transient: bool = True, detail: str = ""):
        self.site = site
        self.kind = kind
        self.transient = transient
        msg = f"injected fault at {site!r}: {kind}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


@dataclass
class FaultSpec:
    """One scheduled fault: where, what and when."""

    site: str
    kind: str
    stall_s: float = 0.0          # kind == "stall"
    chunk: Optional[int] = None   # trigger: the chunk or tile index == K
    call: Optional[int] = None    # trigger: the Nth call at the site (1-based)
    p: Optional[float] = None     # trigger: a seeded probability a call
    max_fires: int = 1
    # run-time state, owned by the armed schedule and changed under its lock
    calls: int = field(default=0, repr=False)
    fires: int = field(default=0, repr=False)

    def spec_str(self) -> str:
        kind = self.kind
        if self.kind == "stall":
            kind = f"stall={self.stall_s:g}"
        if self.chunk is not None:
            trig = f"chunk={self.chunk}"
        elif self.call is not None:
            trig = f"call={self.call}"
        else:
            trig = f"p={self.p:g}"
        tail = f"x{self.max_fires}" if self.max_fires != 1 else ""
        return f"{self.site}:{kind}@{trig}{tail}"


def parse_schedule(text: str) -> List[FaultSpec]:
    """Parse the ``;``-separated schedule grammar into specs.

    A malformed entry raises ``ValueError`` naming the spec: a chaos run
    with a typing error must refuse to start, not run fault-free."""
    specs: List[FaultSpec] = []
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        try:
            head, trig = raw.split("@", 1)
            site, kind = head.split(":", 1)
            site = site.strip()
            kind = kind.strip()
            stall_s = 0.0
            if "=" in kind:
                kind, param = kind.split("=", 1)
                if kind != "stall":
                    raise ValueError(f"kind {kind!r} takes no parameter")
                stall_s = float(param)
            if site not in SITES:
                raise ValueError(f"unknown site {site!r} (sites: {sorted(SITES)})")
            if kind not in KINDS:
                raise ValueError(f"unknown kind {kind!r} (kinds: {sorted(KINDS)})")
            if kind == "torn" and site not in (SITE_CHECKPOINT_WRITE, SITE_CHECKPOINT_FSYNC):
                raise ValueError(
                    "torn faults need a file to tear — only the "
                    "checkpoint_write/checkpoint_fsync sites support them"
                )
            if kind == "nan" and site != SITE_DRAIN:
                raise ValueError(
                    "nan faults need an in-flight chunk block to "
                    "poison — only the drain site supports them"
                )
            max_fires = 1
            trig = trig.strip()
            if "x" in trig.rsplit("=", 1)[-1]:
                trig, n = trig.rsplit("x", 1)
                max_fires = int(n)
            tkey, _, tval = trig.partition("=")
            tkey = tkey.strip()
            spec = FaultSpec(site=site, kind=kind, stall_s=stall_s, max_fires=max_fires)
            if tkey == "chunk":
                spec.chunk = int(tval)
            elif tkey == "call":
                spec.call = int(tval)
                if spec.call < 1:
                    raise ValueError("call trigger is 1-based")
            elif tkey == "p":
                spec.p = float(tval)
                if not 0.0 < spec.p <= 1.0:
                    raise ValueError("p must be in (0, 1]")
            else:
                raise ValueError(f"unknown trigger {tkey!r} (chunk=K | call=N | p=P)")
        except ValueError as exc:
            raise ValueError(f"bad fault spec {raw!r}: {exc}") from None
        specs.append(spec)
    return specs


#: records :func:`fired` keeps (the oldest drop first)
LOG_CAP = 256


class _Schedule:
    """The armed schedule: its specs, one seeded stream a spec, and the
    log of fired faults."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int):
        self.specs = list(specs)
        self.seed = int(seed)
        self.lock = threading.Lock()
        # one stream a spec: the firings at one site cannot shift another
        # spec's draws
        self.rngs = [random.Random(self.seed * 1_000_003 + i) for i in range(len(specs))]
        self.log: List[dict] = []

    def _record(self, rec: dict) -> None:
        # bounded: a runaway p-trigger must not grow host memory
        self.log.append(rec)
        if len(self.log) > LOG_CAP:
            del self.log[0]

    def _match(self, site: str, nan: bool, index):
        """Advance the call counters of this surface's specs at ``site``,
        then take the first that fires: ``(spec, its stream)`` or None.
        Every spec's counter advances on every call at its site, whether
        another spec fires or not, so two ``call=N`` specs each fire at
        their own N."""
        with self.lock:
            for spec in self.specs:
                if spec.site == site and (spec.kind == "nan") == nan:
                    spec.calls += 1
            for k, spec in enumerate(self.specs):
                if (spec.site != site or (spec.kind == "nan") != nan
                        or spec.fires >= spec.max_fires):
                    continue
                if spec.chunk is not None:
                    hit = index is not None and int(index) == spec.chunk
                elif spec.call is not None:
                    hit = spec.calls == spec.call
                else:
                    hit = self.rngs[k].random() < spec.p
                if not hit:
                    continue
                spec.fires += 1
                self._record({
                    "site": site, "kind": spec.kind, "spec": spec.spec_str(),
                    "chunk": None if index is None else int(index), "call": spec.calls,
                })
                return spec, self.rngs[k]
        return None


#: the armed schedule, or None (the disarmed state)
_STATE: Optional[_Schedule] = None


def arm(schedule: Union[str, Sequence[FaultSpec]], seed: int = 0) -> None:
    """Arm a schedule process-wide: the grammar string, or built specs."""
    global _STATE
    specs = parse_schedule(schedule) if isinstance(schedule, str) else list(schedule)
    _STATE = _Schedule(specs, seed)


def disarm() -> None:
    global _STATE
    _STATE = None


def is_armed() -> bool:
    return _STATE is not None


def fired() -> List[dict]:
    """The records of the faults fired since arming (site, kind, spec,
    chunk, call), the last :data:`LOG_CAP`."""
    state = _STATE
    if state is None:
        return []
    with state.lock:
        return list(state.log)


class armed:
    """Context manager: arm for the block, restore the previous state on
    exit."""

    def __init__(self, schedule, seed: int = 0):
        self._schedule = schedule
        self._seed = seed

    def __enter__(self):
        self._saved = _STATE
        arm(self._schedule, seed=self._seed)
        return _STATE

    def __exit__(self, *exc):
        global _STATE
        _STATE = self._saved


def arm_from_env(env: str = "PTA_FAULTS", seed_env: str = "PTA_FAULTS_SEED") -> bool:
    """Arm from ``PTA_FAULTS`` (seed ``PTA_FAULTS_SEED``) when it is set;
    returns whether a schedule was armed."""
    text = os.environ.get(env)
    if not text:
        return False
    arm(text, seed=int(os.environ.get(seed_env, "0")))
    return True


def _tear(path: str) -> None:
    """Truncate ``path`` to half its size: the artifact an interrupted
    write leaves. The atomic-write layer never renamed it into place, so
    the retry overwrites it."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(size // 2)
    except OSError:
        pass  # the raise that follows is the fault either way


def fire(site: str, **ctx) -> None:
    """An injection point. Disarmed: one ``None`` check.

    Armed: ``ctx`` carries the trigger inputs (``chunk=`` or ``tile=``)
    and what the site offers (``path=`` for ``torn``); the first matching
    non-``nan`` spec of ``site`` is performed."""
    state = _STATE
    if state is None:
        return
    index = ctx.get("chunk", ctx.get("tile"))
    # `nan` specs are poison()'s alone: the drain site fires before the
    # fetch, with no block to poison yet
    hit = state._match(site, False, index)
    if hit is None:
        return
    action = hit[0]
    _emit(site, action, index)
    if action.kind == "stall":
        time.sleep(action.stall_s)
        return
    if action.kind == "torn":
        path = ctx.get("path")
        if path:
            _tear(str(path))
        raise InjectedFault(site, "torn", transient=True, detail=f"truncated {ctx.get('path')}")
    if action.kind == "enospc":
        raise OSError(errno.ENOSPC, "No space left on device (injected)")
    if action.kind == "device_lost":
        raise InjectedFault(site, "device_lost", transient=True,
                            detail="DEVICE_LOST: simulated device failure")
    if action.kind == "fatal":
        raise InjectedFault(site, "fatal", transient=False)
    raise InjectedFault(site, "raise", transient=True)


def _poison_array(arr, rng: random.Random):
    """A copy of ``arr`` with one seeded element set to NaN. A torch tensor
    (the drain's pinned readback buffer, which its ring hands to a later
    chunk) is copied to a numpy array; a numpy array is copied."""
    import numpy as np

    if not isinstance(arr, np.ndarray) and hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    arr = np.array(arr, copy=True)
    if arr.size and np.issubdtype(arr.dtype, np.floating):
        arr.reshape(-1)[rng.randrange(arr.size)] = np.nan
    return arr


def poison(site: str, block, **ctx):
    """The data-corruption injection point. Disarmed: one ``None`` check,
    and ``block`` passes through untouched.

    Armed: the first matching ``nan`` spec of ``site`` returns a COPY of
    ``block`` (a numpy array or a tensor, as a numpy array) with one
    seeded element set to NaN; no exception. Triggers and the per-spec
    seeded stream work as :func:`fire`'s; the two surfaces are disjoint by
    kind."""
    state = _STATE
    if state is None:
        return block
    index = ctx.get("chunk", ctx.get("tile"))
    hit = state._match(site, True, index)
    if hit is None:
        return block
    action, rng = hit
    _emit(site, action, index)
    return _poison_array(block, rng)


def _emit(site: str, spec: FaultSpec, index) -> None:
    """Telemetry of one firing (imported here: a disarmed process never
    imports ``obs``)."""
    from ..obs import counter, event, names

    counter(names.FAULTS_INJECTED, site=site, kind=spec.kind).inc()
    event(names.EVENT_FAULT_FIRED, site=site, kind=spec.kind, spec=spec.spec_str(),
          chunk=None if index is None else int(index))
