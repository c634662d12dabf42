"""Device-time attribution: kernel cost accounting, roofline
classification, and the managed torch.profiler trace.

Counterpart of ``pta_replicator_tpu/obs/devprof.py``. The host-side tracer
(``obs/trace.py``) says how long a stage took; this module says what the
card was asked to do in it and what it did:

* **cost capture**: XLA's ``Compiled.cost_analysis()`` has no torch
  counterpart, and the port compiles no program to ask. In its place each
  hand kernel's module counts its operations and bytes from the shapes
  (``ops/cw.py::cw_catalog_operations`` / ``cw_catalog_bytes``,
  ``cov_syrk_operations`` / ``cov_syrk_bytes``,
  ``ops/gp.py::woodbury_operations`` / ``woodbury_bytes``,
  ``tridiag_operations`` / ``tridiag_bytes``), and
  :func:`record_kernel_cost` records a call's counts as
  ``cuda.cost.flops`` / ``cuda.cost.bytes_accessed`` gauges labeled by the
  kernel, where the JAX package writes ``jax.cost.*``.
* **roofline**: :func:`roofline` combines those counts with a measured time
  (CUDA events) and :data:`PEAK_TABLE` into achieved FLOP/s and bytes/s,
  the arithmetic intensity and, where the card's peaks are known, the
  percent of the roofline and a compute- or memory-bound verdict, as
  ``cuda.roofline.*`` gauges (the JAX package's ``jax.roofline.*``). The
  launch-plan tuner records both for the Woodbury kernel at its search
  shape (``likelihood/tuner.py::autotune``).
* **managed device trace**: :func:`device_trace` runs ``torch.profiler``
  with CPU and CUDA activities (no shapes, no stacks) around a block,
  defaults its logdir into the active capture, wraps it in the
  ``device_trace`` span with the wall-clock ``t_wall_open`` /
  ``t_wall_close`` markers, and on exit writes the chrome trace as
  ``<logdir>/<host>.<pid>.pt.trace.json`` (the JAX merger's
  ``*.trace.json*`` glob finds it) and registers the directory: a
  ``devprof.device_trace`` event and ``meta.json``'s ``device_traces``.
  Right after ``t_wall_open`` is stamped, a
  ``record_function("device_trace_open")`` marker lands in the trace;
  ``obs/timeline.py`` anchors the profiler's clock on it.

CUPTI records the CUDA runtime's calls and the kernels of every thread of
the process, but ``torch.profiler`` records the CPU operators of the thread
that opened the session only: a worker thread's launches appear as runtime
events and kernels without their operator. In a process that has profiled
and computed for minutes, a session on the card can lose the records of its
first few dozen kernels (the runtime calls stay; ``chip_smoke.py``'s
``time_attribution`` reads the loss as ``warmup_lost``), so
:func:`device_trace` launches :data:`WARMUP_LAUNCHES` tiny kernels and
synchronizes before its open marker, and the caller's kernels come after
the loss.

What has no counterpart: ``note_trace``, ``capture_pending`` and
``jaxhooks`` (compile and retrace counters, ``instrumented_jit``), since
the port does not jit; the device-memory snapshot is the allocator's
counters (``obs/flightrec.py::device_memory_snapshot``); ``record_transfer``
belongs to the multi-device mesh (ROADMAP A.17).
"""
from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Dict, Optional, Tuple

from . import names
from .metrics import REGISTRY
from .trace import TRACER

#: device kind -> (peak FLOP/s by dtype, peak HBM bytes/s). The H100 SXM's
#: data-sheet rates, dense: FP64 on the tensor cores (DMMA) and FP32
#: outside them, both 67 TFLOP/s, bf16 on the tensor cores 989 TFLOP/s,
#: HBM3 3.35 TB/s. They assume the card's full 700 W power limit.
PEAK_TABLE: Dict[str, Tuple[Dict[str, float], float]] = {
    "NVIDIA H100 80GB HBM3": (
        {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}, 3.35e12,
    ),
}
#: the rate :func:`peak_for` picks without a dtype
DEFAULT_DTYPE = "float64"

#: env overrides for cards the table doesn't know (both required)
_PEAK_FLOPS_ENV = "DEVPROF_PEAK_FLOPS"
_PEAK_BYTES_ENV = "DEVPROF_PEAK_BYTES_PER_S"

#: the chrome trace's open marker (``obs/timeline.py`` anchors on it)
OPEN_MARKER = "device_trace_open"
#: tiny kernels launched on the card between a session's start and its open
#: marker, to take the loss of a session's first kernel records (a few dozen
#: at most on the H100; ``chip_smoke.py`` reads the loss as ``warmup_lost``)
WARMUP_LAUNCHES = 128

_lock = threading.Lock()
#: logdirs registered by managed device traces this run
_TRACE_DIRS: list = []
#: a managed trace is running in this process
_ACTIVE = [False]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def peak_for(device_kind: Optional[str], dtype=None) -> Optional[Tuple[float, float]]:
    """(peak FLOP/s, peak bytes/s) for a device kind, the FLOP rate of
    ``dtype`` (default :data:`DEFAULT_DTYPE`), or None when unknown.
    ``DEVPROF_PEAK_FLOPS`` / ``DEVPROF_PEAK_BYTES_PER_S`` override (both
    required; a half-set or unparseable override warns and is ignored)."""
    import warnings

    env_f, env_b = os.environ.get(_PEAK_FLOPS_ENV), os.environ.get(_PEAK_BYTES_ENV)
    if env_f or env_b:
        try:
            if not (env_f and env_b):
                raise ValueError("both env vars are required")
            return float(env_f), float(env_b)
        except ValueError as exc:
            warnings.warn(
                f"ignoring peak override ({_PEAK_FLOPS_ENV}={env_f!r}, "
                f"{_PEAK_BYTES_ENV}={env_b!r}): {exc} — falling back to "
                "the built-in PEAK_TABLE",
                stacklevel=2,
            )
    entry = PEAK_TABLE.get(device_kind)
    if entry is None:
        return None
    flops = entry[0].get(_dtype_name(dtype) if dtype is not None else DEFAULT_DTYPE)
    return None if flops is None else (flops, entry[1])


def record_kernel_cost(label: str, flops: float, bytes_accessed: float) -> dict:
    """Record one call's operations and bytes of the hand kernel ``label``
    (its own counts, computed from the shapes it was given) as
    ``cuda.cost.flops`` and ``cuda.cost.bytes_accessed`` gauges labeled
    ``label``; returns them."""
    cost = {"flops": float(flops), "bytes_accessed": float(bytes_accessed)}
    for key, val in cost.items():
        REGISTRY.gauge(f"{names.CUDA_COST_PREFIX}{key}", label=label).set(val)
    return cost


def roofline(
    label: str,
    *,
    flops: float,
    bytes_accessed: Optional[float] = None,
    elapsed_s: float,
    calls: int = 1,
    device_kind: Optional[str] = None,
    dtype=None,
) -> dict:
    """Roofline position of ``calls`` executions of a kernel of ``flops`` /
    ``bytes_accessed`` *per call* over ``elapsed_s`` seconds.

    Always computes the achieved FLOP/s (and bytes/s and the arithmetic
    intensity when ``bytes_accessed`` is known); with a known peak
    (:func:`peak_for` of ``device_kind`` and ``dtype``) adds the percent of
    peak, the ridge intensity, the percent of the roofline (the
    intensity-limited attainable rate) and a ``bound`` classification.
    Everything lands in ``cuda.roofline.*`` gauges labeled ``label``."""
    if elapsed_s <= 0 or flops <= 0:
        return {}
    out: Dict[str, float] = {"flops_per_s": flops * calls / elapsed_s}
    if bytes_accessed:
        out["bytes_per_s"] = bytes_accessed * calls / elapsed_s
        out["intensity_flop_per_byte"] = flops / bytes_accessed
    peak = peak_for(device_kind, dtype)
    if peak is not None:
        peak_flops, peak_bw = peak
        out["pct_of_peak_flops"] = 100.0 * out["flops_per_s"] / peak_flops
        if "intensity_flop_per_byte" in out:
            ridge = peak_flops / peak_bw
            out["ridge_intensity"] = ridge
            attainable = min(peak_flops, out["intensity_flop_per_byte"] * peak_bw)
            out["pct_of_roofline"] = 100.0 * out["flops_per_s"] / attainable
    for key, val in out.items():
        REGISTRY.gauge(f"{names.CUDA_ROOFLINE_PREFIX}{key}", label=label).set(val)
    result = dict(out)
    if "ridge_intensity" in out:
        result["bound"] = classify(out["intensity_flop_per_byte"], out["ridge_intensity"])
    return result


def classify(intensity: float, ridge: float) -> str:
    """"compute-bound" when the kernel's arithmetic intensity sits at or
    beyond the ridge point, else "memory-bound"."""
    return "compute-bound" if intensity >= ridge else "memory-bound"


def trace_file_name() -> str:
    """The chrome trace's file name inside a logdir:
    ``<host>.<pid>.pt.trace.json``."""
    return f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, *, device="cuda"):
    """Profile the block with ``torch.profiler`` (CPU and, on the card, CUDA
    activities; no shapes, no stacks) as a *capture artifact*.

    ``logdir`` defaults to ``<capture dir>/device_trace`` and raises
    without an active capture. ``device`` is the card unless the caller
    asks for the CPU (``device="cpu"``: CPU activity only); naming CUDA
    without a card raises. A session inside another ``torch.profiler``
    session raises: the profiler does not nest, and a second start would
    silently end the first. On exit the chrome trace is written as
    ``<logdir>/<host>.<pid>.pt.trace.json``, a ``devprof.device_trace``
    event is emitted and the directory joins ``meta.json``'s
    ``device_traces`` (:func:`trace_dirs`). On the card the session opens
    with :data:`WARMUP_LAUNCHES` tiny kernels and a synchronize, before the
    open marker (the module docstring says why). A profiler error
    propagates.
    ``utils.profiling.device_trace`` is the shim over this."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..device import resolve_device

    if logdir is None:
        base = TRACER.directory
        if base is None:
            raise ValueError(
                "no telemetry capture is active; pass an explicit logdir "
                "or call obs.start_capture first"
            )
        logdir = os.path.join(base, "device_trace")
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with _lock:
        if _ACTIVE[0] or torch.autograd._profiler_enabled():
            raise RuntimeError(
                "device_trace: a torch.profiler session is already running in "
                "this process; the profiler does not nest"
            )
        _ACTIVE[0] = True
    try:
        with TRACER.span(names.SPAN_DEVICE_TRACE, logdir=logdir) as sp:
            os.makedirs(logdir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
            if device.type == "cuda":
                buf = torch.empty(1, device=device)  # no fill: the adds alone launch
                for _ in range(WARMUP_LAUNCHES):
                    buf.add_(1.0)
                torch.cuda.synchronize(device)
            # the correlation markers: the wall-clock instants bracketing the
            # session, and the open marker on the profiler's own clock
            # right after the first, so obs/timeline.py can map one onto
            # the other
            sp["t_wall_open"] = time.time()
            with record_function(OPEN_MARKER):
                pass
            try:
                yield logdir
            finally:
                t_close = time.time()
                sp["t_wall_close"] = t_close
                prof.stop()
                prof.export_chrome_trace(os.path.join(logdir, trace_file_name()))
                with _lock:
                    _TRACE_DIRS.append(logdir)
                TRACER.event(names.EVENT_DEVICE_TRACE, logdir=logdir,
                             t_wall_open=sp["t_wall_open"], t_wall_close=t_close)
    finally:
        with _lock:
            _ACTIVE[0] = False


def trace_dirs(relative_to: Optional[str] = None) -> list:
    """Logdirs registered by managed traces this run; with
    ``relative_to``, paths inside that directory are relativized (so a
    capture directory stays self-describing when moved)."""
    with _lock:
        dirs = list(_TRACE_DIRS)
    if relative_to is None:
        return dirs
    out = []
    for d in dirs:
        rel = os.path.relpath(d, relative_to)
        out.append(rel if not rel.startswith("..") else d)
    return out


def reset() -> None:
    """Forget the registered trace dirs: ``obs.start_capture`` and
    ``obs.reset_all`` call it, so one capture dir describes one run."""
    with _lock:
        _TRACE_DIRS.clear()
