"""``chip_smoke.py``'s ``numerics_observatory`` overhead arm alone, with
a breakdown of the armed observatory's host time.

    python3 chip_probes/numerics_overhead.py [--reps N] [--tag NAME]

On the float32 flagship (68 x 7,758, 100-source catalog, fit), as the
phase runs it: a warm-up sweep of each mode, then ``--reps`` adjacent
pairs of the reduced sweep (12,000 realizations in chunks of 200, drift
rate 1 in 128, no chunk sampled) armed and disarmed in ABBA order; the
rate of each, each pair's armed / disarmed ratio and their median (the
phase's gate reads it against 0.95). Then one more armed sweep with the
observatory's per-chunk entry points timed on the host clock, by
function and by thread (``collecting``'s block, ``probe_realizations``,
``stash_step_stats``, ``on_drain``) and its ledger's calls at
``realization.white`` (one a chunk), and, apart from any sweep, the host
microseconds a call of ``_row_stats`` (on the card, the slabs' stacked
shape), ``scan_block`` (a (200, 68) float32 block) and ``_record``, and
the CUDA kernels one ``_row_stats`` call launches (torch.profiler).
Prints one JSON line. Needs the card; run it from the root of the
repository (or of another checkout, which it then measures).
"""
import argparse
import collections
import functools
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pta_replicator_tpu_torch import flagship_workload  # noqa: E402
from pta_replicator_tpu_torch.obs import numerics  # noqa: E402


def _timed(table, name, fn):
    """``fn`` with its host seconds added to ``table[(name, thread)]``."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            row = table[(name, threading.current_thread().name)]
            row[0] += 1
            row[1] += time.perf_counter() - t0

    return wrapper


def _breakdown(batch, recipe, path, nreal, kw):
    """One armed sweep with the observatory's per-chunk entry points
    timed: {function: {thread: [calls, ms a chunk]}}."""
    table = collections.defaultdict(lambda: [0, 0.0])
    saved = {k: getattr(numerics, k) for k in ("probe_realizations", "stash_step_stats",
                                               "on_drain")}
    enter, leave = numerics.collecting.__enter__, numerics.collecting.__exit__
    try:
        for k, fn in saved.items():
            setattr(numerics, k, _timed(table, k, fn))
        numerics.collecting.__enter__ = _timed(table, "collecting.enter", enter)
        numerics.collecting.__exit__ = _timed(table, "collecting.exit", leave)
        _, wall = cs._numerics_sweep(batch, recipe, path, nreal, True, **kw)
        white = numerics.snapshot()["sites"].get("realization.white", {}).get("calls")
    finally:
        for k, fn in saved.items():
            setattr(numerics, k, fn)
        numerics.collecting.__enter__, numerics.collecting.__exit__ = enter, leave
        numerics.reset()
    chunks = nreal // cs.NUMERICS_CHUNK
    out = collections.defaultdict(dict)
    for (name, thread), (n, s) in sorted(table.items()):
        out[name][thread] = [n, s * 1e3 / chunks]
    return dict(wall_s=wall, white_calls=white, chunks=chunks, ms_a_chunk=dict(out))


def _micro(nreal):
    """Host microseconds a call of the observatory's pieces, apart from
    any sweep, and the kernels one ``_row_stats`` call launches."""
    from torch.profiler import ProfilerActivity, profile

    nsites = 5
    rows = torch.randn(nsites, numerics.PROBE_SAMPLE_CAP_COLLECT * nreal, device="cuda")
    block = np.random.default_rng(0).standard_normal((nreal, 68)).astype(np.float32)
    out = {}
    numerics.reset()
    numerics.arm()
    for _ in range(20):
        numerics._row_stats(rows)
    torch.cuda.synchronize()
    n = 500
    t0 = time.perf_counter()
    for _ in range(n):
        numerics._row_stats(rows)
    out["row_stats_host_us"] = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    out["row_stats_wall_us"] = (time.perf_counter() - t0) / n * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        numerics._row_stats(rows)
        torch.cuda.synchronize()
    out["row_stats_kernels"] = sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA
                                   and "Memcpy" not in e.key and "Memset" not in e.key)
    t0 = time.perf_counter()
    for _ in range(n):
        numerics.scan_block("drain", block)
    out["scan_block_us"] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        numerics._record("realization.white", 1024, 127.0, "float32", 0, 1.0, 1e-9)
    out["record_us"] = (time.perf_counter() - t0) / n * 1e6
    numerics.reset()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=cs.NUMERICS_OVERHEAD_REPS)
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("numerics_overhead: no card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    batch, recipe = flagship_workload(**cs.FLAGSHIP)
    nreal, short = cs.NUMERICS_OVERHEAD_NREAL, cs.NUMERICS_OVERHEAD_SHORT_NREAL
    kw = dict(fit=True, pipeline_depth=cs.TELEMETRY_SWEEP["pipeline_depth"],
              drift_every=cs.NUMERICS_OVERHEAD_DRIFT_EVERY)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "numerics.npz"
        for mode in (False, True):  # warm both
            cs._numerics_sweep(batch, recipe, path, short, mode, **kw)
            numerics.reset()
        rates = {"armed": [], "disarmed": []}
        for k in range(args.reps):
            for mode in (("armed", "disarmed") if k % 2 == 0 else ("disarmed", "armed")):
                _, wall = cs._numerics_sweep(batch, recipe, path, nreal, mode == "armed", **kw)
                rates[mode].append(nreal / wall)
                numerics.reset()
        paired = [a / d for a, d in zip(rates["armed"], rates["disarmed"])]
        breakdown = _breakdown(batch, recipe, path, nreal, kw)
    row = dict(tag=args.tag, rates=rates, paired_ratios=paired,
               paired_median=float(np.median(paired)),
               median={k: float(np.median(v)) for k, v in rates.items()},
               breakdown=breakdown, micro=_micro(cs.NUMERICS_CHUNK),
               seconds=time.perf_counter() - t_start)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
