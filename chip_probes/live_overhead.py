"""The live-run overhead arm of ``chip_smoke.py`` on one tree, for
comparing two trees on one card: armed (a capture, the flight recorder
every 0.16 s, one latency objective) against disarmed (none), flagship
sweeps of 15,000 reduced realizations in chunks of 200 at depth 2, in ABBA
pairs, with each armed sweep's sampler CPU (``obs.overhead_s``) and the
cyclic collector's pauses of every sweep.

    python3 chip_probes/live_overhead.py TREE LABEL [--pairs 6]

``TREE`` is the root of a checkout (this one, or a parent unpacked with
``git archive``); its ``pta_replicator_tpu_torch`` is the one imported.
Prints one JSON line. Run two trees as parent, change, change, parent in
one call. Needs the card.
"""
import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--pairs", type=int, default=6)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import pta_replicator_tpu_torch
    from pta_replicator_tpu_torch import flagship_workload, obs
    from pta_replicator_tpu_torch.kernels import build
    from pta_replicator_tpu_torch.utils import sweep as sweep_mod

    if not Path(pta_replicator_tpu_torch.__file__).resolve().is_relative_to(tree):
        sys.exit(f"imported {pta_replicator_tpu_torch.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        sys.exit("live_overhead: no CUDA device is available")
    build.build_all(build.sources())
    nreal, chunk = 15_000, 200
    batch, recipe = flagship_workload(npsr=68, ntoa=7758, ncw=100)[:2]
    work = Path(tempfile.mkdtemp(prefix="live_overhead_"))
    pauses = []

    def on_gc(phase, info, t=[0.0]):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - t[0])

    gc.callbacks.append(on_gc)

    def one(armed, k):
        if armed:
            obs.start_capture(str(work / f"a{k}"), heartbeat_interval_s=0.16,
                              slo="sweep=dispatch:p99_ms<=1000@99%")
        path = work / "s.npz"
        del pauses[:]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweep_mod.sweep(20, batch, recipe, nreal, str(path), chunk=chunk, fit=True,
                            pipeline_depth=2, device=batch.device)
            wall = time.perf_counter() - t0
            sampler = obs.REGISTRY.counter("obs.overhead_s").value if armed else None
        finally:
            if armed:
                obs.finish_capture(context={})
                obs.configure(None)
                obs.reset_all()
        sweep_mod._cleanup_chunks(str(path), nreal // chunk)
        for p in (path, Path(str(path) + ".meta.json")):
            p.unlink(missing_ok=True)
        return nreal / wall, sampler, sum(pauses)

    one(False, 0)
    one(True, 0)
    rates = {"armed": [], "disarmed": []}
    gc_s = {"armed": [], "disarmed": []}
    sampler_s = []
    for k in range(args.pairs):
        for mode in (("armed", "disarmed") if k % 2 == 0 else ("disarmed", "armed")):
            rate, sampler, paused = one(mode == "armed", k)
            rates[mode].append(rate)
            gc_s[mode].append(paused)
            if sampler is not None:
                sampler_s.append(sampler)
    median = {m: float(np.median(v)) for m, v in rates.items()}
    print(json.dumps(dict(tree=args.label, rates=rates, median=median,
                          ratio=median["armed"] / median["disarmed"],
                          paired=[a / d for a, d in zip(rates["armed"], rates["disarmed"])],
                          sampler_cpu_s=sampler_s, gc_pause_s=gc_s)))


if __name__ == "__main__":
    main()
