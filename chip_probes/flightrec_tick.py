"""Where the flight recorder's sampler tick spends its time while the
flagship sweep runs under a live capture, as in ``chip_smoke.py``'s
live-run overhead arm (68 x 7,758 float32, 100-source catalog, fit,
15,000 reduced realizations in chunks of 200, depth 2, a heartbeat every
0.16 s, one latency objective).

Each part of the tick (the heartbeat and its blocks, the atomic writes,
the series and objective samples, the scrape artifacts) is wrapped to add
its thread CPU and wall time, measured on the sampler thread itself.
Prints one JSON object: the sweeps' rates and ``obs.overhead_s``, each
part's calls, CPU ms and wall ms, and a check that ``proc.rss_bytes``
reads a fresh resident size.

    python3 chip_probes/flightrec_tick.py [--sweeps 4]

Runs on the card; with no card it runs a 4 x 128 sweep on the CPU.
"""
import argparse
import collections
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from pta_replicator_tpu_torch import flagship_workload, obs  # noqa: E402
from pta_replicator_tpu_torch.obs import flightrec, numerics  # noqa: E402
from pta_replicator_tpu_torch.obs import series as series_mod  # noqa: E402
from pta_replicator_tpu_torch.utils import sweep as sweep_mod  # noqa: E402

HEARTBEAT_S, SLO = 0.16, "sweep=dispatch:p99_ms<=1000@99%"


def _rss_check():
    """proc.rss_bytes against a fresh open of /proc/self/statm, before and
    after touching 300 MB."""
    def reopened():
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    r0, f0 = series_mod.process_rss_bytes(), reopened()
    blob = bytearray(300_000_000)
    r1, f1 = series_mod.process_rss_bytes(), reopened()
    del blob
    return dict(kept_fd=[r0, r1], reopened=[f0, f1],
                fresh=abs(r1 - f1) < 8_000_000 and r1 - r0 > 250_000_000)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweeps", type=int, default=4)
    args = ap.parse_args()
    card = torch.cuda.is_available()
    if card:
        from pta_replicator_tpu_torch.kernels import build
        build.build_all(build.sources())
        batch, recipe = flagship_workload(npsr=68, ntoa=7758, ncw=100)[:2]
        nreal, chunk = 15_000, 200
    else:
        batch, recipe = flagship_workload(npsr=4, ntoa=128, ncw=4, device="cpu")[:2]
        nreal, chunk = 600, 20
    acc = collections.defaultdict(lambda: [0, 0.0, 0.0])

    def wrap(name, fn):
        def timed(*a, **k):
            c, t = time.thread_time(), time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                e = acc[name]
                e[0] += 1
                e[1] += time.thread_time() - c
                e[2] += time.perf_counter() - t
        return timed

    for mod, attr in ((flightrec, "_atomic_json"), (flightrec, "_atomic_text"),
                      (flightrec, "device_memory_snapshot"), (numerics, "heartbeat_block")):
        setattr(mod, attr, wrap(attr, getattr(mod, attr)))
    work = Path(tempfile.mkdtemp(prefix="flightrec_tick_"))
    rows = []
    for k in range(args.sweeps):
        obs.start_capture(str(work / f"c{k}"), heartbeat_interval_s=HEARTBEAT_S, slo=SLO)
        rec = flightrec.active()
        for attr in ("write_heartbeat", "_write_live_artifacts", "_heartbeat",
                     "_occupancy_block", "_sweep_block", "_check_watchdog"):
            setattr(rec, attr, wrap(attr, getattr(rec, attr)))
        for obj, attr, label in ((rec.series, "sample", "series.sample"),
                                 (rec.series, "trends", "series.trends"),
                                 (rec.series, "snapshot", "series.snapshot"),
                                 (rec.slo, "sample", "slo.sample"),
                                 (rec.slo, "heartbeat_block", "slo.heartbeat_block"),
                                 (rec.occupancy, "snapshot", "occupancy.snapshot")):
            setattr(obj, attr, wrap(label, getattr(obj, attr)))
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep_mod.sweep(20, batch, recipe, nreal, str(work / "s.npz"), chunk=chunk, fit=True,
                        pipeline_depth=2, device=batch.device)
        wall = time.perf_counter() - t0
        overhead = obs.REGISTRY.counter(obs.names.OBS_OVERHEAD_S).value
        obs.finish_capture(context={})
        obs.configure(None)
        obs.reset_all()
        sweep_mod._cleanup_chunks(str(work / "s.npz"), nreal // chunk)
        for p in (work / "s.npz", work / "s.npz.meta.json"):
            p.unlink(missing_ok=True)
        rows.append(dict(sweep=k, rate=nreal / wall, wall_s=wall, overhead_s=overhead))
    parts = {k: dict(calls=v[0], cpu_ms=round(v[1] * 1e3, 3), wall_ms=round(v[2] * 1e3, 3),
                     wall_ms_per_call=round(v[2] * 1e3 / max(1, v[0]), 4))
             for k, v in sorted(acc.items(), key=lambda kv: -kv[1][2])}
    print(json.dumps(dict(device=torch.cuda.get_device_name(0) if card else "cpu",
                          rss_check=_rss_check(), sweeps=rows, parts=parts)))


if __name__ == "__main__":
    main()
