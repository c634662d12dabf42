"""A multi-process sharded run on one host: ``nproc`` processes join a gloo
group on ``127.0.0.1`` (``parallel/distributed.py``), each lays out the
same local mesh, realizes its rows of every chunk of a workload through
``sharded_realize`` and saves its ``local_realizations``.

The parent side is :func:`launch`; each process runs::

    python -m pta_replicator_tpu_torch.parallel.rehearsal PORT RANK NPROC OUT.npz \\
        [--mesh 1x2] [--device cpu] [--workload white|flagship] [--npsr 4] ...

Chunk ``i`` draws from ``sweep.chunk_seed(seed, i)``, the sweep's seed, so
the stitched blocks of all processes are the rows of one process's sweep
of the same workload. On the card the processes may share one device.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

#: keys of the saved topology
TOPOLOGY_KEYS = ("process_index", "process_count", "local_device_count", "global_device_count")
#: the flagship workload's CW catalog here
NCW = 4
#: seconds a process waits to join the group
JOIN_TIMEOUT_S = 60.0


def workload(kind: str, npsr: int, ntoa: int, dtype, device):
    """``(batch, recipe)`` of a run: ``"white"``, the elementwise recipe
    (per-backend EFAC and EQUAD on a synthetic batch), or ``"flagship"``
    (``scenarios/compile.py::flagship_workload`` with NCW sources)."""
    from ..batch import synthetic_batch
    from ..models.batched import Recipe
    from ..scenarios.compile import flagship_workload

    if kind == "flagship":
        return flagship_workload(npsr=npsr, ntoa=ntoa, ncw=NCW, dtype=dtype, device=device)
    batch = synthetic_batch(npsr=npsr, ntoa=ntoa, nbackend=2, seed=2, dtype=dtype, device=device)
    return batch, Recipe(efac=torch.full((npsr, 2), 1.1, dtype=dtype, device=device),
                         log10_equad=torch.full((npsr, 2), -6.5, dtype=dtype, device=device))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pta_replicator_tpu_torch.parallel.rehearsal")
    ap.add_argument("port", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("out")
    ap.add_argument("--mesh", default="1x1", help="this process's local mesh, RxP")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workload", default="white", choices=("white", "flagship"))
    ap.add_argument("--npsr", type=int, default=4)
    ap.add_argument("--ntoa", type=int, default=64)
    ap.add_argument("--nreal", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--float32", action="store_true")
    return ap


def main(argv=None) -> None:
    from . import distributed
    from .mesh import sharded_realize
    from ..utils.sweep import chunk_seed

    args = _parser().parse_args(argv)
    n_real, n_psr = (int(x) for x in args.mesh.split("x"))
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.float32 if args.float32 else torch.float64
    topo = distributed.initialize(f"tcp://127.0.0.1:{args.port}", args.nproc, args.rank,
                                  devices=[device] * (n_real * n_psr), timeout_s=JOIN_TIMEOUT_S)
    try:
        mesh = distributed.global_mesh(n_real, n_psr)
        batch, recipe = workload(args.workload, args.npsr, args.ntoa, dtype, device)
        blocks = [distributed.local_realizations(
            sharded_realize(chunk_seed(args.seed, i), batch, recipe, args.chunk, mesh=mesh,
                            fit=args.fit))
            for i in range(args.nreal // args.chunk)]
        np.savez(args.out, local=np.stack(blocks), **topo)
    finally:
        distributed.shutdown()


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, outdir: str, *, timeout_s: float = 120.0, env: Optional[dict] = None,
           **options) -> list:
    """Run ``nproc`` processes of :func:`main` (``options`` are its flags:
    ``mesh="1x2"``, ``device="cpu"``, ``fit=True``, ...) and return each
    one's saved arrays, in rank order. Every process has ``timeout_s``: one
    past it has them all killed and raises; a process that failed raises
    with its output."""
    port = free_port()
    flags = []
    for key, value in options.items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            flags.append(flag)
        elif value not in (False, None):
            flags += [flag, str(value)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    outs = [os.path.join(outdir, f"rank{r}.npz") for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pta_replicator_tpu_torch.parallel.rehearsal", str(port), str(r),
         str(nproc), outs[r], *flags],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"a rehearsal process ran past {timeout_s} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rehearsal rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    results = []
    for path in outs:
        with np.load(path) as z:
            results.append({k: z[k] for k in z.files})
    return results


if __name__ == "__main__":
    main()
