"""``chip_smoke.py``'s ``mesh_sweep`` phase alone: build the kernels, then
run the phase on the float32 flagship (68 x 7,758, 100-source catalog)
with its float64 twin, and print the phase's JSON line, then the build's
and the phase's seconds.

    python3 chip_probes/mesh_phase.py [--cli-repeats N] [--inprocess-repeats N]
        [--cli-dataset NPSRxNTOA] [--skip-phase] [--sweep-phase]

On a machine with four or more cards the mesh takes distinct cards, on
one card it repeats card 0 (``chip_smoke._mesh_devices``). Needs the card;
run it from the root of the repository.

``--cli-repeats N`` then runs the phase's CLI arm (``realize`` in fresh
processes on DATASET, unsharded against a 2 x 2 mesh and, on several
cards, ``--sharded``) with N more rounds of the sharded processes, and
prints its row. ``--inprocess-repeats N`` runs the same ``realize`` path in
this process N times on each mesh (every card on 'real', and 2 x 2):
the draws of each card against card 0's, each half of the pulsars' weight
sums against the whole array's, and each shard's block read back through
``fetch_shard_blocks`` (the CLI's readback) and through a device assembly,
against unsharded ``realize``; it prints one JSON line.
``--cli-dataset 8x1000`` runs both on a smaller NG15-shaped dataset
(``ntoa_min`` half the maximum) in place of ``chip_smoke.DATASET``;
``--skip-phase`` skips the build and the phase; ``--sweep-phase`` runs
``chip_smoke.py``'s ``sweep`` phase (whose yardstick reduces through the
sweep's own reduction) before the mesh phase.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _cli_batch(workdir):
    """The CLI's batch, recipe and static delays for ``workdir``'s DATASET
    (``__main__.main``'s realize path, on card 0)."""
    from pta_replicator_tpu_torch.__main__ import _build_recipe
    from pta_replicator_tpu_torch.batch import freeze
    from pta_replicator_tpu_torch.models.batched import deterministic_delays
    from pta_replicator_tpu_torch.simulate import load_from_directories, make_ideal

    device = torch.device("cuda", 0)
    psrs = load_from_directories(str(workdir / "par"), str(workdir / "tim"))
    for psr in psrs:
        make_ideal(psr)
    batch = freeze(psrs, device=device)
    recipe = _build_recipe(json.loads((workdir / "recipe.json").read_text()), psrs).to(device)
    return batch, recipe, deterministic_delays(batch, recipe, device=device)


def inprocess(workdir, repeats):
    """The CLI's realize path in this process on each mesh, ``repeats``
    times: per card, whether its draws equal card 0's; per run, whether the
    fetched and the device-assembled blocks equal unsharded ``realize``,
    and the shards that differ."""
    from pta_replicator_tpu_torch import realize
    from pta_replicator_tpu_torch.models import batched as B
    from pta_replicator_tpu_torch.parallel import mesh as pmesh
    from pta_replicator_tpu_torch.utils.sweep import ShardedBlock

    batch, recipe, static = _cli_batch(workdir)
    nreal, seed = cs.MESH_CLI_NREAL, 0
    # each half of the pulsars' weight sums alone against the whole array's
    # rows: torch.sum as it comes, and row_sums
    w, half = batch.mask / batch.errors_s**2, batch.npsr // 2
    half_sums = {name: [bool(torch.equal(f(w[a:a + half]), f(w)[a:a + half])) for a in (0, half)]
                 for name, f in (("torch_sum", lambda x: torch.sum(x, -1, keepdim=True)),
                                 ("row_sums", B.row_sums))}
    ref = realize(torch.Generator(device=batch.device).manual_seed(seed), batch, recipe, nreal,
                  static=static, device=batch.device).cpu().numpy()
    draws0 = B.draw_noise(torch.Generator(device=batch.device).manual_seed(seed), batch, recipe,
                          nreal)
    draws_equal = {}
    for k in range(torch.cuda.device_count()):
        d = torch.device("cuda", k)
        with torch.cuda.device(d):
            dk = B.draw_noise(torch.Generator(device=d).manual_seed(seed), batch.to(d),
                              recipe.to(d), nreal)
        draws_equal[str(d)] = all(torch.equal(dk[n].cpu(), draws0[n].cpu()) for n in draws0)
    meshes = {"all_cards": pmesh.make_mesh(), "2x2": cs._mesh((2, 2))}
    rows = {}
    for name, mesh in meshes.items():
        runs = []
        for _ in range(repeats):
            res = pmesh.sharded_realize(seed, batch, recipe, nreal, mesh=mesh, static=static)
            fetched = pmesh.fetch_shard_blocks(res)
            fetched = fetched.assemble() if isinstance(fetched, ShardedBlock) else fetched
            on_card = res.assemble().cpu().numpy()
            bad = [str(t.device) for index, t in res.shards
                   if not np.array_equal(t.cpu().numpy(),
                                         ref[tuple(slice(a, b) for a, b in index)])]
            runs.append(dict(fetched_equal=bool(np.array_equal(fetched, ref)),
                             assembled_equal=bool(np.array_equal(on_card, ref)),
                             differing_shards=bad))
        rows[name] = dict(mesh=mesh.label, devices=[str(d) for d in mesh.devices.flat],
                          runs=runs)
    return dict(draws_equal_card0=draws_equal, half_window_sums_equal=half_sums, meshes=rows,
                shape=list(ref.shape))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cli-repeats", type=int, default=None)
    ap.add_argument("--inprocess-repeats", type=int, default=None)
    ap.add_argument("--cli-dataset", default=None, metavar="NPSRxNTOA")
    ap.add_argument("--skip-phase", action="store_true")
    ap.add_argument("--sweep-phase", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mesh_phase: no CUDA device is available")
    t0 = time.perf_counter()
    cs.phase_device()
    extra = {}
    if not args.skip_phase:
        cs.phase_build()
        extra["build_s"] = time.perf_counter() - t0
        batch, recipe = cs.flagship_workload(**cs.FLAGSHIP)
        batch64, recipe64 = cs.flagship_workload(**cs.FLAGSHIP, dtype=torch.float64)
        workdir = Path(tempfile.mkdtemp(prefix="mesh_phase_"))
        t1 = time.perf_counter()
        try:
            if args.sweep_phase:
                cs.phase_sweep(batch, recipe, batch64, recipe64, workdir)
                extra["sweep_phase_s"] = time.perf_counter() - t1
                t1 = time.perf_counter()
            cs.phase_mesh_sweep(batch, recipe, batch64, recipe64, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        extra["phase_s"] = time.perf_counter() - t1
        del batch, recipe, batch64, recipe64
        torch.cuda.empty_cache()
    if args.cli_dataset:
        npsr, ntoa = (int(x) for x in args.cli_dataset.lower().split("x"))
        cs.DATASET = dict(npsr=npsr, ntoa_max=ntoa, ntoa_min=ntoa // 2)
    if args.cli_repeats is not None or args.inprocess_repeats is not None:
        workdir = Path(tempfile.mkdtemp(prefix="mesh_cli_"))
        try:
            t2 = time.perf_counter()
            row = cs._mesh_cli(workdir, "cuda", extra_runs=args.cli_repeats or 0)
            print(json.dumps({"probe": "mesh_cli", **row}), flush=True)
            extra["cli_s"] = time.perf_counter() - t2
            if args.inprocess_repeats:
                t3 = time.perf_counter()
                print(json.dumps({"probe": "mesh_inprocess",
                                  **inprocess(workdir, args.inprocess_repeats)}), flush=True)
                extra["inprocess_s"] = time.perf_counter() - t3
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"cards": torch.cuda.device_count(), "cli_dataset": cs.DATASET, **extra}),
          flush=True)


if __name__ == "__main__":
    main()
