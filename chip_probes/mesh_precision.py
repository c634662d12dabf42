"""How far float32 moves the mesh's results, and the unsharded engine's:
on one chunk of 200 of the flagship (68 x 7,758, fit) and of config B's
GLS refit (166 columns), one set of draws goes through the unsharded
float32 engine, the 2 x 1, 1 x 2 and 2 x 2 meshes on card 0, the float64
engine (the draws cast) and the unsharded float32 engine on the chunk's
first 100 realizations alone. Prints one JSON line per recipe: each pair's
difference, its RMS and its largest entry over the reference's RMS, on the
residual cube and on the per-pulsar RMS the sweep keeps.

    python3 chip_probes/mesh_precision.py

Needs the card; run it from the root of the repository.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pta_replicator_tpu_torch.models import batched as B  # noqa: E402
from pta_replicator_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pta_replicator_tpu_torch.utils.sweep import _default_reduce  # noqa: E402

SEED, CHUNK, HALF = 13, 200, 100


def errors(got, want):
    got, want = got.double(), want.double()
    rms, diff = torch.sqrt(torch.mean(want**2)), (got - want).abs()
    return {"rel_rms": float(torch.sqrt(torch.mean(diff**2)) / rms),
            "max_over_rms": float(diff.max() / rms)}


def both(got, want, batch):
    return {"cube": errors(got, want),
            "rms": errors(_default_reduce(got, batch), _default_reduce(want, batch))}


def main():
    if not torch.cuda.is_available():
        sys.exit("mesh_precision: no CUDA device is available")
    cs.phase_device()
    cs.phase_build()
    b32, r32 = cs.flagship_workload(**cs.FLAGSHIP)
    b64, r64 = cs.flagship_workload(**cs.FLAGSHIP, dtype=torch.float64)
    design = cs._fit_design(b32)
    recipes = {
        "flagship_quadratic": (r32, r64),
        "config_b_gls": tuple(dataclasses.replace(cs._config_b(b, r, b.dtype),
                                                  fit_design=design.to(b.dtype), fit_gls=True)
                              for b, r in ((b32, r32), (b64, r64))),
    }
    for name, (rec32, rec64) in recipes.items():
        draws = B.draw_noise(torch.Generator(device="cuda").manual_seed(SEED), b32, rec32, CHUNK)
        ref = B.realize(None, b32, rec32, CHUNK, fit=True, noise=draws, device=b32.device)
        f64 = B.realize(None, b64, rec64, CHUNK, fit=True, device=b32.device,
                        noise={k: v.double() for k, v in draws.items()})
        row = {"f32_vs_f64": both(ref, f64, b32)}
        for shape in ((2, 1), (1, 2), (2, 2)):
            mesh = pmesh.make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
            got = pmesh.sharded_realize(0, b32, rec32, CHUNK, mesh=mesh, fit=True,
                                        noise=draws).assemble()
            label = f"{shape[0]}x{shape[1]}"
            row[f"{label}_vs_f32"] = both(got, ref, b32)
            row[f"{label}_vs_f64"] = both(got, f64, b32)
        half = B.realize(None, b32, rec32, HALF, fit=True, device=b32.device,
                         noise={k: v[:HALF] for k, v in draws.items()})
        row["half_chunk_vs_f32"] = both(half, ref[:HALF], b32)
        print(json.dumps({"recipe": name, "chunk": CHUNK, **row}), flush=True)
        del draws, ref, f64, half
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
