"""Command line of the port: the dataset path and the declarative
scenario path.

    python -m pta_replicator_tpu_torch info --pardir PAR --timdir TIM [--num-psrs N]
    python -m pta_replicator_tpu_torch realize --pardir PAR --timdir TIM \
        --recipe R.json --out R.npz [--nreal 100] [--seed 0] \
        [--fit | --full-fit | --gls-fit] [--checkpoint CK.npz --chunk 256] \
        [--write-partim DIR --write-max 16] [--device cuda]
    python -m pta_replicator_tpu_torch scenario validate SPEC [SPEC ...]
    python -m pta_replicator_tpu_torch scenario compile SPEC [--out W.npz] [--device cuda]
    python -m pta_replicator_tpu_torch scenario run SPEC [--out R.npz]
        [--checkpoint CK.npz] [--nreal N] [--device cuda]

The counterpart of ``python -m pta_replicator_tpu info|realize|scenario``:
the same arguments, guards and JSON summary lines, with ``--device``
(default ``cuda``; without a card the command fails and names ``--device
cpu``) in place of ``--platform``. ``info`` loads a par/tim directory pair,
zeroes the residuals (``make_ideal``) and prints the frozen array's shape,
backends and epochs. ``realize`` adds a JSON recipe (the ``Recipe``'s
fields, plus ``"orf"``: ``"hd"`` (default), ``"none"`` or ``{"lmax": L,
"clm": [...]}``; the JAX-only ``cgw_backend`` and
``gwb_synthesis_precision`` are dropped) and writes the residual cube,
through ``realize`` or, with ``--checkpoint``, the resumable sweep;
``--full-fit`` refits the full timing design of the par files (WLS),
``--gls-fit`` the same weighted by the recipe's noise model;
``--write-partim`` materializes the first datasets (``utils/export.py``).
Its summary and npz add ``fit`` and ``design_columns``, which say what
the cube was fitted with (a bank must be priced with that design). Flags
of modules not ported yet exit non-zero before ingest: ``--sharded`` and
``--mesh-shape`` (ROADMAP A.17), ``--telemetry``, ``--device-trace`` and
``--faults`` (A.16).
``run`` draws its realizations from the port's generators, seeded from the
spec's ``realize`` family (``CompiledScenario.realize_seed``), so its
residuals are the port's own, not the JAX package's. ``fuzz`` and
``replay`` diff the batched engine against the numpy oracle path through
the differential fuzz harness, which is not ported yet (ROADMAP A.15):
they exit non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pta_replicator_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("realize", "info"):
        p = sub.add_parser(name)
        p.add_argument("--pardir", required=True)
        p.add_argument("--timdir", required=True)
        p.add_argument("--num-psrs", type=int, default=None)
        p.add_argument("--telemetry", default=None, metavar="DIR",
                       help="not ported (ROADMAP A.16): exits non-zero")
        p.add_argument("--faults", default=None, metavar="SCHEDULE",
                       help="not ported (ROADMAP A.16): exits non-zero")
        p.add_argument("--faults-seed", type=int, default=0)
        p.add_argument("--device", default="cuda",
                       help="the torch device (default cuda; cpu on request)")
    p = sub.choices["realize"]
    p.add_argument("--device-trace", action="store_true",
                   help="not ported (ROADMAP A.16): exits non-zero")
    p.add_argument("--recipe", required=True, help="JSON recipe file")
    p.add_argument("--nreal", type=int, default=100)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fit", action="store_true",
                   help="per-realization quadratic refit")
    p.add_argument("--full-fit", action="store_true",
                   help="per-realization FULL-model refit (spin, astrometry, DMX/DM, FD, "
                        "binary, JUMP columns from the loaded par files) by WLS instead of "
                        "the quadratic; implies --fit")
    p.add_argument("--gls-fit", action="store_true",
                   help="weight the full-model refit by the recipe's own noise model "
                        "(GLS); implies --full-fit")
    p.add_argument("--sharded", action="store_true",
                   help="not ported (ROADMAP A.17, multi-GPU): exits non-zero")
    p.add_argument("--mesh-shape", default=None, metavar="RxP",
                   help="not ported (ROADMAP A.17, multi-GPU): exits non-zero")
    p.add_argument("--checkpoint", default=None,
                   help="resumable sweep checkpoint path (chunked)")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="chunks in flight for a checkpointed sweep (1: the synchronous "
                        "loop); the results are identical at every depth")
    p.add_argument("--fused-stream", action="store_true",
                   help="run a checkpointed sweep as one stage graph that rebuilds each "
                        "chunk's deterministic delays; byte-identical results; needs "
                        "--pipeline-depth >= 2")
    p.add_argument("--drain-timeout", type=float, default=900.0, metavar="S",
                   help="fail a pipelined sweep when one chunk's readback or checkpoint "
                        "write exceeds S seconds; <= 0 disables the deadline")
    p.add_argument("--chunk-retries", type=int, default=2,
                   help="transient chunk failures absorbed per failing chunk by resuming "
                        "from the checkpoint sidecar; 0 fails fast")
    p.add_argument("--write-partim", default=None, metavar="DIR",
                   help="also materialize realizations as par/tim datasets under "
                        "DIR/real{r:05d}/ (pre-fit injected delays, the residual cube's "
                        "draws)")
    p.add_argument("--write-max", type=int, default=16,
                   help="cap on datasets written by --write-partim")
    p = sub.add_parser(
        "scenario",
        help="declarative scenario layer: validate/compile specs, or run one "
             "through the sweep with its provenance stamped")
    p.add_argument("action", choices=("validate", "compile", "run", "fuzz", "replay"),
                   help="validate: check spec files and print their content hashes; "
                        "compile: spec -> workload summary (--out writes the static-"
                        "plane npz); run: compile + checkpointed sweep with the spec "
                        "hash stamped into the sidecar; fuzz, replay: not ported")
    p.add_argument("specs", nargs="*", metavar="SPEC",
                   help="scenario spec file(s), .json or .toml")
    p.add_argument("--out", default=None,
                   help="compile: write the static plane + fingerprint npz here; "
                        "run: write the result cube npz here")
    p.add_argument("--checkpoint", default=None,
                   help="run: resumable sweep checkpoint path (default: <out>.sweep.npz)")
    p.add_argument("--nreal", type=int, default=None,
                   help="run: override the spec's sweep.nreal")
    p.add_argument("--device", default="cuda",
                   help="compile, run: the torch device (default cuda; cpu on request)")
    return ap


def _save_npz(path: str, **arrays) -> None:
    """Write an npz atomically (np.savez appends .npz to other suffixes,
    so the temporary name carries it)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _device(name: str, cmd: str = "scenario"):
    from .device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as exc:
        raise SystemExit(f"{cmd}: {exc} (on the command line: --device cpu)")


def _run_scenario(args):
    from .scenarios import SpecError, compile_spec, load_spec
    from .scenarios.compile import sweep_plan

    if args.action in ("fuzz", "replay"):
        raise SystemExit(
            f"scenario {args.action}: not ported; it diffs the batched engine against "
            "the numpy oracle path through the differential fuzz harness, which waits "
            "for ROADMAP A.15. Use `python -m pta_replicator_tpu scenario "
            f"{args.action}`."
        )

    def load_all():
        if not args.specs:
            raise SystemExit("scenario: give at least one SPEC file")
        out = []
        for path in args.specs:
            try:
                out.append((path, load_spec(path)))
            except SpecError as exc:
                raise SystemExit(f"{path}: {exc}")
        return out

    if args.action == "validate":
        for path, spec in load_all():
            print(json.dumps({"spec": path, "name": spec.name, "hash": spec.content_hash,
                              "valid": True}))
        return

    if args.action == "compile":
        all_specs = load_all()
        if args.out and len(all_specs) > 1:
            raise SystemExit(
                "scenario compile --out takes exactly one SPEC (the output path would "
                "be overwritten per spec); compile them separately"
            )
        device = _device(args.device)
        for path, spec in all_specs:
            compiled = compile_spec(spec, validate=False, device=device)
            summary = {
                "spec": path,
                "name": spec.name,
                "hash": compiled.spec_hash,
                "fingerprint": compiled.fingerprint,
                "families": list(compiled.families),
                "npsr": int(compiled.batch.npsr),
                "ntoa": int(compiled.batch.ntoa_max),
                "plan": vars(compiled.plan),
            }
            if args.out:
                _save_npz(args.out, static=compiled.static_delays().cpu().numpy(),
                          fingerprint=np.array(compiled.fingerprint))
                summary["out"] = args.out
            print(json.dumps(summary, sort_keys=True))
        return

    from .utils.sweep import sweep

    specs = load_all()
    if len(specs) > 1:
        raise SystemExit(
            f"scenario run takes exactly one SPEC (got {len(specs)}); run them "
            "separately — each sweep needs its own --checkpoint/--out"
        )
    path, spec = specs[0]
    plan = sweep_plan(spec)
    nreal = args.nreal if args.nreal is not None else plan.nreal
    if nreal % plan.chunk:
        # a different chunk would change the per-chunk seeds (and so the
        # draws): a non-divisible override is an error, not an adjustment
        raise SystemExit(
            f"--nreal {nreal} must be a multiple of the spec's sweep.chunk "
            f"({plan.chunk}); pick a multiple or edit the spec's sweep section"
        )
    device = _device(args.device)
    compiled = compile_spec(spec, validate=False, device=device)
    ckpt = args.checkpoint or ((args.out or f"{spec.name}.npz") + ".sweep.npz")
    out = sweep(compiled.realize_seed(), compiled.batch, compiled.recipe, nreal, ckpt,
                chunk=plan.chunk, reduce_fn=None, fit=plan.fit,
                pipeline_depth=plan.pipeline_depth, provenance=compiled.provenance(),
                device=device)
    summary = {"spec": path, "hash": compiled.spec_hash, "checkpoint": ckpt,
               "shape": list(out.shape), "rms_s": float(np.sqrt((out**2).mean()))}
    if args.out:
        _save_npz(args.out, residuals=out, mask=compiled.batch.mask.cpu().numpy())
        summary["out"] = args.out
    print(json.dumps(summary, sort_keys=True))


#: flags of modules not ported yet: (attribute, flag, ROADMAP item)
UNPORTED_FLAGS = (
    ("sharded", "--sharded", "A.17 (multi-GPU)"),
    ("mesh_shape", "--mesh-shape", "A.17 (multi-GPU)"),
    ("telemetry", "--telemetry", "A.16 (observability)"),
    ("device_trace", "--device-trace", "A.16 (observability)"),
    ("faults", "--faults", "A.16 (fault injection)"),
)


def _build_recipe(spec: dict, psrs):
    """JSON recipe spec -> Recipe (on the host; the caller moves it), the
    ORF's sky locations from ``psrs``. Array fields become float64
    tensors; the JAX-only knobs are dropped
    (``convert.JAX_ONLY_RECIPE_FIELDS``)."""
    import torch

    from .convert import JAX_ONLY_RECIPE_FIELDS
    from .models.batched import ARRAY_FIELDS, Recipe
    from .ops.coords import pulsar_ra_dec
    from .ops.orf import assemble_orf

    spec = dict(spec)
    orf_mode = spec.pop("orf", "hd")
    lmax_ok = (
        isinstance(orf_mode, dict)
        and isinstance(orf_mode.get("lmax"), int)
        and not isinstance(orf_mode.get("lmax"), bool)
    )
    if not (orf_mode in ("hd", "none") or lmax_ok):
        raise SystemExit(
            'recipe key "orf" must be "hd", "none", or an object with an '
            f'integer "lmax" key (and optional "clm"); got {orf_mode!r}'
        )
    kwargs = {}
    for key, val in spec.items():
        if key in JAX_ONLY_RECIPE_FIELDS:
            continue
        if key not in Recipe.__dataclass_fields__:
            raise SystemExit(f"recipe key {key!r} is not a Recipe field")
        kwargs[key] = (torch.from_numpy(np.asarray(val, dtype=np.float64))
                       if key in ARRAY_FIELDS else val)

    if "orf_cholesky" not in kwargs and orf_mode != "none":
        locs = np.zeros((len(psrs), 2))
        for i, p in enumerate(psrs):
            ra, dec = pulsar_ra_dec(p.loc, p.name)
            locs[i] = ra, np.pi / 2 - dec
        if orf_mode == "hd":
            orf = assemble_orf(locs, lmax=0)
        else:
            orf = assemble_orf(locs, clm=orf_mode.get("clm"), lmax=int(orf_mode["lmax"]))
        kwargs["orf_cholesky"] = torch.from_numpy(np.linalg.cholesky(np.asarray(orf, np.float64)))
    return Recipe(**kwargs)


def _run_dataset(args):
    """``info`` and ``realize``: ingest, freeze, and (realize) the cube."""
    import dataclasses

    import torch

    from .batch import freeze
    from .models.batched import deterministic_delays, realize
    from .simulate import load_from_directories, make_ideal

    # every guard runs before ingest: a refused invocation loads nothing
    for attr, flag, item in UNPORTED_FLAGS:
        if getattr(args, attr, None):
            raise SystemExit(
                f"{args.cmd} {flag}: not ported yet (ROADMAP {item}); the JAX package's "
                f"`python -m pta_replicator_tpu {args.cmd}` has it"
            )
    if args.cmd == "realize":
        if args.fused_stream and not args.checkpoint:
            raise SystemExit(
                "--fused-stream needs --checkpoint: the fused stage graph is the "
                "checkpointed sweep executor"
            )
        if args.fused_stream and args.pipeline_depth < 2:
            raise SystemExit(
                "--fused-stream needs --pipeline-depth >= 2: at depth 1 there is no "
                "concurrency for the static build to overlap with"
            )
        chunk = min(args.chunk, args.nreal)
        if args.checkpoint and args.nreal % chunk:
            raise SystemExit(f"--nreal {args.nreal} must be a multiple of --chunk {chunk}")
    device = _device(args.device, args.cmd)
    if device.type == "cuda":
        # the fits and the GWB synthesis need IEEE float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    psrs = load_from_directories(args.pardir, args.timdir, num_psrs=args.num_psrs)
    for psr in psrs:
        make_ideal(psr)
    batch = freeze(psrs, device=device)
    if args.cmd == "info":
        print(json.dumps({
            "npsr": batch.npsr,
            "ntoa_max": batch.ntoa_max,
            "names": list(batch.names),
            "backends": list(batch.backend_names),
            "max_epochs": batch.max_epochs,
            "tref_mjd": float(batch.tref_mjd),
        }))
        return

    with open(args.recipe) as fh:
        recipe = _build_recipe(json.load(fh), psrs)
    if args.gls_fit:
        args.full_fit = True
    mode = "quadratic" if args.fit else "none"
    design_columns = 3 if args.fit else None
    design_names = []
    if args.full_fit:
        from .timing.fit import design_tensor

        args.fit = True
        D, design_names = design_tensor(psrs, ntoa_max=batch.ntoa_max)
        recipe = dataclasses.replace(recipe, fit_design=torch.from_numpy(D),
                                     fit_gls=bool(args.gls_fit))
        mode, design_columns = ("gls" if args.gls_fit else "wls"), int(D.shape[-1])
    recipe = recipe.to(device)
    # the deterministic delays (B.1's CW catalog, ...), once for realize
    # and the datasets; a sweep builds its own
    static = None
    if not args.checkpoint or args.write_partim:
        static = deterministic_delays(batch, recipe, device=device)

    if args.checkpoint:
        from .utils.sweep import sweep

        out = sweep(args.seed, batch, recipe, args.nreal, args.checkpoint, chunk=chunk,
                    reduce_fn=None, fit=args.fit, pipeline_depth=args.pipeline_depth,
                    drain_timeout_s=args.drain_timeout if args.drain_timeout > 0 else None,
                    chunk_retries=args.chunk_retries, fused_stream=args.fused_stream,
                    progress=lambda d, n: print(f"chunk {d}/{n}", file=sys.stderr),
                    device=device)
    else:
        generator = torch.Generator(device=device).manual_seed(args.seed)
        out = realize(generator, batch, recipe, args.nreal, fit=args.fit, static=static,
                      device=device).cpu().numpy()

    np.savez(args.out, residuals=out, mask=batch.mask.cpu().numpy(),
             names=np.array(batch.names), fit=np.array(mode),
             design_names=np.array(json.dumps(design_names)))
    summary = {
        "out": args.out,
        "shape": list(out.shape),
        "rms_s": float(np.sqrt((out**2).mean())),
        "fit": mode,
        "design_columns": design_columns,
    }
    if args.write_partim:
        from .utils.export import materialize_realizations

        # dataset r carries the delays behind cube row r: the draws of the
        # engine that made the cube (a checkpointed sweep's per-chunk
        # generators, or realize's one generator of nreal)
        dirs = materialize_realizations(
            psrs, batch, recipe, args.seed, args.nreal, args.write_partim,
            write_max=args.write_max, sweep_chunk=chunk if args.checkpoint else None,
            static=static, device=device)
        summary["partim_dirs"] = len(dirs)
    print(json.dumps(summary))


def main(argv=None):
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.cmd == "scenario":
        return _run_scenario(args)
    return _run_dataset(args)


if __name__ == "__main__":
    main()
