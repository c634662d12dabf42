"""Command line of the port: the declarative scenario path.

    python -m pta_replicator_tpu_torch scenario validate SPEC [SPEC ...]
    python -m pta_replicator_tpu_torch scenario compile SPEC [--out W.npz] [--device cuda]
    python -m pta_replicator_tpu_torch scenario run SPEC [--out R.npz]
        [--checkpoint CK.npz] [--nreal N] [--device cuda]

The counterpart of ``python -m pta_replicator_tpu scenario``: the same
arguments, guards and JSON summary lines, plus ``--device`` (default
``cuda``; without a card the command fails and names ``--device cpu``).
``run`` draws its realizations from the port's generators, seeded from the
spec's ``realize`` family (``CompiledScenario.realize_seed``), so its
residuals are the port's own, not the JAX package's. ``fuzz`` and
``replay`` diff the batched engine against the numpy oracle path, which
the port does not have yet (ROADMAP A.15, A.18): they exit non-zero.
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


def _device(name: str):
    from .device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as exc:
        raise SystemExit(f"scenario: {exc} (on the command line: --device cpu)")


def _run_scenario(args):
    from .scenarios import SpecError, compile_spec, load_spec
    from .scenarios.compile import sweep_plan

    if args.action in ("fuzz", "replay"):
        raise SystemExit(
            f"scenario {args.action}: not ported; it diffs the batched engine against "
            "the numpy oracle path, which waits for ROADMAP A.15 (the fuzz harness) and "
            "A.18 (the oracle path). Use `python -m pta_replicator_tpu scenario "
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


def main(argv=None):
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    return _run_scenario(args)


if __name__ == "__main__":
    main()
