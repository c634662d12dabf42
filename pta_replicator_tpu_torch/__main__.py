"""Command line of the port: the dataset path, the likelihood over a
realization bank, and the declarative scenario path.

    python -m pta_replicator_tpu_torch info --pardir PAR --timdir TIM [--num-psrs N]
    python -m pta_replicator_tpu_torch realize --pardir PAR --timdir TIM \
        --recipe R.json --out R.npz [--nreal 100] [--seed 0] \
        [--fit | --full-fit | --gls-fit] [--checkpoint CK.npz --chunk 256] \
        [--write-partim DIR --write-max 16] [--device cuda]
    python -m pta_replicator_tpu_torch likelihood --bank CK.npz --recipe R.json \
        (--pardir PAR --timdir TIM | --synthetic 10x512) \
        [--grid FIELD=LO:HI:N ...] [--map FIELD=X0 ...] [--serve N] [--out L.json]
        [--device cuda]
    python -m pta_replicator_tpu_torch scenario validate SPEC [SPEC ...]
    python -m pta_replicator_tpu_torch scenario compile SPEC [--out W.npz] [--device cuda]
    python -m pta_replicator_tpu_torch scenario run SPEC [--out R.npz]
        [--checkpoint CK.npz] [--nreal N] [--device cuda]
    python -m pta_replicator_tpu_torch scenario fuzz [--n 50 | --fast] [--root-seed 0]
        [--out-dir DIR] [--sweep-every K] [--device cuda]
    python -m pta_replicator_tpu_torch scenario replay SPEC [SPEC ...] [--device cuda]
    python -m pta_replicator_tpu_torch report DIR [--json] [--min-ms X]
    python -m pta_replicator_tpu_torch watch DIR [--interval S] [--once] [--serve PORT]
        [--bind HOST]
    python -m pta_replicator_tpu_torch postmortem DIR
    python -m pta_replicator_tpu_torch numerics report DIR
    python -m pta_replicator_tpu_torch critpath DIR [--out PATH] [--json]
    python -m pta_replicator_tpu_torch timeline DIR [--out PATH]

The counterpart of ``python -m pta_replicator_tpu info|realize|likelihood|
scenario``: the same arguments, guards, exit codes and JSON output, with
``--device`` (default ``cuda``; without a card the command fails and names
``--device cpu``) in place of ``--platform``. ``info`` loads a par/tim
directory pair, zeroes the residuals (``make_ideal``) and prints the
frozen array's shape, backends and epochs. ``realize`` adds a JSON recipe
(the ``Recipe``'s fields, plus ``"orf"``: ``"hd"`` (default), ``"none"``
or ``{"lmax": L, "clm": [...]}``; the JAX-only ``cgw_backend`` and
``gwb_synthesis_precision`` are dropped) and writes the residual cube,
through ``realize`` or, with ``--checkpoint``, the resumable sweep;
``--full-fit`` refits the full timing design of the par files (WLS),
``--gls-fit`` the same weighted by the recipe's noise model;
``--write-partim`` materializes the first datasets (``utils/export.py``).
Its summary and npz add ``fit`` and ``design_columns``, which say what
the cube was fitted with (a bank must be priced with that design).

``likelihood`` prices a realization bank (a sweep checkpoint of either
package, or an (R, Np, Nt) ``.npy`` cube) under a recipe's noise model on
the dataset it was synthesized from: a ``--grid`` of phi-only
hyperparameters through ``bank_loglikelihood`` (unfused, no design, the
JAX CLI's route), a ``--map`` fit on one row, and a ``--serve`` demo of
request-batched evaluation with its SLO block. Its batch is frozen in
torch's default float dtype, as the JAX CLI's is in JAX's default float
(float64 under ``jax_enable_x64``).

``run`` draws its realizations from the port's generators, seeded from the
spec's ``realize`` family (``CompiledScenario.realize_seed``), so its
residuals are the port's own, not the JAX package's. ``fuzz`` diffs the
batched engine against the per-pulsar oracle path over random scenarios
(``scenarios/fuzz.py``; the JAX package's specs, the port's draws) and
exits 1 on a disagreement or a broken sweep identity, writing the shrunk
failing specs under ``--out-dir``; ``replay`` re-runs saved specs through
the differential and exits 1 when one disagrees.

``--telemetry DIR`` (on ``info``, ``realize``, ``scenario`` and
``likelihood``) captures the run's spans and metrics into DIR, under a
span named after the subcommand, in the JAX package's formats
(``obs/__init__.py``); ``report DIR`` renders a capture of either package
(``--json`` for the aggregate, ``--min-ms`` to hide short spans). The CLI's
own spans are ``ingest``, ``freeze``, ``build_recipe``, ``compute`` and
``write_output``, at the JAX CLI's places. A capture runs the flight
recorder: ``progress.json`` every second, ``series.jsonl`` and, with
``PTA_SLO`` set, ``slo.json``; SIGTERM, SIGINT or an exception leave
``postmortem.json``. ``watch DIR`` prints one line per heartbeat and exits
0 when the run finishes, 2 when it left a postmortem, 3 with ``--once``
and no heartbeat; ``--serve PORT`` (0: an ephemeral port) serves
``/metrics``, ``/progress``, ``/series``, ``/slo``, ``/healthz`` and
``/readyz`` on ``--bind`` (default 127.0.0.1) while it watches.
``postmortem DIR`` renders the black box.

``realize --telemetry DIR --device-trace`` also profiles the run with
torch.profiler (CPU and CUDA activities; CPU only with ``--device cpu``)
into ``DIR/device_trace``, registered in ``meta.json``
(``obs/devprof.py``); without ``--telemetry`` it exits non-zero before any
work. After a run, ``critpath DIR`` writes ``DIR/critpath.json``, the
critical-path attribution (per-stage exclusive seconds, the per-chunk
chains, a ranked verdict; exit 2 when the capture has no stage spans),
and prints its rendering (``--json``: the document); ``timeline DIR``
writes ``DIR/timeline.json``, one Perfetto file of the host spans, the
chunk flows, the critical path and the device traces on the wall clock,
and prints its summary. Both read either package's capture.

``--faults SCHEDULE`` (every subcommand; ``--faults-seed`` seeds its
``p=`` triggers) arms a fault-injection schedule before any work and
before a capture starts (``faults/inject.py``; e.g. ``'drain:raise@chunk=1;
checkpoint_write:torn@call=2'``); without it, ``PTA_FAULTS`` (seed
``PTA_FAULTS_SEED``) arms one. A malformed schedule exits non-zero with
the parser's message before any work. ``numerics report DIR`` renders a
capture's ``numerics.json`` (either package's; ``PTA_NUMERICS=1`` arms
the observatory for a ``--telemetry`` capture).

Flags of modules not ported yet exit non-zero before any work:
``--sharded`` and ``--mesh-shape`` (ROADMAP A.17).
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
                       help=TELEMETRY_HELP)
        p.add_argument("--device", default="cuda",
                       help="the torch device (default cuda; cpu on request)")
    p = sub.choices["realize"]
    p.add_argument("--device-trace", action="store_true",
                   help="also profile the run with torch.profiler (CPU and CUDA activities) "
                        "into <telemetry dir>/device_trace, registered as a capture artifact "
                        "in meta.json (merge it with `timeline DIR`); requires --telemetry")
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
                        "hash stamped into the sidecar; fuzz: random scenarios through "
                        "the batched-vs-oracle differential (exit 1 on any "
                        "disagreement); replay: re-run saved specs through the "
                        "differential")
    p.add_argument("specs", nargs="*", metavar="SPEC",
                   help="scenario spec file(s), .json or .toml")
    p.add_argument("--out", default=None,
                   help="compile: write the static plane + fingerprint npz here; "
                        "run: write the result cube npz here")
    p.add_argument("--checkpoint", default=None,
                   help="run: resumable sweep checkpoint path (default: <out>.sweep.npz)")
    p.add_argument("--nreal", type=int, default=None,
                   help="run: override the spec's sweep.nreal")
    p.add_argument("--n", type=int, default=50,
                   help="fuzz: scenarios to generate (default 50)")
    p.add_argument("--root-seed", type=int, default=0,
                   help="fuzz: generator root seed (scenario K derives via fold_in(root, K))")
    p.add_argument("--out-dir", default="scenario_fuzz_failures",
                   help="fuzz: directory for shrunk replayable failing specs (default: "
                        "./scenario_fuzz_failures/, created only when a disagreement is "
                        "found)")
    p.add_argument("--sweep-every", type=int, default=0,
                   help="fuzz: run the pipelined-vs-sync sweep byte-identity arm on every "
                        "K-th scenario that carries a sweep plan (0 = off)")
    p.add_argument("--fast", action="store_true",
                   help="fuzz: the CI arm — 8 scenarios, sweep identity every 4th")
    p.add_argument("--telemetry", default=None, metavar="DIR", help=TELEMETRY_HELP)
    p.add_argument("--device", default="cuda",
                   help="compile, run, fuzz, replay: the torch device (default cuda; cpu "
                        "on request)")

    p = sub.add_parser(
        "likelihood",
        help="rank-reduced GP likelihood over a realization bank: hyperparameter "
             "grids, MAP+Fisher fits, and a request-batched serving demo with SLO stats")
    p.add_argument("--bank", required=True,
                   help="realization bank: a sweep checkpoint (consolidated npz or "
                        "in-progress chunk files from `realize --checkpoint`) or a plain "
                        ".npy residual cube (R, Np, Nt)")
    p.add_argument("--recipe", required=True,
                   help="JSON recipe (the NOISE MODEL to evaluate under — normally the "
                        "recipe the bank was synthesized with)")
    p.add_argument("--pardir", default=None)
    p.add_argument("--timdir", default=None)
    p.add_argument("--num-psrs", type=int, default=None)
    p.add_argument("--synthetic", default=None, metavar="NPSRxNTOA",
                   help="use a synthetic frozen batch (e.g. 10x512) instead of ingesting "
                        "--pardir/--timdir — the batch must match whatever produced the "
                        "bank")
    p.add_argument("--synthetic-seed", type=int, default=0)
    p.add_argument("--grid", action="append", default=[], metavar="FIELD=LO:HI:N",
                   help="hyperparameter grid axis (repeatable; axes combine as a "
                        "cartesian product), e.g. rn_log10_amplitude=-14.5:-13:16")
    p.add_argument("--map", action="append", default=[], dest="map_params",
                   metavar="FIELD=X0",
                   help="MAP+Fisher fit over these fields from the given start values "
                        "(repeatable)")
    p.add_argument("--real-index", type=int, default=0,
                   help="bank row the MAP fit runs on (default 0)")
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="serving demo: N requests sampled over the --grid axes, submitted "
                        "from --clients threads through the request-batched server; "
                        "prints the SLO stats block")
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=None,
                   help="bounded request queue: submissions past this are rejected "
                        "(ServerSaturated) and counted in the SLO block")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request queue deadline: a request unserved past this raises "
                        "DeadlineExpired instead of being evaluated late")
    p.add_argument("--telemetry", default=None, metavar="DIR", help=TELEMETRY_HELP)
    p.add_argument("--out", default=None,
                   help="write the result JSON here instead of stdout")
    p.add_argument("--device", default="cuda",
                   help="the torch device (default cuda; cpu on request)")

    p = sub.add_parser("report", help="print a captured --telemetry directory")
    p.add_argument("dir", help="telemetry directory (events.jsonl + metrics.json)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable aggregate instead of the tree")
    p.add_argument("--min-ms", type=float, default=0.0,
                   help="hide span paths with total wall below this")
    p = sub.add_parser(
        "watch", help="tail a live run's progress.json heartbeat (one line per tick, with the "
                      "stage-occupancy bottleneck verdict; exits when the run finishes or "
                      "leaves a postmortem)")
    p.add_argument("dir", help="the run's --telemetry directory")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="poll period in seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print the current heartbeat and exit (exit 3 when there is none)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="also serve the live run over HTTP while watching: /metrics, "
                        "/progress, /series, /slo, /healthz and /readyz (503 on a fast-burn "
                        "SLO breach); read-only; port 0 picks an ephemeral port (printed)")
    p.add_argument("--bind", default="127.0.0.1", metavar="HOST",
                   help="interface for --serve (default loopback)")
    p = sub.add_parser(
        "postmortem", help="render the black box a killed or crashed run left in its "
                           "telemetry directory")
    p.add_argument("dir", help="the run's --telemetry directory")
    p = sub.add_parser(
        "numerics", help="render a capture's precision ledger (numerics.json): per-site "
                         "non-finite counts, |max| watermarks, overflow headroom in bits, "
                         "shadow-oracle drift per family, and the bf16 readiness verdict")
    p.add_argument("action", choices=("report",), help="report: pretty-print DIR/numerics.json")
    p.add_argument("dir", help="the run's --telemetry directory")
    p = sub.add_parser(
        "timeline", help="merge a capture's host spans, stage tracks, chunk flow links, the "
                         "critical path and any registered torch.profiler device traces into "
                         "ONE clock-aligned chrome://tracing file")
    p.add_argument("dir", help="the run's --telemetry directory")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="output path (default DIR/timeline.json)")
    p = sub.add_parser(
        "critpath", help="critical-path attribution over a finished capture: per-chunk span "
                         "chains, busy/blocked/queue-wait decomposition, straggler spread and "
                         "a ranked bottleneck verdict with estimated savings, written as "
                         "DIR/critpath.json (served at /critpath, rendered in `report`, "
                         "annotated in `timeline`)")
    p.add_argument("dir", help="the run's --telemetry directory")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="output path (default DIR/critpath.json)")
    p.add_argument("--json", action="store_true",
                   help="print the full critpath.json document instead of the rendered verdict")
    for p in sub.choices.values():
        p.add_argument("--faults", default=None, metavar="SCHEDULE",
                       help="arm a fault-injection schedule, e.g. 'drain:raise@chunk=2;"
                            "checkpoint_write:torn@call=3' (env: PTA_FAULTS)")
        p.add_argument("--faults-seed", type=int, default=0,
                       help="seed of the schedule's p= triggers (env: PTA_FAULTS_SEED)")
    return ap


TELEMETRY_HELP = ("capture the run's spans and metrics into DIR (events.jsonl, metrics.json, "
                  "metrics.prom, chrome_trace.json, meta.json) with the flight recorder's "
                  "progress.json heartbeat (postmortem.json if killed); read it with "
                  "`report DIR`, follow it with `watch DIR`")


def _save_npz(path: str, **arrays) -> None:
    """Write an npz atomically (np.savez appends .npz to other suffixes,
    so the temporary name carries it)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _device(name: str, cmd: str = "scenario"):
    """The command's torch device; on a card, with IEEE float32 products
    (the fits, the GWB synthesis and the differential's families refuse
    TF32)."""
    import torch

    from .device import resolve_device

    try:
        device = resolve_device(name)
    except RuntimeError as exc:
        raise SystemExit(f"{cmd}: {exc} (on the command line: --device cpu)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _refuse_unported(args):
    """Exit before any work when a flag of a module not ported yet is set."""
    for attr, flag, item in UNPORTED_FLAGS:
        if getattr(args, attr, None):
            raise SystemExit(
                f"{args.cmd} {flag}: not ported yet (ROADMAP {item}); the JAX package's "
                f"`python -m pta_replicator_tpu {args.cmd}` has it"
            )


def _run_scenario(args):
    from .scenarios import SpecError, compile_spec, load_spec
    from .scenarios import fuzz as fz
    from .scenarios.compile import sweep_plan

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

    if args.action == "fuzz":
        if args.specs:
            raise SystemExit(
                "scenario fuzz generates its own random scenarios and takes no SPEC "
                "files (use `scenario replay` to re-run a saved spec through the "
                "differential)"
            )
        n = 8 if args.fast else args.n
        sweep_every = 4 if args.fast else args.sweep_every
        report = fz.fuzz(n, root_seed=args.root_seed, out_dir=args.out_dir,
                         sweep_every=sweep_every,
                         progress=lambda d, t: print(f"scenario {d}/{t}", file=sys.stderr),
                         device=_device(args.device))
        print(json.dumps(report, indent=1, sort_keys=True))
        if report["n_disagreements"]:
            print(f"scenario fuzz: {report['n_disagreements']} disagreement(s); shrunk "
                  f"replayable spec(s) under {args.out_dir}/", file=sys.stderr)
            raise SystemExit(1)
        si = report["sweep_identity"]
        if si["checked"] and not si["all_bit_identical"]:
            # the report on stdout is often discarded: the reason goes to
            # stderr too
            print("scenario fuzz: pipelined-vs-sync sweep byte-identity violated (see "
                  "the sweep_identity block of the report)", file=sys.stderr)
            raise SystemExit(1)
        return

    if args.action == "replay":
        specs = load_all()
        device = _device(args.device)
        rc = 0
        for path, spec in specs:
            res = fz.run_scenario(compile_spec(spec, validate=False, device=device))
            print(json.dumps({"spec": path, **res.to_dict()}, indent=1, sort_keys=True))
            if not res.agree:
                rc = 1
        if rc:
            raise SystemExit(rc)
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
)


def _build_recipe(spec: dict, psrs, locs=None):
    """JSON recipe spec -> Recipe (on the host; the caller moves it). The
    ORF's sky locations come from ``psrs`` (the par-file path) or an
    explicit ``locs`` (azimuth, colatitude) array (the synthetic path of
    ``likelihood``). Array fields become float64 tensors; the JAX-only
    knobs are dropped (``convert.JAX_ONLY_RECIPE_FIELDS``)."""
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
        if locs is None:
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
    from .obs import names, span
    from .simulate import load_from_directories, make_ideal

    # every guard runs before ingest: a refused invocation loads nothing
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
    with span(names.SPAN_INGEST, pardir=args.pardir):
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

    with span(names.SPAN_BUILD_RECIPE), open(args.recipe) as fh:
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

    with span(names.SPAN_COMPUTE, nreal=args.nreal, fit=bool(args.fit)):
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

    with span(names.SPAN_WRITE_OUTPUT, out=args.out):
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


def _axis_specs(pairs, kind):
    """Parse FIELD=LO:HI:N / FIELD=X0 CLI axis specs."""
    out = {}
    for spec in pairs:
        if "=" not in spec:
            raise SystemExit(f"--{kind} must look like FIELD=..., got {spec!r}")
        field, _, val = spec.partition("=")
        if kind == "grid":
            parts = val.split(":")
            if len(parts) != 3:
                raise SystemExit(f"--grid axis must be FIELD=LO:HI:N, got {spec!r}")
            lo, hi, n = float(parts[0]), float(parts[1]), int(parts[2])
            out[field] = np.linspace(lo, hi, n)
        else:
            out[field] = float(val)
    return out


def _run_likelihood(args):
    """``likelihood``: a bank priced over a grid, a MAP fit, a serving demo."""
    import torch

    from . import likelihood as lk
    from .obs import names, span

    if not args.synthetic and not (args.pardir and args.timdir):
        raise SystemExit("likelihood needs a dataset: --pardir/--timdir or --synthetic")
    if args.synthetic:
        try:
            npsr, ntoa = (int(x) for x in args.synthetic.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--synthetic must look like 10x512 (got {args.synthetic!r})")
    device = _device(args.device, args.cmd)
    # the JAX CLI freezes in JAX's default float (float64 under x64)
    dtype = torch.get_default_dtype()
    if args.synthetic:
        from .batch import synthetic_batch

        batch = synthetic_batch(npsr=npsr, ntoa=ntoa, seed=args.synthetic_seed, dtype=dtype,
                                device=device)
        phat = batch.phat.cpu().numpy()
        locs = np.stack([np.arctan2(phat[:, 1], phat[:, 0]), np.arccos(phat[:, 2])], axis=-1)
        psrs = None
    else:
        from .batch import freeze
        from .simulate import load_from_directories, make_ideal

        with span(names.SPAN_INGEST, pardir=args.pardir):
            psrs = load_from_directories(args.pardir, args.timdir, num_psrs=args.num_psrs)
            for psr in psrs:
                make_ideal(psr)
        batch = freeze(psrs, dtype=dtype, device=device)
        locs = None

    with span(names.SPAN_BUILD_RECIPE), open(args.recipe) as fh:
        recipe = _build_recipe(json.load(fh), psrs, locs=locs).to(device)

    if args.bank.endswith(".npy") and os.path.exists(args.bank):
        bank = lk.RealizationBank.from_array(np.load(args.bank))
    else:
        bank = lk.RealizationBank.from_checkpoint(args.bank)
    if tuple(bank.shape[1:]) != tuple(batch.toas_s.shape):
        raise SystemExit(
            f"bank rows are {tuple(bank.shape[1:])} but the batch is "
            f"{tuple(batch.toas_s.shape)} — the bank was synthesized from a different "
            "dataset"
        )

    result = {"bank": args.bank, "nreal": bank.nreal, "npsr": batch.npsr}
    grid_axes = _axis_specs(args.grid, "grid")
    with span(names.SPAN_COMPUTE):
        if grid_axes:
            grid, shape = lk.grid_cartesian(grid_axes)
            # the bank streams chunk by chunk through the projection: the
            # whole cube never sits on the card
            ll = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, device=device)
            mean = ll.cpu().numpy().mean(axis=1)  # (G, R) -> (G,)
            best = int(np.argmax(mean))
            result["grid"] = {
                "axes": sorted(grid_axes),
                "shape": list(shape),
                "loglikelihood_mean": [float(v) for v in mean],
                "best": {
                    "index": best,
                    **{k: float(grid[k][best]) for k in grid},
                    "loglikelihood_mean": float(mean[best]),
                },
            }
        if args.map_params:
            mr = lk.map_fit(bank.row(args.real_index), batch, recipe,
                            _axis_specs(args.map_params, "map"), device=device)
            result["map"] = mr.as_dict()
        if args.serve:
            if not grid_axes:
                raise SystemExit("--serve needs --grid axes to sample requests from")
            result["serve"] = _serve_demo(args, bank, batch, recipe, grid_axes, device)

    payload = json.dumps(result, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(payload + "\n")
    else:
        print(payload)


def _serve_demo(args, bank, batch, recipe, grid_axes, device):
    """N requests sampled over the grid axes, submitted from --clients
    threads through the request-batched server; returns the SLO stats
    block."""
    import threading

    from . import likelihood as lk

    server = lk.LikelihoodServer(
        bank, batch, recipe, axes=tuple(grid_axes), max_batch=args.max_batch,
        max_delay_s=args.max_delay_ms / 1e3, max_queue=args.max_queue,
        request_deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
        device=device,
    )
    rng = np.random.default_rng(0)
    points = {k: rng.choice(v, size=args.serve) for k, v in grid_axes.items()}
    failures = []

    def client(lo, hi):
        futs = []
        for i in range(lo, hi):
            try:
                futs.append(server.submit(**{k: points[k][i] for k in points}))
            except lk.ServerSaturated:
                continue  # shed by --max-queue; counted in stats()["rejected"]
        for f in futs:
            try:
                f.result(timeout=120)
            except lk.DeadlineExpired:
                pass  # shed by --deadline-ms; counted in stats()
            except Exception as exc:  # noqa: BLE001 — reported in the block
                failures.append(repr(exc))

    # ceil partition: exactly min(clients, serve) threads
    per = -(-args.serve // max(1, args.clients))
    threads = []
    with server:
        # one warm request, then the SLO window re-zeroed: the block
        # describes steady-state serving, not the first call's set-up
        server.evaluate(**{k: float(np.atleast_1d(v)[0]) for k, v in grid_axes.items()})
        server.reset_stats()
        for lo in range(0, args.serve, per):
            t = threading.Thread(target=client, args=(lo, min(lo + per, args.serve)))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        stats = server.stats()
    if failures:
        stats["failures"] = failures[:8]
    return stats


def _run_command(args):
    if args.cmd == "scenario":
        return _run_scenario(args)
    if args.cmd == "likelihood":
        return _run_likelihood(args)
    return _run_dataset(args)


def _arm_faults(args) -> None:
    """Arm ``--faults`` (or ``PTA_FAULTS``); a malformed schedule exits
    with the parser's message."""
    from .faults import inject

    try:
        if args.faults:
            inject.arm(args.faults, seed=args.faults_seed)
        else:
            inject.arm_from_env()
    except ValueError as exc:
        raise SystemExit(f"{args.cmd} --faults: {exc}")


def main(argv=None):
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    from .faults import inject

    saved = inject._STATE
    try:
        _arm_faults(args)
        return _main(args, argv)
    finally:
        # an in-process caller gets its own fault state back
        inject._STATE = saved


def _watch(args):
    """``watch DIR``: the JAX CLI's exit codes (0 finished, 2 postmortem,
    3 ``--once`` without a heartbeat), with the HTTP server of ``--serve``
    alive for the watch."""
    from .obs.report import watch_progress

    server = None
    if args.serve is not None:
        from .obs.serve import serve_directory, serve_url

        server = serve_directory(args.dir, args.serve, host=args.bind, background=True)
        print(f"serving {serve_url(server)} (/metrics /progress /series /slo /readyz)",
              file=sys.stderr, flush=True)
    try:
        rc = watch_progress(args.dir, interval=args.interval, once=args.once)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    if rc:
        raise SystemExit(rc)


def _timeline(args):
    """``timeline DIR``: write the merged trace and print its summary; the
    problems it met go to stderr."""
    from .obs.timeline import build_timeline, write_timeline

    doc = build_timeline(args.dir)
    out = write_timeline(args.dir, out=args.out, doc=doc)
    summary = dict(doc.get("otherData") or {})
    summary["out"] = out
    summary["events"] = len(doc.get("traceEvents") or [])
    print(json.dumps(summary, indent=1, sort_keys=True))
    for problem in summary.get("problems") or []:
        print(f"warning: {problem}", file=sys.stderr)


def _critpath(args):
    """``critpath DIR``: attribute, write ``critpath.json`` and print the
    rendering (``--json``: the document). Exit 2 on a capture with no stage
    spans: unusable input, where 1 would read as a failed gate."""
    from .obs import critpath

    doc = critpath.analyze_capture(args.dir)
    if doc is None:
        print(f"critpath: {args.dir}: no stage spans to attribute (missing events.jsonl, "
              "or the run never touched a staged executor)", file=sys.stderr)
        raise SystemExit(2)
    out = critpath.write_critpath(args.dir, out=args.out, doc=doc)
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        print(critpath.render_critpath(doc))
    print(f"critpath: wrote {out}", file=sys.stderr)


def _main(args, argv):
    if args.cmd == "report":
        from .obs.report import print_report

        print_report(args.dir, min_ms=args.min_ms, as_json=args.json)
        return
    if args.cmd == "numerics":
        # no torch needed: the ledger carries its drift tolerances
        from .obs import numerics

        print(numerics.render_report(args.dir))
        return
    if args.cmd == "watch":
        return _watch(args)
    if args.cmd == "postmortem":
        from .obs.report import print_postmortem

        print_postmortem(args.dir)
        return
    if args.cmd == "timeline":
        return _timeline(args)
    if args.cmd == "critpath":
        return _critpath(args)
    # every refusal comes before any work, a capture's included
    _refuse_unported(args)
    device_trace = getattr(args, "device_trace", False)
    if device_trace and not args.telemetry:
        raise SystemExit("--device-trace requires --telemetry DIR (the trace is an "
                         "artifact of the capture)")
    if not args.telemetry:
        return _run_command(args)

    # capture mode: spans and metrics stream into the telemetry directory,
    # whose files are written even when the run raises
    import contextlib

    from . import obs

    obs.start_capture(args.telemetry)
    try:
        profiled = (obs.devprof.device_trace(device=_device(args.device, args.cmd))
                    if device_trace else contextlib.nullcontext())
        with obs.span(args.cmd), profiled:
            return _run_command(args)
    finally:
        obs.finish_capture(context={
            "argv": list(argv) if argv is not None else sys.argv[1:],
        })


if __name__ == "__main__":
    main()
