"""The block-tridiagonal sweeps' launch shapes: a reading on the card.

Run from the repository root on a machine with a CUDA card:

    python -m pta_replicator_tpu_torch.kernels.tridiag_study [--parent DIR]

At config B's shape (68 pulsars x 485 block columns of 16; random
diagonally dominant blocks, seed 0) it times, in float64 and float32:

* the factor sweep on its two routes (the warp per pulsar and the
  per-thread route, which ``csrc/block_tridiag.cu`` keeps for b > 32 and
  for the fused factor + forward sweep);
* the substitution-only forward sweep and the backward sweep at Q = 1, 7,
  123 and 200, on the staged route with both of its lane counts (a lane
  per row, and one lane per column) and one, two or four warps per
  block, beside the per-thread route and the launch
  ``ops/gp.py::tridiag_plan`` picks.

Each launch is checked against the plain version on the same inputs (the
largest |error| over the largest |entry|). Then, in float64, what holds
the staged kernels back: ``csrc/block_tridiag.cu`` built with one part
skipped (the staging copies, the M product or M_k solve, the triangular
solve's updates, the Schur complement, the Cholesky or only its reciprocal square
roots or its rank-1 updates, the stores of L_k and M_k),
each timed on the factor sweep and on both substitution sweeps at Q = 1
and 123 with the plan's launch. The partial builds compute nothing
useful; only their times mean something.

With ``--parent DIR``, a checkout of an earlier version of the repository
whose ``csrc/block_tridiag.cu`` launches take no plan, it first builds
that source and times its sweeps in float64 (the factor at Q = 0, both
substitution sweeps at Q = 1, 123 and 200) beside this version's public
wrappers, on the same inputs in the same process, in the order parent,
this, this, parent.

One JSON line per (sweep, dtype, Q), per comparison and per variant on
stdout, then one with the card and the ptxas report.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import build
from .woodbury_study import _ms
from ..ops import gp

SHAPE = (68, 485, 16)
QS = (1, 7, 123, 200)
#: the right-hand-side counts of the comparison with the parent
PARENT_QS = (1, 123, 200)
BLOCK_WARPS = (1, 2, 4)
SOLVES = {"solve": ("tridiag_solve_fwd_launch", gp.tridiag_forward_solve_plain),
          "backward": ("tridiag_bwd_launch", gp.tridiag_backward_plain)}


#: text replaced in the kernel's source for each partial build
VARIANTS = {
    "kernel": (),
    "no_staging": (("      stage_block(base, st, d + k * bb, b, copies);\n"
                    "      if (k) stage_block(base + tile, st, e + (k - 1) * bb, b, copies);\n", ""),
                   ("      stage_block(base, st, ld + k * bb, b, copies);\n"
                    "      if (s) stage_block(base + tile, st, m + (FWD ? k : k + 1) * bb, b, copies);\n",
                    "")),
    "no_m_product": (("        if (next) vn[i] -= mrj[i] * yj;\n", ""),
                     ("        if (j < b) {\n          mrow[j] *= invp[j];",
                      "        if (j < 0) {\n          mrow[j] *= invp[j];")),
    "no_triangular": (("        if (FWD ? r > j : r < j) v[i] -= lrj[i] * yj;\n", ""),),
    "no_schur": (("      if (k && c < b) {", "      if (k && c < 0) {"),),
    "no_cholesky": (("      if (j < b) {\n        const T piv", "      if (j < 0) {\n        const T piv"),),
    # the factor's Cholesky without its reciprocal square roots, or
    # without the rank-1 updates off the diagonal
    "no_rsqrt": (("        const T inv = rsqrt_t(piv);", "        const T inv = piv;"),),
    "no_rank1_update": (("        if (j + 1 < b) srow[j + 1] -= lij * __shfl_sync(full, lij, j + 1, BP);\n", ""),
                        ("            if (c0 > j + 1) srow[c0] -= lij * l2.x;\n"
                         "            srow[c0 + 1] -= lij * l2.y;\n", "")),
    "no_stores": (("    store_block(ld + k * bb, b, lc, st, copies);\n"
                   "    store_block(m + k * bb, b, ms, st, copies);\n", ""),),
}


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _operands(npsr, nb, b, device):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((npsr, nb, b, b)) / np.sqrt(b)
    D = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(b)
    E = 0.3 * rng.standard_normal((npsr, nb - 1, b, b)) / np.sqrt(b)
    return [torch.as_tensor(a, device=device) for a in (D, E)]


def _launch(name, tensors, ints):
    gp._tridiag_launch(name, tensors[0].device, tensors, ints, "study")


def _factor_plans(npsr, nb, b, dtype):
    """The factor sweep's launch on each route: the warp per pulsar (no
    right-hand sides) and the per-thread route (as the fused sweep takes)."""
    return {"staged": gp.tridiag_plan(npsr, nb, b, 0, dtype, factor=True),
            "per_thread": gp.tridiag_plan(npsr, nb, b, 1, dtype, factor=True)}


def _solve_plans(npsr, nb, b, q, dtype, sms):
    """Every launch a substitution sweep is timed with: the per-thread
    route, the plan's, and both staged lane counts at one, two and four
    warps a block, by "lanes x columns" (lanes 0: the per-thread route)."""
    plan = gp.tridiag_plan(npsr, nb, b, q, dtype, sms=sms)
    bp = 1 << (b - 1).bit_length()
    plans = {"0x128": gp.TridiagPlan("per_thread", 0, gp.TRIDIAG_COLUMN_THREADS,
                                     gp.TRIDIAG_COLUMN_THREADS, None, 0),
             f"{plan.lanes}x{plan.columns}": plan}
    for lanes in (bp, bp // min(bp, gp.TRIDIAG_SOLVE_MAX_ROWS)):
        for w in BLOCK_WARPS:
            cols = min(q, w * 32 // lanes)
            plans.setdefault(f"{lanes}x{cols}", gp.tridiag_staged_solve_plan(npsr, b, q, dtype, lanes, cols))
    return plan, plans


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier version to time beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tridiag_study: no CUDA device is available")
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t0 = time.perf_counter()
    build.build("block_tridiag")
    build_s = time.perf_counter() - t0
    npsr, nb, b = SHAPE
    D64, E64 = _operands(npsr, nb, b, device)
    if args.parent is not None:
        _parent(args.parent, D64, E64)
    for dtype in (torch.float64, torch.float32):
        code = gp._DTYPE_CODES[dtype]
        D, E = D64.to(dtype), E64.to(dtype)
        pLd, pM, _ = gp.tridiag_forward_plain(D, E)
        row = {"sweep": "factor", "dtype": str(dtype), "shape": list(SHAPE)}
        for route, plan in _factor_plans(npsr, nb, b, dtype).items():
            Ld, M = torch.empty_like(D), torch.empty_like(D)
            run = lambda: _launch("tridiag_factor_fwd_launch", (D, E, None, Ld, M, None),
                                  (npsr, nb, b, 0, int(route == "staged"), plan.threads,
                                   plan.shared_bytes, code))
            row[route + "_ms"] = _ms(run, 10)
            row[route + "_rel_err"] = max(_rel(Ld, pLd), _rel(M, pM))
        print(json.dumps(row), flush=True)
        Ld, M = pLd, pM
        for q in QS:
            X = torch.as_tensor(np.random.default_rng(q).standard_normal((npsr, nb, b, q)),
                                dtype=dtype, device=device)
            for sweep, (fn, plain) in SOLVES.items():
                want = plain(Ld, M, X)
                out = torch.empty_like(X)
                plan, plans = _solve_plans(npsr, nb, b, q, dtype, sms)
                row = {"sweep": sweep, "dtype": str(dtype), "shape": [npsr, nb, b, q],
                       "plan": {"lanes": plan.lanes, "columns": plan.columns}}
                times = {}
                worst = 0.0
                for key, p in plans.items():
                    run = lambda: _launch(fn, (Ld, M, X, out),
                                          (npsr, nb, b, q, p.lanes, p.columns, p.threads,
                                           p.shared_bytes, code))
                    times[key] = _ms(run, 10)
                    worst = max(worst, _rel(out, want))
                row.update(per_thread_ms=times["0x128"],
                           plan_ms=times[f"{plan.lanes}x{plan.columns}"],
                           best=min(times, key=times.get), rel_err_max=worst, lanes_x_columns_ms=times)
                print(json.dumps(row), flush=True)
    _variants(device, D64, E64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "build_s": build_s,
                      "ptxas": [l.strip() for l in build.ptxas_reports.get("block_tridiag", "").splitlines()
                                if "entry function" in l or "Used" in l or "spill" in l]}), flush=True)


def _parent(root, D, E):
    """The parent's sweeps (its source built as it stands, launches with no
    plan) against this version's public wrappers, float64, at PARENT_QS:
    parent, this, this, parent, each timed over 10 launches."""
    out_dir = build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path, _ = build.build_variant("block_tridiag", "parent", (), out_dir,
                                      source_path=root / "pta_replicator_tpu_torch/csrc/block_tridiag.cu")
    lib = ctypes.CDLL(str(lib_path))
    lib.tridiag_factor_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (lib.tridiag_solve_fwd_launch, lib.tridiag_bwd_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.block_tridiag_error_string.argtypes = [ctypes.c_int]
    lib.block_tridiag_error_string.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream().cuda_stream
    npsr, nb, b, _ = D.shape
    pLd, pM, _ = gp.tridiag_forward_plain(D, E)
    oLd, oM = torch.empty_like(D), torch.empty_like(D)
    cases = [("factor", 0, lambda: _ok(lib, lib.tridiag_factor_fwd_launch(
        D.data_ptr(), E.data_ptr(), None, oLd.data_ptr(), oM.data_ptr(), None,
        npsr, nb, b, 0, 1, stream)), lambda: gp.tridiag_forward(D, E),
        lambda: max(_rel(oLd, pLd), _rel(oM, pM)))]
    for q in PARENT_QS:
        X = torch.as_tensor(np.random.default_rng(q).standard_normal((npsr, nb, b, q)), device=D.device)
        out = torch.empty_like(X)
        for sweep, (fn, plain) in SOLVES.items():
            wrapper = gp.tridiag_forward_solve if sweep == "solve" else gp.tridiag_backward
            want = plain(pLd, pM, X)
            cases.append((sweep, q, lambda fn=fn, X=X, out=out: _ok(lib, getattr(lib, fn)(
                pLd.data_ptr(), pM.data_ptr(), X.data_ptr(), out.data_ptr(), npsr, nb, b, q, 1, stream)),
                lambda wrapper=wrapper, X=X: wrapper(pLd, pM, X),
                lambda out=out, want=want: _rel(out, want)))
    for sweep, q, parent, change, err in cases:
        times = [_ms(f, 10) for f in (parent, change, change, parent)]
        print(json.dumps({"compare": sweep, "dtype": "torch.float64", "shape": [npsr, nb, b, q],
                          "parent_ms": [times[0], times[3]], "change_ms": times[1:3],
                          "parent_rel_err": err()}), flush=True)


def _ok(lib, rc):
    if rc:
        raise RuntimeError(f"block_tridiag launch failed: {lib.block_tridiag_error_string(rc).decode()}")


def _variants(device, D, E):
    """Each partial build of VARIANTS, timed on the factor sweep and on
    both substitution sweeps at Q = 1 and 123 with the plan's launch."""
    out_dir = build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(
            lambda kv: (kv[0], *build.build_variant("block_tridiag", *kv, out_dir)),
            VARIANTS.items()))
    npsr, nb, b, _ = D.shape
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    Ld, M, _ = gp.tridiag_forward_plain(D, E)
    rhs = {q: torch.as_tensor(np.random.default_rng(q).standard_normal((npsr, nb, b, q)),
                              device=device) for q in (1, 123)}
    for name, lib_path, ptxas in built:
        lib = ctypes.CDLL(str(lib_path))
        gp._bind_tridiag(lib)
        stream = torch.cuda.current_stream().cuda_stream
        row = {"variant": name, "dtype": "torch.float64"}
        oLd, oM = torch.empty_like(D), torch.empty_like(D)
        fplan = _factor_plans(npsr, nb, b, D.dtype)["staged"]
        row["factor_ms"] = _ms(lambda: _ok(lib, lib.tridiag_factor_fwd_launch(
            D.data_ptr(), E.data_ptr(), None, oLd.data_ptr(), oM.data_ptr(), None,
            npsr, nb, b, 0, 1, fplan.threads, fplan.shared_bytes, 1, stream)), 10)
        for q, X in rhs.items():
            plan = gp.tridiag_plan(npsr, nb, b, q, D.dtype, sms=sms)
            out = torch.empty_like(X)
            for sweep, (fn, _) in SOLVES.items():
                row[f"{sweep}_q{q}_ms"] = _ms(lambda: _ok(lib, getattr(lib, fn)(
                    Ld.data_ptr(), M.data_ptr(), X.data_ptr(), out.data_ptr(),
                    npsr, nb, b, q, plan.lanes, plan.columns, plan.threads, plan.shared_bytes,
                    1, stream)), 10)
        row["ptxas"] = ptxas if name == "kernel" else None
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
