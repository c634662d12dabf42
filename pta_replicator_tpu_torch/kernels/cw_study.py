"""What holds the CW-catalog kernel back: a reading on the card.

Run from the repository root on a machine with a CUDA card:

    python -m pta_replicator_tpu_torch.kernels.cw_study [--parent DIR]

On the flagship workload's catalog (68 pulsars x 7,758 TOAs x 100
sources) and on a population catalog of 10,000 sources at the same width
(``flagship_workload(ncw=10_000)``'s own), in the chirped pulsar-term mode,
in float32 and float64, it times:

* the response kernel (``csrc/cw_catalog.cu``, the launch alone on its
  kernel planes), the fold kernel, and the wrapper the path calls (the
  fold and the response), each checked against the plain version
  (relative RMS);
* builds of the response kernel with one thing changed (:data:`VARIANTS`):
  two or four TOAs a thread (``k2``, ``k4``); no sin/cos
  (``no_sincos``), no expm1 series (``no_expm1``), no log1p
  (``no_log1p``), no exp (``no_exp``); the library's log1p and exp at
  every argument instead of their short series (``libm``), and the
  reference's seven divisions per expm1 series put back (``divisions``);
  the library's routines past the series' ranges called in float32 and
  inlined in float64, the other way round from the kernel
  (``far_flipped``); and two other register budgets (``regs_own``,
  ``regs_80``). The partial builds (:data:`PARTIAL`) compute nothing
  useful; only their times mean something; the others are also checked
  against the plain version;
* beside each, the SASS of the kernel's loop over sources (``cuobjdump
  -sass`` of the built library): its instructions per (pulsar, source,
  TOA) element by class, every path once and each called routine at its
  call site (:func:`loop_counts`), and the issue time they give at the
  card's SM clock (:func:`issue_ms`).

With ``--parent DIR``, a checkout of an earlier version of the repository
whose ``csrc/cw_catalog.cu`` takes the reference planes as they are, it
builds that source and times its kernel beside this version's wrapper on
the same planes, in the order parent, this, this, parent; its SASS is
counted on a second build with its source loop kept rolled (``#pragma
unroll 1``), so that the loop's body is one element. Last, in the same
order, each checkout's ``deterministic_delays`` on the population catalog
(float32) in a fresh interpreter: the median and the least milliseconds
of nine whole calls, host plane build included.

One JSON line per (catalog, dtype) on stdout, then one with the card, its
clocks, the SASS counts and the ptxas report.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import build
from .woodbury_study import _ms
from ..ops import cw

#: the catalogs: the flagship's and a population catalog, both at the
#: flagship's width
CATALOGS = {"flagship": dict(npsr=68, ntoa=7758, ncw=100),
            "population": dict(npsr=68, ntoa=7758, ncw=10_000)}
#: kernel launches averaged per time, by catalog
REPS = {"flagship": 20, "population": 3}

#: text replaced in the kernel's source for each partial build
VARIANTS = {
    "kernel": (),
    "k2": (("constexpr int kToasPerThread = 1;", "constexpr int kToasPerThread = 2;"),),
    "k4": (("constexpr int kToasPerThread = 1;", "constexpr int kToasPerThread = 4;"),),
    "no_sincos": (("    m_sincospi(h, &s, &c);\n    return exp_small",
                   "    s = h; c = T(1) - h;\n    return exp_small"),),
    "no_expm1": (("  if (!(z > T(-0.5))) return exp_far(z) - T(1);\n", "  return z;\n"),),
    "no_log1p": (("    const T l = log1p_small(-w[1] * u);", "    const T l = -w[1] * u;"),),
    "no_exp": (("    return exp_small(T(0.125) * l) * (", "    return (T(0.125) * l) * ("),),
    # the library's log1p and exp at every argument, as the first port
    "libm": (("    const T l = log1p_small(-w[1] * u);", "    const T l = log1p_far(-w[1] * u);"),
             ("    return exp_small(T(0.125) * l) * (", "    return exp_far(T(0.125) * l) * (")),
    # the library's routines past the series' ranges called in float32 and
    # inlined in float64
    "far_flipped": tuple((f"__device__ __{a}__ {t} {f}_far", f"__device__ __{b}__ {t} {f}_far")
                         for f in ("log1p", "exp")
                         for a, b, t in (("forceinline", "noinline", "float"),
                                         ("noinline", "forceinline", "double"))),
    # the register budget: ptxas's own (no blocks an SM asked for), or at
    # most 80 registers a thread (6 blocks)
    "regs_own": (("__global__ void __launch_bounds__(kThreads, 8)\ncw_catalog_kernel",
                  "__global__ void __launch_bounds__(kThreads)\ncw_catalog_kernel"),),
    "regs_80": (("__global__ void __launch_bounds__(kThreads, 8)\ncw_catalog_kernel",
                 "__global__ void __launch_bounds__(kThreads, 6)\ncw_catalog_kernel"),),
    # the reference's Horner form, seven IEEE divisions per series
    "divisions": (("  T p = T(1.0 / 40320.0);\n"
                   "  p = fma(p, z, T(1.0 / 5040.0));\n"
                   "  p = fma(p, z, T(1.0 / 720.0));\n"
                   "  p = fma(p, z, T(1.0 / 120.0));\n"
                   "  p = fma(p, z, T(1.0 / 24.0));\n"
                   "  p = fma(p, z, T(1.0 / 6.0));\n"
                   "  p = fma(p, z, T(0.5));\n"
                   "  p = fma(p, z, T(1));\n",
                   "  T p = T(1) + z / T(8);\n"
                   "  p = T(1) + z / T(7) * p;\n"
                   "  p = T(1) + z / T(6) * p;\n"
                   "  p = T(1) + z / T(5) * p;\n"
                   "  p = T(1) + z / T(4) * p;\n"
                   "  p = T(1) + z / T(3) * p;\n"
                   "  p = T(1) + z / T(2) * p;\n"),),
}

#: TOAs a thread of each build, where not one
VARIANT_TOAS = {"k2": 2, "k4": 4}
#: builds that leave out part of the function: timed, not checked
PARTIAL = ("no_sincos", "no_expm1", "no_log1p", "no_exp")

#: the first port's source loop kept rolled, for its SASS count
PARENT_ROLLED = (("    for (int j = 0; j < n; ++j) {",
                  "#pragma unroll 1\n    for (int j = 0; j < n; ++j) {"),)

#: SASS opcode classes; anything else (integer, moves, predicates) is "other"
_CONTROL = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
            "BREAK", "WARPSYNC", "BMOV", "YIELD"}
_CONVERSION = {"F2F", "F2I", "I2F", "F2FP", "I2FP", "F2IP", "FRND"}
_FP32 = {"FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FSET", "FMNMX", "FCHK", "FSWZADD",
         "HADD2", "HMUL2", "HFMA2"}
#: warp instructions one SM can take a clock: any instruction (four
#: schedulers), FP64 (64 lanes) and MUFU (16 lanes), on the H100
_ISSUE_RATE = {"issue": 4.0, "fp64": 2.0, "mufu": 0.5}
#: a kernel instance's template arguments
_KERNEL = re.compile(r"cw_catalog_kernelI([fd])Lb([01])ELb([01])E")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
#: a branch's target: an address, or a label in older listings
_TARGET = re.compile(r"\bBRA\S*\s+(?:!?U?P\w+,\s*)?`?\(?(0x[0-9a-f]+|\.L_x_\d+)")
#: a call's target: an address, or a label in older listings
_CALL = re.compile(r"\bCALL\.REL\S*\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)")


def _opcode_class(opcode: str) -> str:
    """The class of a SASS opcode with its modifiers (``DFMA``, ``MUFU.EX2``)."""
    op = opcode.split(".")[0]
    if op == "MUFU":
        return "mufu"
    if op in ("LDS", "LDSM"):
        return "lds"
    if op in _CONTROL:
        return "branch"
    if op in _CONVERSION:
        return "conversion"
    if op in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"):
        return "fp64"
    if op in _FP32 and opcode != "HFMA2.MMA":  # HFMA2.MMA of zeros is a move
        return "fp32"
    return "other"


def cuobjdump() -> str:
    """Path of cuobjdump, beside the nvcc that builds the kernels."""
    return str(Path(build.nvcc()).parent / "cuobjdump")


def sass_loop_counts(library: Path) -> dict:
    """:func:`loop_counts` of ``cuobjdump -sass`` of a build of
    ``csrc/cw_catalog.cu``."""
    return loop_counts(subprocess.run([cuobjdump(), "-sass", str(library)],
                                      capture_output=True, text=True, check=True).stdout)


def loop_counts(sass: str) -> dict:
    """Per kernel instance in the SASS listing ``sass``, keyed by
    ``(dtype, psr_term, evolve)``: the instructions of its loop over
    sources (kept rolled, so its body is one source for each TOA a thread
    carries) by class, each routine the loop calls counted at its call
    site (``called`` says how many of them lie in called routines). A
    static count: every path once, so for a catalog that takes no path
    twice an upper bound of what an element issues; code that no element
    takes (a Payne-Hanek reduction, a division's slow path, a library
    routine past the kernel's short series) is counted wherever it lies,
    inline or called."""
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = _KERNEL.search(chunk.split("\n", 1)[0])
        if name is None:
            continue
        ops, labels, branches, calls, pending = [], {}, [], [], []
        for line in chunk.splitlines()[1:]:
            stripped = line.strip()
            if stripped.startswith(".L_") and stripped.endswith(":"):
                pending.append(stripped[:-1])
                continue
            m = _INSTRUCTION.search(line)
            if m is None:
                continue
            addr, op = int(m.group(1), 16), m.group(2)
            for label in pending:
                labels[label] = addr
            pending = []
            ops.append((addr, op))
            target = _TARGET.search(line)
            if target:
                branches.append((addr, target.group(1)))
            target = _CALL.search(line)
            if target:
                calls.append((addr, target.group(1)))
        resolve = lambda t: int(t, 16) if t.startswith("0x") else labels.get(t)
        loops = {(resolve(t), a) for a, t in branches
                 if resolve(t) is not None and resolve(t) <= a}
        # the loop over a chunk's sources reads shared memory and holds no
        # barrier (the loop over chunks does; the staging loop only
        # stores), and is the largest such loop (a libm routine's own
        # loops lie inside it)
        inside = lambda r: [op for a, op in ops if r[0] <= a <= r[1]]
        lo, hi = max((r for r in loops
                      if any(op.startswith("LDS") for op in inside(r))
                      and not any(op.startswith("BAR") for op in inside(r))),
                     key=lambda r: len(inside(r)))
        # a called routine runs from its entry to its last return before
        # the next routine's entry
        entries = sorted({resolve(t) for _, t in calls})
        rets = [a for a, op in ops if op.startswith("RET")]

        def routine(entry, seen=()):
            """Opcodes of the routine at ``entry`` and of those it calls."""
            after = [e for e in entries if e > entry]
            end = max((a for a in rets if entry <= a < (after[0] if after else float("inf"))),
                      default=entry)
            body = [op for a, op in ops if entry <= a <= end]
            for a, t in calls:
                if entry <= a <= end and resolve(t) not in seen:
                    body += routine(resolve(t), seen + (entry,))
            return body

        called = [op for a, t in calls if lo <= a <= hi for op in routine(resolve(t))]
        body = Counter(_opcode_class(op) for a, op in ops if lo <= a <= hi)
        body.update(_opcode_class(op) for op in called)
        body["total"] = sum(body.values())
        body["called"] = len(called)
        dtype, psr_term, evolve = name.groups()
        counts[("float32" if dtype == "f" else "float64", psr_term == "1",
                evolve == "1")] = dict(body)
    return counts


def per_element(counts: dict, toas_per_thread: int = 1) -> dict:
    """One loop's counts divided by the elements it computes."""
    return {k: v / toas_per_thread for k, v in counts.items()}


def issue_ms(per_elem: dict, elements: int, sms: int, clock_mhz: float):
    """Issue-limited milliseconds of ``elements`` elements at
    ``per_elem`` warp-lane instructions each: the warp instructions over
    the slowest of the SM's issue slots (4 a clock), FP64 pipe (2) and
    MUFU pipe (0.5), at ``clock_mhz`` on ``sms`` SMs; and which one."""
    warps = elements / 32.0
    cycles = {pipe: per_elem.get("total" if pipe == "issue" else pipe, 0.0) * warps / rate
              for pipe, rate in _ISSUE_RATE.items()}
    pipe = max(cycles, key=cycles.get)
    return cycles[pipe] / sms / (clock_mhz * 1e3), pipe


def sm_clock_mhz() -> dict:
    """The card's SM clocks as nvidia-smi reads them: the maximum and the
    current (MHz)."""
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip()
    peak, now = (float(x) for x in out.split(","))
    return {"max": peak, "current": now}


def _rel_rms(got, want):
    got, want = got.double(), want.double()
    return float(torch.sqrt(torch.mean((got - want) ** 2)) / torch.sqrt(torch.mean(want**2)))


def _catalog(shape, dtype):
    """Fold-relative times and the reference planes of the workload's own
    catalog, chirped, in ``dtype``."""
    from .. import flagship_workload
    from ..models import batched as B

    batch, recipe = flagship_workload(**shape, dtype=dtype)
    u = batch.toas_s - torch.tensor(batch.start_s, dtype=dtype, device=batch.device)
    src, psr, _ = B.cw_catalog_planes_for(batch, *recipe.cgw_params.cpu().numpy(),
                                          pdist=1.0, evolve=True)
    return u.contiguous(), src, psr


def _bind_parent(lib):
    lib.cw_catalog_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.cw_catalog_launch.restype = ctypes.c_int
    return lib


#: deterministic_delays on the population catalog, float32, in a checkout
#: given as the working directory: the median and the least of nine
#: synchronised calls after a first (which builds the checkout's kernel),
#: in milliseconds
_STATIC_MS = """
import json, statistics, time, torch
from pta_replicator_tpu_torch import deterministic_delays, flagship_workload
batch, recipe = flagship_workload(npsr={npsr}, ntoa={ntoa}, ncw={ncw})
deterministic_delays(batch, recipe)
times = []
for _ in range(9):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deterministic_delays(batch, recipe)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps([statistics.median(times), min(times)]))
"""


def _static_ms(root: Path) -> list:
    """:data:`_STATIC_MS` run by a fresh interpreter in the checkout ``root``
    (its own package, so an earlier version can be timed beside this one)."""
    out = subprocess.run([sys.executable, "-c", _STATIC_MS.format(**CATALOGS["population"])],
                         cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def _ok(rc):
    if rc:
        raise RuntimeError(f"the parent's cw_catalog launch failed: cudaError_t {rc}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier version to time beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cw_study: no CUDA device is available")
    out_dir = build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = VARIANTS
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs) + 2) as pool:
        futures = {name: pool.submit(build.build_variant, "cw_catalog", name, edits, out_dir)
                   for name, edits in jobs.items()}
        if args.parent is not None:
            source = args.parent / "pta_replicator_tpu_torch/csrc/cw_catalog.cu"
            for name, edits in (("parent", ()), ("parent_rolled", PARENT_ROLLED)):
                futures[name] = pool.submit(build.build_variant, "cw_catalog", name, edits,
                                            out_dir, source_path=source)
        built = {name: f.result() for name, f in futures.items()}
    build_s = time.perf_counter() - t0
    libs = {name: ctypes.CDLL(str(path)) for name, (path, _) in built.items()
            if name != "parent_rolled"}
    for name, lib in libs.items():
        (_bind_parent if name == "parent" else cw._bind)(lib)
    sass = {name: sass_loop_counts(path) for name, (path, _) in built.items() if name != "parent"}
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for catalog, shape in CATALOGS.items():
        reps = REPS[catalog]
        for dtype in (torch.float32, torch.float64):
            u, src, psr = _catalog(shape, dtype)
            key = str(dtype).replace("torch.", "")
            npsr, ntoa = u.shape
            elements = npsr * ntoa * src.shape[1]
            want = cw.cw_catalog_response_plain(u, src, psr)
            planes = cw._cw_fold(libs["kernel"], src, psr, True, True)
            row = {"catalog": catalog, "dtype": str(dtype), "shape": [npsr, ntoa, src.shape[1]],
                   "sm_clock_mhz": clock}
            change = lambda: cw.cw_catalog_response_cuda(u, src, psr)
            row["fold_ms"] = _ms(lambda: cw._cw_fold(libs["kernel"], src, psr, True, True), reps)
            row["fold_equals_plain"] = bool(torch.equal(planes, cw.cw_kernel_planes(src, psr)))
            if "parent" in libs:
                out = torch.empty_like(u)
                code = cw._DTYPE_CODES[dtype]
                parent = lambda: _ok(libs["parent"].cw_catalog_launch(
                    u.data_ptr(), src.data_ptr(), psr.data_ptr(), out.data_ptr(),
                    npsr, ntoa, src.shape[1], code, 1, 1, stream))
                times = [_ms(f, reps) for f in (parent, change, change, parent)]
                per = per_element(sass["parent_rolled"][key, True, True])
                row.update(parent_ms=[times[0], times[3]], change_ms=times[1:3],
                           parent_rel_rms=_rel_rms(out, want),
                           parent_instructions_per_element=per["total"], parent_by_class=per,
                           parent_issue_ms=issue_ms(per, elements, sms, clock["max"])[0])
            row["wrapper_ms"] = _ms(change, reps)
            row["wrapper_rel_rms"] = _rel_rms(change(), want)
            for name, lib in libs.items():
                if name.startswith("parent"):
                    continue
                run = lambda: cw._cw_launch(lib, u, planes, True, True)
                row[name + "_ms"] = _ms(run, reps)
                per = per_element(sass[name][key, True, True], VARIANT_TOAS.get(name, 1))
                row[name + "_instructions_per_element"] = per["total"]
                row[name + "_issue_ms"] = issue_ms(per, elements, sms, clock["max"])[0]
                if name not in PARTIAL:
                    row[name + "_rel_rms"] = _rel_rms(run(), want)
                if name == "kernel":
                    row[name + "_by_class"] = per
            row["sm_clock_mhz_after"] = sm_clock_mhz()["current"]
            print(json.dumps(row), flush=True)
            del u, src, psr, want, planes
    if args.parent is not None:
        roots = {"parent": args.parent.resolve(), "change": build.PACKAGE_DIR.parent}
        runs = [(name, _static_ms(roots[name])) for name in ("parent", "change", "change", "parent")]
        print(json.dumps({"deterministic_delays": CATALOGS["population"], "dtype": "torch.float32",
                          "static_ms_median_least": {name: [ms for n, ms in runs if n == name]
                                        for name in ("parent", "change")}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "sms": sms,
                      "sm_clock_mhz": clock, "build_s": build_s,
                      "sass_per_loop": {name: {"/".join(map(str, k)): v for k, v in c.items()}
                                        for name, c in sass.items()},
                      "ptxas": {name: report for name, (_, report) in built.items()}}), flush=True)


if __name__ == "__main__":
    main()
