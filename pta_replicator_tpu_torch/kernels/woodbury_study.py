"""What holds the fused Woodbury kernels back: a reading on the card.

Run from the repository root on a machine with a CUDA card:

    python -m pta_replicator_tpu_torch.kernels.woodbury_study [--parent DIR]

It builds ``csrc/fused_woodbury.cu`` several ways with nvcc. For the
highest kernel: as it is, with the products skipped (``staging_only``: the
cp.async ring, the barriers and the epilogue) and with the copies skipped
(``products_only``). It times the three at 68 x 7,758 with Q = 123 and
183, in float64 and float32, on random operands, at the launch plan's
split count and over a sweep of split counts, beside ``torch.bmm`` of the
same Gram matrix.

For the bf16 kernel, at Q = 123 and 286 in float64 and float32: as it is;
``bf16_staging_only`` (the copies, the conversion into bf16 words and the
barriers, no products); ``bf16_copy_only`` (the copies and barriers
alone); ``bf16_products_only`` (the products on whatever the buffers
hold); ``bf16_barrier_only`` (the barriers, epilogue and reduction alone);
and three accumulations, each held against the bf16 plain version:
``bf16_carry`` (each mma adds to the running sums, through a whole split),
``bf16_fadd16`` and ``bf16_fadd32`` (FADD after every one or every two
k16 steps; the kernel's is every four, once a chunk). ``bf16_local_push``
stores a cluster's words into each block's own buffers only (wrong sums;
it times the distributed shared memory's share). Each bf16 row has the bytes the
blocks bring in per call as a multiple of T's bytes (from the plan; the
parent kernel's count beside it), ``torch.bmm`` of the pre-converted bf16
operands, the conversion and ``bmm`` together, and a sweep of split
counts. With ``--parent DIR``, a checkout of an earlier version of the
repository (e.g. a ``git archive`` unpacked under the gitignored
``chip_scratch/``), that version's bf16 kernel is built too and timed
beside this one at its own plan's split count, in the order parent,
this, this, parent.

One JSON line per (Q, dtype) on stdout, then one with the card and the
ptxas reports (registers and spills of every build). The partial builds
compute nothing useful; only their times mean something.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import build
from ..ops import gp

#: text of the bf16 kernel that the partial builds replace
BF16_STEP = ("    else if (c > 0)\n      acc.step(X + ", "    else if (nt < 0)\n      acc.step(X + ")
BF16_CONVERT = ("if (c < nch) convert(c);", "if (nt < 0) convert(c);")
BF16_STAGE = ("if (pc < npieces) stage(pc);", "if (nt < 0) stage(pc);")  # the ring, every piece
BF16_FADD = (("for (int jb = 0; jb < kJB; ++jb) mma_bf16_16x8x16(part[m][jb], a[m][s], b[jb][s]);",
              "for (int jb = 0; jb < kJB; ++jb) mma_bf16_16x8x16(c[m][jj0 + jb], a[m][s], b[jb][s]);"),
             ("for (int e = 0; e < 4; ++e) c[m][jj0 + jb][e] += part[m][jb][e];",
              "for (int e = 0; e < 4; ++e) (void)part[m][jb][e];"))
BF16_STEPS = "constexpr int kFaddSteps = 4;"
BF16_LOCAL = (("st_cluster(map_rank(xa + xo, owner), xw);", "st_cluster(map_rank(xa + xo, rank), xw);"),
              ("st_cluster(map_rank(ya + yo, m), yw);", "st_cluster(map_rank(ya + yo, rank), yw);"))

#: text replaced in the kernel's source for each partial build
VARIANTS = {
    "kernel": (),
    "staging_only": (("    acc.step(As, ", "    if (nt < 0) acc.step(As, "),),
    "products_only": (("    if (chunk + kStages - 1 < nchunks)\n      stage_chunk<",
                       "    if (nt < 0)\n      stage_chunk<"),
                      ("    if (s < nchunks) stage_chunk<", "    if (nt < 0) stage_chunk<")),
    "bf16_staging_only": (BF16_STEP,),
    "bf16_copy_only": (BF16_STEP, BF16_CONVERT),
    "bf16_products_only": (BF16_CONVERT, BF16_STAGE),
    "bf16_local_push": BF16_LOCAL,
    "bf16_barrier_only": (BF16_STEP, BF16_CONVERT, BF16_STAGE),
    "bf16_convert_only": (BF16_STEP, BF16_STAGE),
    "bf16_stager_none": (("constexpr int kStagerWeight = 1;", "constexpr int kStagerWeight = 0;"),),
    "bf16_stager_even": (("constexpr int kMultiplierWeight = 2;", "constexpr int kMultiplierWeight = 1;"),),
    "bf16_issue_last": (("    if (stager) issue(c);\n    else if (c > 0)", "    if (!stager && c > 0)"),
                        ("    if (c < nch) convert(c);\n", "    if (c < nch) convert(c);\n    if (stager) issue(c);\n")),
    "bf16_no_store": (BF16_STEP, ("""              if (xcol >= 0) st_local(xa + xo, xw);
              if (ycol >= 0) st_local(ya + yo, yw);""", """              if (xw == 0x7fc17fc1u && yw == 0x7fc17fc1u) st_local(xa + xo, xw);""")),
    "bf16_carry": BF16_FADD,
    "bf16_fadd16": ((BF16_STEPS, "constexpr int kFaddSteps = 1;"),),
    "bf16_fadd32": ((BF16_STEPS, "constexpr int kFaddSteps = 2;"),),
}
#: the bf16 builds whose sums are the kernel's, to a tolerance
BF16_EXACT = ("kernel", "bf16_carry", "bf16_fadd16", "bf16_fadd32")
SHAPE = (68, 7758)
COLUMNS = (123, 183)
SPLITS = (1, 2, 4, 6, 8, 10, 12, 16, 24)
BF16_COLUMNS = (123, 286)
BF16_SPLITS = (1, 2, 3, 4, 5, 7, 8, 10, 14)
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet)
PEAK_BYTES = 3.35e12


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bind_parent(lib):
    """The parent's bf16 entry points (its library has no grid export)."""
    lib.fused_woodbury_bf16_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_woodbury_bf16_workspace.restype = ctypes.c_longlong
    lib.fused_woodbury_bf16_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fused_woodbury_bf16_launch.restype = ctypes.c_int
    lib.fused_woodbury_error_string.argtypes = [ctypes.c_int]
    lib.fused_woodbury_error_string.restype = ctypes.c_char_p


def parent_bf16_nsplit(npsr, ntoa, q, sms):
    """The split count of the earlier bf16 kernel's plan (one block per
    ordered panel pair, at most 16 blocks per SM)."""
    panels = -(-(q + 1) // gp.WOODBURY_PANEL)
    target = gp.WOODBURY_BLOCKS_PER_SM * sms // (panels * panels * npsr)
    return gp._whole_splits(ntoa, min(target, gp.woodbury_max_splits(ntoa)))


def parent_bf16_staged(q):
    """T's bytes the earlier bf16 kernel stages per call, as a multiple of
    T's: each of the P^2 ordered pairs stages its row panel and, off the
    diagonal, its column panel, so the P panels cross 2P - 1 times."""
    panels = -(-(q + 1) // gp.WOODBURY_PANEL)
    return 2 * panels - 1


def _rel_err(got, want):
    return max(float((g - x).abs().max() / x.abs().max()) for g, x in zip(got, want))


def bf16_row(libs, q, dtype, sms, gen):
    """One bf16 reading at 68 x 7,758 x q with ``dtype`` inputs."""
    shape = (*SHAPE, q)
    T = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
    u = torch.rand((2, *SHAPE), generator=gen, device="cuda", dtype=torch.float64)
    w = (u[0] + 0.5) * 1e12 * (u[1] > 0.1)
    r = torch.randn(SHAPE, generator=gen, device="cuda", dtype=torch.float64) * 1e-6
    T, w, r = (x.to(dtype).contiguous() for x in (T, w, r))
    size = T.element_size()
    want = gp.fused_woodbury_plain(T, w, r, precision="bf16")
    plan = gp.woodbury_plan(*shape, sms, "bf16")[2]
    grid = gp.woodbury_bf16_grid(SHAPE[0], q, plan, size)
    tbytes = SHAPE[0] * SHAPE[1] * q * size
    nbytes = size * (T.numel() + w.numel() + r.numel()) + 4 * SHAPE[0] * (q * q + q + 1)
    row = dict(q=q, precision="bf16", input_dtype=str(dtype), shape=list(shape), plan_nsplit=plan,
               grid=grid._asdict(), bound_ms=nbytes / PEAK_BYTES * 1e3,
               staged_over_t=gp.woodbury_bf16_staged_bytes(*shape, size) / tbytes,
               parent_staged_over_t=parent_bf16_staged(q))
    run = lambda lib, n=plan: gp._woodbury_launch(lib, T, w, r, n, "bf16")
    for name, lib in libs.items():
        if not name.startswith("bf16") and name != "kernel":
            continue
        if name in BF16_EXACT:
            for n in sorted({1, plan}):
                row[f"{name}_rel_err_nsplit{n}"] = _rel_err(run(lib, n), want)
        row[f"{name}_ms"] = _ms(lambda: run(lib))
    if "parent" in libs:
        pn = parent_bf16_nsplit(*shape, sms)
        parent = lambda: run(libs["parent"], pn)
        change = lambda: run(libs["kernel"])
        row["parent_nsplit"] = pn
        row["parent_rel_err"] = _rel_err(parent(), want)
        times = [_ms(f) for f in (parent, change, change, parent)]
        row["parent_ms"], row["change_ms"] = [times[0], times[3]], times[1:3]
    row["kernel_ms_by_nsplit"] = {n: _ms(lambda: run(libs["kernel"], n)) for n in BF16_SPLITS}
    A = torch.cat([T, r[..., None]], dim=-1)
    WA = A * w[..., None]
    At16, WA16 = A.to(torch.bfloat16).transpose(1, 2), WA.to(torch.bfloat16)
    row["bmm_ms"] = _ms(lambda: torch.bmm(At16, WA16, out_dtype=torch.float32))
    row["convert_bmm_ms"] = _ms(lambda: torch.bmm(A.to(torch.bfloat16).transpose(1, 2),
                                                  WA.to(torch.bfloat16), out_dtype=torch.float32))
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier version whose bf16 kernel is timed beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("woodbury_study: no CUDA device is available")
    out_dir = build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (edits, None) for name, edits in VARIANTS.items()}
    if args.parent is not None:
        jobs["parent"] = ((), args.parent / "pta_replicator_tpu_torch/csrc/fused_woodbury.cu")
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(build.build_variant, "fused_woodbury", name, edits, out_dir,
                                     source_path=source)
                   for name, (edits, source) in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    libs, ptxas = {}, {}
    for name, (path, report) in built.items():
        libs[name] = ctypes.CDLL(str(path))
        (_bind_parent if name == "parent" else gp._bind)(libs[name])
        ptxas[name] = report
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    highest = {name: lib for name, lib in libs.items() if name in ("kernel", "staging_only", "products_only")}
    for q in COLUMNS:
        shape = (*SHAPE, q)
        T64 = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
        u = torch.rand((2, *SHAPE), generator=gen, device="cuda", dtype=torch.float64)
        w64 = (u[0] + 0.5) * 1e12 * (u[1] > 0.1)
        r64 = torch.randn(SHAPE, generator=gen, device="cuda", dtype=torch.float64) * 1e-6
        for dtype in (torch.float64, torch.float32):
            T, w, r = (x.to(dtype).contiguous() for x in (T64, w64, r64))
            nsplit = gp.woodbury_plan(*shape, sms)[2]
            A = torch.cat([T, r[..., None]], dim=-1)
            WA, At = A * w[..., None], A.transpose(1, 2)
            row = dict(q=q, dtype=str(dtype), shape=list(shape), plan_nsplit=nsplit,
                       bmm_ms=_ms(lambda: torch.bmm(At, WA)))
            del A, WA, At
            for name, lib in highest.items():
                row[f"{name}_ms"] = _ms(lambda: gp._woodbury_launch(lib, T, w, r, nsplit))
            row["kernel_ms_by_nsplit"] = {n: _ms(lambda: gp._woodbury_launch(libs["kernel"], T, w, r, n))
                                          for n in SPLITS}
            print(json.dumps(row), flush=True)
    for q in BF16_COLUMNS:
        for dtype in (torch.float64, torch.float32):
            print(json.dumps(bf16_row(libs, q, dtype, sms, gen)), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "sms": sms,
                      "ptxas": ptxas}), flush=True)


if __name__ == "__main__":
    main()
