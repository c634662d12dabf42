"""What holds the fused Woodbury kernel back: a reading on the card.

Run from the repository root on a machine with a CUDA card:

    python -m pta_replicator_tpu_torch.kernels.woodbury_study

It builds ``csrc/fused_woodbury.cu`` three ways with nvcc: as it is, with
the products skipped (``staging_only``: the cp.async ring, the barriers
and the epilogue) and with the copies skipped (``products_only``: the
fragment loads and the DMMA / FFMA products on whatever the shared
buffers hold). It times the three at 68 x 7,758 with Q = 123 and 183, in
float64 and float32, on random operands, at the launch plan's split count
and over a sweep of split counts, beside ``torch.bmm`` of the same Gram
matrix. The bf16 rung is also built with its accumulator carried through
the tensor cores across chunks (``bf16_carry``: each mma adds to the
running sums, in place of the FADD of each chunk's products), and both
are held against the bf16 plain version at Q = 123 and 286, float64
inputs, with one split and the plan's. One JSON line per (Q, dtype) and
per bf16 width on stdout, then one with the card and the ptxas reports.
The two partial builds compute nothing useful; only their times mean
something.
"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build
from ..ops import gp

#: text replaced in the kernel's source for each partial build
VARIANTS = {
    "kernel": (),
    "staging_only": (("    acc.step(As, ", "    if (nt < 0) acc.step(As, "),),
    "products_only": (("    if (chunk + kStages - 1 < nchunks)\n      stage_chunk<",
                       "    if (nt < 0)\n      stage_chunk<"),
                      ("    if (s < nchunks) stage_chunk<", "    if (nt < 0) stage_chunk<")),
    "bf16_carry": (("""        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16x8x16(part, a[m], b[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] += part[e];""",
                    "        mma_bf16_16x8x16(c[m][n], a[m], b[n]);"),),
}
SHAPE = (68, 7758)
COLUMNS = (123, 183)
SPLITS = (1, 2, 4, 6, 8, 10, 12, 16, 24)
BF16_COLUMNS = (123, 286)


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


def main():
    if not torch.cuda.is_available():
        sys.exit("woodbury_study: no CUDA device is available")
    out_dir = build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(
            lambda kv: (kv[0], *build.build_variant("fused_woodbury", *kv, out_dir)),
            VARIANTS.items()))
    libs, ptxas = {}, {}
    for name, path, report in built:
        libs[name] = ctypes.CDLL(str(path))
        gp._bind(libs[name])
        ptxas[name] = report
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
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
            for name, lib in libs.items():
                row[f"{name}_ms"] = _ms(lambda: gp._woodbury_launch(lib, T, w, r, nsplit))
            row["kernel_ms_by_nsplit"] = {n: _ms(lambda: gp._woodbury_launch(libs["kernel"], T, w, r, n))
                                          for n in SPLITS}
            print(json.dumps(row), flush=True)
    for q in BF16_COLUMNS:
        shape = (*SHAPE, q)
        T = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
        u = torch.rand((2, *SHAPE), generator=gen, device="cuda", dtype=torch.float64)
        w = (u[0] + 0.5) * 1e12 * (u[1] > 0.1)
        r = torch.randn(SHAPE, generator=gen, device="cuda", dtype=torch.float64) * 1e-6
        want = gp.fused_woodbury_plain(T, w, r, precision="bf16")
        plan = gp.woodbury_plan(*shape, sms, "bf16")[2]
        row = dict(q=q, precision="bf16", input_dtype="torch.float64", shape=list(shape),
                   plan_nsplit=plan)
        for name in ("kernel", "bf16_carry"):
            for n in sorted({1, plan}):
                got = gp._woodbury_launch(libs[name], T, w, r, n, "bf16")
                row[f"{name}_rel_err_nsplit{n}"] = max(
                    float((g - x).abs().max() / x.abs().max()) for g, x in zip(got, want))
            row[f"{name}_ms"] = _ms(lambda: gp._woodbury_launch(libs[name], T, w, r, plan, "bf16"))
        print(json.dumps(row), flush=True)
        del T, w, r, want
    print(json.dumps({"device": smi, "sms": sms, "ptxas": ptxas}), flush=True)


if __name__ == "__main__":
    main()
