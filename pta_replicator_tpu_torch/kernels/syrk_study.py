"""What holds the SYRK trailing-update kernel back: a reading on the card.

Run from the repository root on a machine with a CUDA card:

    python -m pta_replicator_tpu_torch.kernels.syrk_study

It builds ``csrc/cov_syrk.cu`` eight ways with nvcc: as it is, with the
products skipped (``staging_only``: the cp.async ring, the barriers and
C's prefetch, read and write), with the copies skipped
(``products_only``: the fragment loads and the DMMA / FFMA products on
whatever the ring holds, and C), with C's read and prefetch skipped
(``no_c_read``), with only the prefetch skipped (``no_prefetch``), with
half the resident blocks and no register cap (``one_block_per_sm``),
with 32-column stages (``chunk32``) and with C read and written entry by
entry (``c_entry_by_entry``: each read then waits for the write before
it). It times them at the first and the last launch of a blocked
factorization of the dense rung (68 x 1,920 x 128 and 68 x 128 x 128,
tile 128), in float64 and float32, on random operands, beside
``torch.baddbmm`` on the full square. One JSON line per (shape, dtype) on
stdout, then one with the card and the ptxas reports. The partial builds
compute nothing useful; only their times mean something.
"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build
from .woodbury_study import _ms
from ..ops import cw

#: text replaced in the kernel's source for each partial build
VARIANTS = {
    "kernel": (),
    "staging_only": (("    acc.step(smem + ", "    if (m < 0) acc.step(smem + "),),
    "products_only": (("if (s < nchunks) stage_chunk", "if (m < 0) stage_chunk"),
                      ("if (next < nchunks)\n", "if (m < 0)\n")),
    "no_c_read": (("      cv[j] = win.load(r, col);", "      cv[j] = T(0);"),
                  ("  win.prefetch();", "  if (m < 0) win.prefetch();")),
    "no_prefetch": (("  win.prefetch();", "  if (m < 0) win.prefetch();"),),
    # occupancy: half the resident blocks, and no 128-register cap
    "one_block_per_sm": (("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),),
    # pipeline depth: 32 contraction columns per stage, two stages in float64
    "chunk32": (("constexpr int kChunk = 16;", "constexpr int kChunk = 32;"),
                ("struct Stages<double> { static constexpr int value = 3; }",
                 "struct Stages<double> { static constexpr int value = 2; }")),
    "c_entry_by_entry": (("constexpr int kGroup = 8;", "constexpr int kGroup = 1;"),),
}
SHAPES = ((68, 1920, 128), (68, 128, 128))
TILE = 128


def main():
    if not torch.cuda.is_available():
        sys.exit("syrk_study: no CUDA device is available")
    out_dir = build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: (kv[0], *build.build_variant("cov_syrk", *kv, out_dir)),
                              VARIANTS.items()))
    libs, ptxas = {}, {}
    for name, path, report in built:
        libs[name] = ctypes.CDLL(str(path))
        cw._bind_syrk(libs[name])
        ptxas[name] = report
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for npsr, m, b in SHAPES:
        for dtype in (torch.float64, torch.float32):
            C = torch.randn((npsr, m, m), generator=gen, device="cuda", dtype=dtype)
            L = torch.randn((npsr, m, b), generator=gen, device="cuda", dtype=dtype)
            row = dict(shape=[npsr, m, b], tile=TILE, dtype=str(dtype),
                       baddbmm_ms=_ms(lambda: torch.baddbmm(C, L, L.mT, alpha=-1)))
            for name, lib in libs.items():
                row[f"{name}_ms"] = _ms(lambda: cw._syrk_launch(lib, C, L, TILE))
            print(json.dumps(row), flush=True)
            del C, L
    print(json.dumps({"device": smi, "ptxas": ptxas}), flush=True)


if __name__ == "__main__":
    main()
