"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build, check, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``pta_replicator_tpu_torch/
csrc/`` with nvcc, holds each kernel against its plain PyTorch version on
the card at the flagship shape, drives the flagship realization path
(68 pulsars x 7,758 TOAs, 100-source CW catalog, HD GWB, quadratic fit)
through the port's entry points, checks the results, and prints one JSON
line per phase. The line before the last is the kernels line, the last
the result line. Without a CUDA device, or without the port beside it,
it exits non-zero and prints no result; any failed check raises.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pta_replicator_tpu_torch import deterministic_delays, flagship_workload, realize
from pta_replicator_tpu_torch.kernels import build, launches
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.ops import cw

#: the flagship workload's full width (depth is not cut: it is 68 x 7,758)
FLAGSHIP = dict(npsr=68, ntoa=7758, ncw=100)
#: realizations per realize() call, chunks timed after two warm-up chunks
CHUNK, NCHUNKS = 200, 4
#: the small shape of the card-vs-CPU comparison
SMALL = dict(npsr=6, ntoa=1024, ncw=20)
#: H100 SXM peaks (NVIDIA data sheet): FP32 and FP64 outside the tensor
#: cores, and HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
#: tolerances: kernel vs plain (float64; float32 = the cw family
#: tolerance), float32 vs float64, card float32 vs CPU float64 (the total
#: tolerance), and the fit's weighted mean: the median over residual rows
#: of |weighted mean| / RMS is ~3e-5 at the flagship shape in IEEE
#: float32 and ~4e-3 with the fit's products rounded to TF32's 10 bits
#: (both measured on the CPU with the port's fit)
TOL = {torch.float64: 1e-10, torch.float32: 3e-3}
TOL_F32_VS_F64 = 3e-3
TOL_TOTAL = 1e-3
TOL_FIT_MEAN = 5e-4


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok, message):
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def rel_rms(got, want):
    got, want = got.double(), want.double()
    return float(torch.sqrt(torch.mean((got - want) ** 2)) / torch.sqrt(torch.mean(want**2)))


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cw_bound(npsr, ntoa, nsrc, dtype, psr_term, evolve):
    """Least time for the CW response on this card: operations
    (cw.OPS_PER_ELEMENT per element) over the peak rate of the dtype, or
    bytes (times in, sum out, planes in; each once) over HBM bandwidth."""
    size = torch.finfo(dtype).bits // 8
    ops_ms = cw.OPS_PER_ELEMENT[(psr_term, evolve)] * npsr * ntoa * nsrc / PEAK_OPS[dtype] * 1e3
    nbytes = size * (2 * npsr * ntoa + cw.NC_SRC * nsrc + cw.NC_PSR * npsr * nsrc)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build():
    t0 = time.perf_counter()
    names = build.sources()
    build.build_all(names)
    ptxas = {n: [l.strip() for l in build.ptxas_reports.get(n, "").splitlines()
                 if "Used" in l or "spill" in l] for n in names}
    emit("build", sources=names, seconds=time.perf_counter() - t0, ptxas=ptxas)


def _catalog_planes(batch, params, evolve, tref_s):
    return B.cw_catalog_planes_for(batch, *params, pdist=1.0, evolve=evolve,
                                   tref_s=tref_s)[:2]


def phase_kernels(shape):
    """Kernel vs plain at the flagship shape, both dtypes, both phase
    models, with and without the pulsar term, on the workload's own
    catalog and on a stress catalog whose sources merge inside the span
    (the NaN guard) or before the fold (valid = 0)."""
    rng = np.random.default_rng(6)
    n = shape["ncw"] // 2
    stress = np.stack([
        np.arccos(rng.uniform(-1, 1, n)), rng.uniform(0, 2 * np.pi, n),
        10 ** rng.uniform(8.5, 9.8, n), rng.uniform(10, 500, n),
        10 ** rng.uniform(-8.0, -7.0, n), rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0, np.pi, n), np.arccos(rng.uniform(-1, 1, n)),
    ])
    results, k64 = {}, {}
    for dtype in (torch.float64, torch.float32):
        batch, recipe = flagship_workload(**shape, dtype=dtype)
        u = batch.toas_s - torch.tensor(batch.start_s, dtype=dtype, device=batch.device)
        flagship_params = recipe.cgw_params.cpu().numpy()
        for evolve in (True, False):
            catalogs = {
                "flagship": _catalog_planes(batch, flagship_params, evolve, 0.0),
                # one half folds before the data (merging), one after (merged)
                "stress": [torch.cat(p, dim=-1) for p in zip(
                    _catalog_planes(batch, stress, evolve, 53000 * 86400.0),
                    _catalog_planes(batch, stress, evolve, 0.0))],
            }
            for name, (src, psr) in catalogs.items():
                for psr_term in (True, False):
                    run = lambda: cw.cw_catalog_response(u, src, psr, psr_term, evolve)
                    plain = lambda: cw.cw_catalog_response_plain(u, src, psr, psr_term, evolve)
                    got, want = run(), plain()
                    torch.cuda.synchronize()
                    err = rel_rms(got, want)
                    key = (name, evolve, psr_term)
                    bound, bound_by = cw_bound(*u.shape, src.shape[1], dtype, psr_term, evolve)
                    row = dict(catalog=name, dtype=str(dtype), evolve=evolve,
                               psr_term=psr_term, rel_rms=err, tol=TOL[dtype],
                               max_abs_err=float((got - want).abs().max()),
                               finite=bool(torch.isfinite(got).all()),
                               ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 3),
                               bound_ms=bound, bound_by=bound_by)
                    if dtype == torch.float64:
                        k64[key] = got
                    else:
                        row["rel_rms_vs_float64_kernel"] = rel_rms(got, k64[key])
                        require(row["rel_rms_vs_float64_kernel"] <= TOL_F32_VS_F64,
                                f"float32 kernel vs float64 kernel {key}: {row}")
                    emit("kernel_vs_plain", **row)
                    require(row["finite"] and err <= TOL[dtype],
                            f"kernel vs plain {key} {dtype}: {row}")
                    results[(str(dtype), *key)] = row
    return results["torch.float32", "flagship", True, True]


def phase_main_path(shape):
    """The flagship path through the entry points, float32 on the card:
    workload, CW catalog once, then realize() in chunks with the fit,
    reduced on the card to per-pulsar RMS."""
    launches.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch, recipe, fingerprint = flagship_workload(**shape, with_fingerprint=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = deterministic_delays(batch, recipe)  # host planes + the kernel
    torch.cuda.synchronize()
    static_ms = (time.perf_counter() - t0) * 1e3
    generator = torch.Generator(device=batch.device).manual_seed(0)
    msum = batch.mask.sum(-1)

    def chunk():
        res = realize(generator, batch, recipe, CHUNK, fit=True, static=static)
        return res, torch.sqrt((res**2 * batch.mask).sum(-1) / msum)

    for _ in range(2):  # warm-up: library handles, allocator growth
        res, rms = chunk()
        rms.cpu()
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        res, rms = chunk()
    rms_host = rms.cpu()  # the readback waits for every queued chunk
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    count = launches["cw_catalog_response"]

    w = batch.mask / batch.errors_s**2
    mean = (res * w).sum(-1) / w.sum(-1)
    fit_mean = float((mean.abs() / rms).median())
    row = dict(
        shape=shape, chunk=CHUNK, nchunks=NCHUNKS, fingerprint=fingerprint,
        realizations_per_s=NCHUNKS * CHUNK / elapsed, elapsed_s=elapsed,
        workload_build_s=build_s, static_ms=static_ms,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        residual_shape=list(res.shape), finite=bool(torch.isfinite(res).all()),
        static_finite=bool(torch.isfinite(static).all()),
        median_rms_s=float(rms_host.median()), fit_mean_over_rms=fit_mean,
        cw_launches=count,
    )
    emit("main_path", **row)
    require(count > 0, "the main path never launched the CW kernel")
    require(row["finite"] and row["static_finite"] and bool(static.abs().max() > 0),
            f"main path output not finite or CW catalog empty: {row}")
    require(tuple(res.shape) == (CHUNK, shape["npsr"], shape["ntoa"]),
            f"residual shape {tuple(res.shape)}")
    require(fit_mean <= TOL_FIT_MEAN, f"fit leaves a weighted mean (TF32?): {fit_mean}")
    return batch, recipe, static, generator, count


def phase_breakdown(batch, recipe, static, generator):
    """Device milliseconds of each stage of one realize() chunk."""
    draws = B.draw_noise(generator, batch, recipe, CHUNK)
    delays = B.realization_delays(batch, recipe, draws) + static
    stages = {
        "draw_noise": lambda: B.draw_noise(generator, batch, recipe, CHUNK),
        "white": lambda: B.white_noise_delays(
            None, batch, recipe.efac, recipe.log10_equad, eps=draws["white"]),
        "ecorr": lambda: B.jitter_delays(None, batch, recipe.log10_ecorr, eps=draws["ecorr"]),
        "red": lambda: B.red_noise_delays(
            None, batch, recipe.rn_log10_amplitude, recipe.rn_gamma, eps=draws["red"]),
        "gwb": lambda: B.gwb_delays(
            None, batch, recipe.gwb_log10_amplitude, recipe.gwb_gamma,
            recipe.orf_cholesky, eps=draws["gwb"]),
        "fit": lambda: B.finalize_residuals(delays, batch, recipe, True),
        "realize_block": lambda: B.realize_block(draws, batch, recipe, True, static, CHUNK),
    }
    emit("breakdown", chunk=CHUNK, ms={k: cuda_ms(f, 5) for k, f in stages.items()})


def phase_card_vs_cpu(shape):
    """The same explicit noise through the port on the card (kernel,
    float32) and on the CPU (plain version, float64)."""
    nreal = 16
    cb, cr = flagship_workload(**shape, dtype=torch.float64, device="cpu")
    gb, gr = flagship_workload(**shape)
    rng = np.random.default_rng(1)
    noise = {k: rng.standard_normal((nreal,) + s) for k, s in B.noise_shapes(cb, cr).items()}
    ref = realize(None, cb, cr, nreal, fit=True, noise=noise, device="cpu")
    got = realize(None, gb, gr, nreal, fit=True, noise=noise).cpu()
    cw_ref = deterministic_delays(cb, cr, device="cpu")
    cw_got = deterministic_delays(gb, gr).cpu()
    row = dict(shape=shape, nreal=nreal, rel_rms_total=rel_rms(got, ref),
               rel_rms_cw=rel_rms(cw_got, cw_ref), tol_total=TOL_TOTAL,
               tol_cw=TOL[torch.float32])
    emit("card_vs_cpu", **row)
    require(row["rel_rms_total"] <= TOL_TOTAL and row["rel_rms_cw"] <= TOL[torch.float32],
            f"card float32 vs CPU float64: {row}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    phase_device()
    phase_build()
    kernel_row = phase_kernels(FLAGSHIP)
    batch, recipe, static, generator, count = phase_main_path(FLAGSHIP)
    phase_breakdown(batch, recipe, static, generator)
    phase_card_vs_cpu(SMALL)
    print(json.dumps({"kernels": [{
        "name": "cw_catalog_response", "route": "cuda",
        "source": "pta_replicator_tpu_torch/csrc/cw_catalog.cu",
        "replaces": "pta_replicator_tpu/ops/pallas_cw.py:526",
        "launches": count, "max_abs_err": kernel_row["max_abs_err"],
        "ms": kernel_row["ms"], "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"], "bound_by": kernel_row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
