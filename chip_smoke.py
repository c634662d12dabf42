"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build, check, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``pta_replicator_tpu_torch/
csrc/`` with nvcc, holds each kernel against its plain PyTorch version on
the card at the shapes its path gives it, drives the port's paths through
its entry points and checks the results: the flagship realization path (68
pulsars x 7,758 TOAs, 100-source CW catalog, HD GWB, quadratic fit); the
likelihood path that prices its bank of 200 realizations in float64 over
an 8 x 8 GWB grid (the fused ReducedGP build, the grid evaluation and the
request-batched server), and a small bank of the flagship recipe with a
30-mode chromatic block (a 183-column GP basis) through the fused and
composed routes; and the structured noise covariance in two
configurations: banded (block-tridiagonal) correlated noise at the
flagship width, realized and priced on the block-tridiagonal kernels, and
the solar-wind Kronecker covariance with ECORR at 68 x 2,048, priced on
the dense rung's blocked Cholesky. The CW kernel is also held and timed at
a population catalog of 10,000 sources at the flagship width, and the
deterministic delays are driven there through the entry point. The
full-model refit of a 166-column design drawn on the card runs at the
flagship width in three modes (quadratic, WLS, GLS; phase `full_fit`),
with GLS weighted through config B's block-tridiagonal kernels
(`full_fit_banded`) and config D's blocked Cholesky (`full_fit_dense`);
the GLS-fitted float64 bank is priced with its own design, the Woodbury
kernel at 286 columns (`full_fit_likelihood`); and the deterministic
delays add a burst, a burst with memory and a transient, beside a realize
with a user GWB spectrum (`deterministic_families`). The bf16 rung of the
Woodbury assembly is held against its plain version at Q = 123 (float64
and float32 inputs) and 286 (`woodbury_kernel_vs_plain_bf16`), gated on a
numerics capture of the armed float64 bank call and priced on the
flagship bank (`likelihood_bf16`); the tuner searches the kernel's TOA
splits (`tuner_woodbury`), and the MAP fit runs at the flagship width and
card against CPU (`map_fit`, `map_fit_card_vs_cpu`). The declarative
scenario path compiles the committed `ng15_population` spec on the card
(100,000 binaries split into ~3,000 outlier CWs and a free-spectrum GWB
under an anisotropic ORF, with burst, memory and glitch), holds the card
compile against the CPU compile bit for bit and B.1 at its catalog
against the plain version, and runs the spec's sweep
(`scenario_population`); the same spec goes through `python -m
pta_replicator_tpu_torch scenario validate|compile|run` in subprocesses
(`scenario_cli`). The differential fuzz harness runs the first 25
generated scenarios (every family and structural variant, one sweep
identity check) on the card against the host float64 oracle within the
JAX package's per-family tolerances, then a planted ECORR defect that
must be detected, shrunk to ECORR alone and replayed, and `scenario fuzz
--fast` and `scenario replay` in subprocesses, and holds the card's
families (B.1 among them) against the port's CPU run (`fuzz`). The
dataset path writes an NG15-shaped par/tim dataset
(68 pulsars, ragged to 7,758 TOAs), reads it through the native tim
reader, idealizes, freezes and refits it with its real timing design
(quadratic, WLS, GLS), holds B.1 at its shape against the plain version,
and runs `python -m pta_replicator_tpu_torch info|realize` on it, with
datasets written back out (`dataset_path`); the same CLI's `realize
--checkpoint` with `--telemetry` and without (equal bytes, the JAX CLI's
span set), `likelihood` and `scenario compile` captures, `report`, and an
in-process flagship-shaped sweep whose rate and synchronizing CUDA calls
are held with and without a capture (`telemetry`); `python -m
pta_replicator_tpu_torch likelihood` prices that CLI's 400-realization
bank over an 8 x 8 grid, with a MAP fit and 32 served requests, against
the in-process call (`likelihood_cli`), then a synthetic flagship-shaped
bank its noise model describes, whose MAP must find the injected GWB
amplitude within 5 sigma (`likelihood_cli_truth`). The per-pulsar oracle path
runs the reference's regression recipe and every other `add_*` operator
on the same 68 pulsars in host float64 numpy, gates the ledger's
decomposition, and holds the card's batched engine against it: B.1 on
the oracle's CW catalog, the burst, memory and transient, and the GLS
refit of the full timing design on the nested Woodbury, on B.4/B.5
(banded) and on the dense rung with B.2, against the dense oracle; then
`SimulatedPulsar.fit` and `write_partim` (`oracle_path`). Fault injection
runs at the flagship width: the full-cube sweep under seeded drain raises,
stalls past the drain deadline and torn checkpoint writes, a lost device,
a fatal fault and no retry budget, the streamed 10,000-source catalog
under a lost device, and the CLI armed by `--faults` and `PTA_FAULTS`
(`chaos`), then the server under a flapped engine call and a flood past
its queue bound (`chaos_server`); the numerics observatory holds armed
cubes bitwise the disarmed ones, the armed sweep's rate and synchronizing
calls, a planted overflow and a planted NaN at their sites, drift on
every chunk against the host f64 oracle, and the `cov.*` probe sites on
B.4 and B.2 against the CPU (`numerics_observatory`). The live-run surface
holds the flagship sweep's rate with the flight recorder heartbeating and
an objective armed against none (equal synchronizing calls, B.1 launches
and outputs), runs the dataset CLI's `realize --telemetry` beside `watch
--serve 0` (its HTTP routes polled, the final heartbeat, series, SLO and
report read) and SIGTERMs a held one (its postmortem read back), every arm
restoring the process state it found (`live_run`); then the server under a
tight objective with a planted engine stall: one trace a request, /readyz
200 before the burn and 503 during it, rows bitwise the uncaptured
server's (`live_run_server`). Time attribution runs the flagship sweep
under a capture and a torch.profiler device trace, with the tuner's search
of B.3 in the same capture, then `critpath DIR` and `timeline DIR` over it:
every chunk attributed and one trace a chunk, B.1's kernels on the merged
timeline after the host spans that launched them, the report's critical
path and roofline; a retried chunk's trace with both attempts; equal CUDA
calls with a trace scope and without (`time_attribution`); and the dataset
CLI's `realize --telemetry --device-trace` beside the likelihood CLI, read
the same way (`time_attribution_cli`). The MAP fit over a covariance recipe
differentiates through C0's solver on the card: the factor sweep's two
adjoint kernels (kernel 1, its backward; kernel 2, kernel 1's backward,
reached by the Hessian) against their plain versions at config B's blocks
(`cov_adjoint_kernels`); `map_fit` over the covariance amplitude and the
GWB's at configs B and D, its gradient and Hessian at the start against
central differences, with no plain version called (`map_fit_covariance`);
the fit at 2 x 128 on both rungs, card against CPU
(`map_fit_covariance_card_vs_cpu`); and the JAX package's covariance round
trip at config B's width, each amplitude within 3 Fisher sigma
(`covariance_round_trip`). The device mesh (A.17a) shards the flagship
sweep at 1 x 1, 2 x 1, 1 x 2 and 2 x 2 on card 0 repeated (on distinct
cards where there are that many): the elementwise recipe bitwise, the
flagship recipe within its tolerance and anchored to the float64 engine,
a resume across mesh shapes, a sharded archive, each shard's dispatch,
config B's GLS refit on 1 x 2 with B.4/B.5 on each shard, `realize
--sharded` in a fresh process and two processes of a gloo group
(`mesh_sweep`). It prints one JSON line per phase. The
line before the last is the kernels line, the last the result line.
Without a CUDA device, or without the port beside it, it exits non-zero
and prints no result; any failed check raises.
"""
import collections
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pta_replicator_tpu_torch import deterministic_delays, flagship_workload, realize
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.kernels import build, cw_study, launches
from pta_replicator_tpu_torch.covariance import banded_from_times, kron_time_channel, recipe_cov_s2
from pta_replicator_tpu_torch.covariance import kernels as cov_kernels
from pta_replicator_tpu_torch.covariance import structure as cov_structure
from pta_replicator_tpu_torch.likelihood import gp as lgp
from pta_replicator_tpu_torch.likelihood import tuner
from pta_replicator_tpu_torch.likelihood.infer import _reduced_points, _theta_block, map_objective
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.obs import numerics
from pta_replicator_tpu_torch.ops import cw
from pta_replicator_tpu_torch.ops import gp as ops_gp
from pta_replicator_tpu_torch.scenarios import compile_spec, load_spec, sample_spec
from pta_replicator_tpu_torch.scenarios import spec_families
from pta_replicator_tpu_torch.scenarios import compile as scenario_compile
from pta_replicator_tpu_torch.scenarios.compile import deterministic_families
from pta_replicator_tpu_torch.parallel import distributed, rehearsal
from pta_replicator_tpu_torch.parallel import mesh as pmesh
from pta_replicator_tpu_torch.parallel.stages import fan_out
from pta_replicator_tpu_torch.utils import sweep as sweep_mod
from pta_replicator_tpu_torch.utils.sweep import chunk_seed, sweep

#: the flagship workload's full width (depth is not cut: it is 68 x 7,758)
FLAGSHIP = dict(npsr=68, ntoa=7758, ncw=100)
#: a population catalog at the flagship width: flagship_workload's own
#: catalog of 10,000 sources (kernel rows in the chirped pulsar-term mode,
#: and phase cw_population)
POPULATION = dict(npsr=68, ntoa=7758, ncw=10_000)
#: kernel launches averaged per CW time: the flagship catalogs and the
#: population catalog
CW_REPS = {"flagship": 20, "stress": 20, "population": 3}
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
#: the fused Woodbury kernel's peak rates: FP32 outside the tensor cores,
#: and FP64 on the tensor cores (DMMA can carry this product), both
#: 67 TFLOP/s on the H100 SXM
WOODBURY_PEAK_OPS = {torch.float32: 67e12, torch.float64: 67e12}
#: kernel vs plain, max |error| over the largest |reference| entry of each
#: output: both sum the same products in another order (float64), and
#: float32 sums of ~7,758 terms carry ~sqrt(Nt) eps
TOL_WOODBURY = {torch.float64: 1e-12, torch.float32: 1e-4}
#: a 30-mode chromatic (DM, index 2) block on the flagship recipe: the GP
#: basis grows from Q = 123 to 183 columns, past the 175 the first
#: Woodbury kernel took; per-pulsar amplitudes and slopes from this seed
CHROM_SEED, CHROM_BANK = 9, 16
#: the likelihood path, float64, entry by entry relative: fused vs
#: composed, server vs bank, card vs CPU (sums of ~1e6 in log L carry
#: ~1e-13 of rounding; the Woodbury blocks differ at ~1e-15)
TOL_LIKELIHOOD = 1e-10
#: the hyperparameter grid of the likelihood path (8 x 8 points)
LIKELIHOOD_GRID = {"gwb_log10_amplitude": np.linspace(-14.6, -13.4, 8),
                   "gwb_gamma": np.linspace(3.5, 5.0, 8)}
#: the server's requests and batch capacity
SERVER_REQUESTS, SERVER_BATCH = 32, 8
#: realizations of the small card-vs-CPU likelihood bank
SMALL_BANK = 16
#: config B: the scenario compiler's banded defaults over the flagship
#: recipe without ECORR (banded + ECORR takes the dense rung)
DAY_S = 86400.0
BANDED = dict(rho=0.5, corr_s=30 * DAY_S, block=16)
BANDED_LOG10_SIGMA = -6.4
#: config D: the compiler's solar_wind preset (Kronecker time (x) 4
#: channels, with ECORR) at 68 x 2,048: a dense flagship C0 would be 32.7
#: GB per copy
DENSE_SHAPE = dict(npsr=68, ntoa=2048, ncw=100)
KRON = dict(channels=4, time_ell_s=20 * DAY_S, chan_rho=0.9, nugget=0.05)
KRON_LOG10_SIGMA = -6.6
#: config D's realizations, GWB grid (4 x 4) and covariance-amplitude grids
DENSE_BANK = 32
DENSE_GRID = {k: v[::2] for k, v in LIKELIHOOD_GRID.items()}
COV_SIGMA_GRID_B = np.linspace(-6.8, -6.0, 8)
COV_SIGMA_GRID_D = np.linspace(-7.0, -6.2, 4)
#: the dense rung's block and the covariance kernels' peak rates: FP64 on
#: the tensor cores (DMMA can carry both) and FP32 outside them, both 67
#: TFLOP/s on the H100 SXM
DENSE_BLOCK = 128
COV_PEAK_OPS = {torch.float64: 67e12, torch.float32: 67e12}
#: covariance kernel vs plain, max |error| over the largest |entry| of each
#: output: float64 sums the same products in another order; float32
#: carries ~sqrt(b) eps through 485 dependent block columns
TOL_COV = {torch.float64: 1e-12, torch.float32: 1e-4}
#: the blocked factor against the library Cholesky of the same C0 (f64)
TOL_BLOCKED = 1e-10
#: the launch counters of the covariance kernels: the SYRK update, the
#: forward sweep that factors (with or without right-hand sides), the
#: substitution-only forward sweep and the backward sweep
COV_KERNELS = ("cov_syrk_update", "tridiag_factor_solve_fwd", "tridiag_solve_fwd",
               "tridiag_factor_solve_bwd")

#: the sweep phase: chunk, realizations (10 chunks), seed, runs of each
#: mode, the chunk after which (b) aborts, and (c)'s full cubes (two
#: 422 MB chunks, cut from three to keep the script's time); (d)'s bank
#: vs the in-memory array, float64, entry by entry relative (the same
#: residuals; ~1e-15 apart at most)
SWEEP_CHUNK, SWEEP_NREAL, SWEEP_SEED, SWEEP_REPS = 200, 2000, 9, 2
SWEEP_MODES = {"depth1": dict(pipeline_depth=1), "depth2": dict(pipeline_depth=2),
               "fused": dict(pipeline_depth=2, fused_stream=True)}
SWEEP_ABORT_AFTER = 4
CUBE_NREAL = 400
TOL_BANK = 1e-12
#: the mesh sweep (A.17a): the mesh shapes, on as many cards as a shape
#: has shards where there are that many and on card 0 repeated where the
#: card is alone; the sweeps' realizations (10 chunks of CHUNK), seed,
#: and the warm-up sweep's; the elementwise recipe (per-backend EFAC and
#: EQUAD, no fit) held bitwise; the flagship recipe (fit) and config B's
#: GLS refit held to MESH_TOL: the RMS of the difference from the
#: unsharded result over its RMS, and, against the float64 engine on the
#: same draws, a worst entry no more than MESH_F64_RATIO times the
#: unsharded float32 result's (on the H100 the float32 engine's own worst
#: entry moves by 1.0e-5 of the RMS when only its chunk changes from 200
#: to 100 realizations: a mesh cannot be held closer than that); the
#: chunk after which the 2 x 2 resume arm stops; the dispatch reps; the
#: CLI arm's realizations (on DATASET, through a 2 x 2 mesh); the gloo
#: arm's processes (one card shared)
MESH_SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2))
MESH_NREAL, MESH_SEED, MESH_ABORT_AFTER, MESH_DISPATCH_REPS = 2000, 13, 2, 3
MESH_TOL, MESH_F64_RATIO = 1e-5, 2.0
MESH_CLI_NREAL = 8
MESH_PROCESSES = 2
#: the streamed catalog: sources per plane tile, calls timed per mode, and
#: the large catalog (the reference's CW ladder runs to 1e5 sources)
SOURCES_PER_TILE, CW_STREAM_REPS, CW_STREAM_LARGE = 1024, 5, 100_000
#: the sources of one macro tile: cw_stream_response joins 8 plane tiles
#: (its default tiles_per_step) for each fold and launch
SOURCES_PER_MACRO = 8 * SOURCES_PER_TILE

#: the declarative scenario path: the committed full-width population
#: spec (68 x 7,758, 100,000 binaries, ~3,000 outlier CWs, an lmax = 2
#: anisotropic ORF, burst, memory and glitch), the CW kernel's timed
#: calls at its catalog, and the CLI's realizations (full cubes, one
#: chunk of the spec's 200: its sweep.nreal of 400 is cut to keep the
#: cubes it writes and reads back at ~0.4 GB each)
SCENARIO_SPEC = (Path(__file__).resolve().parent / "pta_replicator_tpu_torch" / "scenarios"
                 / "specs" / "ng15_population.json")
SCENARIO_CW_REPS, SCENARIO_CLI_NREAL = 10, 200

#: the dataset path: an NG15-shaped par/tim dataset fabricated from a seed
#: (68 pulsars, ragged 2,000 to 7,758 TOAs, 4 backends, 16 years, DMX every
#: 40 days, ELL1 and DD binaries, JUMPs; utils/fabricate.py), the flagship
#: recipe from JSON (utils/fabricate.py::ng15_like_recipe), the CLI's
#: checkpointed sweep (400 in chunks of 200) and its datasets written, a
#: second CLI sweep in chunks of 2 whose fourth dataset lies in its second
#: chunk, the pulsars of the card-vs-CPU float64 bank, and B.1's timed calls
DATASET = dict(npsr=68, ntoa_max=7758, ntoa_min=2000)
DATASET_SEED, DATASET_NREAL, DATASET_CHUNK, DATASET_WRITE_MAX = 0, 400, 200, 4
DATASET_SMALL_CHUNK, DATASET_SMALL_NREAL, DATASET_CARD_VS_CPU_PSRS = 2, 8, 6
#: make_ideal's bound on every pulsar's residual RMS [s] (the JAX package's
#: tests/test_simulate.py), and dataset r's residualized TOA shift against
#: cube row r's pre-fit delays [s] (tests/test_cli.py)
TOL_IDEAL_RMS_S, TOL_SHIFT_S = 1e-9, 5e-9

#: the differential fuzz harness: every signal family and structural
#: variant a run must exercise (``spec_families`` tokens; the JAX
#: package's bench list, benchmarks/scenario_fuzz.py:59-69); the first
#: fuzz_cover_n() generated scenarios at root 0 cover them and hold a
#: sweep-identity check (found from the specs, capped at FUZZ_CAP); the
#: sweep identity on every 4th; the card against the port's own CPU run
#: (each kernel against its plain version) over the first
#: FUZZ_CARD_VS_CPU of them under the same draws; the planted defect of
#: the JAX package's bench (6 scenarios at root 5)
REQUIRED_COVERAGE = (
    "white", "ecorr", "red", "chromatic",
    "gwb_powerlaw", "gwb_turnover", "gwb_freespec",
    "orf_hd", "orf_none", "orf_aniso",
    "cw", "cw_streamed", "population_cw",
    "burst", "memory", "transient", "glitch",
    "cov_banded", "cov_kron", "cov_dense",
)
FUZZ_CAP, FUZZ_SWEEP_EVERY, FUZZ_CARD_VS_CPU = 200, 4, 8
FUZZ_PLANTED = dict(n=6, root_seed=5, perturb={"family": "ecorr", "scale": 1.01})
#: the likelihood CLI: two 8-point GWB axes and one MAP field, its grid
#: against the in-process call on the same bank; on the dataset path's
#: checkpointed full-fit bank (400 x 68 x 7,758) also 32 served requests
LIKELIHOOD_CLI_GRID = ("gwb_log10_amplitude=-14.6:-13.4:8", "gwb_gamma=3.5:5.0:8")
LIKELIHOOD_CLI_MAP, LIKELIHOOD_CLI_SERVE = "gwb_log10_amplitude=-14.2", 32
TOL_LIKELIHOOD_CLI = 1e-12
#: the likelihood CLI's truth arm, on a bank its noise model describes
#: (the dataset bank's is not: the CLI prices without a design, as the
#: JAX CLI does, so the weighted mean that realize() removes, the refit
#: and the CW catalog are outside the model, and with spans of 8 to 16 of
#: the array's 16 years so is the GWB's power below each pulsar's 1/T):
#: the synthetic flagship-shaped batch (every pulsar spans the 16 years),
#: ng15_like_recipe without its CW catalog, the GWB without
#: cross-correlations and without power below 1/T (orf "none", gwb_howml
#: 1) on a synthesis grid of 4,800 points (~1.2 days; the default 600's
#: ~9.7-day grid reads as excess GWB power, ROADMAP C.11), its summed
#: stochastic delays (realization_delays: nothing fitted or removed) from
#: a seed. The MAP must land within 5 of its Fisher sigmas of the
#: injected log10 A, inside the grid
LIKELIHOOD_TRUTH_NPTS = 4800
LIKELIHOOD_TRUTH_NREAL, LIKELIHOOD_TRUTH_SEED, TOL_LIKELIHOOD_TRUTH_SIGMAS = 100, 7, 5.0

#: the per-pulsar oracle path (phase oracle_path), on the dataset path's 68
#: pulsars: the reference's regression recipe (tests/test_parity_libstempo.py:
#: 30-56: GWB, EFAC, ECORR, libstempo-convention red noise, one CW), then
#: chromatic (DM) noise, the dataset recipe's 100-source CW catalog at the
#: reference's epoch, a burst, a burst with memory and a transient (pulsar
#: ORACLE_TRANSIENT_PSR) as the JAX package's own tests shape them
ORACLE_CHROMATIC = dict(log10_amplitude=-13.8, spectral_index=3.0, chromatic_index=2.0, seed=777)
ORACLE_TREF_S = 53000 * 86400.0
ORACLE_BURST_WIDTH_S, ORACLE_BURST_GRID = 100 * 86400.0, 16384
ORACLE_MEMORY = dict(strain=5e-15, gwtheta=1.1, gwphi=2.3, bwm_pol=0.7)
ORACLE_TRANSIENT_PSR = 1
#: the ledger's decomposition of each pulsar's TOA shifts and residuals [s]
#: (tests/test_parity_libstempo.py:68-75), both exact up to the longdouble
#: epochs' rounding: the residuals through the timing model, the ideal TOAs
#: shifted once by the ledger's sum
TOL_LEDGER_S = 5e-9
#: the card against the oracle (tests/test_batched.py:293, :453, :476-483,
#: :1000-1008): B.1 float64 per TOA (rtol, atol), the memory ramp (rtol,
#: atol), burst and transient (atol over the oracle's RMS), and the GLS
#: refit (post-fit relative RMS; sigmas rtol)
TOL_ORACLE_CW = (1e-8, 1e-15)
TOL_ORACLE_MEMORY = (1e-9, 1e-19)
TOL_ORACLE_BURST = 1e-5
TOL_ORACLE_GLS = 1e-6
#: the GLS refit's batch: the dataset's shortest pulsar and its 7,758-TOA
#: one; the dense run's squared-exponential noise_cov and amplitudes
ORACLE_DENSE_CORR_S, ORACLE_DENSE_LOG10_SIGMA = 20 * DAY_S, -6.6

#: the GLS refit's right-hand-side counts on config B: the GP basis alone,
#: the design and a chunk of realizations
FIT_WIDTHS = (120, 166, 200)
#: right-hand-side counts of the substitution sweeps timed beside the GP
#: basis's: the direct route's single residual (the chain's latency), and
#: the GLS refit's: the GP basis alone (120), the design (166) and a chunk
#: of realizations (200)
TRIDIAG_EXTRA_Q = (1, *FIT_WIDTHS)
#: the full-model refit: the design's columns (bench.py's BENCH_FIT_K) and
#: the seed of its draw on the card (standard normals, bench.py's shape)
FIT_COLUMNS, FIT_SEED = 166, 3
#: the projection gate at full width, float32: max over columns of
#: |Mn_k^T W r| / |r|_W, W the white weights (WLS) or C^-1 (GLS, applied in
#: float64), Mn the W-normalized design: the share of a fitted column left
#: in the residual by the fit (before the weighted-mean subtraction). On
#: the H100 at the flagship: WLS 2.6e-7 (its float32 products); GLS
#: 2.4e-8-4.3e-8 (config B's too; config D, float64, 7.1e-12); the GLS fit
#: with its C^-1 apply in float32, which the port rejects, 4.3e-6. The GLS
#: limit sits between the last two, and phase full_fit reads that control
#: and requires it above the limit
TOL_PROJECTION = {"wls": 1e-5, "gls": 5e-7}
#: the GLS gates' other half, float64: C z = r for z = C^-1 r, the fit's
#: own operator applied to its output, with C applied forward from the
#: noise model's parts (no inverse, no factor): max over realizations and
#: pulsars of |C z - r| / |r|. The float64 solves read 4.6e-8 (flagship),
#: 5.5e-8 (config B) and 2.5e-9 (config D) on the H100; a C^-1 without its
#: GP Woodbury term reads 1e3-1e6 (on the CPU at 6 x 1,024)
TOL_INVERSE = 1e-6
#: card float64 vs CPU float64, the largest |error| over the largest
#: |entry|: the fits (the same float64 products in another order) and the
#: new deterministic families (burst, memory, transient)
TOL_FIT_CARD_VS_CPU = 1e-10
TOL_FAMILIES = 1e-12
#: the user GWB spectrum of phase deterministic_families: (freq_hz, hc)
#: nodes between 2 and 60 nHz, so the synthesis grid is clamped at both ends
USER_SPECTRUM_F = np.geomspace(2e-9, 6e-8, 9)
USER_SPECTRUM = np.stack([USER_SPECTRUM_F, 1e-15 * (USER_SPECTRUM_F / 1e-8) ** (-2.0 / 3.0)], axis=1)

#: the bf16 rung of B.3 against its plain version on the card, max |error|
#: over the largest |entry| of each output: the CPU tests' tolerance of the
#: plain version against JAX (both sum exact products of bf16 operands in
#: float32, in another order)
TOL_WOODBURY_BF16 = 1e-5
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_PEAK_OPS = 989e12
#: the MAP fit over the GWB's amplitude and slope, started off the
#: flagship recipe's truth (-14.0, 4.33), and card vs CPU at SMALL (x and
#: sigma, relative)
MAP_START = {"gwb_log10_amplitude": -14.4, "gwb_gamma": 4.0}
TOL_MAP_CARD_VS_CPU = 1e-6
#: calls per candidate of the tuner's search on the card
TUNER_REPS = 20
#: the MAP fit over a covariance recipe (A.24): configs B and D over these
#: axes, started MAP_COV_OFFSET above the recipe's values; at the start,
#: the gradient against central differences of the value and the Hessian
#: against central differences of the gradient (step FD_STEP in each
#: axis), each relative to its largest entry
MAP_COV_AXES = ("cov_log10_sigma", "gwb_log10_amplitude")
MAP_COV_OFFSET = 0.2
FD_STEP = 1e-4
TOL_FD_GRAD, TOL_FD_HESS = 1e-5, 1e-4
#: the JAX package's covariance round trip (benchmarks/cov_solve.py:175-223):
#: EFAC 1.1, red noise (10 modes, slope 4), banded noise with the truths
#: below, no GWB; fit from the truths + 0.25 with a constant design column,
#: each within ROUND_TRIP_Z Fisher sigma. Card vs CPU runs it at
#: MAP_COV_SMALL on both rungs (the dense one with the Kronecker op and
#: ECORR of tests/test_covariance.py)
ROUND_TRIP_TRUTH = {"cov_log10_sigma": -6.3, "rn_log10_amplitude": -13.3}
ROUND_TRIP_BANDED = dict(rho=0.6, corr_s=40 * DAY_S, block=16)
ROUND_TRIP_KRON = dict(channels=4, time_ell_s=20 * DAY_S, chan_rho=0.8)
ROUND_TRIP_LOG10_ECORR = -6.6
ROUND_TRIP_START, ROUND_TRIP_Z = 0.25, 3.0
MAP_COV_SMALL = dict(npsr=2, ntoa=128, nbackend=2, seed=3)
#: the plain versions that no covariance gradient or Hessian may reach on
#: the card, by module
COV_PLAIN_VERSIONS = (
    (ops_gp, ("tridiag_forward_plain", "tridiag_forward_solve_plain", "tridiag_backward_plain",
              "tridiag_factor_adjoint_plain", "tridiag_factor_adjoint_vjp_plain")),
    (cw, ("cov_syrk_plain",)),
)
ADJOINT_KERNELS = ("tridiag_factor_adjoint", "tridiag_factor_adjoint_vjp")

#: the counter of each block-tridiagonal sweep checked in cov_kernels
TRIDIAG_COUNTER = {"factor": "tridiag_factor_solve_fwd", "factor_solve": "tridiag_factor_solve_fwd",
                   "solve": "tridiag_solve_fwd", "backward": "tridiag_factor_solve_bwd"}


#: the script's start: each phase line carries its seconds since (``at_s``),
#: so the script's time is read phase by phase
_T_START = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _T_START}),
          flush=True)


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
    (ops/cw.py::cw_catalog_operations) over the peak rate of the dtype, or
    bytes (cw_catalog_bytes: times in, sum out, planes in; each once) over
    HBM bandwidth."""
    size = torch.finfo(dtype).bits // 8
    ops_ms = cw.cw_catalog_operations(npsr, ntoa, nsrc, psr_term, evolve) / PEAK_OPS[dtype] * 1e3
    bytes_ms = cw.cw_catalog_bytes(npsr, ntoa, nsrc, size) / PEAK_BYTES * 1e3
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
    """Build every source at once; then the CW kernel's instruction account:
    the SASS of each instance's loop over sources, by class, every path
    once and each called routine at its call site (kernels/cw_study.py),
    with the card's maximum SM clock. Returns
    ``(counts, clock_mhz)``, or ``(None, None)`` where the toolkit has no
    cuobjdump (the rows then say "not measured")."""
    t0 = time.perf_counter()
    names = build.sources()
    build.build_all(names)
    ptxas = {n: [l.strip() for l in build.ptxas_reports.get(n, "").splitlines()
                 if "Used" in l or "spill" in l] for n in names}
    seconds = time.perf_counter() - t0
    sass = clock = None
    if Path(cw_study.cuobjdump()).is_file():
        sass = cw_study.sass_loop_counts(build.library_path("cw_catalog"))
        clock = cw_study.sm_clock_mhz()["max"]
    emit("build", sources=names, seconds=seconds, ptxas=ptxas, sm_clock_max_mhz=clock,
         cw_sass_per_element=None if sass is None else {
             "/".join(map(str, key)): cw_study.per_element(c) for key, c in sass.items()})
    return sass, clock


def _cw_account(sass, clock, dtype, psr_term, evolve, elements):
    """instructions_per_element (every path of the loop once, each called
    routine at its call site; instructions_called of them in called
    routines) and issue_ms, their issue time: an upper estimate, since the
    count includes code that no element takes. From the build's SASS count
    for one CW launch of ``elements`` elements, or "not measured"."""
    if sass is None:
        return dict(instructions_per_element="not measured", issue_ms="not measured")
    per = cw_study.per_element(sass[str(dtype).replace("torch.", ""), psr_term, evolve])
    ms, pipe = cw_study.issue_ms(per, elements,
                                 torch.cuda.get_device_properties(0).multi_processor_count, clock)
    return dict(instructions_per_element=per["total"], instructions_called=per["called"],
                issue_ms=ms, issue_pipe=pipe)


def _catalog_planes(batch, params, evolve, tref_s):
    return B.cw_catalog_planes_for(batch, *params, pdist=1.0, evolve=evolve,
                                   tref_s=tref_s)[:2]


def phase_kernels(shape, population_params, sass, clock):
    """Kernel vs plain at the flagship shape, both dtypes, both phase
    models, with and without the pulsar term, on the workload's own
    catalog and on a stress catalog whose sources merge inside the span
    (the NaN guard) or before the fold (valid = 0); and on the population
    catalog (``population_params``: POPULATION's own 10,000 sources) in
    the chirped pulsar-term mode. Each row: the wrapper's time (the fold kernel and the response
    kernel, as the path calls them), each kernel alone, the plain version's
    time, the bound and the instruction account; the fold's planes against
    its plain version (cw_kernel_planes, bit for bit); float32 rows also
    against the float64 kernel. Returns the rows by (dtype, catalog,
    evolve, psr_term)."""
    rng = np.random.default_rng(6)
    n = shape["ncw"] // 2
    stress = np.stack([
        np.arccos(rng.uniform(-1, 1, n)), rng.uniform(0, 2 * np.pi, n),
        10 ** rng.uniform(8.5, 9.8, n), rng.uniform(10, 500, n),
        10 ** rng.uniform(-8.0, -7.0, n), rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0, np.pi, n), np.arccos(rng.uniform(-1, 1, n)),
    ])
    lib = build.load("cw_catalog", cw._bind)
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
            if evolve:
                catalogs["population"] = _catalog_planes(batch, population_params, evolve, 0.0)
            for name, (src, psr) in catalogs.items():
                for psr_term in (True, False):
                    if name == "population" and not psr_term:
                        continue
                    key = (name, evolve, psr_term)
                    run = lambda: cw.cw_catalog_response(u, src, psr, psr_term, evolve)
                    plain = lambda: cw.cw_catalog_response_plain(u, src, psr, psr_term, evolve)
                    if name == "population":  # ~2 s a call: timed once
                        want, plain_ms = _once_ms(plain)
                    else:
                        want, plain_ms = plain(), cuda_ms(plain, 3)
                    got, again = run(), run()
                    torch.cuda.synchronize()
                    err = rel_rms(got, want)
                    nsrc = src.shape[1]
                    bound, bound_by = cw_bound(*u.shape, nsrc, dtype, psr_term, evolve)
                    planes = cw._cw_fold(lib, src, psr, psr_term, evolve)
                    fold_exact = bool(torch.equal(planes, cw.cw_kernel_planes(src, psr, psr_term,
                                                                              evolve)))
                    reps = CW_REPS[name]
                    row = dict(catalog=name, dtype=str(dtype), shape=[*u.shape, nsrc],
                               evolve=evolve, psr_term=psr_term, rel_rms=err, tol=TOL[dtype],
                               max_abs_err=float((got - want).abs().max()),
                               finite=bool(torch.isfinite(got).all()),
                               same_bits=bool(torch.equal(got, again)),
                               ms=cuda_ms(run, reps),
                               kernel_ms=cuda_ms(lambda: cw._cw_launch(lib, u, planes, psr_term,
                                                                       evolve), reps),
                               fold_ms=cuda_ms(lambda: cw._cw_fold(lib, src, psr, psr_term, evolve),
                                               reps),
                               fold_equals_plain=fold_exact,
                               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                               **_cw_account(sass, clock, dtype, psr_term, evolve,
                                             u.numel() * nsrc))
                    del want, again, planes
                    if dtype == torch.float64:
                        k64[key] = got
                    else:
                        row["rel_rms_vs_float64_kernel"] = rel_rms(got, k64.pop(key))
                        require(row["rel_rms_vs_float64_kernel"] <= TOL_F32_VS_F64,
                                f"float32 kernel vs float64 kernel {key}: {row}")
                    emit("kernel_vs_plain", **row)
                    require(row["finite"] and err <= TOL[dtype] and row["same_bits"]
                            and fold_exact, f"kernel vs plain {key} {dtype}: {row}")
                    results[(str(dtype), *key)] = row
    torch.cuda.empty_cache()  # the population rows' large temporaries
    return results


def phase_cw_population(batch, recipe, sass, clock):
    """deterministic_delays through the entry point on the population
    workload (POPULATION: 68 x 7,758 x 10,000), float32, with the launch
    counts cleared just before and read just after; then, apart, the host
    plane build (float64 numpy and the copy to the card), the wrapper (the
    fold and the response kernels) and each kernel alone."""
    torch.cuda.synchronize()
    launches.clear()
    static = deterministic_delays(batch, recipe)
    torch.cuda.synchronize()
    count, fold_count = launches["cw_catalog_response"], launches["cw_fold_planes"]
    _, static_ms = _timed_ms(lambda: deterministic_delays(batch, recipe))
    params = recipe.cgw_params.cpu().unbind(0)
    build_planes = lambda: B.cw_catalog_planes_for(
        batch, *params, pdist=1.0, evolve=recipe.cgw_evolve,
        phase_approx=recipe.cgw_phase_approx, tref_s=recipe.cgw_tref_s)
    (src, psr, evolve), planes_build_ms = _timed_ms(build_planes)
    u = batch.toas_s - torch.tensor(batch.start_s, dtype=batch.dtype, device=batch.device)
    psr_term = recipe.cgw_psr_term
    lib = build.load("cw_catalog", cw._bind)
    planes = cw._cw_fold(lib, src, psr, psr_term, evolve)
    elements = u.numel() * src.shape[1]
    row = dict(shape=POPULATION, dtype=str(batch.dtype), psr_term=psr_term, evolve=evolve,
               static_ms=static_ms, planes_build_ms=planes_build_ms,
               response_ms=cuda_ms(lambda: cw.cw_catalog_response(u, src, psr, psr_term, evolve),
                                   CW_REPS["population"]),
               fold_ms=cuda_ms(lambda: cw._cw_fold(lib, src, psr, psr_term, evolve),
                               CW_REPS["population"]),
               kernel_ms=cuda_ms(lambda: cw._cw_launch(lib, u, planes, psr_term, evolve),
                                 CW_REPS["population"]),
               bound_ms=cw_bound(*u.shape, src.shape[1], batch.dtype, psr_term, evolve)[0],
               **_cw_account(sass, clock, batch.dtype, psr_term, evolve, elements),
               cw_launches=count, fold_launches=fold_count,
               finite=bool(torch.isfinite(static).all()),
               nonzero=bool(static.abs().max() > 0), output_shape=list(static.shape))
    del static, src, psr, planes
    torch.cuda.empty_cache()
    emit("cw_population", **row)
    require(count > 0 and fold_count > 0,
            f"the population catalog never launched the CW kernels: {row}")
    require(row["finite"] and row["nonzero"], f"population delays not finite or empty: {row}")


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
    count = launches["cw_catalog_response"], launches["cw_fold_planes"]

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
        cw_launches=count[0], fold_launches=count[1],
    )
    emit("main_path", **row)
    require(min(count) > 0, f"the main path never launched the CW kernels: {count}")
    require(row["finite"] and row["static_finite"] and bool(static.abs().max() > 0),
            f"main path output not finite or CW catalog empty: {row}")
    require(tuple(res.shape) == (CHUNK, shape["npsr"], shape["ntoa"]),
            f"residual shape {tuple(res.shape)}")
    require(fit_mean <= TOL_FIT_MEAN, f"fit leaves a weighted mean (TF32?): {fit_mean}")
    return batch, recipe, static, generator, count, res


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


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _timed_ms(fn, reps=3):
    """(result, median host milliseconds) of ``reps`` calls, each ending
    synchronised."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def _device_busy(fn):
    """Share of one synchronised call's wall time during which the card
    ran a kernel (torch.profiler's device time, one stream, so kernels do
    not overlap), and every kernel's device milliseconds, the most first;
    (None, []) when the profiler records no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_ms = _timed_ms(fn, reps=1)
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]  # kernels, not ops
    device_ms = sum(ms for _, ms in rows)
    rows = sorted(rows, key=lambda kv: -kv[1])
    return (device_ms / wall_ms if device_ms > 0 else None), [[k, ms] for k, ms in rows]


def woodbury_bound(npsr, ntoa, q, dtype):
    """Least time for the fused Woodbury assembly on this card: its
    operations (ops/gp.py::woodbury_operations) over the dtype's peak
    rate, or its bytes (woodbury_bytes: T, w, r read once, the three
    outputs written once) over HBM bandwidth."""
    size = torch.finfo(dtype).bits // 8
    ops_ms = ops_gp.woodbury_operations(npsr, ntoa, q) / WOODBURY_PEAK_OPS[dtype] * 1e3
    bytes_ms = ops_gp.woodbury_bytes(npsr, ntoa, q, size) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def chromatic_recipe(batch, recipe):
    """The flagship recipe plus a 30-mode chromatic (index 2) block."""
    rng = np.random.default_rng(CHROM_SEED)
    return dataclasses.replace(
        recipe, chrom_log10_amplitude=rng.uniform(-14.0, -13.2, batch.npsr),
        chrom_gamma=rng.uniform(2.0, 4.0, batch.npsr), chrom_index=np.array(2.0),
        chrom_nmodes=30).to(batch.device)


def _woodbury_operands(batch, recipe, design):
    """B.3's operands at a likelihood path's own shape, float64: the
    stacked basis T of the fused build, the white inverse variances with a
    tenth of the rows masked (w = 0), random residuals."""
    reduced, _ = lgp.ReducedGP.build_fused(batch, recipe, design=design)
    winv = B.white_ecorr_parts(batch, reduced.sigma2, None, torch.float64)[0]
    rng = np.random.default_rng(7)
    keep = torch.as_tensor(rng.random(tuple(winv.shape)) > 0.1, device=winv.device)
    r64 = torch.as_tensor(rng.standard_normal(tuple(winv.shape)) * 1e-6, device=winv.device)
    return reduced.T, winv * keep, r64


def phase_woodbury_kernel(batch, recipe, design, basis):
    """Kernel vs plain at a likelihood path's own shape: the stacked basis
    T (68 x 7,758 x Q) and white inverse variances of the float64
    flagship, a tenth of the rows masked (w = 0), random residuals; Nt =
    7,758 is no multiple of any tile. Both dtypes; two kernel runs must
    give the same bits; the float64 call is also read by the profiler
    (device time per kernel). Returns the float64 row (the path's dtype)."""
    operands64 = _woodbury_operands(batch, recipe, design)
    rows = {}
    for dtype in (torch.float64, torch.float32):
        T, w, r = (x.to(dtype).contiguous() for x in operands64)
        run = lambda: ops_gp.fused_woodbury_update(T, w, r)
        plain = lambda: ops_gp.fused_woodbury_plain(T, w, r)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        A = torch.cat([T, r[..., None]], dim=-1)  # [T | r], built before timing
        WA = A * w[..., None]
        At = A.transpose(1, 2)
        library = lambda: torch.bmm(At, WA)
        lib_out = library()
        q = T.shape[-1]
        errs = [_rel_max(g, x) for g, x in zip(got, want)]
        bound, bound_by = woodbury_bound(*T.shape, dtype)
        sms = torch.cuda.get_device_properties(T.device).multi_processor_count
        row = dict(
            basis=basis, dtype=str(dtype), shape=list(T.shape), masked_rows=int((w == 0).sum()),
            plan=dict(zip(("panels", "pairs", "nsplit", "workspace_entries"),
                          ops_gp.woodbury_plan(*T.shape, sms))),
            rel_err_tnt=errs[0], rel_err_d=errs[1], rel_err_rnr=errs[2], tol=TOL_WOODBURY[dtype],
            max_abs_err=max(float((g - x).abs().max()) for g, x in zip(got, want)),
            symmetric=bool(torch.equal(got[0], got[0].transpose(-1, -2))),
            same_bits=all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            finite=all(bool(torch.isfinite(g).all()) for g in got),
            rel_err_library_tnt=_rel_max(lib_out[:, :q, :q], got[0]),
            ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 20),
            bound_ms=bound, bound_by=bound_by,
        )
        if dtype == torch.float64:
            row["profiler_kernels_ms"] = _device_busy(run)[1][:5]
        emit("woodbury_kernel_vs_plain", **row)
        require(row["finite"] and max(errs) <= TOL_WOODBURY[dtype],
                f"woodbury kernel vs plain {dtype}: {row}")
        require(row["same_bits"] and row["symmetric"],
                f"woodbury kernel not deterministic or not symmetric {dtype}: {row}")
        rows[dtype] = row
        del A, WA, At, got, again, want, lib_out
    return rows[torch.float64]


def woodbury_bf16_bound(npsr, ntoa, q, dtype):
    """Least time for the bf16 rung on this card: the full Gram of [T |
    r] (ops/gp.py::woodbury_operations, "bf16") at the bf16 tensor-core
    peak, or its bytes (woodbury_bytes, "bf16": T, w, r read once in their
    dtype, the float32 outputs written once) over HBM bandwidth."""
    size = torch.finfo(dtype).bits // 8
    ops_ms = ops_gp.woodbury_operations(npsr, ntoa, q, "bf16") / BF16_PEAK_OPS * 1e3
    bytes_ms = ops_gp.woodbury_bytes(npsr, ntoa, q, size, "bf16") / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _bf16_library(T, w, r):
    """One torch.bmm of the bf16 operands bf16([T | r])^T bf16(w [T | r]),
    built before timing, with float32 output (``out_dtype``)."""
    A = torch.cat([T, r[..., None]], dim=-1)
    At = A.to(torch.bfloat16).transpose(1, 2)
    WA = (A * w[..., None]).to(torch.bfloat16)
    return lambda: torch.bmm(At, WA, out_dtype=torch.float32)


def _bf16_library_convert(T, w, r):
    """The conversion and the torch.bmm together: A.to(bf16), (A w).to(bf16)
    and bmm from [T | r] in the input dtype (A built before timing)."""
    A = torch.cat([T, r[..., None]], dim=-1)
    return lambda: torch.bmm(A.to(torch.bfloat16).transpose(1, 2),
                             (A * w[..., None]).to(torch.bfloat16), out_dtype=torch.float32)


def phase_woodbury_bf16(batch, recipe, design, basis, dtypes):
    """The bf16 rung of B.3 (precision="bf16") against its plain version
    on the card at a likelihood path's shape, with float64 and float32
    inputs (``dtypes``): TOL_WOODBURY_BF16, two runs bitwise equal, finite,
    and T^T W T asymmetric as the reference's (its largest |X - X^T| over
    the largest |X|). Returns the rows by dtype."""
    operands64 = _woodbury_operands(batch, recipe, design)
    rows = {}
    for dtype in dtypes:
        T, w, r = (x.to(dtype).contiguous() for x in operands64)
        run = lambda: ops_gp.fused_woodbury_update(T, w, r, precision="bf16")
        plain = lambda: ops_gp.fused_woodbury_plain(T, w, r, precision="bf16")
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        library = _bf16_library(T, w, r)
        library()
        library_convert = _bf16_library_convert(T, w, r)
        errs = [_rel_max(g, x) for g, x in zip(got, want)]
        bound, bound_by = woodbury_bf16_bound(*T.shape, dtype)
        sms = torch.cuda.get_device_properties(T.device).multi_processor_count
        tnt = got[0]
        plan = ops_gp.woodbury_plan(*T.shape, sms, "bf16")
        size = T.element_size()
        row = dict(
            basis=basis, input_dtype=str(dtype), shape=list(T.shape),
            plan=dict(zip(("panels", "pairs", "nsplit", "workspace_entries"), plan),
                      grid=ops_gp.woodbury_bf16_grid(T.shape[0], T.shape[2], plan[2], size)._asdict(),
                      staged_over_t=ops_gp.woodbury_bf16_staged_bytes(*T.shape, size)
                      / (T.numel() * size)),
            rel_err_tnt=errs[0], rel_err_d=errs[1], rel_err_rnr=errs[2], tol=TOL_WOODBURY_BF16,
            max_abs_err=max(float((g - x).abs().max()) for g, x in zip(got, want)),
            asymmetry=float((tnt - tnt.transpose(-1, -2)).abs().max() / tnt.abs().max()),
            output_dtype=str(tnt.dtype),
            same_bits=all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            finite=all(bool(torch.isfinite(g).all()) for g in got),
            ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 20),
            library_convert_ms=cuda_ms(library_convert, 20), bound_ms=bound, bound_by=bound_by,
        )
        emit("woodbury_kernel_vs_plain_bf16", **row)
        require(row["finite"] and max(errs) <= TOL_WOODBURY_BF16,
                f"woodbury bf16 kernel vs plain {dtype}: {row}")
        require(row["same_bits"] and row["asymmetry"] > 0 and tnt.dtype == torch.float32,
                f"woodbury bf16 kernel not deterministic, symmetric or not float32: {row}")
        rows[dtype] = row
        del got, again, want, tnt
    return rows


def phase_likelihood_bf16(bank, batch, recipe, design, ll):
    """The bf16 rung on the flagship f64 bank (200 x 8 x 8): arm the
    numerics ledger, run the f64 fused bank call, write the capture to a
    temporary directory and disarm; bf16 without the capture must raise
    PrecisionNotReady; then the bank and grid calls with the capture, the
    bf16 launches counted around them (> 0, the highest kernel's 0).
    Measured, not gated: the finite share and the relative deviation from
    the f64 log L ``ll`` (the float32 reduced algebra may lose
    definiteness), and the finite share without the design (S alone)."""
    grid, shape = lk.grid_cartesian(LIKELIHOOD_GRID)
    capture = tempfile.mkdtemp(prefix="chip_smoke_numerics_")
    try:
        numerics.reset()
        numerics.arm()
        lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design, fused=True)
        doc = json.loads(Path(numerics.write(capture)).read_text())
        numerics.disarm()
        verdict = numerics.ladder_verdict(doc)
        refused = False
        try:
            lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design, precision="bf16")
        except lgp.PrecisionNotReady:
            refused = True
        call = lambda: lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design,
                                             precision="bf16", numerics_capture=capture)
        launches.clear()
        ll16 = call().cpu()
        ll16_one = lk.grid_loglikelihood(bank[0], batch, recipe, grid, design=design,
                                         precision="bf16", numerics_capture=capture).cpu()
        counts = launches["fused_woodbury_update_bf16"], launches["fused_woodbury_update"]
        # without the design: whether S alone (the GP block) still factors
        free = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, precision="bf16",
                                     numerics_capture=capture)
        _, call_ms = _timed_ms(call)
        _, build_ms = _timed_ms(lambda: lgp.ReducedGP.build(batch, recipe, design=design,
                                                             precision="bf16"))
    finally:
        numerics.reset()
        shutil.rmtree(capture, ignore_errors=True)
    finite = torch.isfinite(ll16)
    rel = ((ll16 - ll).abs() / ll.abs())[finite]
    row = dict(
        bank_shape=list(bank.shape), grid_shape=list(shape),
        verdict={site: ("ready" if v["ready"] else v["reasons"]) for site, v in verdict.items()},
        sites_headroom_bits={k: v["headroom_bits"] for k, v in doc["sites"].items()},
        refused_without_capture=refused, bf16_launches=counts[0], highest_launches=counts[1],
        call_ms=call_ms, build_ms=build_ms, evals_per_s=ll16.numel() / (call_ms / 1e3),
        output_shape=list(ll16.shape), output_dtype=str(ll16.dtype),
        finite_share=float(finite.double().mean()),
        rel_vs_float64_median=float(rel.median()) if rel.numel() else None,
        rel_vs_float64_max=float(rel.max()) if rel.numel() else None,
        grid_finite_share=float(torch.isfinite(ll16_one).double().mean()),
        finite_share_without_design=float(torch.isfinite(free).double().mean()),
    )
    emit("likelihood_bf16", **row)
    require(all(verdict[s]["ready"] for s in lgp.FUSED_PRECISION_SITES),
            f"the armed f64 capture does not clear the fused sites: {row}")
    require(refused, "precision='bf16' ran without a numerics capture")
    require(counts[0] > 0 and counts[1] == 0,
            f"the bf16 calls did not launch only the bf16 kernel: {row}")
    require(tuple(ll16.shape) == tuple(ll.shape), f"bf16 likelihood output: {row}")
    return counts[0]


def phase_tuner_woodbury(batch, recipe, design):
    """tuner.autotune at the flagship Q = 123 in f64 highest and in bf16,
    into a temporary cache: each candidate split count's CUDA-event ms;
    the lookup must return the winner."""
    T, w, r = _woodbury_operands(batch, recipe, design)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_tuner_"))
    try:
        rows = {}
        for precision in ("highest", "bf16"):
            choice = tuner.autotune(T, w, r, precision, reps=TUNER_REPS,
                                    cache_path=str(workdir / "cache.json"))
            lookup = tuner.woodbury_knob(T, precision, cache_path=str(workdir / "cache.json"))
            rows[precision] = dict(
                winner=choice["nsplit"], lookup=lookup, bucket=choice["bucket"],
                candidates_ms={str(s["nsplit"]): s["seconds"] * 1e3 for s in choice["scored"]},
                plan=ops_gp.woodbury_plan(*T.shape, torch.cuda.get_device_properties(
                    T.device).multi_processor_count, precision)[2])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("tuner_woodbury", shape=list(T.shape), reps=TUNER_REPS, **rows)
    for precision, row in rows.items():
        require(row["lookup"] == {"nsplit": row["winner"]},
                f"the tuner's lookup does not return its winner ({precision}): {row}")


def phase_map_fit(batch, recipe, generator):
    """map_fit on the card: the flagship f64 residuals of one realization
    (fitted, priced with the quadratic design) over the GWB's amplitude
    and slope, started off the truth. Gate: converged and finite."""
    design = B.quadratic_design(batch)
    res = realize(generator, batch, recipe, 1, fit=True)[0]
    names = tuple(sorted(MAP_START))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = lk.map_fit(res, batch, recipe, MAP_START, design=design)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    value_and_grad, hessian = map_objective(res, batch, recipe, names, design, batch.device)
    _, vg_ms = _timed_ms(lambda: value_and_grad(fit.x))
    _, hess_ms = _timed_ms(lambda: hessian(fit.x))
    row = dict(shape=[int(n) for n in res.shape], start=MAP_START, **fit.as_dict(),
               fit_s=fit_s, value_and_grad_ms=vg_ms, hessian_ms=hess_ms, peak_memory_gib=peak)
    emit("map_fit", **row)
    require(fit.converged and np.all(np.isfinite(fit.x)) and np.all(np.isfinite(fit.sigma)),
            f"map_fit on the card: {row}")


def phase_map_fit_card_vs_cpu(shape):
    """map_fit at ``shape`` on the card and on the CPU, f64, on the same
    residuals: x and sigma within TOL_MAP_CARD_VS_CPU, the same iterations."""
    cb, cr = flagship_workload(**shape, dtype=torch.float64, device="cpu")
    gb, gr = flagship_workload(**shape, dtype=torch.float64)
    rng = np.random.default_rng(4)
    noise = {k: rng.standard_normal((1,) + s) for k, s in B.noise_shapes(cb, cr).items()}
    res = realize(None, cb, cr, 1, fit=True, noise=noise, device="cpu")[0]
    ref = lk.map_fit(res, cb, cr, MAP_START, design=B.quadratic_design(cb), device="cpu")
    got = lk.map_fit(res, gb, gr, MAP_START, design=B.quadratic_design(gb))
    row = dict(shape=shape, iterations=[got.iterations, ref.iterations],
               converged=[got.converged, ref.converged],
               rel_x=float(np.max(np.abs(got.x - ref.x) / np.abs(ref.x))),
               rel_sigma=float(np.max(np.abs(got.sigma - ref.sigma) / np.abs(ref.sigma))),
               tol=TOL_MAP_CARD_VS_CPU)
    emit("map_fit_card_vs_cpu", **row)
    require(got.iterations == ref.iterations and got.converged and ref.converged
            and max(row["rel_x"], row["rel_sigma"]) <= TOL_MAP_CARD_VS_CPU,
            f"map_fit card vs CPU: {row}")


def phase_likelihood_chromatic(batch, recipe, generator):
    """A bank of CHROM_BANK float64 realizations with the chromatic block,
    priced over the 4 x 4 GWB grid through the fused route (the Q = 183
    Woodbury kernel; launches counted from zero around the call) and the
    composed one."""
    design = B.quadratic_design(batch)
    bank = realize(generator, batch, recipe, CHROM_BANK, fit=True)
    grid, shape = lk.grid_cartesian(DENSE_GRID)
    launches.clear()
    ll = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design, fused=True).cpu()
    count = launches["fused_woodbury_update"]
    ll_c = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design).cpu()
    rel = float(((ll - ll_c).abs() / ll_c.abs()).max())
    row = dict(bank_shape=list(bank.shape), grid_shape=list(shape),
               basis_columns=3 + int(lgp.phi_for_recipe(batch, recipe).shape[-1]),
               woodbury_launches=count, rel_fused_vs_composed=rel, tol=TOL_LIKELIHOOD,
               finite=bool(torch.isfinite(ll).all()), output_shape=list(ll.shape))
    emit("likelihood_chromatic", **row)
    require(count == 1, f"the chromatic bank did not launch the Woodbury kernel once: {row}")
    require(row["finite"] and rel <= TOL_LIKELIHOOD, f"chromatic fused vs composed: {row}")


def phase_likelihood(bank, batch, recipe, design):
    """The likelihood path on the main path's bank (200 realizations,
    cast to float64): bank_loglikelihood(fused=True) over the 8 x 8 GWB
    grid, then grid_loglikelihood(fused=True) on one realization, with
    the launch counts cleared just before and read just after. Then the
    same calls composed, for the check, and each stage timed alone."""
    grid, shape = lk.grid_cartesian(LIKELIHOOD_GRID)
    G, R = int(np.prod(shape)), bank.shape[0]
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    t0 = time.perf_counter()
    ll = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design, fused=True)
    ll_host = ll.cpu()
    first_s = time.perf_counter() - t0
    ll_one = lk.grid_loglikelihood(bank[0], batch, recipe, grid, design=design, fused=True)
    ll_one_host = ll_one.cpu()
    count = launches["fused_woodbury_update"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    ll_c = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design).cpu()
    ll_one_c = lk.grid_loglikelihood(bank[0], batch, recipe, grid, design=design).cpu()
    rel = float(((ll_host - ll_c).abs() / ll_c.abs()).max())
    rel_one = float(((ll_one_host - ll_one_c).abs() / ll_one_c.abs()).max())
    rel_row0 = float(((ll_one_host - ll_host[:, 0]).abs() / ll_host[:, 0].abs()).max())

    call = lambda: lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design, fused=True)
    _, call_ms = _timed_ms(call)
    reduced, build_ms = _timed_ms(lambda: lgp.ReducedGP.build(
        batch, recipe, design=design, fused=True))
    proj, project_ms = _timed_ms(lambda: reduced.project(bank, batch))
    names, theta = _theta_block(grid, batch.dtype, batch.device)
    _, grid_ms = _timed_ms(lambda: _reduced_points(theta, names, reduced, proj, batch, recipe))
    phi, phi_ms = _timed_ms(lambda: torch.stack([
        lgp.phi_for_recipe(batch, dataclasses.replace(recipe, **dict(zip(names, th))))
        for th in theta]))
    _, factor_solve_ms = _timed_ms(lambda: reduced.loglikelihood(proj, phi))
    busy_share, top_kernels = _device_busy(call)
    best = np.unravel_index(int(ll_host.mean(dim=1).argmax()), shape)
    row = dict(
        bank_shape=list(bank.shape), grid_shape=list(shape), basis_columns=int(reduced.TNT.shape[-1]),
        evaluations=G * R, evals_per_s=G * R / (call_ms / 1e3),
        evals_per_s_grid_only=G * R / (grid_ms / 1e3), first_call_s=first_s,
        call_ms=call_ms, build_ms=build_ms, project_ms=project_ms, grid_ms=grid_ms,
        grid_phi_ms=phi_ms, grid_factor_solve_ms=factor_solve_ms,
        device_busy_share=busy_share, top_kernels_ms=top_kernels[:5],
        peak_memory_gib=peak_gib, woodbury_launches=count,
        rel_fused_vs_composed=rel, rel_grid_fused_vs_composed=rel_one,
        rel_grid_vs_bank_row=rel_row0, tol=TOL_LIKELIHOOD,
        finite=bool(torch.isfinite(ll_host).all()), output_shape=list(ll_host.shape),
        best_mean_point={k: float(LIKELIHOOD_GRID[k][i]) for k, i in zip(LIKELIHOOD_GRID, best)},
    )
    emit("likelihood", **row)
    require(count > 0, "the likelihood path never launched the fused Woodbury kernel")
    require(row["finite"] and tuple(ll_host.shape) == (G, R), f"likelihood output: {row}")
    require(max(rel, rel_one, rel_row0) <= TOL_LIKELIHOOD, f"fused vs composed likelihood: {row}")
    return count, ll_host


def phase_likelihood_float32(bank, batch, recipe, ll):
    """Measured, not gated: the same bank and grid through the fused
    path in float32 (the main path's own batch). The Gram entries reach
    Nt / sigma^2 ~ 1e16 against 1/phi on the diagonal, so a float32 S may
    lose definiteness (its entries come out NaN)."""
    grid, _ = lk.grid_cartesian(LIKELIHOOD_GRID)
    call = lambda: lk.bank_loglikelihood(bank.float(), batch, recipe, grid=grid,
                                         design=B.quadratic_design(batch), fused=True)
    ll32, call_ms = _timed_ms(call)
    ll32 = ll32.double().cpu()
    finite = torch.isfinite(ll32)
    rel = ((ll32 - ll).abs() / ll.abs())[finite]
    emit("likelihood_float32", call_ms=call_ms, finite_share=float(finite.double().mean()),
         rel_vs_float64_median=float(rel.median()) if rel.numel() else None,
         rel_vs_float64_max=float(rel.max()) if rel.numel() else None)


def phase_likelihood_server(bank, batch, recipe, design, ll):
    """SERVER_REQUESTS requests through the LikelihoodServer, submitted
    at once after a warm-up request; each answer row must equal the
    bank_loglikelihood row of its grid point."""
    grid, _ = lk.grid_cartesian(LIKELIHOOD_GRID)
    axes = tuple(sorted(LIKELIHOOD_GRID))
    point = lambda i: {k: float(grid[k][i]) for k in axes}
    t0 = time.perf_counter()
    server = lk.LikelihoodServer(lk.RealizationBank.from_array(bank), batch, recipe, axes,
                                 design=design, max_batch=SERVER_BATCH)
    setup_s = time.perf_counter() - t0
    with server:
        server.evaluate(**point(0))
        server.reset_stats()
        futures = [server.submit(**point(i)) for i in range(SERVER_REQUESTS)]
        rows = [f.result(timeout=600) for f in futures]
        stats = server.stats()
    rel = max(float(np.max(np.abs(rows[i] - ll[i].numpy()) / np.abs(ll[i].numpy())))
              for i in range(SERVER_REQUESTS))
    row = dict(requests=SERVER_REQUESTS, max_batch=SERVER_BATCH, setup_s=setup_s,
               rel_vs_bank=rel, tol=TOL_LIKELIHOOD, batches=stats["batches"],
               coalesce_efficiency=stats["coalesce_efficiency"],
               latency_p50_ms=stats["latency"]["p50"] * 1e3,
               latency_p99_ms=stats["latency"]["p99"] * 1e3,
               evals_per_s=stats["evals_per_s"], requests_per_s=stats["requests_per_s"])
    emit("likelihood_server", **row)
    require(rel <= TOL_LIKELIHOOD and stats["requests"] == SERVER_REQUESTS,
            f"server answers vs bank_loglikelihood: {row}")


def phase_likelihood_card_vs_cpu(shape):
    """A small bank through the likelihood path on the card (kernel) and
    on the CPU (plain version), both float64, on the same residuals."""
    cb, cr = flagship_workload(**shape, dtype=torch.float64, device="cpu")
    gb, gr = flagship_workload(**shape, dtype=torch.float64)
    rng = np.random.default_rng(2)
    noise = {k: rng.standard_normal((SMALL_BANK,) + s) for k, s in B.noise_shapes(cb, cr).items()}
    bank = realize(None, cb, cr, SMALL_BANK, fit=True, noise=noise, device="cpu")
    grid, _ = lk.grid_cartesian({k: v[::2] for k, v in LIKELIHOOD_GRID.items()})
    ref = lk.bank_loglikelihood(bank, cb, cr, grid=grid, design=B.quadratic_design(cb),
                                fused=True, device="cpu")
    got = lk.bank_loglikelihood(bank, gb, gr, grid=grid, design=B.quadratic_design(gb),
                                fused=True).cpu()
    row = dict(shape=shape, nreal=SMALL_BANK, grid_points=int(ref.shape[0]),
               rel_card_vs_cpu=float(((got - ref).abs() / ref.abs()).max()), tol=TOL_LIKELIHOOD)
    emit("likelihood_card_vs_cpu", **row)
    require(row["rel_card_vs_cpu"] <= TOL_LIKELIHOOD, f"likelihood card vs CPU: {row}")


def _once_ms(fn):
    """(result, device milliseconds) of one call, CUDA events, no warm-up:
    for a plain version, whose many small launches make a repeat costly."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _kernel_row(run, plain, dtype, bound):
    """Kernel vs plain on the same inputs: the largest |error| over the
    largest |reference entry| of each output, two kernel runs bitwise
    equal, finite outputs, the plain version's time (its one call) and the
    bound. The caller times the kernel."""
    want, plain_ms = _once_ms(plain)
    got, again = run(), run()
    torch.cuda.synchronize()
    got, again, want = (x if isinstance(x, tuple) else (x,) for x in (got, again, want))
    errs = [_rel_max(g, w) for g, w in zip(got, want)]
    row = dict(
        dtype=str(dtype), rel_err=max(errs), tol=TOL_COV[dtype],
        max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
        same_bits=all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
        finite=all(bool(torch.isfinite(g).all()) for g in got),
        bound_ms=bound[0], bound_by=bound[1], plain_ms=plain_ms,
    )
    del got, again, want
    return row


def _bound(ops, nbytes, dtype):
    ops_ms = ops / COV_PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _safe_sigma2(batch, recipe):
    sigma2, ecorr2, _, _ = B.gls_noise_model(batch, recipe)
    return torch.where(batch.mask > 0, sigma2, 1.0), ecorr2


def _config_b(batch, recipe, dtype):
    """Config B: the flagship recipe without ECORR plus the compiler's
    banded covariance, built in ``dtype`` from the host-f64 builder."""
    op = banded_from_times(batch.toas_s, batch.mask, dtype=dtype, device=batch.device, **BANDED)
    return dataclasses.replace(recipe, log10_ecorr=None, noise_cov=op,
                               cov_log10_sigma=BANDED_LOG10_SIGMA)


def _config_d(batch, recipe):
    """Config D: the flagship recipe plus the solar-wind Kronecker
    covariance, built in the batch's dtype."""
    op = kron_time_channel(batch.toas_s, mask=batch.mask, dtype=batch.dtype,
                           device=batch.device, **KRON)
    return dataclasses.replace(recipe, noise_cov=op, cov_log10_sigma=KRON_LOG10_SIGMA)


def _syrk_bound(npsr, m, b, dtype):
    """Least time of one trailing update at tile DENSE_BLOCK: ops/cw.py's
    operations and bytes (C's lower tiles read and written once, L read
    once) over the peak rates."""
    size = torch.finfo(dtype).bits // 8
    return _bound(cw.cov_syrk_operations(npsr, m, b, DENSE_BLOCK),
                  cw.cov_syrk_bytes(npsr, m, b, DENSE_BLOCK, size), dtype)


def phase_cov_kernels():
    """The covariance kernels against their plain versions at their paths'
    shapes, float64 and float32. B.2: the first and the last trailing
    update of config D's dense C0 (68 x 1,920 x 1,920 and 68 x 128 x 128,
    panel 128), then the blocked factor against the library Cholesky, and
    one profiled factorization: the SYRK kernel's device time over its 15
    launches beside the sum of their bounds, and the rest of the factor's
    device time by kernel. B.4/B.5: config B's C0 blocks (68 x 485
    x 16 x 16) in the sweeps the banded solver runs: the factor sweep
    without right-hand sides, then, with the 123 columns of the GP basis,
    the substitution-only forward sweep and the backward sweep (also at
    Q = 1 and 200, each row with its launch plan and its time per block
    column); and the fused factor + forward sweep with those 123 columns,
    which no path runs, checked only."""
    f64 = torch.float64
    rows = {}
    # ---- B.2, config D's C0
    batch, recipe = flagship_workload(**DENSE_SHAPE, dtype=f64)
    recipe = _config_d(batch, recipe)
    safe, ecorr2 = _safe_sigma2(batch, recipe)
    C0 = cov_structure.dense_c0(batch, safe, ecorr2, recipe.noise_cov,
                                recipe_cov_s2(recipe, f64), f64)
    Lkk = torch.linalg.cholesky(C0[:, :DENSE_BLOCK, :DENSE_BLOCK])
    P64 = torch.linalg.solve_triangular(Lkk.mT, C0[:, DENSE_BLOCK:, :DENSE_BLOCK],
                                        upper=True, left=False).contiguous()
    T64 = C0[:, DENSE_BLOCK:, DENSE_BLOCK:].contiguous()
    # the factorization's first launch (its row goes on the kernels line)
    # and its last, one tile pair per pulsar: a grid of about one block per SM
    launches_at = {"first": (T64, P64),
                   "last": (T64[:, -DENSE_BLOCK:, -DENSE_BLOCK:], P64[:, -DENSE_BLOCK:])}
    for which, (C_, P_) in launches_at.items():
        npsr, m, b = P_.shape
        for dtype in (f64, torch.float32):
            C, P = C_.to(dtype).contiguous(), P_.to(dtype).contiguous()
            # the kernel updates in place: compared on copies, timed on one
            # working copy (the values drift over the repeats, the work does not)
            row = _kernel_row(lambda: cw.cov_syrk_update(C.clone(), P, DENSE_BLOCK),
                              lambda: cw.cov_syrk_plain(C, P, DENSE_BLOCK), dtype,
                              _syrk_bound(npsr, m, b, dtype))
            work = C.clone()
            row.update(launch=which, shape=[npsr, m, b], tile=DENSE_BLOCK,
                       plan=dict(zip(("row_blocks", "col_blocks", "grid_x"),
                                     cw.syrk_plan(m, DENSE_BLOCK))),
                       ms=cuda_ms(lambda: cw.cov_syrk_update(work, P, DENSE_BLOCK), 10),
                       library_ms=cuda_ms(lambda: torch.baddbmm(C, P, P.mT, alpha=-1), 10))
            del work
            emit("cov_kernels", kernel="cov_syrk_update", **row)
            require(row["finite"] and row["rel_err"] <= TOL_COV[dtype] and row["same_bits"],
                    f"cov_syrk kernel vs plain {which} {dtype}: {row}")
            rows["cov_syrk_update" if which == "first" else "cov_syrk_update_last", dtype] = row
            del C, P
    del T64, P64, launches_at
    L_blk, blocked_ms = _timed_ms(lambda: cov_kernels.blocked_cholesky(C0, DENSE_BLOCK))
    L_lib, library_ms = _timed_ms(lambda: torch.linalg.cholesky(C0))
    rel = _rel_max(L_blk, L_lib)
    del L_blk, L_lib
    busy, kernels_ms = _device_busy(lambda: cov_kernels.blocked_cholesky(C0, DENSE_BLOCK))
    syrk = [ms for name, ms in kernels_ms if "cov_syrk" in name]
    n = C0.shape[-1]
    trailing = range(-(-n // DENSE_BLOCK) * DENSE_BLOCK - DENSE_BLOCK, 0, -DENSE_BLOCK)
    emit("cov_kernels", kernel="blocked_cholesky", shape=list(C0.shape), block=DENSE_BLOCK,
         rel_err_vs_library=rel, tol=TOL_BLOCKED, blocked_ms=blocked_ms, library_ms=library_ms,
         syrk_launches=len(trailing), syrk_device_ms=sum(syrk) if syrk else None,
         syrk_bound_ms=sum(_syrk_bound(C0.shape[0], m, DENSE_BLOCK, f64)[0] for m in trailing),
         device_ms=sum(ms for _, ms in kernels_ms), device_busy_share=busy,
         other_kernels_ms=[r for r in kernels_ms if "cov_syrk" not in r[0]][:5])
    require(rel <= TOL_BLOCKED, f"blocked Cholesky vs library: {rel}")
    del C0

    # ---- B.4 / B.5, config B's C0 blocks
    batch, recipe = flagship_workload(**FLAGSHIP, dtype=f64)
    recipe = _config_b(batch, recipe, f64)
    safe, _ = _safe_sigma2(batch, recipe)
    D64, E64 = cov_structure.banded_c0_blocks(recipe.noise_cov, safe,
                                              recipe_cov_s2(recipe, f64), f64)
    npsr, nb, b, _ = D64.shape
    q = 3 + int(lgp.phi_for_recipe(batch, recipe).shape[-1])  # the design + GP columns
    X64 = torch.as_tensor(np.random.default_rng(8).standard_normal((npsr, nb, b, q)),
                          device=D64.device)
    rhs64 = {qq: torch.as_tensor(np.random.default_rng(8 + qq).standard_normal((npsr, nb, b, qq)),
                                 device=D64.device) for qq in TRIDIAG_EXTRA_Q}
    for dtype in (f64, torch.float32):
        D, E, X = D64.to(dtype), E64.to(dtype), X64.to(dtype)
        size = torch.finfo(dtype).bits // 8
        Ld, M, Y = ops_gp.tridiag_forward(D, E, X)  # the inputs of the later sweeps
        cases = [
            ("factor", 0, lambda: ops_gp.tridiag_forward(D, E)[:2],
             lambda: ops_gp.tridiag_forward_plain(D, E)[:2]),
            ("factor_solve", q, lambda: ops_gp.tridiag_forward(D, E, X),
             lambda: ops_gp.tridiag_forward_plain(D, E, X)),
        ]
        # the substitution sweeps at the path's basis width (its rows go on
        # the kernels line), then at one column and at 200
        for qq in (q, *TRIDIAG_EXTRA_Q):
            Xq = X if qq == q else rhs64[qq].to(dtype)
            Yq = Y if qq == q else ops_gp.tridiag_forward_solve(Ld, M, Xq)
            cases += [
                ("solve", qq, lambda Xq=Xq: ops_gp.tridiag_forward_solve(Ld, M, Xq),
                 lambda Xq=Xq: ops_gp.tridiag_forward_solve_plain(Ld, M, Xq)),
                ("backward", qq, lambda Yq=Yq: ops_gp.tridiag_backward(Ld, M, Yq),
                 lambda Yq=Yq: ops_gp.tridiag_backward_plain(Ld, M, Yq)),
            ]
        for mode, qq, run, plain in cases:
            factor = mode.startswith("factor")
            bound = _bound(ops_gp.tridiag_operations(npsr, nb, b, qq, factor),
                           ops_gp.tridiag_bytes(npsr, nb, b, qq, factor, size), dtype)
            row = _kernel_row(run, plain, dtype, bound)
            plan = ops_gp.tridiag_plan(npsr, nb, b, qq, dtype, factor=factor,
                                       sms=torch.cuda.get_device_properties(0).multi_processor_count)
            row.update(mode=mode, shape=[npsr, nb, b, qq], ms=cuda_ms(run, 5), library_ms=None,
                       plan=plan._asdict())
            row["us_per_block_column"] = row["ms"] * 1e3 / nb
            emit("cov_kernels", kernel=TRIDIAG_COUNTER[mode], **row)
            require(row["finite"] and row["rel_err"] <= TOL_COV[dtype] and row["same_bits"],
                    f"block-tridiagonal kernel vs plain {mode} Q = {qq} {dtype}: {row}")
            if qq in (0, q):
                rows[mode, dtype] = row
            rows[mode, dtype, qq] = row
        del D, E, X, Ld, M, Y
    return rows


def _time_split(bank, batch, recipe, design, grid):
    """Host milliseconds (median of 3, synchronised) of the likelihood
    stages of one bank call: the C0 factorization, the C0^-1 T solve, the
    projection of the bank (which refactors C0, as the reference's
    project does) and the grid evaluation."""
    f64 = torch.float64
    sigma2, ecorr2, U, _ = B.gls_noise_model(batch, recipe)
    (_, c0inv, _), factor_ms = _timed_ms(lambda: B.white_ecorr_solver(
        batch, sigma2, ecorr2, f64, extra=recipe.noise_cov, extra_s2=recipe_cov_s2(recipe, f64)))
    T = lgp._stack_columns(batch, design, U, f64)[0]
    _, tsolve_ms = _timed_ms(lambda: c0inv(T))
    del T, U
    reduced = lgp.ReducedGP.build(batch, recipe, design=design)
    proj, project_ms = _timed_ms(lambda: reduced.project(bank, batch))
    names, theta = _theta_block(grid, f64, batch.device)
    _, grid_ms = _timed_ms(lambda: _reduced_points(theta, names, reduced, proj, batch, recipe))
    return dict(factor_ms=factor_ms, t_solve_ms=tsolve_ms, project_ms=project_ms,
                grid_ms=grid_ms, basis_columns=int(reduced.TNT.shape[-1]))


def _serve(bank, batch, recipe, design, grid, ll):
    """SERVER_REQUESTS requests over the phi axes; each answer must equal
    its bank_loglikelihood row."""
    axes = tuple(sorted(grid))
    point = lambda i: {k: float(grid[k][i % len(grid[k])]) for k in axes}
    with lk.LikelihoodServer(lk.RealizationBank.from_array(bank), batch, recipe, axes,
                             design=design, max_batch=SERVER_BATCH) as server:
        server.evaluate(**point(0))
        server.reset_stats()
        rows = [f.result(timeout=600) for f in
                [server.submit(**point(i)) for i in range(SERVER_REQUESTS)]]
        stats = server.stats()
    n = len(grid[axes[0]])
    rel = max(float(np.max(np.abs(rows[i] - ll[i % n].numpy()) / np.abs(ll[i % n].numpy())))
              for i in range(SERVER_REQUESTS))
    return dict(server_rel_vs_bank=rel, server_p50_ms=stats["latency"]["p50"] * 1e3,
                server_p99_ms=stats["latency"]["p99"] * 1e3, server_batches=stats["batches"])


def phase_covariance_banded(batch32, recipe32, static, generator):
    """Config B through the entry points, with the launch counts cleared
    just before and read just after: realize 200 with the banded draw
    (f32), then in f64 the bank priced over the 8 x 8 GWB grid
    (fused=False: the block-tridiagonal factor and solves), a grid of 8
    points over cov_log10_sigma on one realization (the direct route, one
    factorization each), and the server."""
    f64 = torch.float64
    recipe_r = _config_b(batch32, recipe32, torch.float32)
    batch, recipe = flagship_workload(**FLAGSHIP, dtype=f64)
    recipe = _config_b(batch, recipe, f64)
    design = B.quadratic_design(batch)
    grid, shape = lk.grid_cartesian(LIKELIHOOD_GRID)
    sig_grid = {"cov_log10_sigma": COV_SIGMA_GRID_B}
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    res = realize(generator, batch32, recipe_r, CHUNK, fit=True, static=static)
    rms = torch.sqrt((res**2 * batch32.mask).sum(-1) / batch32.mask.sum(-1)).cpu()
    _, realize_ms = _timed_ms(lambda: realize(generator, batch32, recipe_r, CHUNK, fit=True,
                                              static=static), reps=2)
    bank = res.double()
    del res
    t0 = time.perf_counter()
    ll = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design).cpu()
    bank_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ll_sig = lk.grid_loglikelihood(bank[0], batch, recipe, sig_grid, design=design).cpu()
    sig_s = time.perf_counter() - t0
    served = _serve(bank, batch, recipe, design, grid, ll)
    counts = {k: launches[k] for k in COV_KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    call = lambda: lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design)
    _, call_ms = _timed_ms(call)
    busy, top = _device_busy(call)
    tridiag_ms = [[k, ms] for k, ms in top if "tridiag" in k]  # B.4 and B.5, every launch shape
    G, R = int(np.prod(shape)), bank.shape[0]
    row = dict(
        shape=FLAGSHIP, block=BANDED["block"], chunk=CHUNK,
        realizations_per_s=CHUNK / (realize_ms / 1e3), realize_ms=realize_ms,
        median_rms_s=float(rms.median()), bank_call_ms=call_ms, bank_first_call_s=bank_first_s,
        evals_per_s=G * R / (call_ms / 1e3), cov_sigma_points=len(COV_SIGMA_GRID_B),
        cov_sigma_grid_s=sig_s, cov_sigma_evals_per_s=len(COV_SIGMA_GRID_B) / sig_s,
        best_cov_log10_sigma=float(COV_SIGMA_GRID_B[int(ll_sig.argmax())]),
        **_time_split(bank, batch, recipe, design, grid), **served,
        peak_memory_gib=peak_gib, device_busy_share=busy, top_kernels_ms=top[:5],
        tridiag_device_ms=sum(ms for _, ms in tridiag_ms), tridiag_kernels_ms=tridiag_ms,
        launches=counts, tol=TOL_LIKELIHOOD,
        finite=bool(torch.isfinite(ll).all() and torch.isfinite(ll_sig).all()),
    )
    emit("covariance_banded", **row)
    require(all(counts[k] for k in COV_KERNELS[1:]),
            f"config B left a block-tridiagonal sweep unlaunched: {counts}")
    require(row["finite"] and tuple(ll.shape) == (G, R), f"config B likelihood: {row}")
    require(served["server_rel_vs_bank"] <= TOL_LIKELIHOOD, f"config B server vs bank: {row}")
    return counts


def _card_vs_cpu(phase, make_recipe, nreal):
    """A small bank realized and priced on the card (kernels) and on the
    CPU (plain and library routes) from the same explicit noise, float64."""
    cb, cr = flagship_workload(**SMALL, dtype=torch.float64, device="cpu")
    gb, gr = flagship_workload(**SMALL, dtype=torch.float64)
    cr, gr = make_recipe(cb, cr), make_recipe(gb, gr)
    rng = np.random.default_rng(3)
    noise = {k: rng.standard_normal((nreal,) + s) for k, s in B.noise_shapes(cb, cr).items()}
    grid, _ = lk.grid_cartesian(DENSE_GRID)
    ref_bank = realize(None, cb, cr, nreal, fit=True, noise=noise, device="cpu")
    got_bank = realize(None, gb, gr, nreal, fit=True, noise=noise)
    ref = lk.bank_loglikelihood(ref_bank, cb, cr, grid=grid, design=B.quadratic_design(cb),
                                device="cpu")
    got = lk.bank_loglikelihood(got_bank, gb, gr, grid=grid, design=B.quadratic_design(gb)).cpu()
    row = dict(shape=SMALL, nreal=nreal, rel_rms_bank=rel_rms(got_bank.cpu(), ref_bank),
               rel_card_vs_cpu=float(((got - ref).abs() / ref.abs()).max()), tol=TOL_LIKELIHOOD)
    emit(phase, **row)
    require(row["rel_card_vs_cpu"] <= TOL_LIKELIHOOD, f"{phase}: {row}")


def phase_covariance_dense():
    """Config D through the entry points, counts cleared just before and
    read just after: realize 32 with the Kronecker draw, price the bank
    over the 4 x 4 GWB grid (fused=False: the dense C0 and its blocked
    Cholesky), then a grid of 4 points over cov_log10_sigma (one dense
    factorization each). All float64."""
    batch, recipe = flagship_workload(**DENSE_SHAPE, dtype=torch.float64)
    recipe = _config_d(batch, recipe)
    design = B.quadratic_design(batch)
    grid, shape = lk.grid_cartesian(DENSE_GRID)
    sig_grid = {"cov_log10_sigma": COV_SIGMA_GRID_D}
    generator = torch.Generator(device=batch.device).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    bank, realize_ms = _timed_ms(lambda: realize(generator, batch, recipe, DENSE_BANK, fit=True),
                                 reps=1)
    t0 = time.perf_counter()
    ll = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design).cpu()
    bank_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ll_sig = lk.grid_loglikelihood(bank[0], batch, recipe, sig_grid, design=design).cpu()
    sig_s = time.perf_counter() - t0
    counts = {k: launches[k] for k in COV_KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    call = lambda: lk.bank_loglikelihood(bank, batch, recipe, grid=grid, design=design)
    _, call_ms = _timed_ms(call)
    busy, top = _device_busy(call)
    G, R = int(np.prod(shape)), bank.shape[0]
    row = dict(
        shape=DENSE_SHAPE, channels=KRON["channels"], nreal=DENSE_BANK, realize_ms=realize_ms,
        realizations_per_s=DENSE_BANK / (realize_ms / 1e3), bank_call_ms=call_ms,
        bank_first_call_s=bank_s, evals_per_s=G * R / (call_ms / 1e3),
        cov_sigma_points=len(COV_SIGMA_GRID_D),
        cov_sigma_grid_s=sig_s, cov_sigma_evals_per_s=len(COV_SIGMA_GRID_D) / sig_s,
        best_cov_log10_sigma=float(COV_SIGMA_GRID_D[int(ll_sig.argmax())]),
        **_time_split(bank, batch, recipe, design, grid),
        peak_memory_gib=peak_gib, device_busy_share=busy, top_kernels_ms=top[:5],
        launches=counts,
        finite=bool(torch.isfinite(ll).all() and torch.isfinite(ll_sig).all()),
    )
    emit("covariance_dense", **row)
    require(counts["cov_syrk_update"] > 0, f"config D never launched the SYRK kernel: {counts}")
    require(row["finite"] and tuple(ll.shape) == (G, R), f"config D likelihood: {row}")
    return counts["cov_syrk_update"]


def _adjoint_bound(label):
    """The least time of one call of kernel 1 or 2 from the counts its
    wrapper recorded at its last launch (``cuda.cost.*``, labeled with its
    launch counter), over the peak rates."""
    from pta_replicator_tpu_torch.obs import devprof, names

    cost = {key: devprof.REGISTRY.gauge(f"{names.CUDA_COST_PREFIX}{key}", label=label).value
            for key in ("flops", "bytes_accessed")}
    return _bound(cost["flops"], cost["bytes_accessed"], torch.float64)


def phase_cov_adjoint_kernels():
    """Kernels 1 and 2 (the factor sweep's adjoint and its adjoint, on no
    Pallas kernel) against their plain versions at config B's C0 blocks (68
    x 485 x 16 x 16, float64) with random cotangents: each output within
    TOL_COV of its largest |entry|, two runs bitwise equal; the time by
    CUDA events beside the bound from the counts the wrappers record and
    the plain versions' one call (kernel 2's is autograd through kernel 1's
    plain loop). Kernel 2 is fed kernel 1's gD, gE and Lbar, as the
    Function feeds it. Each row has the µs per block column and the plan
    (the input-only terms run inside the chain's block: no pre-pass)."""
    f64 = torch.float64
    batch, recipe = flagship_workload(**FLAGSHIP, dtype=f64)
    recipe = _config_b(batch, recipe, f64)
    safe, _ = _safe_sigma2(batch, recipe)
    Ld, M, _ = ops_gp.tridiag_forward(*cov_structure.banded_c0_blocks(
        recipe.noise_cov, safe, recipe_cov_s2(recipe, f64), f64))
    del batch, recipe, safe
    rng = np.random.default_rng(23)
    gLd, gM, hD = (torch.as_tensor(rng.standard_normal(Ld.shape), device=Ld.device)
                   for _ in range(3))
    hE = torch.as_tensor(rng.standard_normal((Ld.shape[0], Ld.shape[1] - 1) + Ld.shape[2:]),
                         device=Ld.device)
    gD, gE, lbar = ops_gp.tridiag_factor_adjoint(Ld, M, gLd, gM)
    cases = {
        "tridiag_factor_adjoint": (lambda: ops_gp.tridiag_factor_adjoint(Ld, M, gLd, gM)[:2],
                                   lambda: ops_gp.tridiag_factor_adjoint_plain(Ld, M, gLd, gM)),
        "tridiag_factor_adjoint_vjp": (
            lambda: ops_gp.tridiag_factor_adjoint_vjp(Ld, M, gLd, gM, hD, hE, lbar=lbar, gD=gD,
                                                      gE=gE),
            lambda: ops_gp.tridiag_factor_adjoint_vjp_plain(Ld, M, gLd, gM, hD, hE)),
    }
    rows = {}
    npsr, nb, b, _ = Ld.shape
    for name, (run, plain) in cases.items():
        run()
        row = _kernel_row(run, plain, f64, _adjoint_bound(name))
        row.update(shape=[npsr, nb, b], ms=cuda_ms(run, 5), library_ms=None,
                   plan=ops_gp.tridiag_adjoint_plan(npsr, b, name.endswith("vjp"))._asdict())
        row["us_per_block_column"] = row["ms"] * 1e3 / nb
        emit("cov_adjoint_kernels", kernel=name, **row)
        require(row["finite"] and row["rel_err"] <= TOL_COV[f64] and row["same_bits"],
                f"{name} vs plain: {row}")
        rows[name] = row
    return rows


class _PlainCalls:
    """Counts the calls of COV_PLAIN_VERSIONS inside a ``with`` block (each
    wrapped in a counting function, put back on exit)."""

    def __enter__(self):
        self.calls, self._saved = collections.Counter(), []
        for module, fns in COV_PLAIN_VERSIONS:
            for name in fns:
                fn = getattr(module, name)
                self._saved.append((module, name, fn))

                def counting(*args, _fn=fn, _name=name, **kw):
                    self.calls[_name] += 1
                    return _fn(*args, **kw)

                setattr(module, name, counting)
        return self.calls

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def _fd_checks(value_and_grad, hessian, x0):
    """The autograd gradient and Hessian at ``x0`` against central
    differences (FD_STEP) of the value and of the gradient: their errors
    over each one's largest entry, and the Hessian's asymmetry."""
    _, g = value_and_grad(x0)
    H = hessian(x0)
    fd_g, fd_H = np.empty_like(g), np.empty_like(H)
    for j in range(len(x0)):
        step = np.zeros_like(x0)
        step[j] = FD_STEP
        (fp, gp_), (fm, gm_) = value_and_grad(x0 + step), value_and_grad(x0 - step)
        fd_g[j] = (fp - fm) / (2 * FD_STEP)
        fd_H[:, j] = (gp_ - gm_) / (2 * FD_STEP)
    scale_g, scale_H = np.max(np.abs(g)), np.max(np.abs(H))
    return dict(grad=g.tolist(), fd_grad=fd_g.tolist(), hessian=H.tolist(),
                grad_rel_err=float(np.max(np.abs(g - fd_g)) / scale_g),
                hessian_rel_err=float(np.max(np.abs(H - fd_H)) / scale_H),
                hessian_asymmetry=float(np.max(np.abs(H - H.T)) / scale_H))


def phase_map_fit_covariance(generator):
    """map_fit over MAP_COV_AXES at config B (68 x 7,758, banded, the
    block-tridiagonal Functions: kernels 1 and 2 in the gradient and the
    Hessian) and config D (68 x 2,048, Kronecker + ECORR, the blocked
    Cholesky with the SYRK Function), float64, on one fitted realization
    priced with the quadratic design, started MAP_COV_OFFSET off the
    recipe. Counts cleared just before each fit and read just after, the
    plain versions' calls counted around it. Gates: converged and finite;
    at the start the gradient and the Hessian against central differences
    (TOL_FD_GRAD, TOL_FD_HESS, the Hessian's asymmetry too); B launches
    kernels 1 and 2, D the SYRK kernel, and no plain version runs. Returns
    config B's launch counts."""
    f64 = torch.float64
    counts = {}
    for config, shape, make in (("B", FLAGSHIP, lambda b, r: _config_b(b, r, f64)),
                                ("D", DENSE_SHAPE, _config_d)):
        batch, recipe = flagship_workload(**shape, dtype=f64)
        recipe = make(batch, recipe)
        design = B.quadratic_design(batch)
        res = realize(generator, batch, recipe, 1, fit=True)[0]
        start = {k: float(getattr(recipe, k)) + MAP_COV_OFFSET for k in MAP_COV_AXES}
        names = tuple(sorted(start))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.clear()
        with _PlainCalls() as plain:
            t0 = time.perf_counter()
            fit = lk.map_fit(res, batch, recipe, start, design=design)
            fit_s = time.perf_counter() - t0
            counts[config] = dict(launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            value_and_grad, hessian = map_objective(res, batch, recipe, names, design,
                                                    batch.device)
            _, vg_ms = _timed_ms(lambda: value_and_grad(fit.x))
            _, hess_ms = _timed_ms(lambda: hessian(fit.x))
            fd = _fd_checks(value_and_grad, hessian, np.asarray([start[k] for k in names]))
        row = dict(config=config, shape=shape, start=start, **fit.as_dict(), fit_s=fit_s,
                   value_and_grad_ms=vg_ms, hessian_ms=hess_ms, peak_memory_gib=peak,
                   launches=counts[config], plain_calls=dict(plain), **fd,
                   tol_grad=TOL_FD_GRAD, tol_hessian=TOL_FD_HESS)
        emit("map_fit_covariance", **row)
        require(fit.converged and np.all(np.isfinite(fit.x)) and np.all(np.isfinite(fit.sigma)),
                f"map_fit config {config}: {row}")
        require(fd["grad_rel_err"] <= TOL_FD_GRAD, f"map_fit config {config} gradient: {row}")
        require(max(fd["hessian_rel_err"], fd["hessian_asymmetry"]) <= TOL_FD_HESS,
                f"map_fit config {config} Hessian: {row}")
        require(not plain, f"map_fit config {config} ran plain versions: {dict(plain)}")
        kernels = ADJOINT_KERNELS if config == "B" else ("cov_syrk_update",)
        require(all(counts[config].get(k, 0) > 0 for k in kernels),
                f"map_fit config {config} left a kernel unlaunched: {counts[config]}")
        del batch, recipe, design, res
        torch.cuda.empty_cache()
    return counts["B"]


def _round_trip_recipe(batch, rung):
    """The round trip's recipe on ``batch``'s device, float64: banded noise
    (the block-tridiagonal rung) or the Kronecker op with ECORR (the dense
    rung)."""
    f64 = torch.float64
    if rung == "banded":
        op, extra = banded_from_times(batch.toas_s, batch.mask, dtype=f64, device=batch.device,
                                      **ROUND_TRIP_BANDED), {}
    else:
        op = kron_time_channel(batch.toas_s, mask=batch.mask, dtype=f64, device=batch.device,
                               **ROUND_TRIP_KRON)
        extra = {"log10_ecorr": torch.tensor(ROUND_TRIP_LOG10_ECORR, dtype=f64)}
    return B.Recipe(efac=torch.tensor(1.1, dtype=f64),
                    rn_log10_amplitude=torch.tensor(ROUND_TRIP_TRUTH["rn_log10_amplitude"],
                                                    dtype=f64),
                    rn_gamma=torch.tensor(4.0, dtype=f64), rn_nmodes=10, noise_cov=op,
                    cov_log10_sigma=torch.tensor(ROUND_TRIP_TRUTH["cov_log10_sigma"], dtype=f64),
                    **extra).to(batch.device)


def _constant_design(batch):
    """The round trip's design: one constant column (realize removes each
    pulsar's mean)."""
    return torch.ones(batch.toas_s.shape + (1,), dtype=torch.float64, device=batch.device)


def phase_map_fit_covariance_card_vs_cpu():
    """The round trip's fit at MAP_COV_SMALL on both rungs, on the card and
    on the CPU (the plain loops and the library Cholesky), from the same
    residuals (explicit noise realized on the CPU): x and sigma within
    TOL_MAP_CARD_VS_CPU, the same iterations."""
    from pta_replicator_tpu_torch.batch import synthetic_batch

    start = {k: v + ROUND_TRIP_START for k, v in ROUND_TRIP_TRUTH.items()}
    rows = {}
    for rung in ("banded", "dense"):
        cb = synthetic_batch(**MAP_COV_SMALL, dtype=torch.float64, device="cpu")
        gb = synthetic_batch(**MAP_COV_SMALL, dtype=torch.float64)
        cr, gr = _round_trip_recipe(cb, rung), _round_trip_recipe(gb, rung)
        rng = np.random.default_rng(7)
        noise = {k: rng.standard_normal((1,) + s) for k, s in B.noise_shapes(cb, cr).items()}
        res = realize(None, cb, cr, 1, fit=False, noise=noise, device="cpu")[0]
        t0 = time.perf_counter()
        ref = lk.map_fit(res, cb, cr, start, design=_constant_design(cb), device="cpu")
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = lk.map_fit(res, gb, gr, start, design=_constant_design(gb))
        card_s = time.perf_counter() - t0
        row = dict(rung=rung, shape=MAP_COV_SMALL, iterations=[got.iterations, ref.iterations],
                   converged=[got.converged, ref.converged],
                   rel_x=float(np.max(np.abs(got.x - ref.x) / np.abs(ref.x))),
                   rel_sigma=float(np.max(np.abs(got.sigma - ref.sigma) / np.abs(ref.sigma))),
                   card_s=card_s, cpu_s=cpu_s, tol=TOL_MAP_CARD_VS_CPU)
        emit("map_fit_covariance_card_vs_cpu", **row)
        require(got.iterations == ref.iterations and got.converged and ref.converged
                and max(row["rel_x"], row["rel_sigma"]) <= TOL_MAP_CARD_VS_CPU,
                f"map_fit covariance card vs CPU: {row}")
        rows[rung] = row
    return rows


def phase_covariance_round_trip(generator):
    """The JAX package's round trip at config B's width (68 x 7,758): inject
    the recipe with ``realize(..., fit=False)``, fit ROUND_TRIP_TRUTH's two
    axes from the truths + ROUND_TRIP_START with the constant design
    column; each within ROUND_TRIP_Z Fisher sigma of its truth, converged."""
    batch, _ = flagship_workload(**FLAGSHIP, dtype=torch.float64)
    recipe = _round_trip_recipe(batch, "banded")
    res = realize(generator, batch, recipe, 1, fit=False)[0]
    start = {k: v + ROUND_TRIP_START for k, v in ROUND_TRIP_TRUTH.items()}
    t0 = time.perf_counter()
    fit = lk.map_fit(res, batch, recipe, start, design=_constant_design(batch))
    fit_s = time.perf_counter() - t0
    z = {name: float((fit.x[i] - ROUND_TRIP_TRUTH[name]) / fit.sigma[i])
         for i, name in enumerate(fit.names)}
    row = dict(shape=FLAGSHIP, truth=ROUND_TRIP_TRUTH, start=start, **fit.as_dict(),
               zscores=z, limit=ROUND_TRIP_Z, fit_s=fit_s)
    emit("covariance_round_trip", **row)
    require(fit.converged and all(np.isfinite(v) and abs(v) <= ROUND_TRIP_Z for v in z.values()),
            f"covariance round trip: {row}")


def _sweep_run(seed, batch, recipe, nreal, path, **kw):
    """(result, wall seconds, stats) of one sweep through the entry point,
    ending synchronised (the sweep returns host arrays)."""
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep(seed, batch, recipe, nreal, path, chunk=SWEEP_CHUNK, fit=True, stats=stats, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, stats


def _file_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _profiled_busy(fn):
    """Kernel busy share of one synchronised call's wall time and the
    copies' device milliseconds, from torch.profiler (kernels on the
    compute stream do not overlap; copies run beside them on a copy
    stream); (None, None) when the profiler records no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_ms = _timed_ms(fn, reps=1)
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    copy_ms = sum(ms for k, ms in rows if k.startswith(("Memcpy", "Memset")))
    kernel_ms = sum(ms for k, ms in rows) - copy_ms
    if kernel_ms <= 0:
        return None, None
    return kernel_ms / wall_ms, copy_ms


def _writer_steps_ms(block, workdir):
    """Host milliseconds of each step the sweep's writers take for one
    full-cube chunk (``block``, on the host), once each: the chunk file
    (``np.save``), the consolidated archive of that one chunk, the writer
    thread's copy of a readback buffer (its pages touched for the first
    time, then again), and pinning a readback buffer of the chunk's
    size."""
    out = np.empty_like(block)
    steps = {
        "np_save": lambda: np.save(workdir / "step_a.npy", block, allow_pickle=False),
        "consolidate": lambda: sweep_mod._consolidate(str(workdir / "step_b.npz"), [block],
                                                      durable=False),
        "copy_first_touch": lambda: np.copyto(out, block),
        "copy_again": lambda: np.copyto(out, block),
        "pin_buffer": lambda: torch.empty(block.nbytes, dtype=torch.uint8, pin_memory=True),
    }
    times = {}
    for name, fn in steps.items():
        t0 = time.perf_counter()
        fn()
        times[name] = (time.perf_counter() - t0) * 1e3
    for name in ("step_a.npy", "step_b.npz"):
        (workdir / name).unlink()
    return times


def phase_sweep(batch, recipe, batch64, recipe64, workdir):
    """The sweep through its entry point at the flagship width, float32:
    (a) fit, the default RMS reduction, chunk 200, 2,000 realizations at
    depth 1, depth 2 and fused_stream, twice each, beside realize() alone
    over the same chunks with a readback; the three checkpoints
    byte-identical, the arrays equal, and equal to realize() alone;
    (b) an abort after chunk 4 and a resume, byte-identical; (c) full
    cubes, 600 realizations (three 422 MB chunks), at depth 1 and 2,
    without and with durable writes: rate, MB/s written, readback copy
    per chunk, kernel busy share (torch.profiler, a second run), and each
    writer step timed alone on one chunk; (d) the
    bank from (c)'s checkpoint priced in float64 against the in-memory
    array. The launch counts are cleared just before (a) and read just
    after."""
    runs, rates, pipeline_rates, raw = {}, {}, {}, {}
    launches.clear()
    for rep in range(SWEEP_REPS):
        for name, kw in SWEEP_MODES.items():
            path = str(workdir / f"rms_{name}_{rep}.npz")
            out, wall, stats = _sweep_run(SWEEP_SEED, batch, recipe, SWEEP_NREAL, path, **kw)
            rates.setdefault(name, []).append(SWEEP_NREAL / wall)
            if "wall_s" in stats:  # the pipelined graph alone, without set-up
                pipeline_rates.setdefault(name, []).append(SWEEP_NREAL / stats["wall_s"])
            runs[name], raw[name] = out, _file_bytes(path)
    counts = {k: launches[k] for k in ("cw_catalog_response", "cw_fold_planes")}

    def yardstick():
        rows = []
        for i in range(SWEEP_NREAL // SWEEP_CHUNK):
            gen = torch.Generator(device=batch.device).manual_seed(chunk_seed(SWEEP_SEED, i))
            res = realize(gen, batch, recipe, SWEEP_CHUNK, fit=True, static=static)
            # the sweep's own reduction (a card's sums laid out by row_sums)
            rows.append(sweep_mod._default_reduce(res, batch).cpu())
        return torch.cat(rows).numpy()

    static = deterministic_delays(batch, recipe)
    realize_rates = []
    for _ in range(SWEEP_REPS):
        alone, ms = _timed_ms(yardstick, reps=1)
        realize_rates.append(SWEEP_NREAL / (ms / 1e3))

    class Abort(Exception):
        """A progress callback's own error: fatal, never retried."""

    def abort(done, total):
        if done == SWEEP_ABORT_AFTER:
            raise Abort

    path = str(workdir / "abort.npz")
    aborted = False
    try:
        _sweep_run(SWEEP_SEED, batch, recipe, SWEEP_NREAL, path, progress=abort)
    except Abort:
        aborted = True
    done_after_abort = json.loads(_file_bytes(path + ".meta.json"))["done"]
    calls = []
    resumed, _, _ = _sweep_run(SWEEP_SEED, batch, recipe, SWEEP_NREAL, path,
                               progress=lambda d, t: calls.append(d))
    row = dict(
        shape=FLAGSHIP, dtype=str(batch.dtype), chunk=SWEEP_CHUNK, nreal=SWEEP_NREAL,
        realizations_per_s=rates, pipeline_realizations_per_s=pipeline_rates,
        realize_alone_per_s=realize_rates,
        depth2_over_realize=float(np.median(rates["depth2"]) / np.median(realize_rates)),
        npz_identical=all(raw[k] == raw["depth1"] for k in raw),
        arrays_equal=all(np.array_equal(runs[k], runs["depth1"]) for k in runs),
        equals_realize_alone=bool(np.array_equal(runs["depth1"], alone)),
        cw_launches=counts["cw_catalog_response"], fold_launches=counts["cw_fold_planes"],
        aborted=aborted, done_after_abort=done_after_abort, resumed_chunks=calls,
        resume_identical=_file_bytes(path) == raw["depth1"]
        and bool(np.array_equal(resumed, runs["depth1"])),
        finite=bool(np.isfinite(runs["depth1"]).all()), output_shape=list(runs["depth1"].shape),
    )
    emit("sweep", **row)
    require(row["npz_identical"] and row["arrays_equal"] and row["equals_realize_alone"],
            f"sweep depths disagree: {row}")
    require(aborted and done_after_abort == SWEEP_ABORT_AFTER and row["resume_identical"]
            and calls == list(range(SWEEP_ABORT_AFTER + 1, SWEEP_NREAL // SWEEP_CHUNK + 1)),
            f"sweep abort and resume: {row}")
    require(counts["cw_catalog_response"] > 0, f"the sweep never launched the CW kernels: {row}")
    require(row["finite"], f"sweep output: {row}")
    for p in workdir.glob("rms_*"):
        p.unlink()

    cube_rows, cube_raw, cube = [], None, None
    for depth in (1, 2):
        for durable in (False, True):
            path = str(workdir / f"cube_{depth}_{int(durable)}.npz")
            kw = dict(reduce_fn=None, pipeline_depth=depth, durable=durable)
            out, wall, stats = _sweep_run(SWEEP_SEED, batch, recipe, CUBE_NREAL, path, **kw)
            nbytes = out.nbytes * 2  # the chunk files, then the consolidated archive
            data = _file_bytes(path)
            Path(path).unlink()
            Path(path + ".meta.json").unlink()
            busy, copy_ms = _profiled_busy(
                lambda: _sweep_run(SWEEP_SEED, batch, recipe, CUBE_NREAL, path, **kw))
            if depth == 2 and not durable:
                cube = out  # kept, with the profiled run's checkpoint, for (d)
            else:
                Path(path).unlink()
                Path(path + ".meta.json").unlink()
            cube_rows.append(dict(
                depth=depth, durable=durable, realizations_per_s=CUBE_NREAL / wall,
                wall_s=wall, mb_written=nbytes / 1e6, mb_per_s=nbytes / 1e6 / wall,
                d2h_ms_per_chunk=stats.get("d2h_ms"), stage_busy_s=stats.get("stage_busy_s"),
                kernel_busy_share=busy, profiled_copy_ms=copy_ms,
                identical=cube_raw is None or data == cube_raw))
            cube_raw = data if cube_raw is None else cube_raw
            del out, data
    emit("sweep_cubes", shape=FLAGSHIP, nreal=CUBE_NREAL, chunk=SWEEP_CHUNK,
         chunk_mb=cube.nbytes / (CUBE_NREAL // SWEEP_CHUNK) / 1e6, runs=cube_rows,
         writer_steps_ms=_writer_steps_ms(cube[:SWEEP_CHUNK], workdir))
    require(all(r["identical"] for r in cube_rows), f"full-cube checkpoints differ: {cube_rows}")

    path = str(workdir / "cube_2_0.npz")
    bank = lk.RealizationBank.from_checkpoint(path)
    grid, shape = lk.grid_cartesian(DENSE_GRID)
    design = B.quadratic_design(batch64)
    t0 = time.perf_counter()
    ll_disk = lk.bank_loglikelihood(bank, batch64, recipe64, grid=grid, design=design,
                                    fused=True).cpu()
    disk_s = time.perf_counter() - t0
    ll_mem = lk.bank_loglikelihood(torch.as_tensor(cube), batch64, recipe64, grid=grid,
                                   design=design, fused=True).cpu()
    rel = float(((ll_disk - ll_mem).abs() / ll_mem.abs()).max())
    row = dict(bank_shape=list(bank.shape), bank_dtype=str(bank.dtype), grid_shape=list(shape),
               rel_disk_vs_memory=rel, tol=TOL_BANK, bank_call_s=disk_s,
               finite=bool(torch.isfinite(ll_disk).all()))
    emit("sweep_bank", **row)
    require(rel <= TOL_BANK and row["finite"] and bank.shape == cube.shape,
            f"the bank from the checkpoint prices differently: {row}")
    del bank, cube
    torch.cuda.empty_cache()


def _mesh_devices(k):
    """k devices: k distinct cards where there are that many, else card 0
    repeated (the counterpart of the JAX package's forced device count)."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(k)] if n >= k else ["cuda:0"] * k


def _mesh(shape):
    return pmesh.make_mesh(*shape, devices=_mesh_devices(shape[0] * shape[1]))


def _white(batch):
    """The elementwise recipe: per-backend EFAC and EQUAD, nothing that a
    product or a window could re-tile."""
    nb = len(batch.backend_names)
    full = lambda v: torch.full((batch.npsr, nb), v, dtype=batch.dtype, device=batch.device)
    return B.Recipe(efac=full(1.1), log10_equad=full(-6.5))


def _errors(got, want):
    """The RMS of ``got - want`` and its largest entry, each over
    ``want``'s RMS (float64)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    rms, diff = torch.sqrt(torch.mean(want**2)), (got - want).abs()
    return dict(rel_rms=float(torch.sqrt(torch.mean(diff**2)) / rms),
                max_over_rms=float(diff.max() / rms))


def _f64_anchor(batch, recipe, batch64, recipe64, mesh, reduce_fn):
    """One chunk on one set of draws: the unsharded float32 engine, the
    mesh and the float64 engine (the draws cast), each through
    ``reduce_fn``: the mesh against the unsharded result and both against
    float64."""
    draws = B.draw_noise(torch.Generator(device=batch.device).manual_seed(MESH_SEED), batch,
                         recipe, CHUNK)
    ref = reduce_fn(realize(None, batch, recipe, CHUNK, fit=True, noise=draws,
                            device=batch.device), batch)
    got = reduce_fn(pmesh.sharded_realize(0, batch, recipe, CHUNK, mesh=mesh, fit=True,
                                          noise=draws).assemble(), batch)
    f64 = reduce_fn(realize(None, batch64, recipe64, CHUNK, fit=True, noise={
        k: v.double() for k, v in draws.items()}, device=batch.device), batch64)
    return dict(mesh_vs_unsharded=_errors(got, ref), unsharded_vs_f64=_errors(ref, f64),
                mesh_vs_f64=_errors(got, f64))


def _anchored(row):
    return (row["mesh_vs_unsharded"]["rel_rms"] <= MESH_TOL
            and row["mesh_vs_f64"]["max_over_rms"]
            <= MESH_F64_RATIO * row["unsharded_vs_f64"]["max_over_rms"])


def _threaded_dispatch(batch, recipe, mesh, static, inputs, stats):
    """One chunk of the flagship recipe (fit) on ``mesh``, each shard
    dispatched by a thread of its own that enters its device and the
    calling thread's current stream there (the engine dispatches every
    shard from the calling thread): a ShardedArray, and each shard's host
    dispatch milliseconds and its thread's CPU milliseconds in ``stats``
    (``shard_dispatch_ms``, ``shard_thread_cpu_ms``)."""
    plan = pmesh.shard_plan(mesh, CHUNK, batch.npsr)
    systems = (pmesh.shard_fit_systems(inputs, plan) if recipe.fit_design is not None
               else None)
    streams = {d: torch.cuda.current_stream(d) for d in mesh.distinct_devices()}
    ms, cpu_ms = [0.0] * len(plan), [0.0] * len(plan)

    def task(k):
        def run():
            shard = plan[k]
            t0, c0 = time.perf_counter(), time.thread_time()
            with torch.cuda.device(shard.device), torch.cuda.stream(streams[shard.device]):
                out = pmesh._realize_shard(shard, MESH_SEED, inputs, CHUNK, True, static,
                                           systems, None)
            ms[k] = (time.perf_counter() - t0) * 1e3
            cpu_ms[k] = (time.thread_time() - c0) * 1e3
            return out
        return run

    outs = fan_out([task(k) for k in range(len(plan))], name="shard-dispatch")
    stats["shard_dispatch_ms"], stats["shard_thread_cpu_ms"] = ms, cpu_ms
    shape = (CHUNK, batch.npsr, batch.ntoa_max)
    return pmesh.ShardedArray(shape, outs[0].dtype, [
        ((s.rows, s.pulsars, (0, batch.ntoa_max)), out) for s, out in zip(plan, outs)])


def _mesh_cli(workdir, device_type, extra_runs=0):
    """``realize`` of the elementwise recipe on DATASET in fresh processes:
    unsharded, through ``--mesh-shape 2x2 --mesh-devices`` (four cards where
    there are four, else card 0 four times), and, where there are two cards
    or more, ``--sharded`` (every visible card on 'real'); each sharded
    output against the unsharded, with the mesh its summary names and, where
    they differ, the realizations and pulsars that do. ``extra_runs`` more
    rounds of the sharded processes (a probe's repeats)."""
    from pta_replicator_tpu_torch.utils.fabricate import ng15_like_pulsars, write_dataset

    pardir, timdir = workdir / "par", workdir / "tim"
    if not pardir.exists():
        write_dataset(ng15_like_pulsars(**DATASET, seed=DATASET_SEED), pardir, timdir)
        (workdir / "recipe.json").write_text(json.dumps({"efac": 1.1, "log10_equad": -6.5}))
    argv = ["realize", "--pardir", str(pardir), "--timdir", str(timdir), "--recipe",
            str(workdir / "recipe.json"), "--nreal", str(MESH_CLI_NREAL), "--device", device_type]
    arms = {"mesh_2x2": (["--mesh-shape", "2x2", "--mesh-devices", ",".join(_mesh_devices(4))],
                         "2x2")}
    if torch.cuda.device_count() > 1:
        arms["sharded"] = (["--sharded"], f"{torch.cuda.device_count()}x1")
    runs = [(None, "ref")] + [(name, f"{name}_{k}") for k in range(1 + extra_runs)
                              for name in arms]

    def one(run):
        name, tag = run
        return _module_cli(*argv, "--out", str(workdir / f"cli_{tag}.npz"),
                           *(arms[name][0] if name else []))

    with ThreadPoolExecutor(len(runs)) as pool:
        results = list(pool.map(one, runs))
    for code, _out, err, _s in results:
        require(code == 0, f"mesh_sweep: realize CLI exit {code}: {err[-2000:]}")
    ref = np.load(workdir / "cli_ref.npz")["residuals"]
    row = dict(shape=list(ref.shape), unsharded_s=results[0][3], runs=[])
    for (name, tag), (_code, out, _err, secs) in zip(runs[1:], results[1:]):
        got = np.load(workdir / f"cli_{tag}.npz")["residuals"]
        arm = dict(arm=name, seconds=secs, mesh=json.loads(out.strip().splitlines()[-1]).get("mesh"),
                   want_mesh=arms[name][1], equal=bool(np.array_equal(got, ref)))
        if not arm["equal"] and got.shape == ref.shape:
            differ = got != ref
            arm["differing_realizations"] = np.flatnonzero(differ.any(axis=(1, 2))).tolist()
            arm["differing_pulsars"] = np.flatnonzero(differ.any(axis=(0, 2))).tolist()
            arm["differing_entries"] = int(differ.sum())
            arm["max_abs_diff"] = float(np.abs(got.astype(np.float64) - ref).max())
        row["runs"].append(arm)
    row["equal"] = all(a["equal"] and a["mesh"] == a["want_mesh"] for a in row["runs"])
    return row


def _mesh_sweeps(batch, recipe, workdir, tag, **kw):
    """A warm-up sweep, then the unsharded sweep and the mesh sweep at every
    shape, each synchronised, with its rate, peak memory (the largest of
    its cards') and B.1 launches: {None or shape: (row, result, archive
    bytes)}."""
    # the warm-up touches every card of the largest mesh (a card's first use
    # sets up its context, handles and modules)
    for k, mesh in enumerate((None, _mesh((2, 2)))):
        sweep(MESH_SEED + 1, batch, recipe, 4 * CHUNK, str(workdir / f"{tag}_warm{k}.npz"),
              chunk=CHUNK, device=batch.device, mesh=mesh, **kw)
    out = {}
    for shape in (None,) + MESH_SHAPES:
        path = workdir / f"{tag}_{'x'.join(map(str, shape or ('none',)))}.npz"
        mesh = None if shape is None else _mesh(shape)
        cards = [batch.device] if mesh is None else mesh.distinct_devices()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(MESH_SEED, batch, recipe, MESH_NREAL, str(path), chunk=CHUNK, mesh=mesh,
                    device=batch.device, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        row = dict(realizations_per_s=MESH_NREAL / wall_s, wall_s=wall_s,
                   peak_gib=max(torch.cuda.max_memory_allocated(d) for d in cards) / 2**30,
                   b1_launches=launches["cw_catalog_response"])
        out[shape] = (row, res, _file_bytes(path))
        path.unlink()
    return out


def phase_mesh_sweep(batch, recipe, batch64, recipe64, workdir):
    """The mesh sweep (A.17a) at the flagship width, float32, chunk 200,
    through its entry points: the elementwise recipe bitwise and the
    flagship recipe (fit) within MESH_TOL of the RMS against the unsharded
    sweep at every shape, with realizations/s and peak memory per shape
    (and the elementwise recipe bitwise on odd and small pulsar windows),
    and one chunk on 2 x 2 anchored to the float64 engine;
    a 2 x 2 sweep of the elementwise recipe stopped after two chunks and
    resumed at 1 x 2, byte for byte the unsharded archive; a full-cube
    chunk's sharded archive written (MB/s); each shard's dispatch
    milliseconds with one dispatching thread and with a thread per shard
    (equal bits); config B's GLS refit on 1 x 2 with B.4/B.5's launches
    counted on each shard (and on the profiler's trace); ``realize`` on a
    2 x 2 mesh (and, on several cards, ``--sharded``) at DATASET width in
    fresh processes byte-equal to ``realize``, each naming its mesh; two
    processes of a gloo group on the card byte-equal to one process's 2 x 1
    mesh. Returns the launch counts of B.1 and of B.4/B.5 on this path."""
    white = _white(batch)
    rows = {}
    ref_rows = _mesh_sweeps(batch, white, workdir, "white", fit=False)
    (base_row, base, base_bytes) = ref_rows.pop(None)
    for shape, (row, res, data) in ref_rows.items():
        row["equal"] = bool(np.array_equal(res, base)) and data == base_bytes
        rows[f"white_{shape[0]}x{shape[1]}"] = row
    rows["white_unsharded"] = base_row
    # a full-cube chunk, unfetched, against realize's on the same seed
    cube = pmesh.sharded_realize(MESH_SEED, batch, white, CHUNK, mesh=_mesh((2, 2))).assemble()
    rows["white_cube_2x2"] = dict(equal=bool(torch.equal(cube, realize(
        torch.Generator(device=batch.device).manual_seed(MESH_SEED), batch, white, CHUNK,
        device=batch.device))))
    # windows the flagship's even halves do not reach, each against realize:
    # a 1 x 4 full cube (17-pulsar windows at odd offsets: rows that start
    # 8 bytes off a 16-byte boundary) and, on 8 pulsars x 1,000 TOAs, 2 x 2
    # (4-pulsar windows) and 8 x 1 (one realization a shard): a card's sums
    # over fewer than 16 rows, or over rows aligned otherwise, round
    # otherwise unless models/batched.py::row_sums lays them out
    cube = pmesh.sharded_realize(MESH_SEED, batch, white, CHUNK, mesh=_mesh((1, 4))).assemble()
    rows["white_cube_1x4"] = dict(equal=bool(torch.equal(cube, realize(
        torch.Generator(device=batch.device).manual_seed(MESH_SEED), batch, white, CHUNK,
        device=batch.device))))
    del cube
    small_b, small_r = rehearsal.workload("white", 8, 1000, batch.dtype, batch.device)
    small = realize(torch.Generator(device=batch.device).manual_seed(MESH_SEED), small_b, small_r,
                    8, device=batch.device)
    for shape in ((2, 2), (8, 1)):
        rows[f"white_small_{shape[0]}x{shape[1]}"] = dict(equal=bool(torch.equal(
            pmesh.sharded_realize(MESH_SEED, small_b, small_r, 8, mesh=_mesh(shape)).assemble(),
            small)))
    flag = _mesh_sweeps(batch, recipe, workdir, "flagship", fit=True)
    (fbase_row, fbase, _) = flag.pop(None)
    for shape, (row, res, _data) in flag.items():
        row["vs_unsharded"] = _errors(res, fbase)
        rows[f"flagship_{shape[0]}x{shape[1]}"] = row
    rows["flagship_unsharded"] = fbase_row
    anchor = _f64_anchor(batch, recipe, batch64, recipe64, _mesh((2, 2)),
                         sweep_mod._default_reduce)
    b1 = sum(r["b1_launches"] for k, r in rows.items() if k.startswith("flagship_")
             and k != "flagship_unsharded")

    # stopped at 2 x 2 after two chunks, resumed at 1 x 2
    path = workdir / "resume.npz"

    class Stop(Exception):
        pass

    def stop(done, total):
        if done == MESH_ABORT_AFTER:
            raise Stop

    try:
        sweep(MESH_SEED, batch, white, MESH_NREAL, str(path), chunk=CHUNK, mesh=_mesh((2, 2)),
              progress=stop, device=batch.device)
        raise RuntimeError("chip_smoke: the resume arm's sweep did not stop")
    except Stop:
        pass
    archives = sorted(p.name for p in workdir.glob("resume.npz.chunk*"))
    resumed = sweep(MESH_SEED, batch, white, MESH_NREAL, str(path), chunk=CHUNK,
                    mesh=_mesh((1, 2)), device=batch.device)
    resume = dict(stopped_archives=archives, equal=bool(np.array_equal(resumed, base))
                  and _file_bytes(path) == base_bytes)
    path.unlink()

    # one full-cube chunk of the flagship recipe on 2 x 2: its shards' readback
    # and their sharded archive (non-durable), then the dispatch readings
    mesh22 = _mesh((2, 2))
    inputs = pmesh.shard_batch(batch, mesh22, recipe)
    static22 = pmesh.static_delays(batch, recipe, mesh22)

    def run(threads, stats=None):
        if threads:
            return _threaded_dispatch(batch, recipe, mesh22, static22, inputs, stats)
        return pmesh.sharded_realize(MESH_SEED, batch, recipe, CHUNK, mesh=mesh22, fit=True,
                                     static=static22, inputs=inputs, stats=stats)

    block = pmesh.fetch_shard_blocks(run(False))
    t0 = time.perf_counter()
    sweep_mod.write_shard_archive(str(workdir / "cube.npz"), block)
    archive_s = time.perf_counter() - t0
    archive_mb = block.nbytes / 1e6
    (workdir / "cube.npz").unlink()
    # beside each call's wall time, the CPU time of the whole process over
    # it, and each dispatching thread's own CPU time: a thread that waits
    # (for the GIL, a lock) spends wall time without CPU time
    dispatch = {}
    for threads in (False, True):
        runs, calls, thread_cpu = [], [], []
        for _ in range(MESH_DISPATCH_REPS):
            st = {}
            c0, w0 = time.process_time(), time.perf_counter()
            out = run(threads, st)
            calls.append(((time.perf_counter() - w0) * 1e3, (time.process_time() - c0) * 1e3))
            for d in mesh22.distinct_devices():
                torch.cuda.synchronize(d)
            runs.append(st["shard_dispatch_ms"])
            thread_cpu.append(st.get("shard_thread_cpu_ms"))
        row = dispatch["thread_per_shard" if threads else "one_thread"] = {
            "shard_dispatch_ms": [float(np.median(col)) for col in zip(*runs)],
            "call_wall_ms": float(np.median([c[0] for c in calls])),
            "call_process_cpu_ms": float(np.median([c[1] for c in calls]))}
        if threads:
            row["shard_thread_cpu_ms"] = [float(np.median(col)) for col in zip(*thread_cpu)]
        row["equal_bits"] = bool(
            np.array_equal(pmesh.fetch_shard_blocks(out).assemble(), block.assemble()))
    del block, out

    # config B's GLS refit on 1 x 2: the assembly and a chunk's solves per shard
    gls = dataclasses.replace(_config_b(batch, recipe, torch.float32),
                              fit_design=_fit_design(batch), fit_gls=True)
    mesh12 = _mesh((1, 2))
    gin = pmesh.shard_batch(batch, mesh12, gls)
    plan = pmesh.shard_plan(mesh12, CHUNK, batch.npsr)
    systems, assembly = {}, []
    for shard in plan:
        launches.clear()
        systems.update(pmesh.shard_fit_systems(gin, [shard]))
        torch.cuda.synchronize()
        assembly.append({k: launches[k] for k in COV_KERNELS if launches[k]})
    gstatic = pmesh.static_delays(batch, gls, mesh12)
    st = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # a profiler session can lose its first records on a card
        # (device_trace warms up for the same reason): tiny kernels first
        for d in mesh12.distinct_devices():
            pad = torch.zeros(1, device=d)
            for _ in range(128):
                pad.add_(1.0)
        gres = pmesh.sharded_realize(MESH_SEED, batch, gls, CHUNK, mesh=mesh12, fit=True,
                                     static=gstatic, inputs=gin, systems=systems, stats=st)
        torch.cuda.synchronize()
    by_device = collections.Counter(
        f"cuda:{e.device_index}" for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and "tridiag" in e.name)
    profiled = sum(by_device.values())
    del gres, gin, systems, gstatic
    gls64 = dataclasses.replace(_config_b(batch64, recipe64, torch.float64),
                                fit_design=_fit_design(batch).double(), fit_gls=True)
    gls_row = dict(assembly_launches=assembly, chunk_launches=st["shard_launches"],
                   profiled_tridiag_kernels=int(profiled),
                   profiled_tridiag_by_device=dict(by_device),
                   **_f64_anchor(batch, gls, batch64, gls64, mesh12, lambda res, _b: res))
    del gls, gls64
    torch.cuda.empty_cache()

    # realize on a mesh in fresh processes against realize in another, and,
    # beside them, two processes on the card, a gloo group, against one
    # process's 2 x 1 (the fresh interpreters start together)
    def gloo_arm():
        t0 = time.perf_counter()
        ranks = rehearsal.launch(MESH_PROCESSES, str(workdir), mesh="1x1",
                                 device=batch.device.type, workload="white", npsr=batch.npsr,
                                 ntoa=batch.ntoa_max, nreal=CHUNK, chunk=CHUNK, seed=MESH_SEED,
                                 float32=True, timeout_s=300.0)
        return ranks, time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        gloo = pool.submit(gloo_arm)
        cli_row = _mesh_cli(workdir, batch.device.type)
        ranks, procs_s = gloo.result()
    white_b, white_r = rehearsal.workload("white", batch.npsr, batch.ntoa_max, batch.dtype,
                                          batch.device)
    one = distributed.local_realizations(pmesh.sharded_realize(
        chunk_seed(MESH_SEED, 0), white_b, white_r, CHUNK, mesh=_mesh((MESH_PROCESSES, 1))))
    stitched = np.concatenate([r["local"][0] for r in ranks], axis=0)
    gloo_row = dict(seconds=procs_s, equal=bool(np.array_equal(stitched, one)),
                    topology=[{k: int(r[k]) for k in rehearsal.TOPOLOGY_KEYS} for r in ranks])

    row = dict(shape=FLAGSHIP, chunk=CHUNK, nreal=MESH_NREAL, devices=_mesh_devices(4),
               shapes=rows, tol=MESH_TOL, f64_ratio=MESH_F64_RATIO, f64_anchor_2x2=anchor,
               resume=resume,
               archive=dict(mb=archive_mb, seconds=archive_s, mb_per_s=archive_mb / archive_s,
                            shards=4),
               dispatch=dispatch, gls_1x2=gls_row, cli=cli_row, gloo=gloo_row)
    emit("mesh_sweep", **row)
    require(all(r["equal"] for k, r in rows.items() if k.startswith("white_") and "equal" in r),
            f"mesh_sweep: the elementwise recipe's mesh sweep differs from the unsharded: {rows}")
    require(all(r["vs_unsharded"]["rel_rms"] <= MESH_TOL for k, r in rows.items()
                if "vs_unsharded" in r) and _anchored(anchor),
            f"mesh_sweep: the flagship mesh sweep: {rows}, {anchor}")
    require(all(r["b1_launches"] > 0 for k, r in rows.items() if k.startswith("flagship_")),
            f"mesh_sweep: a flagship sweep never launched B.1: {rows}")
    require(resume["equal"] and len(resume["stopped_archives"]) == MESH_ABORT_AFTER,
            f"mesh_sweep: the resume across shapes: {resume}")
    require(all(d["equal_bits"] for d in dispatch.values()),
            f"mesh_sweep: a thread per shard changed the bits: {dispatch}")
    require(all(a.get("tridiag_factor_solve_fwd") for a in assembly)
            and all(c.get("tridiag_solve_fwd") == 1 and c.get("tridiag_factor_solve_bwd") == 1
                    for c in st["shard_launches"])
            and profiled >= sum(sum(c.values()) for c in st["shard_launches"])
            and _anchored(gls_row), f"mesh_sweep: config B's GLS refit on 1 x 2: {gls_row}")
    require(cli_row["equal"], f"mesh_sweep: realize on a mesh differs from realize, or its "
            f"summary names another mesh: {cli_row}")
    require(gloo_row["equal"], f"mesh_sweep: two processes differ from one: {gloo_row}")
    counts = {k: sum(a.get(k, 0) for a in assembly) + sum(c.get(k, 0) for c in st["shard_launches"])
              for k in COV_KERNELS}
    return b1, counts


def _union_us(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersection_us(xs, ys):
    """Length of the intersection of two unions of intervals."""
    xs, ys, total, i, j = _union_us(xs), _union_us(ys), 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _traced_overlap(batch, recipe):
    """How much of the streamed catalog's host tile build overlaps its
    accumulating kernels, read from one torch.profiler trace of the
    streamed response (prefetch depth 2): the kernels' device intervals
    from the trace, the tile builds' intervals timed on the prefetch
    worker with the host clock and put on the trace's clock by a span the
    caller's thread closes at a known host time. Returns the build and
    kernel milliseconds, their intersection, and its share of each; "not
    measured" when the trace holds no kernel."""
    builds = []

    def timed(tiles):
        it = iter(tiles)
        while True:
            t0 = time.perf_counter_ns()
            try:
                tile = next(it)
            except StopIteration:
                return
            builds.append((t0, time.perf_counter_ns()))
            yield tile

    tiles = B.cw_catalog_plane_tiles_for(
        batch, *recipe.cgw_params.cpu().unbind(0), pdist=1.0, evolve=recipe.cgw_evolve,
        phase_approx=recipe.cgw_phase_approx, tref_s=recipe.cgw_tref_s, chunk=SOURCES_PER_TILE)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("overlap_anchor"):
            anchor_ns = time.perf_counter_ns()
        B.cw_stream_response(batch, timed(tiles), evolve=recipe.cgw_evolve,
                             psr_term=recipe.cgw_psr_term, prefetch_depth=2)
        torch.cuda.synchronize()
        end_ns = time.perf_counter_ns()
    events = prof.events()
    anchor = [e for e in events if e.name == "overlap_anchor"]
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "cw_catalog_kernel" in e.name]
    if not anchor or not kernels:
        return dict(traced_overlap="not measured")
    # the span's end, a few microseconds after its last host reading (its
    # start carries the profiler's first-call set-up)
    offset_us = anchor[0].time_range.end - anchor_ns / 1e3
    builds_us = [(a / 1e3 + offset_us, b / 1e3 + offset_us) for a, b in builds]
    both = _intersection_us(builds_us, kernels)
    build_us = sum(b - a for a, b in _union_us(builds_us))
    kernel_us = sum(b - a for a, b in _union_us(kernels))
    # the two clocks agree when every kernel lies inside the traced call
    in_window = (min(a for a, _ in kernels) >= anchor[0].time_range.end
                 and max(b for _, b in kernels) <= end_ns / 1e3 + offset_us)
    return dict(traced_build_ms=build_us / 1e3, traced_kernel_ms=kernel_us / 1e3,
                kernels_inside_the_call=in_window,
                traced_overlap_ms=both / 1e3, traced_kernel_launches=len(kernels),
                kernel_share_under_build=both / kernel_us, build_share_under_kernel=both / build_us)


def phase_cw_stream(population32):
    """deterministic_delays with cgw_stream_chunk (SOURCES_PER_TILE, prefetch
    depth 2: tiled host planes staged by the prefetcher, one accumulating
    launch per macro tile) against the monolithic call on the population
    catalog, float32 and float64, bitwise; median of CW_STREAM_REPS calls
    each, the host tile build (the prefetch worker's busy seconds) and
    the peak device memory above what was allocated before. Then one
    float32 call each at 100,000 sources; each row also times the kernels
    over the whole catalog's planes, and reads from a torch.profiler trace
    how much of the host tile build overlapped the accumulating kernels
    (:func:`_traced_overlap`). The launch counts are cleared just before
    the float32 population's streamed call and read just after. The
    accumulating launch is held against its plain version (acc + the
    plain response) at the population's macro and tail shapes, both
    dtypes, and alone at the flagship catalog, timed."""
    rows, accumulate, checks = [], None, []
    for name, nsrc, dtype, reps in (("population", POPULATION["ncw"], torch.float32, CW_STREAM_REPS),
                                    ("population", POPULATION["ncw"], torch.float64, CW_STREAM_REPS),
                                    ("1e5", CW_STREAM_LARGE, torch.float32, 1)):
        if name == "population" and dtype == torch.float32:
            batch, recipe = population32
        else:
            batch, recipe = flagship_workload(**{**POPULATION, "ncw": nsrc}, dtype=dtype)
        streamed = dataclasses.replace(recipe, cgw_stream_chunk=SOURCES_PER_TILE,
                                       cgw_prefetch_depth=2)
        row = dict(catalog=name, shape=[batch.npsr, batch.ntoa_max, nsrc], dtype=str(dtype),
                   tile=SOURCES_PER_TILE, prefetch_depth=2)
        results = {}
        for mode, rec in (("monolithic", recipe), ("streamed", streamed)):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if mode == "streamed" and name == "population" and dtype == torch.float32:
                launches.clear()
                results[mode] = deterministic_delays(batch, rec)
                torch.cuda.synchronize()
                accumulate = dict(launches)
            else:
                results[mode] = deterministic_delays(batch, rec)
                torch.cuda.synchronize()
            row[f"{mode}_peak_extra_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            times = [_timed_ms(lambda: deterministic_delays(batch, rec), reps=1)[1]
                     for _ in range(reps)]
            row[f"{mode}_ms"] = times
            row[f"{mode}_median_ms"] = float(np.median(times))
        stats = {}
        B.cgw_catalog_delays_streamed(
            batch, *streamed.cgw_params.cpu().unbind(0), pdist=1.0,
            psr_term=streamed.cgw_psr_term, evolve=streamed.cgw_evolve,
            phase_approx=streamed.cgw_phase_approx, tref_s=streamed.cgw_tref_s,
            chunk=SOURCES_PER_TILE, prefetch_depth=2, stats=stats)
        torch.cuda.synchronize()
        params = recipe.cgw_params.cpu().unbind(0)
        (src, psr, _), planes_build_ms = _timed_ms(lambda: B.cw_catalog_planes_for(
            batch, *params, pdist=1.0, evolve=recipe.cgw_evolve,
            phase_approx=recipe.cgw_phase_approx, tref_s=recipe.cgw_tref_s), reps=1)
        u = batch.toas_s - torch.tensor(batch.start_s, dtype=dtype, device=batch.device)
        kernel_ms = cuda_ms(lambda: cw.cw_catalog_response(u, src, psr), 3)
        if name == "population":
            checks.extend(_accumulate_vs_plain(u, src, psr, recipe, dtype))
        del src, psr
        build_s, wall_s = stats["stage_busy_s"]["cw_stream_stage"], stats["wall_s"]
        row.update(bitwise_equal=bool(torch.equal(results["streamed"], results["monolithic"])),
                   finite=bool(torch.isfinite(results["streamed"]).all()),
                   host_tile_build_s=build_s, consumer_wait_s=stats["stall_s"],
                   stream_wall_s=wall_s, macros=stats["items"],
                   bytes_staged=stats["bytes_staged"], monolithic_planes_build_ms=planes_build_ms,
                   kernel_ms_whole_catalog=kernel_ms,
                   # an estimate beside the trace's reading: the worker's
                   # busy seconds (its waits on copy events included) plus
                   # the kernels' time alone, less the wall, over the
                   # kernels' time; not clamped
                   overlap_estimate=(build_s + kernel_ms / 1e3 - wall_s) / (kernel_ms / 1e3),
                   **_traced_overlap(batch, streamed))
        rows.append(row)
        emit("cw_stream", **row)
        require(row["bitwise_equal"] and row["finite"],
                f"streamed catalog differs from the monolithic kernel: {row}")
        del results, batch, recipe, streamed
        torch.cuda.empty_cache()
    require(accumulate.get("cw_catalog_accumulate", 0) > 0,
            f"the streamed catalog never launched the accumulating kernel: {accumulate}")

    batch, recipe = flagship_workload(**FLAGSHIP)
    u = batch.toas_s - torch.tensor(batch.start_s, dtype=batch.dtype, device=batch.device)
    src, psr = _catalog_planes(batch, recipe.cgw_params.cpu().numpy(), True, 0.0)
    acc0 = cw.cw_catalog_response(u, src, psr) * 0.5
    want, plain_ms = _once_ms(lambda: acc0 + cw.cw_catalog_response_plain(u, src, psr))
    got = cw.cw_catalog_response(u, src, psr, out=acc0.clone())
    torch.cuda.synchronize()
    acc = acc0.clone()
    ms = cuda_ms(lambda: cw.cw_catalog_response(u, src, psr, out=acc), CW_REPS["flagship"])
    bound, bound_by = cw_bound(*u.shape, src.shape[1], batch.dtype, True, True)
    check = dict(catalog="flagship", dtype=str(batch.dtype), shape=[*u.shape, src.shape[1]],
                 rel_rms=rel_rms(got, want), tol=TOL[batch.dtype],
                 max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                 bound_ms=bound, bound_by=bound_by, finite=bool(torch.isfinite(got).all()))
    for row in checks + [check]:
        emit("cw_accumulate_vs_plain", **row)
        require(row["finite"] and row["rel_rms"] <= row["tol"],
                f"the accumulating launch vs plain: {row}")
    return accumulate.get("cw_catalog_accumulate", 0), check


def _accumulate_vs_plain(u, src, psr, recipe, dtype):
    """The accumulating launch at the shapes the streamed population
    catalog gives it, against its plain version on the same inputs: the
    first macro tile (SOURCES_PER_MACRO sources) into a zero accumulator,
    then the rest of the catalog (at 10,000 sources, the stream's last,
    narrower macro) into that sum."""
    kw = dict(psr_term=recipe.cgw_psr_term, evolve=recipe.cgw_evolve)
    acc, rows = torch.zeros_like(u), []
    for part, cols in (("macro", slice(0, SOURCES_PER_MACRO)),
                       ("tail", slice(SOURCES_PER_MACRO, None))):
        s, p = src[:, cols].contiguous(), psr[..., cols].contiguous()
        want, plain_ms = _once_ms(lambda: acc + cw.cw_catalog_response_plain(u, s, p, **kw))
        got = cw.cw_catalog_response(u, s, p, out=acc.clone(), **kw)
        torch.cuda.synchronize()
        rows.append(dict(catalog=f"population {part}", dtype=str(dtype),
                         shape=[*u.shape, s.shape[1]], rel_rms=rel_rms(got, want),
                         tol=TOL[dtype], max_abs_err=float((got - want).abs().max()),
                         plain_ms=plain_ms, finite=bool(torch.isfinite(got).all())))
        acc = got
    return rows


#: the kernels line's reason where no single PyTorch call computes a kernel
# ------------------------------------------------- the full-model refit

def _fit_design(batch):
    """(Np, Nt, FIT_COLUMNS) standard normals drawn on the card from a fixed
    generator (no 350 MB upload), masked: bench.py's BENCH_FIT design."""
    g = torch.Generator(device=batch.device).manual_seed(FIT_SEED)
    design = torch.randn((batch.npsr, batch.ntoa_max, FIT_COLUMNS), generator=g,
                         dtype=batch.dtype, device=batch.device)
    return design * batch.mask[..., None]


def _projection(system, res, batch):
    """The projection gate's value, float64: max over realizations,
    pulsars and columns of |Mn_k^T W r| / |r|_W, W the white weights (WLS)
    or C^-1 (GLS, the system's own float64 operator), for ``res`` the
    fit's output (``system.subtract``). ``finalize_residuals`` then removes
    the weighted mean, as the reference does (a design need not span a
    constant), which moves a random column's projection to ~0.3 at the
    flagship: that shift is not the fit's."""
    r = res.double()
    if system.gls:
        Wr = system.cinv_mat(r[..., None])[..., 0]
        p = torch.einsum("pnk,...pn->...pk", system.design, Wr) / system.norms
    else:
        w = (batch.mask / batch.errors_s).double()
        Wr = r * w**2
        p = torch.einsum("pnk,...pn->...pk", system.design.double(), r * w)
    rnorm = torch.sqrt(torch.sum(r * Wr, dim=-1))
    return float((p.abs() / rnorm[..., None]).max())


def _c_matvec(batch, recipe, Y):
    """C Y for Y (Np, Nt, Q), float64, C the recipe's GLS noise model
    applied forward from its parts: the white diagonal, each epoch's ECORR
    block (a scatter over the epoch index), U diag(phi) U^T and the
    ``noise_cov`` block's own matvec, masked."""
    f64 = torch.float64
    b64, r64 = batch.astype(f64), dataclasses.replace(recipe, fit_design=None).astype(f64)
    sigma2, ecorr2, U, phi = B.gls_noise_model(b64, r64)
    mask = b64.mask[..., None]
    Y = Y * mask
    out = sigma2[..., None] * Y
    if ecorr2 is not None:
        idx = b64.epoch_index[..., None].expand(Y.shape)
        sums = torch.zeros((Y.shape[0], ecorr2.shape[1], Y.shape[2]), dtype=f64,
                           device=Y.device).scatter_add_(1, idx, Y)
        out = out + torch.gather(ecorr2[..., None] * sums, 1, idx)
    if U is not None:
        out = out + torch.einsum("pnr,prq->pnq", U, phi[..., None] * torch.einsum("pnr,pnq->prq", U, Y))
    if r64.noise_cov is not None:
        out = out + r64.noise_cov.matvec(Y, s2=recipe_cov_s2(r64, f64))
    return out * mask


def _inverse_residual(system, res, batch, recipe):
    """The GLS system's C^-1 held against C applied forward (TOL_INVERSE):
    max over realizations and pulsars of |C z - r| / |r|, z = C^-1 r for
    ``res`` (R, Np, Nt) the fit's output, float64."""
    r = res.double().permute(1, 2, 0)
    z = system.cinv_mat(r)
    num = torch.linalg.vector_norm(_c_matvec(batch, recipe, z) - r * batch.mask[..., None], dim=1)
    return float((num / torch.linalg.vector_norm(r, dim=1)).max())


def _f32_apply_control(system, res_of, batch, recipe):
    """The projection of the same GLS fit with its C^-1 apply in float32
    (``gls_cinv(dtype=float32)``, the precision the port rejects): the
    control that TOL_PROJECTION["gls"] must fail. ``res_of(system)`` fits."""
    cinv32 = B.gls_cinv(batch, recipe, dtype=torch.float32)
    control = dataclasses.replace(system, cinv_mat=lambda X: cinv32(X.float()).double())
    return _projection(system, res_of(control), batch)


def _chunk_delays(batch, recipe, static, generator, nreal):
    """(nreal, Np, Nt) delays of one chunk before its fit."""
    draws = B.draw_noise(generator, batch, recipe, nreal)
    return (B.realization_delays(batch, recipe, draws) + static).expand(
        (nreal,) + tuple(batch.toas_s.shape))


def _rate(run):
    """(realizations per second, the last result) of NCHUNKS chunks of
    CHUNK after one warm-up chunk, synchronised."""
    out = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        out = run()
    torch.cuda.synchronize()
    return NCHUNKS * CHUNK / (time.perf_counter() - t0), out


def _fit_card_vs_cpu(phase, make_recipe, nreal=SMALL_BANK):
    """The same explicit noise realized with a FIT_COLUMNS-column design
    fit on the card and on the CPU, float64: the largest |error| over the
    largest |entry|. ``make_recipe(batch, recipe, design)``."""
    out = {}
    design = np.random.default_rng(4).standard_normal((SMALL["npsr"], SMALL["ntoa"], FIT_COLUMNS))
    rng = np.random.default_rng(5)
    noise = None
    for device in ("cpu", "cuda"):
        b, r = flagship_workload(**SMALL, dtype=torch.float64, device=device)
        r = make_recipe(b, r, torch.as_tensor(design, device=device))
        if noise is None:
            noise = {k: rng.standard_normal((nreal,) + s) for k, s in B.noise_shapes(b, r).items()}
        out[device] = realize(None, b, r, nreal, fit=True, noise=noise, device=device).cpu()
    rel = _rel_max(out["cuda"], out["cpu"])
    emit(phase, shape=SMALL, nreal=nreal, columns=FIT_COLUMNS, rel_card_vs_cpu=rel,
         tol=TOL_FIT_CARD_VS_CPU)
    require(rel <= TOL_FIT_CARD_VS_CPU, f"{phase}: card vs CPU {rel}")
    return rel


def phase_full_fit(batch, recipe, static, generator):
    """The flagship chunk (f32, 200) with its three refits: the quadratic,
    WLS and GLS (weighted by the recipe's own white, ECORR and 120-column
    GP model) of a 166-column design drawn on the card. Realizations/s per
    mode (the assembly built once, as a sweep does), the assembly's ms,
    gls_fit_uncertainties' ms, each fit's device ms on one chunk, the
    sidecar fingerprint's ms with the design, and the projection gate;
    then card f64 vs CPU f64 at the small shape, both modes."""
    design = _fit_design(batch)
    recipes = {"quadratic": recipe,
               "wls": dataclasses.replace(recipe, fit_design=design),
               "gls": dataclasses.replace(recipe, fit_design=design, fit_gls=True)}
    delays = _chunk_delays(batch, recipe, static, generator, CHUNK)
    row = dict(shape=FLAGSHIP, chunk=CHUNK, columns=FIT_COLUMNS, tol_projection=TOL_PROJECTION,
               tol_inverse=TOL_INVERSE, realizations_per_s={}, assembly_ms={}, fit_device_ms={},
               projection={})
    for mode, rec in recipes.items():
        system = None
        if mode != "quadratic":
            system, row["assembly_ms"][mode] = _timed_ms(lambda: B.fit_system(batch, rec))
        rate, res = _rate(lambda: realize(generator, batch, rec, CHUNK, fit=True, static=static,
                                          system=system))
        row["realizations_per_s"][mode] = rate
        row["fit_device_ms"][mode] = cuda_ms(
            lambda: B.finalize_residuals(delays, batch, rec, True, system=system), 5)
        require(bool(torch.isfinite(res).all()), f"full_fit {mode}: non-finite residuals")
        if system is not None:
            fitted = system.subtract(delays)
            row["projection"][mode] = _projection(system, fitted, batch)
        if mode == "gls":
            row["inverse_residual"] = _inverse_residual(system, fitted, batch, rec)
            row["projection_f32_apply_control"] = _f32_apply_control(
                system, lambda s: s.subtract(delays), batch, rec)
        del res, system
    sig, row["uncertainties_ms"] = _timed_ms(
        lambda: B.gls_fit_uncertainties(batch, design, recipes["gls"]), reps=1)
    row["uncertainties_finite"] = bool(torch.isfinite(sig).all() and (sig > 0).all())
    _, row["fingerprint_ms"] = _timed_ms(lambda: sweep_mod._fingerprint(batch, recipe), reps=1)
    _, row["fingerprint_ms_with_design"] = _timed_ms(
        lambda: sweep_mod._fingerprint(batch, recipes["gls"]), reps=1)
    row["design_mb"] = design.numel() * design.element_size() / 1e6
    emit("full_fit", **row)
    require(row["uncertainties_finite"], f"full_fit: gls_fit_uncertainties {row}")
    require(all(v <= TOL_PROJECTION[m] for m, v in row["projection"].items()),
            f"full_fit projection: {row}")
    require(row["inverse_residual"] <= TOL_INVERSE, f"full_fit: C^-1 against C: {row}")
    require(row["projection_f32_apply_control"] > TOL_PROJECTION["gls"],
            f"full_fit: the projection limit passes the float32 apply it must fail: {row}")
    del design, recipes, delays, fitted
    torch.cuda.empty_cache()
    _fit_card_vs_cpu("full_fit_card_vs_cpu_wls",
                     lambda b, r, d: dataclasses.replace(r, fit_design=d))
    _fit_card_vs_cpu("full_fit_card_vs_cpu_gls",
                     lambda b, r, d: dataclasses.replace(r, fit_design=d, fit_gls=True))


def phase_full_fit_banded(batch, recipe, static, generator):
    """Config B with the GLS refit (f32 chunk of 200; the C^-1 apply in
    f64): the assembly factors C0 once (B.4) and solves the GP basis (Q =
    120) and the design (Q = 166) through B.4/B.5; each chunk's C0 solve
    takes its 200 realizations as right-hand sides of one B.4/B.5 pair.
    Launch counts cleared before and read after each stage; then card vs
    CPU at the small shape."""
    f64 = torch.float64
    design = _fit_design(batch)
    rec = dataclasses.replace(_config_b(batch, recipe, torch.float32), fit_design=design,
                              fit_gls=True)
    launches.clear()
    system = B.fit_system(batch, rec)
    torch.cuda.synchronize()
    assembly_counts = {k: launches[k] for k in COV_KERNELS}
    _, assembly_ms = _timed_ms(lambda: B.fit_system(batch, rec))
    launches.clear()
    run = lambda: realize(generator, batch, rec, CHUNK, fit=True, static=static, system=system)
    res = run()
    torch.cuda.synchronize()
    chunk_counts = {k: launches[k] for k in COV_KERNELS}
    rate, res = _rate(run)
    busy, top = _device_busy(run)
    safe, _ = _safe_sigma2(batch.astype(f64), rec)
    D, E = cov_structure.banded_c0_blocks(rec.noise_cov, safe, recipe_cov_s2(rec, f64), f64)
    _, factor_ms = _timed_ms(lambda: ops_gp.tridiag_forward(D, E))
    row = dict(shape=FLAGSHIP, block=BANDED["block"], chunk=CHUNK, columns=FIT_COLUMNS,
               realizations_per_s=rate, assembly_ms=assembly_ms, factor_ms=factor_ms,
               assembly_launches=assembly_counts, chunk_launches=chunk_counts,
               chunk_tridiag_device_ms=sum(ms for k, ms in top if "tridiag" in k),
               chunk_tridiag_kernels_ms=[[k, ms] for k, ms in top if "tridiag" in k],
               device_busy_share=busy, top_kernels_ms=top[:5],
               tol_projection=TOL_PROJECTION["gls"], tol_inverse=TOL_INVERSE)
    fitted = system.subtract(_chunk_delays(batch, rec, static, generator, CHUNK))
    row["projection"] = _projection(system, fitted, batch)
    row["inverse_residual"] = _inverse_residual(system, fitted, batch, rec)
    emit("full_fit_banded", **row)
    require(assembly_counts["tridiag_factor_solve_fwd"] >= 1
            and assembly_counts["tridiag_solve_fwd"] >= 2
            and chunk_counts["tridiag_solve_fwd"] == 1 and chunk_counts["tridiag_factor_solve_bwd"] == 1,
            f"config B's GLS refit did not run B.4/B.5 as planned: {row}")
    require(row["projection"] <= TOL_PROJECTION["gls"], f"full_fit_banded projection: {row}")
    require(row["inverse_residual"] <= TOL_INVERSE, f"full_fit_banded: C^-1 against C: {row}")
    del system, res, D, E, design, rec, fitted
    torch.cuda.empty_cache()
    _fit_card_vs_cpu("full_fit_banded_card_vs_cpu", lambda b, r, d: dataclasses.replace(
        _config_b(b, r, torch.float64), fit_design=d, fit_gls=True))
    return {k: assembly_counts[k] + chunk_counts[k] for k in COV_KERNELS}


def phase_full_fit_dense():
    """Config D (68 x 2,048, f64, the Kronecker op with ECORR) with the GLS
    refit: the assembly materializes C0 and factors it once on the blocked
    Cholesky (B.2); a bank of DENSE_BANK realizations then applies the
    hoisted factor (no B.2 launch per chunk, where a rebuild would
    refactor C0). Then card vs CPU at the small shape."""
    batch, recipe = flagship_workload(**DENSE_SHAPE, dtype=torch.float64)
    design = _fit_design(batch)
    rec = dataclasses.replace(_config_d(batch, recipe), fit_design=design, fit_gls=True)
    generator = torch.Generator(device=batch.device).manual_seed(4)
    static = deterministic_delays(batch, rec)
    launches.clear()
    system = B.fit_system(batch, rec)
    torch.cuda.synchronize()
    assembly_syrk = launches["cov_syrk_update"]
    _, assembly_ms = _timed_ms(lambda: B.fit_system(batch, rec))
    busy_a, top_a = _device_busy(lambda: B.fit_system(batch, rec))
    launches.clear()
    run = lambda: realize(generator, batch, rec, DENSE_BANK, fit=True, static=static, system=system)
    res, realize_ms = _timed_ms(run)
    chunk_syrk = launches["cov_syrk_update"]
    row = dict(shape=DENSE_SHAPE, nreal=DENSE_BANK, columns=FIT_COLUMNS,
               realizations_per_s=DENSE_BANK / (realize_ms / 1e3), realize_ms=realize_ms,
               assembly_ms=assembly_ms, assembly_syrk_launches=assembly_syrk,
               assembly_syrk_device_ms=sum(ms for k, ms in top_a if "cov_syrk" in k),
               assembly_device_busy_share=busy_a, assembly_top_kernels_ms=top_a[:5],
               chunk_syrk_launches=chunk_syrk // 3,
               tol_projection=TOL_PROJECTION["gls"], tol_inverse=TOL_INVERSE)
    fitted = system.subtract(_chunk_delays(batch, rec, static, generator, DENSE_BANK))
    row["projection"] = _projection(system, fitted, batch)
    row["inverse_residual"] = _inverse_residual(system, fitted, batch, rec)
    emit("full_fit_dense", **row)
    require(assembly_syrk > 0 and chunk_syrk == 0,
            f"config D's GLS refit: B.2 not once in the assembly alone: {row}")
    require(row["projection"] <= TOL_PROJECTION["gls"], f"full_fit_dense projection: {row}")
    require(row["inverse_residual"] <= TOL_INVERSE, f"full_fit_dense: C^-1 against C: {row}")
    del system, res, design, rec, batch, fitted
    torch.cuda.empty_cache()
    _fit_card_vs_cpu("full_fit_dense_card_vs_cpu", lambda b, r, d: dataclasses.replace(
        _config_d(b, r), fit_design=d, fit_gls=True))
    return assembly_syrk


def phase_full_fit_likelihood(batch, recipe, generator):
    """The f64 GLS-fitted flagship bank (200) priced with its own design:
    bank_loglikelihood(..., design=fit_design, fused=True) over the 4 x 4
    GWB grid runs B.3 at Q = 166 + 120 = 286 (launches cleared just
    before, read just after), cross-checked against fused=False; then the
    B.3 row at Q = 286 against its plain version and torch.bmm."""
    design = _fit_design(batch)
    rec = dataclasses.replace(recipe, fit_design=design, fit_gls=True)
    bank = realize(generator, batch, rec, CHUNK, fit=True)
    grid, shape = lk.grid_cartesian(DENSE_GRID)
    launches.clear()
    ll = lk.bank_loglikelihood(bank, batch, rec, grid=grid, design=design, fused=True).cpu()
    count = launches["fused_woodbury_update"]
    ll_c = lk.bank_loglikelihood(bank, batch, rec, grid=grid, design=design).cpu()
    rel = float(((ll - ll_c).abs() / ll_c.abs()).max())
    _, call_ms = _timed_ms(lambda: lk.bank_loglikelihood(bank, batch, rec, grid=grid,
                                                         design=design, fused=True))
    G, R = int(np.prod(shape)), bank.shape[0]
    out = dict(bank_shape=list(bank.shape), grid_shape=list(shape),
               basis_columns=FIT_COLUMNS + int(lgp.phi_for_recipe(batch, rec).shape[-1]),
               woodbury_launches=count, rel_fused_vs_composed=rel, tol=TOL_LIKELIHOOD,
               call_ms=call_ms, evals_per_s=G * R / (call_ms / 1e3),
               finite=bool(torch.isfinite(ll).all()))
    emit("full_fit_likelihood", **out)
    require(count == 1 and out["basis_columns"] == 286,
            f"the GLS-fitted bank did not launch B.3 once at Q = 286: {out}")
    require(out["finite"] and rel <= TOL_LIKELIHOOD, f"GLS-fitted bank fused vs composed: {out}")
    del bank
    torch.cuda.empty_cache()
    basis = "GLS-fitted bank: design 166 + GP 120"
    row = phase_woodbury_kernel(batch, rec, design, basis)
    bf16_row = phase_woodbury_bf16(batch, rec, design, basis, (torch.float64,))[torch.float64]
    return count, row, bf16_row


def phase_deterministic_families(batch, recipe, generator):
    """deterministic_delays at the flagship width (f32) with the CW catalog
    plus one burst, one burst with memory and one transient, drawn as the
    reference's scenario compiler draws them; then a realize chunk with a
    user GWB spectrum in place of the power law. Gates, float64 card vs
    CPU at the small shape: the three new families <= TOL_FAMILIES, the
    sum with the CW catalog <= the CW kernel's TOL, the user-spectrum
    realizations <= TOL_FIT_CARD_VS_CPU."""
    def with_families(b, r):
        fam = deterministic_families(b, seed=7, transient_psr=5)
        return dataclasses.replace(
            r, **{k: v if k == "transient_psr" else torch.as_tensor(v, device=b.device)
                  for k, v in fam.items()})

    def with_spectrum(b, r):
        return dataclasses.replace(r, gwb_log10_amplitude=None, gwb_gamma=None,
                                   gwb_user_spectrum=torch.as_tensor(USER_SPECTRUM, device=b.device))

    rec = with_families(batch, recipe)
    launches.clear()
    static, static_ms = _timed_ms(lambda: deterministic_delays(batch, rec))
    counts = {k: launches[k] // 3 for k in ("cw_catalog_response", "cw_fold_planes")}
    _, cw_only_ms = _timed_ms(lambda: deterministic_delays(batch, recipe))
    no_cw = dataclasses.replace(rec, cgw_params=None)
    fam_only, families_ms = _timed_ms(lambda: deterministic_delays(batch, no_cw))
    spec = with_spectrum(batch, rec)
    spectrum_rate, _ = _rate(lambda: realize(generator, batch, spec, CHUNK, fit=True,
                                             static=static))
    power_law_rate, _ = _rate(lambda: realize(generator, batch, rec, CHUNK, fit=True,
                                              static=static))
    cb, cr = flagship_workload(**SMALL, dtype=torch.float64, device="cpu")
    gb, gr = flagship_workload(**SMALL, dtype=torch.float64)
    cr, gr = with_families(cb, cr), with_families(gb, gr)
    gates = {}
    for name, drop_cw, tol in (("families", True, TOL_FAMILIES),
                               ("families_and_cw", False, TOL[torch.float64])):
        pick = lambda r: dataclasses.replace(r, cgw_params=None) if drop_cw else r
        ref = deterministic_delays(cb, pick(cr), device="cpu")
        gates[name] = (_rel_max(deterministic_delays(gb, pick(gr)).cpu(), ref), tol)
    rng = np.random.default_rng(6)
    cr, gr = with_spectrum(cb, cr), with_spectrum(gb, gr)
    noise = {k: rng.standard_normal((SMALL_BANK,) + s) for k, s in B.noise_shapes(cb, cr).items()}
    ref = realize(None, cb, cr, SMALL_BANK, fit=True, noise=noise, device="cpu")
    got = realize(None, gb, gr, SMALL_BANK, fit=True, noise=noise).cpu()
    gates["user_spectrum_realize"] = (_rel_max(got, ref), TOL_FIT_CARD_VS_CPU)
    row = dict(shape=FLAGSHIP, static_ms=static_ms, cw_only_ms=cw_only_ms,
               families_only_ms=families_ms, chunk=CHUNK,
               user_spectrum_realizations_per_s=spectrum_rate,
               power_law_realizations_per_s=power_law_rate,
               cw_launches=counts, transient_psr=rec.transient_psr,
               finite=bool(torch.isfinite(static).all() and torch.isfinite(fam_only).all()),
               nonzero_families=bool(fam_only.abs().max() > 0),
               card_vs_cpu={k: {"rel": v, "tol": t} for k, (v, t) in gates.items()})
    emit("deterministic_families", **row)
    require(min(counts.values()) > 0, f"deterministic_families never launched B.1: {row}")
    require(row["finite"] and row["nonzero_families"], f"deterministic_families output: {row}")
    require(all(v <= t for v, t in gates.values()), f"deterministic_families card vs CPU: {row}")
    return counts["cw_catalog_response"]


def _unequal_tensors(a, b, where):
    """The tensor fields of two dataclasses (nested ones field by field)
    whose host copies are not bitwise equal, or whose presence differs."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())):
                bad.append(f"{where}.{f.name}")
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            bad += _unequal_tensors(x, y, f"{where}.{f.name}")
    return bad


def _scenario_cw_row(batch, params, tref_s, dtype):
    """B.1 at the scenario's catalog against its plain version, on the
    compiled batch cast to ``dtype`` (the catalog planes built as the path
    builds them, chirped, with the pulsar term)."""
    b = batch.astype(dtype)
    u = b.toas_s - torch.tensor(b.start_s, dtype=dtype, device=b.device)
    src, psr = _catalog_planes(b, params, True, tref_s)
    run = lambda: cw.cw_catalog_response(u, src, psr, True, True)
    want, plain_ms = _once_ms(lambda: cw.cw_catalog_response_plain(u, src, psr, True, True))
    got, again = run(), run()
    torch.cuda.synchronize()
    bound, bound_by = cw_bound(*u.shape, src.shape[1], dtype, True, True)
    row = dict(dtype=str(dtype), shape=[*u.shape, src.shape[1]], rel_rms=rel_rms(got, want),
               tol=TOL[dtype], max_abs_err=float((got - want).abs().max()),
               finite=bool(torch.isfinite(got).all()), same_bits=bool(torch.equal(got, again)),
               ms=cuda_ms(run, SCENARIO_CW_REPS), plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by)
    del want, got, again, src, psr
    return row


def phase_scenario_population(workdir):
    """The declarative scenario path through its entry points, on the card:
    ``load_spec`` and ``compile_spec`` of the committed ng15_population
    spec (host seconds for the whole compile, and for its parts: the
    population's draws and split, the anisotropic ORF's basis and
    Cholesky, the catalog's host planes), then the launch counts cleared,
    ``deterministic_delays`` (the ~3,000-source catalog on B.1, a burst,
    memory and a glitch) and the spec's sweep (400 realizations in chunks
    of 200 with the fit, reduced to per-pulsar RMS) through
    ``utils/sweep.py::sweep`` seeded from the spec, the counts read
    after. Apart: B.1 at the catalog's shape against its plain version,
    float32 and float64. Gates: B.1 launched, the kernel within the CW
    limits and the same bits twice, every compiled tensor equal to the CPU
    compile's bit for bit, the sidecar's provenance, finite outputs."""
    spec = load_spec(str(SCENARIO_SPEC))
    compiled, compile_ms = _timed_ms(lambda: compile_spec(spec), reps=1)
    batch, recipe = compiled.batch, compiled.recipe
    (split, _), split_ms = _timed_ms(lambda: scenario_compile._draw_population(spec, batch),
                                     reps=1)
    chol, orf_ms = _timed_ms(lambda: scenario_compile._orf_cholesky(
        spec.population["orf"], batch, path="population.orf"), reps=1)
    params = recipe.cgw_params.cpu().numpy()
    _, planes_ms = _timed_ms(lambda: B.cw_catalog_planes_for(
        batch, *recipe.cgw_params.cpu().unbind(0), pdist=1.0, evolve=recipe.cgw_evolve,
        tref_s=recipe.cgw_tref_s), reps=1)
    orf_min_eig = float(np.linalg.eigvalsh(chol @ chol.T).min())

    path = str(workdir / "scenario_population.npz")
    torch.cuda.synchronize()
    launches.clear()
    static, static_ms = _timed_ms(lambda: deterministic_delays(batch, recipe,
                                                               device=batch.device), reps=1)
    plan = compiled.plan
    out, sweep_ms = _timed_ms(lambda: sweep(
        compiled.realize_seed(), batch, recipe, plan.nreal, path, chunk=plan.chunk,
        fit=plan.fit, pipeline_depth=plan.pipeline_depth, provenance=compiled.provenance()),
        reps=1)
    counts = {k: launches[k] for k in ("cw_catalog_response", "cw_fold_planes")}
    with open(path + ".meta.json") as fh:
        provenance = json.load(fh).get("provenance")

    host = compile_spec(spec, device="cpu")
    unequal = (_unequal_tensors(compiled.batch, host.batch, "batch")
               + _unequal_tensors(compiled.recipe, host.recipe, "recipe"))
    del host
    rows = {dtype: _scenario_cw_row(batch, params, recipe.cgw_tref_s, dtype)
            for dtype in (torch.float32, torch.float64)}
    row = dict(
        spec=SCENARIO_SPEC.name, hash=compiled.spec_hash, families=list(compiled.families),
        shape=[batch.npsr, batch.ntoa_max], dtype=str(batch.dtype),
        outliers=compiled.drawn["population_outliers"], catalog_shape=list(params.shape),
        free_spectrum_bins=int(split.f_centers.shape[0]), orf_min_eigenvalue=orf_min_eig,
        orf_clm=spec.population["orf"]["clm"], compile_s=compile_ms / 1e3,
        compile_parts_s={"population_split": split_ms / 1e3,
                         "orf_basis_and_cholesky": orf_ms / 1e3,
                         "catalog_planes": planes_ms / 1e3},
        static_ms=static_ms, nreal=plan.nreal, chunk=plan.chunk, fit=plan.fit,
        sweep_s=sweep_ms / 1e3, realizations_per_s=plan.nreal / (sweep_ms / 1e3),
        launches=counts, provenance=provenance, card_vs_cpu_unequal=unequal,
        sweep_shape=list(out.shape), finite=bool(torch.isfinite(static).all()
                                                 and np.isfinite(out).all()),
        cw_kernel_vs_plain={str(k): v for k, v in rows.items()},
    )
    emit("scenario_population", **row)
    require(min(counts.values()) > 0, f"the scenario path never launched B.1: {counts}")
    require(not unequal, f"card compile differs from the CPU compile: {unequal}")
    require(provenance == compiled.provenance(), f"sidecar provenance: {provenance}")
    require(row["finite"] and float(static.abs().max()) > 0
            and out.shape == (plan.nreal, batch.npsr),
            f"scenario outputs: {row}")
    require(orf_min_eig > 0 and row["outliers"] > 0, f"scenario ORF / outliers: {row}")
    for dtype, r in rows.items():
        require(r["finite"] and r["same_bits"] and r["rel_rms"] <= TOL[dtype],
                f"B.1 at the scenario catalog, {dtype}: {r}")
    del static, out
    torch.cuda.empty_cache()
    return counts["cw_catalog_response"], rows[torch.float32], compiled


def _module_cli(*args, timeout=600, env=None):
    """``python -m pta_replicator_tpu_torch ARGS`` in a fresh interpreter
    on the card (``env``: its environment, default this one's): (exit
    code, stdout, stderr, host seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pta_replicator_tpu_torch", *args],
                          cwd=str(Path(__file__).resolve().parent), capture_output=True,
                          text=True, timeout=timeout, env=env)
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0


def _cli(*args, expect_ok=True):
    """One ``python -m pta_replicator_tpu_torch scenario ...`` in a fresh
    interpreter on the card: (exit code, parsed JSON summary or None,
    stderr tail, host seconds)."""
    code, out, err, seconds = _module_cli("scenario", *args)
    summary = json.loads(out.strip().splitlines()[-1]) if code == 0 else None
    require(expect_ok == (code == 0), f"scenario {args[0]} exit {code}: {err[-2000:]}")
    return code, summary, err[-400:], seconds


#: the JAX CLI's JSON summary keys of each action (``pta_replicator_tpu/
#: __main__.py``: validate, compile --out, run --out)
CLI_KEYS = {
    "validate": {"spec", "name", "hash", "valid"},
    "compile": {"spec", "name", "hash", "fingerprint", "families", "npsr", "ntoa", "plan", "out"},
    "run": {"spec", "hash", "checkpoint", "shape", "rms_s", "out"},
}


def phase_scenario_cli(workdir, compiled):
    """``python -m pta_replicator_tpu_torch scenario validate|compile|run`` on
    the same spec, each in a subprocess on the card (``--device`` left at
    its default; validate, compile, run and the refused run at once, then
    the resumed run). Gates: exit 0 and the JAX CLI's summary keys; the
    compile's static plane equal to the in-process one bit for bit; a
    second ``run`` on the finished checkpoint resumes with the same
    checkpoint bytes and the same residuals; a ``--nreal`` that is not a
    multiple of the spec's chunk exits non-zero."""
    spec = str(SCENARIO_SPEC)
    ck, res, res2 = (str(workdir / n) for n in ("cli_ck.npz", "cli_r.npz", "cli_r2.npz"))
    static_out = str(workdir / "cli_static.npz")
    nreal = ["--nreal", str(SCENARIO_CLI_NREAL)]
    # the independent calls run at once, each in its own interpreter; the
    # resumed run waits for the first
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {
            "validate": pool.submit(_cli, "validate", spec),
            "compile": pool.submit(_cli, "compile", spec, "--out", static_out),
            "run": pool.submit(_cli, "run", spec, "--out", res, "--checkpoint", ck, *nreal),
            "bad_nreal": pool.submit(_cli, "run", spec, "--nreal", str(compiled.plan.chunk + 1),
                                     "--checkpoint", str(workdir / "cli_bad.npz"),
                                     expect_ok=False),
        }
        calls = {name: f.result() for name, f in futures.items()}
    bad_nreal = calls.pop("bad_nreal")
    ck_bytes = _file_bytes(ck)
    calls["resume"] = _cli("run", spec, "--out", res2, "--checkpoint", ck, *nreal)
    with np.load(static_out) as z:
        static_equal = bool(np.array_equal(
            z["static"], compiled.static_delays().cpu().numpy()))
    with np.load(res) as a, np.load(res2) as b:
        resumed_equal = bool(np.array_equal(a["residuals"], b["residuals"]))
        shape = list(a["residuals"].shape)
    keys_ok = {name: set(calls[name][1]) == CLI_KEYS[name] for name in CLI_KEYS}
    row = dict(
        spec=SCENARIO_SPEC.name, nreal=SCENARIO_CLI_NREAL, residual_shape=shape,
        seconds={**{name: c[3] for name, c in calls.items()}, "bad_nreal": bad_nreal[3]},
        keys_match_jax_cli=keys_ok,
        hash=calls["validate"][1]["hash"], families=calls["compile"][1]["families"],
        static_equal_in_process=static_equal,
        resumed_checkpoint_bytes_equal=_file_bytes(ck) == ck_bytes,
        resumed_residuals_equal=resumed_equal,
        bad_nreal_exit=bad_nreal[0], bad_nreal_stderr=bad_nreal[2].strip()[-200:],
        rms_s=calls["run"][1]["rms_s"],
    )
    emit("scenario_cli", **row)
    require(all(keys_ok.values()), f"CLI summary keys: {row}")
    require(row["hash"] == compiled.spec_hash and static_equal, f"CLI compile: {row}")
    require(row["resumed_checkpoint_bytes_equal"] and resumed_equal
            and calls["resume"][1]["rms_s"] == row["rms_s"], f"CLI resume: {row}")
    require(shape == [SCENARIO_CLI_NREAL, compiled.batch.npsr, compiled.batch.ntoa_max]
            and "multiple" in bad_nreal[2],
            f"CLI run: {row}")


def _dataset_cli(*args, expect_ok=True):
    """One ``python -m pta_replicator_tpu_torch info|realize ...`` in a
    fresh interpreter on the card: (exit code, parsed JSON summary or None,
    host seconds)."""
    code, out, err, seconds = _module_cli(*args, timeout=900)
    require(expect_ok == (code == 0), f"{args[0]} exit {code}: {err[-3000:]}")
    summary = json.loads(out.strip().splitlines()[-1]) if code == 0 else None
    return code, summary, seconds


def _shift_rows(psrs, rdir):
    """(Np, Nt_max) residualized TOA shifts [s] of the dataset written in
    ``rdir`` against the template pulsars, reloaded by the port (longdouble
    epochs, weighted mean removed per pulsar), zero-padded."""
    from pta_replicator_tpu_torch.io.tim import read_tim

    out = np.zeros((len(psrs), max(p.toas.ntoas for p in psrs)))
    for i, p in enumerate(psrs):
        back = read_tim(str(Path(rdir) / f"{p.name}.tim"))
        shift = np.asarray((back.mjd - p.toas.mjd) * np.longdouble(DAY_S), np.float64)
        w = 1.0 / p.toas.errors_s**2
        out[i, :p.toas.ntoas] = shift - np.sum(w * shift) / np.sum(w)
    return out


def _dataset_card_vs_cpu(psrs, spec_small):
    """The first DATASET_CARD_VS_CPU_PSRS pulsars, float64, the same
    explicit noise realized with the real design's WLS and GLS refits on
    the card and on the CPU: the largest |error| over the largest |entry|."""
    from pta_replicator_tpu_torch.__main__ import _build_recipe
    from pta_replicator_tpu_torch.batch import freeze
    from pta_replicator_tpu_torch.timing.fit import design_tensor

    sub = psrs[:DATASET_CARD_VS_CPU_PSRS]
    design = design_tensor(sub)[0]
    rng = np.random.default_rng(8)
    out, noise = {}, None
    for mode in ("wls", "gls"):
        for device in ("cpu", "cuda"):
            b = freeze(sub, dtype=torch.float64, device=device)
            r = dataclasses.replace(_build_recipe(spec_small, sub),
                                    fit_design=torch.from_numpy(design),
                                    fit_gls=mode == "gls").to(device)
            if noise is None:
                noise = {k: rng.standard_normal((SMALL_BANK,) + s)
                         for k, s in B.noise_shapes(b, r).items()}
            out[mode, device] = realize(None, b, r, SMALL_BANK, fit=True, noise=noise,
                                        device=device).cpu()
    return {mode: _rel_max(out[mode, "cuda"], out[mode, "cpu"]) for mode in ("wls", "gls")}


def phase_dataset_path(workdir, smi):
    """The dataset path on the card, at full width, through its entry
    points: an NG15-shaped par/tim dataset written by the port
    (``utils/fabricate.py``: ``fabricate_toas``, ``ParModel``,
    ``write_partim``), then in process ``load_from_directories`` (every
    tim file through the native reader), ``make_ideal``, ``freeze`` to the
    card, ``design_tensor`` as the recipe's ``fit_design`` and a recipe
    from JSON (per-backend EFAC/EQUAD/ECORR (68, 4), 30-mode red noise, an
    HD GWB, the flagship's 100-source CW catalog), the launch counts
    cleared, ``deterministic_delays`` (B.1) and ``realize`` in chunks of
    200 with the quadratic fit, WLS and GLS of the real design, the counts
    read; then the CLI in subprocesses on the card (``info``, ``realize
    --full-fit --checkpoint --write-partim``, ``realize --gls-fit``, and a
    checkpointed sweep in chunks of 2 whose fourth dataset lies in its
    second chunk, at once). Apart: B.1 against its plain version at this
    shape, float32 and float64. Gates: every residual RMS after make_ideal
    <= 1e-9 s; the card's freeze equal to the CPU's bit for bit; B.1 within
    the CW limits and the same bits twice; the refit's projection with the
    real design (WLS <= 1e-5, GLS <= 5e-7, the float32-apply control above
    the GLS limit) and C z = r <= 1e-6; card vs CPU float64 <= 1e-10; the
    CLI's checkpointed cube equal to an in-process sweep bit for bit;
    datasets 0 and 3 of each CLI sweep (3 in the small sweep's second
    chunk) reloaded within 5e-9 s of their cube rows' pre-fit delays; the
    template's TOAs restored bit for bit after an in-process
    materialization, whose files equal the CLI's."""
    from pta_replicator_tpu_torch.__main__ import _build_recipe
    from pta_replicator_tpu_torch.batch import freeze
    from pta_replicator_tpu_torch.io import tim as tim_io
    from pta_replicator_tpu_torch.simulate import load_from_directories, make_ideal
    from pta_replicator_tpu_torch.timing.fit import design_tensor
    from pta_replicator_tpu_torch.utils.export import materialize_realizations
    from pta_replicator_tpu_torch.utils.fabricate import (
        ng15_like_pulsars, ng15_like_recipe, write_dataset,
    )

    host = {}
    pardir, timdir = str(workdir / "par"), str(workdir / "tim")
    t0 = time.perf_counter()
    write_dataset(ng15_like_pulsars(**DATASET, seed=DATASET_SEED), pardir, timdir)
    host["write_s"] = time.perf_counter() - t0
    tim_mb = sum(f.stat().st_size for f in Path(timdir).iterdir()) / 1e6
    tim_io.reads.clear()
    t0 = time.perf_counter()
    psrs = load_from_directories(pardir, timdir)
    host["load_s"] = time.perf_counter() - t0
    reads = dict(tim_io.reads)
    t0 = time.perf_counter()
    for p in psrs:
        make_ideal(p)
    host["make_ideal_s"] = time.perf_counter() - t0
    ideal_rms = max(float(np.sqrt(np.mean(p.residuals.resids_value**2))) for p in psrs)
    t0 = time.perf_counter()
    batch_cpu = freeze(psrs, device="cpu")
    host["freeze_host_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_h2d = batch_cpu.to("cuda")
    torch.cuda.synchronize()
    host["freeze_h2d_s"] = time.perf_counter() - t0
    batch = freeze(psrs)  # the entry point's own route to the card
    unequal = _unequal_tensors(batch, batch_cpu, "batch") + _unequal_tensors(
        batch, batch_h2d, "batch_h2d")
    del batch_h2d
    t0 = time.perf_counter()
    design, names = design_tensor(psrs, ntoa_max=batch.ntoa_max)
    host["design_tensor_s"] = time.perf_counter() - t0
    spec = ng15_like_recipe(batch.npsr)
    recipe_path = workdir / "recipe.json"
    recipe_path.write_text(json.dumps(spec))
    recipe = _build_recipe(json.loads(recipe_path.read_text()), psrs).to("cuda")
    design_card = torch.from_numpy(design).to("cuda")
    recipes = {"quadratic": recipe,
               "wls": dataclasses.replace(recipe, fit_design=design_card),
               "gls": dataclasses.replace(recipe, fit_design=design_card, fit_gls=True)}
    ntoas = batch.ntoas.cpu().numpy()

    # the path: counts cleared, the CW catalog once, then the refits
    torch.cuda.synchronize()
    launches.clear()
    static, static_ms = _timed_ms(lambda: deterministic_delays(batch, recipe,
                                                               device=batch.device), reps=1)
    generator = torch.Generator(device="cuda").manual_seed(DATASET_SEED)
    rates, projection = {}, {}
    systems = {m: B.fit_system(batch, r) for m, r in recipes.items() if m != "quadratic"}
    for mode, rec in recipes.items():
        rates[mode], res = _rate(lambda: realize(generator, batch, rec, CHUNK, fit=True,
                                                 static=static, system=systems.get(mode),
                                                 device=batch.device))
        require(bool(torch.isfinite(res).all()), f"dataset_path {mode}: non-finite residuals")
        del res
    torch.cuda.synchronize()
    counts = {k: launches[k] for k in ("cw_catalog_response", "cw_fold_planes")}
    delays = _chunk_delays(batch, recipe, static, generator, CHUNK)
    for mode, system in systems.items():
        fitted = system.subtract(delays)
        projection[mode] = _projection(system, fitted, batch)
    inverse = _inverse_residual(systems["gls"], fitted, batch, recipes["gls"])
    control = _f32_apply_control(systems["gls"], lambda s: s.subtract(delays), batch,
                                 recipes["gls"])
    del delays, fitted, systems
    torch.cuda.empty_cache()

    cw_rows = {dtype: _scenario_cw_row(batch, recipe.cgw_params.cpu().numpy(),
                                       recipe.cgw_tref_s, dtype)
               for dtype in (torch.float32, torch.float64)}
    card_vs_cpu = _dataset_card_vs_cpu(psrs, ng15_like_recipe(DATASET_CARD_VS_CPU_PSRS))

    # the CLI, each call in its own interpreter on the card, at once
    common = ["--pardir", pardir, "--timdir", timdir]
    ck, out, out_gls = (str(workdir / n) for n in ("cli_ck.npz", "cli.npz", "cli_gls.npz"))
    ck2, out2 = str(workdir / "cli_small_ck.npz"), str(workdir / "cli_small.npz")
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {
            "info": pool.submit(_dataset_cli, "info", *common),
            "realize_full_fit": pool.submit(
                _dataset_cli, "realize", *common, "--recipe", str(recipe_path), "--out", out,
                "--full-fit", "--checkpoint", ck, "--nreal", str(DATASET_NREAL), "--chunk",
                str(DATASET_CHUNK), "--seed", str(DATASET_SEED), "--write-partim",
                str(workdir / "ds"), "--write-max", str(DATASET_WRITE_MAX)),
            "realize_gls_fit": pool.submit(
                _dataset_cli, "realize", *common, "--recipe", str(recipe_path), "--out", out_gls,
                "--gls-fit", "--nreal", str(CHUNK), "--seed", str(DATASET_SEED)),
            "realize_small_chunks": pool.submit(
                _dataset_cli, "realize", *common, "--recipe", str(recipe_path), "--out", out2,
                "--checkpoint", ck2, "--nreal", str(DATASET_SMALL_NREAL), "--chunk",
                str(DATASET_SMALL_CHUNK), "--seed", str(DATASET_SEED), "--write-partim",
                str(workdir / "ds_small"), "--write-max", str(DATASET_WRITE_MAX)),
        }
        calls = {name: f.result() for name, f in futures.items()}
    info = calls["info"][1]

    # the CLI's checkpointed cube against the in-process sweep, same seed
    # and chunk: the same bits
    in_process = sweep(DATASET_SEED, batch, recipes["wls"], DATASET_NREAL,
                       str(workdir / "in_process.npz"), chunk=DATASET_CHUNK, reduce_fn=None,
                       fit=True, device=batch.device)
    with np.load(out) as z:
        cube_equal = bool(np.array_equal(z["residuals"], in_process))
        fit_saved = str(z["fit"])
    del in_process

    # dataset r <-> pre-fit delays of cube row r: the full-fit sweep's
    # chunk 0, and the small sweep's cube (no fit: its rows are the
    # residualized delays)
    g0 = torch.Generator(device="cuda").manual_seed(chunk_seed(DATASET_SEED, 0))
    prefit = realize(g0, batch, recipe, DATASET_CHUNK, fit=False, static=static,
                     device=batch.device)
    shift_err = {}
    for r in (0, DATASET_WRITE_MAX - 1):
        got = _shift_rows(psrs, workdir / "ds" / f"real{r:05d}")
        shift_err[f"full_fit_r{r}"] = float(np.abs(got - prefit[r].cpu().numpy()).max())
    del prefit
    with np.load(out2) as z:
        small_cube = z["residuals"]
    for r in (0, DATASET_WRITE_MAX - 1):
        got = _shift_rows(psrs, workdir / "ds_small" / f"real{r:05d}")
        shift_err[f"chunks_of_2_r{r}"] = float(np.abs(got - small_cube[r]).max())

    # in process: the same datasets, the template restored, and the rate
    before = [p.toas.mjd.copy() for p in psrs]
    ds_in = workdir / "ds_in_process"
    _, export_ms = _timed_ms(lambda: materialize_realizations(
        psrs, batch, recipes["wls"], DATASET_SEED, DATASET_NREAL, str(ds_in),
        write_max=DATASET_WRITE_MAX, sweep_chunk=DATASET_CHUNK, static=static,
        device=batch.device), reps=1)
    restored = all(np.array_equal(p.toas.mjd, m) for p, m in zip(psrs, before))
    export_mb = sum(f.stat().st_size for f in ds_in.rglob("*")) / 1e6
    same_files = all(
        (ds_in / f"real{r:05d}" / f.name).read_bytes() == f.read_bytes()
        for r in range(DATASET_WRITE_MAX) for f in (workdir / "ds" / f"real{r:05d}").iterdir())

    row = dict(
        nvidia_smi=smi, shape=[batch.npsr, batch.ntoa_max], dtype=str(batch.dtype),
        ntoas_min_max=[int(ntoas.min()), int(ntoas.max())], backends=list(batch.backend_names),
        max_epochs=batch.max_epochs, design_columns=int(design.shape[-1]),
        design_columns_min_max=[min(map(len, names)), max(map(len, names))],
        design_mb=design.nbytes / 1e6, tim_mb=tim_mb, host_s=host, tim_reads=reads,
        ideal_rms_max_s=ideal_rms, card_vs_cpu_freeze_unequal=unequal,
        static_ms=static_ms, launches=counts, chunk=CHUNK, realizations_per_s=rates,
        projection=projection, tol_projection=TOL_PROJECTION, inverse_residual=inverse,
        projection_f32_apply_control=control, card_vs_cpu=card_vs_cpu,
        tol_card_vs_cpu=TOL_FIT_CARD_VS_CPU,
        cli_seconds={name: c[2] for name, c in calls.items()},
        cli_summaries={name: c[1] for name, c in calls.items() if name != "info"},
        info=info, cli_cube_equals_in_process=cube_equal, cli_fit=fit_saved,
        shift_max_abs_s=shift_err, tol_shift_s=TOL_SHIFT_S, template_restored=restored,
        export_s=export_ms / 1e3, export_mb=export_mb,
        export_mb_per_s=export_mb / (export_ms / 1e3), export_files_equal_cli=same_files,
        cw_kernel_vs_plain={str(k): v for k, v in cw_rows.items()},
    )
    emit("dataset_path", **row)
    require(reads == {"native": batch.npsr}, f"tim files not all read natively: {reads}")
    require(ideal_rms <= TOL_IDEAL_RMS_S, f"make_ideal left {ideal_rms} s")
    require(not unequal, f"card freeze differs from the CPU freeze: {unequal}")
    require(int(ntoas.max()) == DATASET["ntoa_max"] and len(set(ntoas.tolist())) > 1,
            f"dataset not ragged to {DATASET['ntoa_max']}: {row['ntoas_min_max']}")
    require(min(counts.values()) > 0, f"the dataset path never launched B.1: {counts}")
    for dtype, r in cw_rows.items():
        require(r["finite"] and r["same_bits"] and r["rel_rms"] <= TOL[dtype],
                f"B.1 at the dataset, {dtype}: {r}")
    require(all(v <= TOL_PROJECTION[m] for m, v in projection.items()),
            f"dataset_path projection with the real design: {projection}")
    require(inverse <= TOL_INVERSE, f"dataset_path: C z = r reads {inverse}")
    require(control > TOL_PROJECTION["gls"],
            f"dataset_path: the float32-apply control passes the GLS limit: {control}")
    require(all(v <= TOL_FIT_CARD_VS_CPU for v in card_vs_cpu.values()),
            f"dataset_path card vs CPU: {card_vs_cpu}")
    require(info == {"npsr": batch.npsr, "ntoa_max": batch.ntoa_max, "names": list(batch.names),
                     "backends": list(batch.backend_names), "max_epochs": batch.max_epochs,
                     "tref_mjd": float(batch.tref_mjd)}, f"CLI info: {info}")
    require(cube_equal and fit_saved == "wls", "CLI cube differs from the in-process sweep")
    require(calls["realize_gls_fit"][1]["fit"] == "gls"
            and calls["realize_full_fit"][1]["partim_dirs"] == DATASET_WRITE_MAX,
            f"CLI summaries: {row['cli_summaries']}")
    require(all(v <= TOL_SHIFT_S for v in shift_err.values()), f"dataset r <-> row r: {shift_err}")
    require(restored and same_files, "materialization: template or files")
    del static, batch, batch_cpu, recipe, recipes, design_card
    torch.cuda.empty_cache()
    return counts["cw_catalog_response"], cw_rows[torch.float32]


#: the telemetry phase (PR 18): the CLI's checkpointed realize at the
#: dataset's width, and the in-process sweep whose rate and synchronizing
#: calls are held with and without a capture
TELEMETRY_NREAL, TELEMETRY_CHUNK = 400, 200
TELEMETRY_SWEEP = dict(nreal=2000, chunk=200, pipeline_depth=2)
#: captured / uncaptured pairs (ABBA; 0.2 s sweeps on a host whose
#: single-sweep rates spread by 10%: five pairs for a stable median)
TELEMETRY_REPS = 5
#: the capture's median sweep rate over the rate without, at least
TELEMETRY_RATE_FLOOR = 0.90
TELEMETRY_GRID = ["gwb_log10_amplitude=-14.6:-13.6:3"]
#: CUDA runtime calls that block the host on the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def telemetry_spans(npsr):
    """The span paths and calls of ``realize --checkpoint --chunk 200
    --nreal 400 --fit --telemetry`` at depth 2 on ``npsr`` pulsars: the
    JAX CLI's set (tests/test_torch_telemetry_cli.py holds the two equal on
    the CPU)."""
    ing = "realize/ingest"
    pipe = "realize/compute/sweep_pipeline"
    nchunks = TELEMETRY_NREAL // TELEMETRY_CHUNK
    return {
        "realize": 1, ing: 1, f"{ing}/load_pulsars": 1,
        f"{ing}/load_pulsars/read_par": npsr, f"{ing}/load_pulsars/read_tim": npsr,
        f"{ing}/make_ideal": npsr, "realize/freeze": 1, "realize/build_recipe": 1,
        "realize/compute": 1, "realize/compute/static_delays": 1, pipe: 1,
        f"{pipe}/dispatch": nchunks, f"{pipe}/drain": nchunks, f"{pipe}/io_write": nchunks,
        "realize/write_output": 1,
    }


def _npz_members(path):
    """Each member's name and stored bytes (the npy payloads; the zip's
    own timestamps excluded)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def _capture(directory):
    """A capture directory read back: span calls by path, metric values
    by name (the first instance), meta.json, and the events.jsonl records
    that fail the port's EVENT_SCHEMA."""
    from pta_replicator_tpu_torch.obs import report as obs_report
    from pta_replicator_tpu_torch.obs.trace import EVENT_SCHEMA

    data = obs_report.load_telemetry(str(directory))
    spans = obs_report.aggregate_spans(data["events"])
    bad = []
    for rec in data["events"]:
        schema = EVENT_SCHEMA.get(rec.get("type"))
        if schema is None or any(not isinstance(rec.get(f), t) for f, t in schema.items()):
            bad.append(rec)
    metrics = {name: insts[0].get("value", insts[0].get("count"))
               for name, insts in (data["metrics"] or {}).items()}
    return dict(spans=spans, calls={p: a["calls"] for p, a in spans.items()},
                metrics=metrics, meta=data["meta"] or {}, bad=bad,
                problems=data["problems"])


def _telemetry_sweep(batch, recipe, path, directory=None):
    """One in-process sweep at TELEMETRY_SWEEP (the default reduce), under
    a capture into ``directory`` when given: (realizations per second of
    the sweep call, seconds of the capture's finish)."""
    from pta_replicator_tpu_torch import obs

    sweep_mod._cleanup_chunks(str(path), TELEMETRY_SWEEP["nreal"] // TELEMETRY_SWEEP["chunk"])
    for leftover in (path, Path(str(path) + ".meta.json")):
        Path(leftover).unlink(missing_ok=True)
    if directory is not None:
        obs.start_capture(str(directory))
    try:
        t0 = time.perf_counter()
        sweep(DATASET_SEED, batch, recipe, TELEMETRY_SWEEP["nreal"], str(path),
              chunk=TELEMETRY_SWEEP["chunk"], fit=True,
              pipeline_depth=TELEMETRY_SWEEP["pipeline_depth"], device=batch.device)
        seconds = time.perf_counter() - t0
    finally:
        t1 = time.perf_counter()
        if directory is not None:
            obs.finish_capture(context={"phase": "telemetry"})
        finish_s = time.perf_counter() - t1
        # the next run without a capture streams nowhere: the sink closed,
        # the buffers cleared (a capture's tracer keeps its sink open)
        obs.configure(None)
        obs.reset_all()
    return TELEMETRY_SWEEP["nreal"] / seconds, finish_s


def _sync_calls(run, calls=SYNC_CALLS):
    """The CUDA runtime's synchronizing calls (or other ``calls``) during
    ``run()`` under torch.profiler, by name, and B.1's launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    launches.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = {name: 0 for name in calls}
    for evt in prof.key_averages():
        if evt.key in counts:
            counts[evt.key] += evt.count
    # the profiler's own closing synchronize is the same in both runs
    return counts, launches.get("cw_catalog_response", 0)


def phase_telemetry(workdir, smi):
    """Telemetry on the card (A.16.1), on the dataset path's 68-pulsar
    NG15-shaped dataset and its recipe (the 100-source CW catalog). (1)
    ``realize --checkpoint --chunk 200 --nreal 400 --fit`` in fresh
    interpreters, with ``--telemetry DIR`` and without, at once, beside
    ``scenario compile ng15_population.json --telemetry``; then
    ``likelihood --telemetry`` over the capture run's bank (a 3-point GWB
    axis), and ``report DIR --json`` and ``report DIR``. (2) In process, at
    the flagship shape of that dataset (68 x 7,758, chunk 200, 2,000
    realizations, depth 2, the default reduce): after a warm-up of each,
    the sweep TELEMETRY_REPS times with a capture and as many without in
    ABBA order, then once each under
    torch.profiler, counting the CUDA runtime's synchronizing calls and
    B.1's launches. Gates: the checkpoints and cubes with and without the
    capture equal member for member, byte for byte; the span paths and
    calls exactly ``telemetry_spans`` (drain and io_write under
    sweep_pipeline); ``sweep.realizations`` 400, ``io.tim.toas`` and
    ``batch.toas_frozen`` the dataset's TOA count; ``meta.json``'s
    ``device_memory`` naming the card with a peak > 0; every events.jsonl
    record valid against EVENT_SCHEMA; both reports exit 0, the JSON's
    ``realize/compute`` spans equal to the phase's own aggregate; the
    likelihood's and the compile's spans and counters; the synchronizing
    calls equal with and without a capture (the readback's event waits
    seen at all), B.1's launches equal; the capture's median rate >=
    0.90 x the rate without."""
    from pta_replicator_tpu_torch.__main__ import _build_recipe
    from pta_replicator_tpu_torch.batch import freeze
    from pta_replicator_tpu_torch.simulate import load_from_directories, make_ideal

    common = ["--pardir", str(workdir / "par"), "--timdir", str(workdir / "tim")]
    recipe_path = str(workdir / "recipe.json")
    tel, tel_lk, tel_sc = (workdir / n for n in ("tel", "tel_likelihood", "tel_scenario"))
    realize_args = ["realize", *common, "--recipe", recipe_path, "--nreal",
                    str(TELEMETRY_NREAL), "--chunk", str(TELEMETRY_CHUNK), "--fit", "--seed",
                    str(DATASET_SEED)]
    runs = {
        "with": realize_args + ["--out", str(workdir / "tel_cube.npz"), "--checkpoint",
                                str(workdir / "tel_ck.npz"), "--telemetry", str(tel)],
        "without": realize_args + ["--out", str(workdir / "plain_cube.npz"), "--checkpoint",
                                   str(workdir / "plain_ck.npz")],
        "scenario": ["scenario", "compile", str(SCENARIO_SPEC), "--telemetry", str(tel_sc)],
    }
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        futures = {name: pool.submit(_module_cli, *args, timeout=900)
                   for name, args in runs.items()}
        calls = {name: f.result() for name, f in futures.items()}
    for name, (code, _out, err, _s) in calls.items():
        require(code == 0, f"telemetry CLI {name}: exit {code}: {err[-3000:]}")
    lk_args = ["likelihood", "--bank", str(workdir / "tel_ck.npz"), "--recipe", recipe_path,
               *common, *sum((["--grid", g] for g in TELEMETRY_GRID), []), "--out",
               str(workdir / "tel_likelihood.json"), "--telemetry", str(tel_lk)]
    # the three read finished files: at once
    later = {"likelihood": lk_args, "report_json": ["report", str(tel), "--json"],
             "report": ["report", str(tel)]}
    with ThreadPoolExecutor(max_workers=len(later)) as pool:
        futures = {name: pool.submit(_module_cli, *args, timeout=900)
                   for name, args in later.items()}
        calls.update({name: f.result() for name, f in futures.items()})
    for name in ("likelihood", "report_json", "report"):
        code, _out, err, _s = calls[name]
        require(code == 0, f"telemetry CLI {name}: exit {code}: {err[-3000:]}")

    cap, cap_lk, cap_sc = _capture(tel), _capture(tel_lk), _capture(tel_sc)
    ck_equal = _npz_members(workdir / "tel_ck.npz") == _npz_members(workdir / "plain_ck.npz")
    cube_equal = (_npz_members(workdir / "tel_cube.npz")
                  == _npz_members(workdir / "plain_cube.npz"))
    psrs = load_from_directories(*common[1::2])
    npsr, ntoas = len(psrs), int(sum(p.toas.ntoas for p in psrs))
    want = telemetry_spans(npsr)
    with np.load(workdir / "tel_ck.npz") as z:
        bank_bytes = int(sum(z[k].nbytes for k in z.files))
    report_json = json.loads(calls["report_json"][1])
    compute = {p: (a["calls"], a["total_s"]) for p, a in cap["spans"].items()
               if p.startswith("realize/compute")}
    compute_report = {p: (a["calls"], a["total_s"]) for p, a in report_json["spans"].items()
                      if p.startswith("realize/compute")}
    name = torch.cuda.get_device_name(0)
    memory = cap["meta"].get("device_memory") or []
    lk_spans = {p: c for p, c in cap_lk["calls"].items() if "likelihood_project" in p}

    # (2) the in-process sweep at the flagship shape of the dataset
    for p in psrs:
        make_ideal(p)
    batch = freeze(psrs)
    ntoa_max = batch.ntoa_max
    recipe = _build_recipe(json.loads(Path(recipe_path).read_text()), psrs).to("cuda")
    del psrs
    path = workdir / "tel_sweep.npz"
    _telemetry_sweep(batch, recipe, path)  # warm: the allocator, the build cache
    _telemetry_sweep(batch, recipe, path, workdir / "tel_sweep_warm")  # and a capture's start
    rates = {"with": [], "without": []}
    finish_s = []
    for k in range(TELEMETRY_REPS):
        # alternating order (ABBA), so that neither mode always runs first
        for mode in (("with", "without") if k % 2 == 0 else ("without", "with")):
            if mode == "with":
                r, f = _telemetry_sweep(batch, recipe, path, workdir / f"tel_sweep_{k}")
                finish_s.append(f)
            else:
                r = _telemetry_sweep(batch, recipe, path)[0]
            rates[mode].append(r)
    syncs, b1 = {}, {}
    syncs["with"], b1["with"] = _sync_calls(
        lambda: _telemetry_sweep(batch, recipe, path, workdir / "tel_sweep_profiled"))
    syncs["without"], b1["without"] = _sync_calls(lambda: _telemetry_sweep(batch, recipe, path))
    cap_sweep = _capture(workdir / "tel_sweep_profiled")
    median = {k: float(np.median(v)) for k, v in rates.items()}
    del batch, recipe
    torch.cuda.empty_cache()

    row = dict(
        nvidia_smi=smi, npsr=npsr, ntoas=ntoas, bank_bytes=bank_bytes,
        cli_seconds={n: c[3] for n, c in calls.items()},
        checkpoint_members_equal=ck_equal, cube_members_equal=cube_equal,
        spans=cap["calls"], spans_expected=want,
        span_total_s={p: a["total_s"] for p, a in cap["spans"].items()},
        metrics=cap["metrics"], device_memory=memory,
        schema_failures=len(cap["bad"]) + len(cap_lk["bad"]) + len(cap_sc["bad"]),
        problems=cap["problems"], report_compute_equal=compute == compute_report,
        report_lines=len(calls["report"][1].splitlines()),
        likelihood_spans=lk_spans, likelihood_metrics=cap_lk["metrics"],
        scenario_spans=cap_sc["calls"], scenario_metrics=cap_sc["metrics"],
        sweep=dict(TELEMETRY_SWEEP, shape=[npsr, ntoa_max], rates=rates, median=median,
                   ratio=median["with"] / median["without"], floor=TELEMETRY_RATE_FLOOR,
                   finish_capture_s=finish_s, sync_calls=syncs, b1_launches=b1,
                   spans=cap_sweep["calls"]),
    )
    emit("telemetry", **row)
    require(ck_equal and cube_equal, "telemetry: a capture changed the checkpoint or the cube")
    require(cap["calls"] == want, f"telemetry: realize spans {cap['calls']} != {want}")
    require(cap["metrics"].get("sweep.realizations") == TELEMETRY_NREAL
            and cap["metrics"].get("io.tim.toas") == ntoas
            and cap["metrics"].get("batch.toas_frozen") == ntoas,
            f"telemetry: counters {cap['metrics']}")
    require(any(name in m["device"] and m.get("peak_bytes_in_use", 0) > 0 for m in memory),
            f"telemetry: device_memory {memory}")
    require(row["schema_failures"] == 0 and not cap["problems"],
            f"telemetry: schema failures {cap['bad'][:3]} {cap['problems']}")
    require(row["report_compute_equal"] and compute,
            f"telemetry: report --json {compute_report} vs {compute}")
    require(lk_spans == {"likelihood/compute/likelihood_project": 1,
                         "likelihood/compute/likelihood_project/cw_stream_stage":
                             TELEMETRY_NREAL // TELEMETRY_CHUNK + 1}
            and all(f"likelihood/{s}" in cap_lk["calls"]
                    for s in ("ingest", "freeze", "build_recipe", "compute"))
            and cap_lk["metrics"].get("cw_stream.bytes_staged") == bank_bytes,
            f"telemetry: likelihood {cap_lk['calls']} {cap_lk['metrics']}")
    require(cap_sc["calls"] == {"scenario": 1, "scenario/scenario_compile": 1}
            and cap_sc["metrics"].get("scenario.compiled") == 1,
            f"telemetry: scenario {cap_sc['calls']} {cap_sc['metrics']}")
    require(syncs["with"] == syncs["without"] and syncs["with"]["cudaEventSynchronize"] > 0,
            f"telemetry: synchronizing calls {syncs}")
    require(b1["with"] == b1["without"] > 0, f"telemetry: B.1 launches {b1}")
    require(median["with"] >= TELEMETRY_RATE_FLOOR * median["without"],
            f"telemetry: sweep rate with a capture {median}")
    return b1["with"]


#: the chaos phase: the flagship sweep's full cubes (3 chunks of 200, a
#: ~1.3 GB checkpoint; cut from 4 chunks for the script's time when the
#: mesh phase came), the drain deadline, the stall past it, the two
#: seeded arms' seeds, the retry budget (one more than the arms' three
#: faults could take from one chunk) and a fast backoff (the default's
#: 0.5 s and more would only add sleep to the overhead it reports)
CHAOS_NREAL, CHAOS_CHUNK = 600, 200
CHAOS_DEADLINE_S, CHAOS_STALL_S = 3.0, 4.0
CHAOS_ARM_SEEDS = (11, 12)
CHAOS_RETRIES = 3
CHAOS_POLICY = dict(max_attempts=4, base_delay_s=0.05, multiplier=2.0, max_delay_s=0.5,
                    jitter=0.0)
#: the faulted server: requests, and the flood past its queue bound
#: while a stalled engine call (a fault) holds the worker, with a deadline
#: shorter than the stall
CHAOS_SERVER_REQUESTS, CHAOS_FLOOD, CHAOS_MAX_QUEUE = 16, 96, 4
CHAOS_DEADLINE_MS, CHAOS_ENGINE_STALL_S = 50.0, 0.3
#: the CLI arm's schedule
CHAOS_CLI_SCHEDULE = "drain:raise@chunk=1;checkpoint_write:torn@call=2"


def _chaos_schedule(seed, nchunks):
    """A seeded arm: a transient raise at one chunk's drain, a stall past
    the deadline at another's, and a torn write of the last chunk's file
    or sidecar (chunk c writes calls 2c+1 and 2c+2; a failure lets the
    write in flight finish, so the count holds). The drains run ahead of
    the full-cube writer, so a torn write of an earlier chunk could fire
    in the same attempt as a later drain fault, and two faults would take
    one retry; the last chunk's writes come after every drain."""
    import random

    rng = random.Random(seed)
    k_raise, k_stall = rng.sample(range(nchunks), 2)
    call = 2 * (nchunks - 1) + 1 + rng.randrange(2)
    return (f"drain:raise@chunk={k_raise};drain:stall={CHAOS_STALL_S:g}@chunk={k_stall};"
            f"checkpoint_write:torn@call={call}")


def _metric(name):
    from pta_replicator_tpu_torch.obs import counter

    return counter(name).value


def _chaos_sweep(batch, recipe, path, schedule=None, **kw):
    """One full-cube sweep of CHAOS_NREAL under ``schedule`` (None: no
    fault): (result or the exception it raised, wall s, faults fired,
    chunk retries, drain timeouts)."""
    from pta_replicator_tpu_torch.faults import RetryPolicy
    from pta_replicator_tpu_torch.faults import inject
    from pta_replicator_tpu_torch.obs import names

    r0, t0 = _metric(names.SWEEP_CHUNK_RETRIES), _metric(names.PIPELINE_DRAIN_TIMEOUTS)
    kw.setdefault("chunk_retries", CHAOS_RETRIES)
    if schedule is not None:
        inject.arm(schedule)
    start = time.perf_counter()
    try:
        out = sweep(SWEEP_SEED, batch, recipe, CHAOS_NREAL, str(path), chunk=CHAOS_CHUNK,
                    reduce_fn=None, fit=True, drain_timeout_s=CHAOS_DEADLINE_S,
                    retry_policy=RetryPolicy(**CHAOS_POLICY), **kw)
    except Exception as exc:  # the fail-fast arms' outcome, checked by the caller
        out = exc
    finally:
        wall = time.perf_counter() - start
        fired = inject.fired()
        inject.disarm()
    return (out, wall, fired, _metric(names.SWEEP_CHUNK_RETRIES) - r0,
            _metric(names.PIPELINE_DRAIN_TIMEOUTS) - t0)


def _drop_checkpoint(path, nchunks):
    sweep_mod._cleanup_chunks(str(path), nchunks)
    for p in (Path(path), Path(str(path) + ".meta.json")):
        p.unlink(missing_ok=True)


def _chaos_sweeps(batch, recipe, workdir):
    """The sweep's arms (see phase_chaos); the B.1 launches of the fault-
    free run and of each arm."""
    from pta_replicator_tpu_torch.faults import inject

    nchunks = CHAOS_NREAL // CHAOS_CHUNK
    path = workdir / "chaos.npz"
    runs, b1 = {}, {}
    # warm (the allocator, the pinned ring's buffers: one chunk is enough),
    # then the fault-free reference whose wall the arms' overheads are read
    # against
    sweep(SWEEP_SEED, batch, recipe, CHAOS_CHUNK, str(path), chunk=CHAOS_CHUNK, reduce_fn=None,
          fit=True)
    _drop_checkpoint(path, 1)
    launches.clear()
    ref, ref_wall, _f, ref_retries, _t = _chaos_sweep(batch, recipe, path)
    b1["fault_free"] = launches.get("cw_catalog_response", 0)
    require(isinstance(ref, np.ndarray), f"chaos: the fault-free sweep failed: {ref!r}")
    ref_members = _npz_members(path)
    ref_bytes = ref.tobytes()
    _drop_checkpoint(path, nchunks)
    arms = {f"seed{s}": (_chaos_schedule(s, nchunks), {}) for s in CHAOS_ARM_SEEDS}
    arms["device_lost"] = ("drain:device_lost@chunk=1", {})
    for name, (schedule, kw) in arms.items():
        launches.clear()
        out, wall, fired, retries, timeouts = _chaos_sweep(batch, recipe, path, schedule, **kw)
        b1[name] = launches.get("cw_catalog_response", 0)
        want = sorted(s.spec_str() for s in inject.parse_schedule(schedule))
        ok = isinstance(out, np.ndarray)
        runs[name] = dict(schedule=schedule, recovered=ok, wall_s=wall,
                          fault_overhead=wall / ref_wall - 1.0, chunk_retries=retries,
                          drain_timeouts=timeouts, fired=[f["spec"] for f in fired],
                          checkpoint_members_equal=ok and _npz_members(path) == ref_members,
                          cube_equal=ok and out.tobytes() == ref_bytes)
        _drop_checkpoint(path, nchunks)
        nfaults = len(want)
        require(ok, f"chaos {name}: the sweep did not recover: {out!r}")
        require(runs[name]["checkpoint_members_equal"] and runs[name]["cube_equal"],
                f"chaos {name}: the recovered checkpoint differs from the fault-free one")
        require(retries == nfaults, f"chaos {name}: {retries} retries for {nfaults} faults")
        require(sorted(runs[name]["fired"]) == want,
                f"chaos {name}: fired {runs[name]['fired']} != the schedule {want}")
        if "stall" in schedule:
            require(timeouts >= 1, f"chaos {name}: the stall tripped no drain deadline")
    for name, schedule, kw in (("fatal", "drain:fatal@chunk=1", {}),
                               ("fail_fast", "drain:raise@chunk=1", {"chunk_retries": 0})):
        out, wall, fired, retries, _t = _chaos_sweep(batch, recipe, path, schedule, **kw)
        _drop_checkpoint(path, nchunks)
        runs[name] = dict(schedule=schedule, raised=type(out).__name__, wall_s=wall,
                          chunk_retries=retries, fired=[f["spec"] for f in fired])
        require(isinstance(out, inject.InjectedFault) and retries == 0 and len(fired) == 1,
                f"chaos {name}: want InjectedFault with 0 retries, got {runs[name]}")
    return dict(fault_free_wall_s=ref_wall, fault_free_retries=ref_retries, arms=runs,
                b1_launches=b1)


def _chaos_prefetch():
    """The streamed 10,000-source catalog under a lost device at the
    second staging, against the fault-free streamed call."""
    from pta_replicator_tpu_torch.faults import inject
    from pta_replicator_tpu_torch.obs import names

    batch, recipe = flagship_workload(**POPULATION)
    streamed = dataclasses.replace(recipe, cgw_stream_chunk=SOURCES_PER_TILE,
                                   cgw_prefetch_depth=2)
    want = deterministic_delays(batch, streamed)
    r0 = _metric(names.CW_STREAM_STAGE_RETRIES)
    launches.clear()
    with inject.armed("cw_stream_stage:device_lost@call=2"):
        got = deterministic_delays(batch, streamed)
        torch.cuda.synchronize()
        fired = inject.fired()
    counts = dict(launches)
    row = dict(shape=[batch.npsr, batch.ntoa_max, POPULATION["ncw"]], tile=SOURCES_PER_TILE,
               bitwise_equal=bool(torch.equal(got, want)),
               stage_retries=_metric(names.CW_STREAM_STAGE_RETRIES) - r0,
               fired=[f["spec"] for f in fired],
               accumulate_launches=counts.get("cw_catalog_accumulate", 0),
               fold_launches=counts.get("cw_fold_planes", 0))
    del batch, recipe, streamed, want, got
    torch.cuda.empty_cache()
    require(row["bitwise_equal"] and row["stage_retries"] == 1 and len(row["fired"]) == 1,
            f"chaos prefetch: {row}")
    require(row["accumulate_launches"] > 0, f"chaos prefetch: no accumulating launch: {row}")
    return row


def _chaos_cli(workdir):
    """``realize --checkpoint`` on the dataset under CHAOS_CLI_SCHEDULE,
    by ``--faults`` and by ``PTA_FAULTS``, each with ``--telemetry``,
    against phase telemetry's fault-free call of the same arguments."""
    import os

    from pta_replicator_tpu_torch.obs import report as obs_report

    common = ["--pardir", str(workdir / "par"), "--timdir", str(workdir / "tim")]
    args = ["realize", *common, "--recipe", str(workdir / "recipe.json"), "--nreal",
            str(TELEMETRY_NREAL), "--chunk", str(TELEMETRY_CHUNK), "--fit", "--seed",
            str(DATASET_SEED)]
    env = dict(os.environ, PTA_FAULTS=CHAOS_CLI_SCHEDULE)
    runs = {
        "flag": (args + ["--out", str(workdir / "chaos_flag.npz"), "--checkpoint",
                         str(workdir / "chaos_flag_ck.npz"), "--telemetry",
                         str(workdir / "chaos_tel_flag"), "--faults", CHAOS_CLI_SCHEDULE], None),
        "env": (args + ["--out", str(workdir / "chaos_env.npz"), "--checkpoint",
                        str(workdir / "chaos_env_ck.npz"), "--telemetry",
                        str(workdir / "chaos_tel_env")], env),
    }
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        futures = {n: pool.submit(_module_cli, *a, timeout=900, env=e) for n, (a, e) in runs.items()}
        calls = {n: f.result() for n, f in futures.items()}
    want_cube = _npz_members(workdir / "plain_cube.npz")
    want_ck = _npz_members(workdir / "plain_ck.npz")
    out = {}
    for name, (code, _o, err, seconds) in calls.items():
        require(code == 0, f"chaos CLI {name}: exit {code}: {err[-3000:]}")
        cap = _capture(workdir / f"chaos_tel_{name}")
        data_events = [r for r in obs_report.load_telemetry(str(workdir / f"chaos_tel_{name}"))[
            "events"] if r.get("type") == "event" and r.get("name") == "faults.fired"]
        metrics = json.loads((workdir / f"chaos_tel_{name}" / "metrics.json").read_text())
        injected = {f"{m['labels']['site']}:{m['labels']['kind']}": m["value"]
                    for m in metrics.get("faults.injected", [])}
        out[name] = dict(seconds=seconds,
                         cube_members_equal=_npz_members(workdir / f"chaos_{name}.npz") == want_cube,
                         checkpoint_members_equal=(_npz_members(workdir / f"chaos_{name}_ck.npz")
                                                   == want_ck),
                         faults_injected=injected,
                         faults_fired=sorted(e["attrs"]["site"] for e in data_events),
                         chunk_retries=cap["metrics"].get("sweep.chunk_retries"))
        require(out[name]["cube_members_equal"] and out[name]["checkpoint_members_equal"],
                f"chaos CLI {name}: the cube or checkpoint differs from the fault-free call")
        require(injected == {"drain:raise": 1, "checkpoint_write:torn": 1}
                and out[name]["faults_fired"] == ["checkpoint_write", "drain"],
                f"chaos CLI {name}: the capture's faults {out[name]}")
    return out


def phase_chaos(workdir, batch, recipe, smi):
    """Fault injection on the card (A.16.2), the counterpart of the JAX
    package's benchmarks/chaos_sweep.py. (1) The flagship sweep (68 x 7,758,
    float32, fit, full cubes, CHAOS_NREAL in chunks of CHAOS_CHUNK, depth 2,
    drain deadline CHAOS_DEADLINE_S) fault-free, then two seeded arms (a
    drain raise, a drain stall past the deadline and a torn checkpoint
    write, each on its own chunk), a lost device at chunk 1's drain, a
    fatal fault and a transient one with no retry budget. Gates: every
    recovering arm's checkpoint equal member for member to the fault-free
    one and its cube bit for bit, its chunk retries equal to its faults,
    ``fired()`` equal to its schedule, the stall arms' drain timeouts >= 1;
    the fatal and fail-fast arms raise InjectedFault after 0 retries. Each
    arm's wall over the fault-free wall, less one, is reported
    (``fault_overhead``, not gated). (2) The streamed 10,000-source catalog
    under a lost device at the second staging: bitwise the fault-free
    streamed call, one staging retry, B.1's accumulating launches counted.
    (3) ``realize --checkpoint`` on the dataset under CHAOS_CLI_SCHEDULE by
    ``--faults`` and by ``PTA_FAULTS``, with a capture each: cube and
    checkpoint equal member for member to phase telemetry's fault-free
    call, the captures holding ``faults.injected{site,kind}`` and the
    ``faults.fired`` events. Returns B.1's launches in the phase."""
    t0 = time.perf_counter()
    sweeps = _chaos_sweeps(batch, recipe, workdir)
    part_s = {"sweeps": time.perf_counter() - t0}
    prefetch = _chaos_prefetch()
    part_s["prefetch"] = time.perf_counter() - t0 - part_s["sweeps"]
    cli = _chaos_cli(workdir)
    part_s["cli"] = time.perf_counter() - t0 - part_s["sweeps"] - part_s["prefetch"]
    emit("chaos", nvidia_smi=smi, nreal=CHAOS_NREAL, chunk=CHAOS_CHUNK,
         deadline_s=CHAOS_DEADLINE_S, stall_s=CHAOS_STALL_S, policy=CHAOS_POLICY,
         sweep=sweeps, prefetch=prefetch, cli=cli, part_s=part_s,
         seconds=time.perf_counter() - t0)
    return (sum(sweeps["b1_launches"].values()), prefetch["accumulate_launches"],
            prefetch["fold_launches"])


def phase_chaos_server(bank, batch, recipe, design):
    """The float64 LikelihoodServer on the flagship bank under a transient
    fault at its second engine call, against the fault-free server on the
    same requests (the server prices with the composed ReducedGP build in
    both packages: no Woodbury kernel launches here, counted). Then a
    flood of CHAOS_FLOOD requests past ``max_queue`` with a deadline
    shorter than one evaluation. Gates: every future resolves and equals
    the fault-free server's bit for bit; one retry absorbed; the flood
    rejects and expires requests, and no future is left pending after
    ``stop()``."""
    from pta_replicator_tpu_torch.faults import inject

    grid, _ = lk.grid_cartesian(LIKELIHOOD_GRID)
    axes = tuple(sorted(LIKELIHOOD_GRID))
    point = lambda i: {k: float(grid[k][i]) for k in axes}

    def serve(schedule):
        inject.arm(schedule)
        try:
            with lk.LikelihoodServer(lk.RealizationBank.from_array(bank), batch, recipe, axes,
                                     design=design, max_batch=SERVER_BATCH) as server:
                futures = [server.submit(**point(i)) for i in range(CHAOS_SERVER_REQUESTS)]
                rows = [f.result(timeout=600) for f in futures]
            return rows, inject.fired()
        finally:
            inject.disarm()

    launches.clear()
    clean, _ = serve("likelihood_batch:raise@call=100000")
    t0 = time.perf_counter()
    flapped, fired = serve("likelihood_batch:raise@call=2")
    flapped_s = time.perf_counter() - t0
    b3 = launches.get("fused_woodbury_update", 0)
    equal = all(np.array_equal(a, b) for a, b in zip(flapped, clean))
    # the flood: the first request's engine call stalls (a fault), and once
    # the worker is inside it, CHAOS_FLOOD requests arrive: the queue bound
    # rejects the surplus, and the queued ones outlive their deadline
    server = lk.LikelihoodServer(lk.RealizationBank.from_array(bank), batch, recipe, axes,
                                 design=design, max_batch=SERVER_BATCH, max_delay_s=0.0,
                                 max_queue=CHAOS_MAX_QUEUE,
                                 request_deadline_s=CHAOS_DEADLINE_MS / 1e3).start()
    inject.arm(f"likelihood_batch:stall={CHAOS_ENGINE_STALL_S:g}@call=1")
    futures, rejected = [], 0
    try:
        first = server.submit(**point(0))
        t_wait = time.perf_counter()
        while not inject.fired() and time.perf_counter() - t_wait < 60:
            time.sleep(0.001)
        for i in range(CHAOS_FLOOD):
            try:
                futures.append(server.submit(**point(i % len(grid[axes[0]]))))
            except lk.ServerSaturated:
                rejected += 1
    finally:
        server.stop()
        inject.disarm()
    first_ok = first.done() and first.exception() is None
    pending = sum(not f.done() for f in futures + [first])
    expired = sum(f.done() and isinstance(f.exception(), lk.DeadlineExpired) for f in futures)
    stats = server.stats()
    row = dict(requests=CHAOS_SERVER_REQUESTS, fired=[f["spec"] for f in fired],
               rows_equal_fault_free=equal, flapped_s=flapped_s, b3_launches=b3,
               flood=CHAOS_FLOOD, max_queue=CHAOS_MAX_QUEUE, deadline_ms=CHAOS_DEADLINE_MS,
               engine_stall_s=CHAOS_ENGINE_STALL_S, first_resolved=first_ok,
               rejected=rejected, expired=expired, pending_after_stop=pending,
               served=stats["requests"], stats_rejected=stats["rejected"],
               stats_expired=stats["deadline_expired"])
    emit("chaos_server", **row)
    require(equal and len(fired) == 1, f"chaos server: the faulted server {row}")
    require(first_ok and rejected > 0 and expired > 0 and pending == 0,
            f"chaos server: the flood {row}")
    return b3


#: the numerics observatory phase: the identity sweeps' full cubes, the
#: drift arm's sweep (one chunk, for the script's time: one oracle
#: sample), and the chunk
NUMERICS_IDENTITY_NREAL, NUMERICS_DRIFT_NREAL, NUMERICS_CHUNK = 400, 200, 200
#: the overhead arm's reduced sweeps, its pairs and its rate floor: 60
#: chunks of 200, about 1 s a sweep on the card. A burst of load on the
#: card's host is short: 0.2 s sweeps (12 chunks, the most the default
#: 1-in-16 rate samples none of) spread 5-14% from one to the next, 1.3 s
#: sweeps 1-3% on the same hosts. Armed at a 1-in-128 drift rate, whose
#: offset from the default seed (98) samples none of the 60 chunks: every
#: chunk does the armed work of an unsampled chunk at the default rate,
#: and the oracle replay is the drift arm's to time
NUMERICS_OVERHEAD_NREAL, NUMERICS_OVERHEAD_REPS, NUMERICS_RATE_FLOOR = 12_000, 9, 0.95
NUMERICS_OVERHEAD_DRIFT_EVERY = 128
#: the warm-up and the profiled sweeps: 12 chunks, as the live arm's are
#: shorter than its timed ones (the profiler's accounting is slow)
NUMERICS_OVERHEAD_SHORT_NREAL = 2400
#: the CUDA runtime calls counted beside the synchronizing ones
NUMERICS_RUNTIME_CALLS = SYNC_CALLS + ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaEventRecord",
                                       "cudaHostAlloc")
#: the drift arm's replay against cube row 0 (float32, the same delays
#: summed in another batch shape), relative RMS
TOL_REPLAY = 1e-5


def _numerics_sweep(batch, recipe, path, nreal, armed, drift_every=None, **kw):
    """One sweep (``armed``: the observatory armed at ``drift_every``),
    its checkpoint dropped: (result, wall s)."""
    if armed:
        numerics.reset()
        numerics.arm(drift_every=drift_every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = sweep(SWEEP_SEED, batch, recipe, nreal, str(path), chunk=NUMERICS_CHUNK, **kw)
    finally:
        wall = time.perf_counter() - t0
        if armed:
            numerics.flush()
    _drop_checkpoint(path, nreal // NUMERICS_CHUNK)
    return out, wall


def _numerics_cov(batch, recipe):
    """Config B's banded factor (B.4) and config D's blocked factor (B.2)
    armed on the card and on the CPU from the same matrices: each cov.*
    site's ledger, and the kernels' launches."""
    from pta_replicator_tpu_torch.covariance.structure import banded_c0_blocks, dense_c0

    out = {}
    b64 = batch.astype(torch.float64)
    r64 = recipe.astype(torch.float64)
    rb = _config_b(b64, r64, torch.float64)
    sigma2, _ = _safe_sigma2(b64, rb)
    D, E = banded_c0_blocks(rb.noise_cov, sigma2, recipe_cov_s2(rb, torch.float64), torch.float64)
    bd, rd = flagship_workload(**DENSE_SHAPE, dtype=torch.float64)
    rd = _config_d(bd, rd)
    sigma2d, ecorr2d = _safe_sigma2(bd, rd)
    C = dense_c0(bd, sigma2d, ecorr2d, rd.noise_cov, recipe_cov_s2(rd, torch.float64),
                 torch.float64)
    for where in ("card", "cpu"):
        numerics.reset()
        numerics.arm()
        launches.clear()
        t = (lambda x: x) if where == "card" else (lambda x: x.cpu())
        cov_kernels.block_tridiag_cholesky(t(D), t(E))
        cov_kernels.blocked_cholesky(t(C), block=DENSE_BLOCK)
        torch.cuda.synchronize()
        out[where] = dict(sites={s: {k: r[k] for k in ("calls", "elements", "nonfinite",
                                                        "max_abs")}
                                 for s, r in numerics.snapshot()["sites"].items()},
                          launches=dict(launches))
    numerics.reset()
    del D, E, C, bd, rd, b64, r64, rb
    torch.cuda.empty_cache()
    return out


def phase_numerics_observatory(workdir, batch, recipe, smi):
    """The numerics observatory on the card (A.16.3), the counterpart of the
    JAX package's benchmarks/numerics_probe.py, on the flagship (68 x 7,758,
    float32, fit). Overhead, first (after an ``os.sync``): the reduced
    sweep (NUMERICS_OVERHEAD_NREAL x 200, drift rate
    NUMERICS_OVERHEAD_DRIFT_EVERY, no chunk sampled)
    NUMERICS_OVERHEAD_REPS times armed and disarmed in ABBA order,
    then once each under torch.profiler (NUMERICS_OVERHEAD_SHORT_NREAL
    realizations): the median of the adjacent pairs' armed / disarmed
    rate ratios >= NUMERICS_RATE_FLOOR (the ratio of the two medians is a
    reading: when the host's rate drifts mid-phase, both arms of a pair
    move together and the pairs' ratios do not), and at most one synchronizing CUDA
    call more a chunk. Identity: the full-cube sweep disarmed, armed
    (default drift rate) and disarmed after an arm/disarm cycle, bit for
    bit.
    Planted overflow: ``log10_equad = 25`` in float32 is named at
    ``realization.white`` and at no other probe site. Planted NaN:
    ``drain:nan@chunk=1`` is named at ``drain`` alone with
    ``numerics.nonfinite`` 1. Drift: drift_every 1 on a 200 x 200 sweep
    without the fit, under a capture: every family's worst drift within
    the fuzz tolerances, samples = chunks, the replayed draws rebuild cube
    row 0 of each chunk (TOL_REPLAY), the oracle's seconds a sample
    reported (the capture's drift-sample spans less the batched side's
    time); ``numerics report`` renders the capture, and the verdict
    reads drift for the realization sites. Covariance: config B's banded
    factor (B.4) and config D's blocked factor (B.2) armed on the card and
    on the CPU: each cov.* site's calls and elements equal. Returns the
    kernels' launches in the phase."""
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.faults import inject
    from pta_replicator_tpu_torch.obs import names
    from pta_replicator_tpu_torch.scenarios import fuzz

    t_phase = time.perf_counter()
    path = workdir / "numerics.npz"
    counts = collections.Counter()
    row = dict(nvidia_smi=smi)

    part_s = {}
    # overhead, first: before the phase's full-cube writes leave dirty
    # pages for the host to flush under the timed sweeps
    os.sync()
    t_part = time.perf_counter()
    kw = dict(fit=True, pipeline_depth=TELEMETRY_SWEEP["pipeline_depth"])
    nreal, short = NUMERICS_OVERHEAD_NREAL, NUMERICS_OVERHEAD_SHORT_NREAL
    nchunks, short_chunks = nreal // NUMERICS_CHUNK, short // NUMERICS_CHUNK
    every = NUMERICS_OVERHEAD_DRIFT_EVERY
    offset = numerics.drift_offset(every, 0)
    require(offset >= nchunks, f"numerics: the overhead sweeps would sample chunk {offset}")
    kw["drift_every"] = every
    # the Python threads alive under the timed sweeps (an earlier phase's
    # leftover would take the interpreter lock from the dispatching thread)
    threads = sorted(t.name for t in threading.enumerate())
    launches.clear()
    for mode in (False, True):  # warm both
        _numerics_sweep(batch, recipe, path, short, mode, **kw)
        numerics.reset()
    rates = {"armed": [], "disarmed": []}
    for k in range(NUMERICS_OVERHEAD_REPS):
        # alternating order (ABBA), so that neither mode always runs first
        for mode in (("armed", "disarmed") if k % 2 == 0 else ("disarmed", "armed")):
            _, wall = _numerics_sweep(batch, recipe, path, nreal, mode == "armed", **kw)
            rates[mode].append(nreal / wall)
            numerics.reset()
    # each adjacent pair's ratio: a drift of the host's rate mid-phase hits
    # both sides of a pair, so the gate reads their median
    paired = [a / d for a, d in zip(rates["armed"], rates["disarmed"])]
    counts.update(launches)
    runtime = {}
    for mode in ("armed", "disarmed"):
        # _sync_calls clears the launch counts, then holds its run's
        runtime[mode], _b1 = _sync_calls(
            lambda: _numerics_sweep(batch, recipe, path, short, mode == "armed", **kw),
            calls=NUMERICS_RUNTIME_CALLS)
        counts.update(launches)
        numerics.reset()
    syncs = {m: {k: v for k, v in c.items() if k in SYNC_CALLS} for m, c in runtime.items()}
    median = {k: float(np.median(v)) for k, v in rates.items()}
    extra_syncs = sum(syncs["armed"].values()) - sum(syncs["disarmed"].values())
    row["overhead"] = dict(nreal=nreal, chunk=NUMERICS_CHUNK, chunks=nchunks,
                           profiled_nreal=short,
                           drift_every=every, drift_offset=offset,
                           rates=rates, median=median,
                           ratio=median["armed"] / median["disarmed"],
                           paired_ratios=paired, paired_median=float(np.median(paired)),
                           floor=NUMERICS_RATE_FLOOR, sync_calls=syncs, extra_syncs=extra_syncs,
                           runtime_calls=runtime, threads=threads)
    require(row["overhead"]["paired_median"] >= NUMERICS_RATE_FLOOR,
            f"numerics: armed sweep rate {row['overhead']}")
    require(extra_syncs <= short_chunks, f"numerics: synchronizing calls armed {syncs}")

    part_s["overhead"] = time.perf_counter() - t_part
    # identity
    t_part = time.perf_counter()
    launches.clear()
    cubes = {}
    cubes["disarmed"], _ = _numerics_sweep(batch, recipe, path, NUMERICS_IDENTITY_NREAL, False,
                                           reduce_fn=None, fit=True)
    cubes["armed"], _ = _numerics_sweep(batch, recipe, path, NUMERICS_IDENTITY_NREAL, True,
                                        reduce_fn=None, fit=True)
    identity_ledger = numerics.snapshot()
    numerics.disarm()
    cubes["after_cycle"], _ = _numerics_sweep(batch, recipe, path, NUMERICS_IDENTITY_NREAL,
                                              False, reduce_fn=None, fit=True)
    counts.update(launches)
    row["identity"] = dict(
        equal=cubes["armed"].tobytes() == cubes["disarmed"].tobytes()
        == cubes["after_cycle"].tobytes(),
        sites={s: {k: r[k] for k in ("calls", "elements", "nonfinite", "headroom_bits")}
               for s, r in identity_ledger["sites"].items()})
    del cubes
    numerics.reset()
    require(row["identity"]["equal"], "numerics: an armed or cycled sweep changed the cube")
    require(identity_ledger["sites"].get("realization.white", {}).get("calls")
            == NUMERICS_IDENTITY_NREAL // NUMERICS_CHUNK,
            f"numerics: the armed sweep's ledger {identity_ledger['sites']}")
    part_s["identity"] = time.perf_counter() - t_part
    # planted overflow
    t_part = time.perf_counter()
    launches.clear()
    equad = dataclasses.replace(recipe, log10_equad=torch.full_like(recipe.log10_equad, 25.0))
    numerics.reset()
    numerics.arm()
    realize(torch.Generator(device="cuda").manual_seed(1), batch, equad, NUMERICS_CHUNK, fit=True)
    numerics.flush()
    overflow = {s: r["nonfinite"] for s, r in numerics.snapshot()["sites"].items()}
    counts.update(launches)
    numerics.reset()
    row["overflow"] = overflow
    require({s for s, n in overflow.items() if n} == {"realization.white"}
            and len(overflow) >= 4, f"numerics: planted overflow named at {overflow}")

    # planted NaN
    launches.clear()
    n0 = _metric(names.NUMERICS_NONFINITE)
    inject.arm("drain:nan@chunk=1")
    try:
        cube, _ = _numerics_sweep(batch, recipe, path, NUMERICS_IDENTITY_NREAL, True,
                                  reduce_fn=None, fit=True)
    finally:
        inject.disarm()
    nan_sites = {s: r["nonfinite"] for s, r in numerics.snapshot()["sites"].items()}
    counts.update(launches)
    row["nan"] = dict(sites=nan_sites, nonfinite_counter=_metric(names.NUMERICS_NONFINITE) - n0,
                      cube_nans=int(np.isnan(cube).sum()))
    del cube
    numerics.reset()
    require({s for s, n in nan_sites.items() if n} == {"drain"} and nan_sites["drain"] == 1
            and row["nan"]["nonfinite_counter"] == 1 and row["nan"]["cube_nans"] == 1,
            f"numerics: planted NaN {row['nan']}")

    part_s["planted"] = time.perf_counter() - t_part
    # drift, under a capture
    t_part = time.perf_counter()
    launches.clear()
    tel = workdir / "numerics_tel"
    obs.start_capture(str(tel))
    try:
        cube, drift_wall = _numerics_sweep(batch, recipe, path, NUMERICS_DRIFT_NREAL, True,
                                           drift_every=1, reduce_fn=None, fit=False)
        drift = numerics.snapshot()["drift"]
        verdict = numerics.ladder_verdict()
    finally:
        obs.finish_capture(context={"phase": "numerics_observatory"})
        obs.configure(None)
        obs.reset_all()
    counts.update(launches)
    drift_spans = [a for p, a in _capture(tel)["spans"].items()
                   if p.endswith(names.SPAN_NUMERICS_DRIFT)]
    sample_s = (sum(a["total_s"] for a in drift_spans)
                / max(1, sum(a["calls"] for a in drift_spans)))
    static = deterministic_delays(batch, recipe)
    replay = []
    for i in range(NUMERICS_DRIFT_NREAL // NUMERICS_CHUNK):
        draws = numerics.replay_draws(batch, recipe, SWEEP_SEED, i, NUMERICS_CHUNK)
        got = B.residualize(B.realization_delays(batch, recipe, draws) + static, batch)
        replay.append(rel_rms(got, torch.from_numpy(cube[i * NUMERICS_CHUNK]).cuda()))
    del cube
    shim = numerics._DriftShim(batch, recipe)
    t0 = time.perf_counter()
    fuzz.batched_family_delays(shim, draws)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    # through the CLI's entry point in process (a fresh interpreter would
    # add its imports' seconds to the script's time)
    code, report_out = _cli_in_process("numerics", "report", str(tel))
    err = report_out
    realization_sites = [s for s in verdict if s.startswith("realization.")]
    row["drift"] = dict(nreal=NUMERICS_DRIFT_NREAL, chunk=NUMERICS_CHUNK, families=drift,
                        sweep_wall_s=drift_wall, replay_rel_rms=replay, tol_replay=TOL_REPLAY,
                        sample_s=sample_s, batched_s_per_sample=batched_s,
                        oracle_s_per_sample=sample_s - batched_s,
                        report_exit=code, report_lines=len(report_out.splitlines()),
                        verdict={s: verdict[s] for s in realization_sites})
    numerics.reset()
    nsamples = NUMERICS_DRIFT_NREAL // NUMERICS_CHUNK
    require(drift and all(d["samples"] == nsamples and d["worst"] <= d["tolerance"]
                          for d in drift.values()), f"numerics: drift {drift}")
    require(max(replay) <= TOL_REPLAY, f"numerics: replay vs cube row 0 {replay}")
    require(code == 0 and "realization.white" in report_out and "drift vs" in report_out,
            f"numerics report: exit {code}: {err[-2000:]}")
    require(realization_sites and all(
        not any("no drift samples" in r for r in verdict[s]["reasons"])
        for s in realization_sites), f"numerics: the verdict {row['drift']['verdict']}")

    part_s["drift"] = time.perf_counter() - t_part
    # covariance
    t_part = time.perf_counter()
    cov = _numerics_cov(batch, recipe)
    counts.update(cov["card"]["launches"])
    row["covariance"] = cov
    shape_of = lambda sites: {s: (r["calls"], r["elements"]) for s, r in sites.items()}
    require(shape_of(cov["card"]["sites"]) == shape_of(cov["cpu"]["sites"])
            and {"cov.tridiag_pivot", "cov.blocked_pivot"} <= set(cov["card"]["sites"])
            and all(r["nonfinite"] == 0 for r in cov["card"]["sites"].values()),
            f"numerics: cov sites card {cov['card']['sites']} vs cpu {cov['cpu']['sites']}")
    require(cov["card"]["launches"].get("tridiag_factor_solve_fwd", 0) > 0
            and cov["card"]["launches"].get("cov_syrk_update", 0) > 0,
            f"numerics: covariance launches {cov['card']['launches']}")
    part_s["covariance"] = time.perf_counter() - t_part
    row["launches"] = dict(counts)
    row["part_s"] = part_s
    row["seconds"] = time.perf_counter() - t_phase
    emit("numerics_observatory", **row)
    return dict(counts)


#: the live-run phase (A.16.4a). Overhead: reduced sweeps on the flagship
#: (75 chunks of 200, 1.1-1.5 s a sweep on the card, so a heartbeat every
#: LIVE_HEARTBEAT_S ticks 7-9 times in each) in LIVE_OVERHEAD_PAIRS ABBA
#: pairs, the rate floor, the heartbeats each armed sweep must see, and the
#: latency objective armed there. The flagship sweep is host-dispatch bound,
#: so each tick's hold on the interpreter lock is taken from the dispatching
#: thread: the interval is a reasonable live cadence, not the shortest
LIVE_OVERHEAD_NREAL, LIVE_OVERHEAD_PAIRS, LIVE_RATE_FLOOR = 15_000, 7, 0.95
LIVE_HEARTBEAT_S, LIVE_MIN_HEARTBEATS = 0.16, 5
#: the warm-up and the profiled sweeps: about half as long (about four
#: ticks), since the profiler's own accounting costs seconds per thousand
#: launches
LIVE_SHORT_NREAL = 8_000
LIVE_SLO = "sweep=dispatch:p99_ms<=1000@99%"
#: the CLI arms: PTA_SLO of both calls, the drain stall that holds the
#: killed call in its second chunk, the watch's poll and the arms' limit
LIVE_CLI_SLO = "sweep=dispatch:p99_ms<=5000@99%;drain=drain:p99_ms<=60000@99%"
LIVE_KILL_STALL_S, LIVE_WATCH_INTERVAL_S, LIVE_CLI_TIMEOUT_S = 300, 0.5, 600
LIVE_ROUTES = ("/healthz", "/readyz", "/progress", "/metrics")
#: the report sections a finished capture renders
LIVE_SECTIONS = ("utilization (stage occupancy):", "slo (error budgets",
                 "series (sampled by the flight recorder):", "latency percentiles")
#: the server arm: requests served one by one under the objective, then one
#: more whose engine call stalls past it (a fast burn: 1 bad in 5 > 14.4%)
LIVE_SERVER_FAST, LIVE_SERVER_SLO_MS, LIVE_SERVER_STALL_S = 4, 500, 2.0
LIVE_SERVER_HEARTBEAT_S = 0.05


def _http_get(url):
    """(status, body) of a GET on the loopback server."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()
    except OSError:
        return None, b""


def _read_json(path):
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None


class _ProcessState:
    """The signal handlers and the excepthook as a phase found them, put
    back when it ends, with any flight recorder stopped and the capture
    closed: a later phase sees the process as it was."""

    def __enter__(self):
        import signal

        self.handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
        self.hook = sys.excepthook
        return self

    def __exit__(self, *exc):
        import signal

        from pta_replicator_tpu_torch import obs

        obs.configure(None)
        obs.reset_all()  # stops a recorder still sampling, takes its hooks down
        for s, h in self.handlers.items():
            signal.signal(s, h)
        sys.excepthook = self.hook
        return False


def _live_sweep(batch, recipe, path, nreal, directory=None):
    """One reduced flagship sweep (fit, depth 2), under a capture into
    ``directory`` when given (flight recorder every LIVE_HEARTBEAT_S,
    LIVE_SLO armed, crash hooks on): (result, wall s of the sweep call,
    heartbeats the recorder wrote during the call, the occupancy block the
    sweep stamped into its ``sweep_pipeline`` span, or None, and the
    sampler's thread CPU s, ``obs.overhead_s``, or None)."""
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.obs import flightrec

    if directory is not None:
        obs.start_capture(str(directory), heartbeat_interval_s=LIVE_HEARTBEAT_S, slo=LIVE_SLO)
    beats, occupancy, sampler_s = 0, None, None
    try:
        torch.cuda.synchronize()
        w0, t0 = time.time(), time.perf_counter()
        out = sweep(SWEEP_SEED, batch, recipe, nreal, str(path), chunk=NUMERICS_CHUNK, fit=True,
                    pipeline_depth=TELEMETRY_SWEEP["pipeline_depth"], device=batch.device)
        wall, w1 = time.perf_counter() - t0, time.time()
        if directory is not None:
            # one proc.rss_bytes sample a sampler tick, each tick a heartbeat
            snap = flightrec.active().series.snapshot(recent=100_000)
            beats = sum(w0 <= t <= w1 for s in snap["series"] if s["name"] == "proc.rss_bytes"
                        for t, _v in s["samples"])
            occupancy = next((r["attrs"].get("occupancy") for r in obs.TRACER.events()
                              if r.get("name") == "sweep_pipeline"), None)
            sampler_s = obs.REGISTRY.counter(obs.names.OBS_OVERHEAD_S).value
    finally:
        if directory is not None:
            obs.finish_capture(context={"phase": "live_run"})
            obs.configure(None)
            obs.reset_all()
    _drop_checkpoint(path, nreal // NUMERICS_CHUNK)
    return out, wall, beats, occupancy, sampler_s


def _cli_in_process(*args):
    """``python -m pta_replicator_tpu_torch ARGS`` through ``main`` in this
    process: (exit code, stdout)."""
    import contextlib
    import io

    from pta_replicator_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            cli_main(list(args))
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else 1
    return code, out.getvalue()


def _live_overhead(batch, recipe, workdir, counts):
    """The armed / disarmed sweep rates in ABBA pairs, then one of each
    under torch.profiler: the gates' numbers."""
    path = workdir / "live.npz"
    nreal = LIVE_OVERHEAD_NREAL
    launches.clear()
    part_s, t_part = {}, time.perf_counter()
    for directory in (None, workdir / "live_warm"):  # warm both
        _live_sweep(batch, recipe, path, LIVE_SHORT_NREAL, directory)
    part_s["warm"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    rates, beats, outs, occupancy = {"armed": [], "disarmed": []}, [], {}, None
    sampler_s = []
    for k in range(LIVE_OVERHEAD_PAIRS):
        for mode in (("armed", "disarmed") if k % 2 == 0 else ("disarmed", "armed")):
            armed = mode == "armed"
            out, wall, n, occ, tick_s = _live_sweep(batch, recipe, path, nreal,
                                                    workdir / f"live_{k}" if armed else None)
            rates[mode].append(nreal / wall)
            if armed:
                beats.append(n)
                sampler_s.append(tick_s)
                occupancy = occupancy or occ
            outs.setdefault(mode, out)
    counts.update(launches)
    part_s["pairs"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    runtime, b1, profiled_beats = {}, {}, []
    for mode in ("armed", "disarmed"):
        directory = workdir / "live_profiled" if mode == "armed" else None
        runtime[mode], b1[mode] = _sync_calls(
            lambda: profiled_beats.append(
                _live_sweep(batch, recipe, path, LIVE_SHORT_NREAL, directory)[2]),
            calls=NUMERICS_RUNTIME_CALLS)
        counts.update(launches)
    part_s["profiled"] = time.perf_counter() - t_part
    syncs = {m: {k: v for k, v in c.items() if k in SYNC_CALLS} for m, c in runtime.items()}
    median = {k: float(np.median(v)) for k, v in rates.items()}
    # each adjacent pair's ratio: the gate reads their median (see
    # phase_numerics_observatory)
    paired = [a / d for a, d in zip(rates["armed"], rates["disarmed"])]
    return dict(nreal=nreal, chunk=NUMERICS_CHUNK, heartbeat_interval_s=LIVE_HEARTBEAT_S,
                slo=LIVE_SLO, rates=rates, median=median,
                ratio=median["armed"] / median["disarmed"],
                paired_ratios=paired, paired_median=float(np.median(paired)),
                floor=LIVE_RATE_FLOOR, heartbeats=beats, sampler_cpu_s=sampler_s,
                sync_calls=syncs,
                runtime_calls=runtime, b1_launches=b1, profiled_nreal=LIVE_SHORT_NREAL,
                profiled_heartbeats=profiled_beats[0], part_s=part_s,
                sweep_occupancy=occupancy,
                outputs_equal=outs["armed"].tobytes() == outs["disarmed"].tobytes())


class _LiveCliArms:
    """The CLI arms, run in the background while the next phase runs (they
    wait mostly on their interpreters and the dataset's ingest):
    ``realize --checkpoint --telemetry`` on the dataset with PTA_SLO set,
    watched by ``watch DIR --serve 0`` in a second process whose routes a
    monitor thread polls; beside it the same call held by a drain stall in
    its second chunk and SIGTERMed once its heartbeat shows a chunk done.
    :meth:`finish` joins them and reads the finished capture (``report``)
    and the killed one (``postmortem``)."""

    def __init__(self, workdir):
        self.workdir = workdir
        common = ["--pardir", str(workdir / "par"), "--timdir", str(workdir / "tim")]
        base = ["realize", *common, "--recipe", str(workdir / "recipe.json"), "--nreal",
                str(TELEMETRY_NREAL), "--chunk", str(TELEMETRY_CHUNK), "--fit", "--seed",
                str(DATASET_SEED)]
        self.live, self.killed = workdir / "live_cli", workdir / "live_kill"
        env = dict(os.environ, PTA_SLO=LIVE_CLI_SLO)

        def start(args):
            return subprocess.Popen([sys.executable, "-m", "pta_replicator_tpu_torch", *args],
                                    cwd=str(Path(__file__).resolve().parent), env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        self.seen = {r: collections.Counter() for r in LIVE_ROUTES}
        self.killed_at, self.url, self.error = None, None, None
        self.t0 = time.perf_counter()
        self.procs = {"watch": start(["watch", str(self.live), "--serve", "0", "--interval",
                                      str(LIVE_WATCH_INTERVAL_S)])}
        self.procs["realize"] = start(base + ["--out", str(workdir / "live_cube.npz"),
                                              "--checkpoint", str(workdir / "live_ck.npz"),
                                              "--telemetry", str(self.live)])
        self.procs["kill"] = start(base + ["--out", str(workdir / "kill_cube.npz"),
                                           "--checkpoint", str(workdir / "kill_ck.npz"),
                                           "--telemetry", str(self.killed), "--faults",
                                           f"drain:stall={LIVE_KILL_STALL_S}@chunk=1"])
        self.monitor = threading.Thread(target=self._monitor, name="live-cli-monitor",
                                        daemon=True)
        self.monitor.start()

    def _monitor(self):
        import re
        import signal

        try:
            line = self.procs["watch"].stderr.readline()
            match = re.search(r"serving (http://127\.0\.0\.1:\d+)/", line)
            if match is None:
                raise RuntimeError(f"watch --serve printed {line!r}")
            self.url = match.group(1)
            while any(p.poll() is None for p in self.procs.values()):
                if time.perf_counter() - self.t0 > LIVE_CLI_TIMEOUT_S:
                    raise RuntimeError(f"CLI arms past {LIVE_CLI_TIMEOUT_S} s")
                if self.procs["watch"].poll() is None:
                    for route in LIVE_ROUTES:
                        self.seen[route][str(_http_get(self.url + route)[0])] += 1
                hb = _read_json(self.killed / "progress.json") or {}
                if self.killed_at is None and (hb.get("sweep") or {}).get("chunks_done", 0) >= 1:
                    self.procs["kill"].send_signal(signal.SIGTERM)
                    self.killed_at = time.perf_counter() - self.t0
                time.sleep(0.2)
        except Exception as exc:  # reported by finish(), which kills what is left
            self.error = repr(exc)
        self.cli_s = time.perf_counter() - self.t0

    def kill(self):
        """Stop every process of the arms (the phase between failed)."""
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    def finish(self):
        from pta_replicator_tpu_torch.obs import occupancy
        from pta_replicator_tpu_torch.obs import report as obs_report
        from pta_replicator_tpu_torch.obs.series import load_series

        try:
            self.monitor.join(timeout=LIVE_CLI_TIMEOUT_S)
            outs = {name: p.communicate(timeout=60) for name, p in self.procs.items()}
        finally:
            self.kill()
        require(self.error is None, f"live_run: CLI arms: {self.error}")
        codes = {name: p.returncode for name, p in self.procs.items()}
        live, killed = self.live, self.killed
        # the two reading subcommands through the CLI's entry point, in
        # process (an interpreter each would add seconds of imports)
        reads = {name: _cli_in_process(*args) for name, args in
                 (("report", ["report", str(live)]), ("postmortem", ["postmortem", str(killed)]))}
        hb = _read_json(live / "progress.json") or {}
        pm = _read_json(killed / "postmortem.json") or {}
        series = load_series(str(live / "series.jsonl")) if (live / "series.jsonl").exists() else {}
        report_text = reads["report"][1]
        utilization = occupancy.analyze(obs_report.load_telemetry(str(live))["events"])
        return dict(
            cli_s=self.cli_s, exit_codes=codes, killed_at_s=self.killed_at, routes=self.seen,
            watch_lines=len(outs["watch"][0].splitlines()),
            watch_finished="FINISHED" in outs["watch"][0],
            heartbeat=dict(finished=hb.get("finished"), sweep=hb.get("sweep"),
                           occupancy=hb.get("occupancy"), slo=hb.get("slo"),
                           device_memory=hb.get("device_memory"), jax=hb.get("jax"),
                           trends=len(hb.get("trends") or {})),
            series=dict(series=len(series.get("series") or []),
                        quantiles=len(series.get("quantiles") or [])),
            report_exit=reads["report"][0],
            report_sections={s: s in report_text for s in LIVE_SECTIONS},
            report_lines=len(report_text.splitlines()), utilization=utilization,
            postmortem_exit=reads["postmortem"][0],
            postmortem_lines=len(reads["postmortem"][1].splitlines()),
            killed=dict(reason=pm.get("reason"), ring=len(pm.get("ring") or []),
                        open_spans=(pm.get("heartbeat") or {}).get("open_spans"),
                        chunks_done=((pm.get("heartbeat") or {}).get("sweep") or {}).get(
                            "chunks_done")),
            stderr_tail={n: o[1][-1500:] for n, o in outs.items() if codes[n] not in (0, None)},
        )


def phase_live_run(workdir, batch, recipe, smi):
    """The live-run surface on the card (A.16.4a), on the flagship (68 x
    7,758, float32, fit, chunk 200) and the dataset path's par/tim.
    (1) Overhead, first (after an ``os.sync``): the reduced in-process sweep
    under a capture (the flight recorder every LIVE_HEARTBEAT_S, a latency
    objective armed) against none, LIVE_OVERHEAD_PAIRS ABBA pairs, then one
    of each under torch.profiler. Gates: the median of the adjacent pairs'
    armed / disarmed rate ratios >= LIVE_RATE_FLOOR (the ratio of the two
    medians is a reading); the synchronizing CUDA calls equal;
    B.1's launches equal; the reduced outputs equal bit for bit; at least
    LIVE_MIN_HEARTBEATS heartbeats each armed sweep. Then the CLI arms start
    in the background (:class:`_LiveCliArms`), and the caller runs the next
    phase before :func:`phase_live_run_cli` joins them. Returns the row so
    far, the arms and the kernels' launches."""
    t_phase = time.perf_counter()
    counts = collections.Counter()
    row = dict(nvidia_smi=smi)
    with _ProcessState():
        os.sync()
        t_part = time.perf_counter()
        row["overhead"] = _live_overhead(batch, recipe, workdir, counts)
        row["part_s"] = {"overhead": time.perf_counter() - t_part}
    ov = row["overhead"]
    require(ov["paired_median"] >= LIVE_RATE_FLOOR, f"live_run: armed sweep rate {ov}")
    require(ov["sync_calls"]["armed"] == ov["sync_calls"]["disarmed"],
            f"live_run: synchronizing calls {ov['sync_calls']}")
    require(ov["b1_launches"]["armed"] == ov["b1_launches"]["disarmed"] > 0,
            f"live_run: B.1 launches {ov['b1_launches']}")
    require(ov["outputs_equal"], "live_run: a capture changed the sweep's output")
    require(min(ov["heartbeats"]) >= LIVE_MIN_HEARTBEATS,
            f"live_run: heartbeats a sweep {ov['heartbeats']}")
    row["launches"] = dict(counts)
    row["seconds_in_process"] = time.perf_counter() - t_phase
    return row, _LiveCliArms(workdir), dict(counts)


def phase_live_run_cli(row, arms):
    """The live-run phase's CLI arms joined and held (they ran beside the
    phase between). Gates: the watch exits 0 when the run finishes; the
    final heartbeat finished, chunks_done = chunks_total, with an occupancy
    verdict and the card's memory (peak > 0); series.jsonl loads;
    ``report`` renders LIVE_SECTIONS; /healthz, /readyz, /progress and
    /metrics each answered 200; the killed call's postmortem.json has
    reason SIGTERM, a non-empty ring and the sweep's open spans, its exit
    status is a re-raised SIGTERM's, and ``postmortem DIR`` exits 0."""
    import signal

    t_part = time.perf_counter()
    cli = arms.finish()
    row["cli"] = cli
    row["part_s"]["cli_join"] = time.perf_counter() - t_part
    emit("live_run", **row)
    hb = cli["heartbeat"]
    sweep_block = hb["sweep"] or {}
    name = torch.cuda.get_device_name(0)
    require(cli["exit_codes"]["watch"] == 0 and cli["exit_codes"]["realize"] == 0
            and cli["watch_finished"], f"live_run: CLI {cli['exit_codes']} {cli['stderr_tail']}")
    require(hb["finished"] is True and sweep_block.get("chunks_total")
            and sweep_block.get("chunks_done") == sweep_block.get("chunks_total")
            and (hb["occupancy"] or {}).get("bottleneck"), f"live_run: heartbeat {hb}")
    require(any(name in m["device"] and m.get("peak_bytes_in_use", 0) > 0
                for m in hb["device_memory"] or []), f"live_run: device_memory {hb}")
    require(cli["series"]["series"] > 0, f"live_run: series.jsonl {cli['series']}")
    require(cli["report_exit"] == 0 and all(cli["report_sections"].values()),
            f"live_run: report {cli['report_sections']}")
    require(all(cli["routes"][r].get("200", 0) > 0 for r in LIVE_ROUTES),
            f"live_run: routes seen {cli['routes']}")
    killed = cli["killed"]
    require(cli["exit_codes"]["kill"] == -signal.SIGTERM and killed["reason"] == "SIGTERM"
            and killed["ring"] > 0
            and any("sweep_pipeline" in s for s in (killed["open_spans"] or {}).values()),
            f"live_run: killed run {cli['exit_codes']} {killed}")
    require(cli["postmortem_exit"] == 0, f"live_run: postmortem exit {cli['postmortem_exit']}")


def phase_live_run_server(bank, batch, recipe, design):
    """The live-run phase's server arm: the float64 LikelihoodServer on the
    flagship bank under a capture with a tight latency objective on
    ``likelihood_batch`` and the capture served on loopback. LIVE_SERVER_FAST
    requests one by one, then one whose engine call a
    ``likelihood_batch:stall`` fault holds past the objective. Gates: one
    trace a request with the JAX hop spans (submit, queue wait, resolve, the
    batch span linking it); ``likelihood.requests`` = the requests sent;
    /readyz 200 before the stall and 503 during the fast burn; the rows
    bitwise the uncaptured server's. Returns the Woodbury kernel's launches
    (the server prices with the composed build: none)."""
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.faults import inject
    from pta_replicator_tpu_torch.obs import report as obs_report
    from pta_replicator_tpu_torch.obs.serve import serve_directory, serve_url

    t_phase = time.perf_counter()
    grid, _ = lk.grid_cartesian(LIKELIHOOD_GRID)
    axes = tuple(sorted(LIKELIHOOD_GRID))
    point = lambda i: {k: float(grid[k][i]) for k in axes}
    n = LIVE_SERVER_FAST + 1

    def make():
        return lk.LikelihoodServer(lk.RealizationBank.from_array(bank), batch, recipe, axes,
                                   design=design, max_batch=SERVER_BATCH, device=batch.device)

    launches.clear()
    with make() as server:
        clean = [server.submit(**point(i)).result(timeout=600) for i in range(n)]
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_live_server_"))
    slo = f"serve=likelihood_batch:p99_ms<={LIVE_SERVER_SLO_MS}@99%"
    readyz, futures, rows, http = {}, [], [], None

    def wait_readyz(code, timeout=15.0):
        t_wait = time.perf_counter()
        while time.perf_counter() - t_wait < timeout:
            got, body = _http_get(serve_url(http, "/readyz"))
            if got == code and (d / "slo.json").exists():
                return got, json.loads(body)
            time.sleep(0.05)
        got, body = _http_get(serve_url(http, "/readyz"))
        return got, _json_or_text(body)

    try:
        with _ProcessState():
            obs.start_capture(str(d), heartbeat_interval_s=LIVE_SERVER_HEARTBEAT_S, slo=slo)
            try:
                http = serve_directory(str(d), 0, background=True)
                server = make().start()
                try:
                    for i in range(LIVE_SERVER_FAST):
                        futures.append(server.submit(**point(i)))
                        rows.append(futures[-1].result(timeout=600))
                    readyz["before"] = wait_readyz(200)
                    inject.arm(f"likelihood_batch:stall={LIVE_SERVER_STALL_S:g}@call=1")
                    futures.append(server.submit(**point(LIVE_SERVER_FAST)))
                    rows.append(futures[-1].result(timeout=600))
                    inject.disarm()
                    readyz["during"] = wait_readyz(503)
                finally:
                    inject.disarm()
                    server.stop()
                stats = server.stats()
            finally:
                if http is not None:
                    http.shutdown()
                    http.server_close()
                obs.finish_capture(context={"phase": "live_run_server"})
        data = obs_report.load_telemetry(str(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    b3 = launches.get("fused_woodbury_update", 0)
    spans = collections.defaultdict(list)
    for rec in data["events"]:
        if rec.get("type") == "span":
            spans[rec["name"]].append(rec)
    traces = {}
    for f in futures:
        tid = f.trace_id
        traces[tid] = dict(
            submit=sum(r.get("trace_id") == tid for r in spans["likelihood_submit"]),
            queue_wait=sum(r.get("trace_id") == tid for r in spans["likelihood_queue_wait"]),
            resolve=sum(r.get("trace_id") == tid for r in spans["likelihood_resolve"]),
            batch=sum(tid in (r.get("links") or []) for r in spans["likelihood_batch"]))
    requests = ((data["metrics"] or {}).get("likelihood.requests") or [{}])[0].get("value")
    equal = len(rows) == n and all(np.array_equal(a, b) for a, b in zip(rows, clean))
    row = dict(requests=n, objective=slo, stall_s=LIVE_SERVER_STALL_S,
               readyz={k: [v[0], v[1]] for k, v in readyz.items()},
               traces=list(traces.values()), likelihood_requests=requests,
               batch_ms=[round(1e3 * r["wall_s"], 3) for r in spans["likelihood_batch"]],
               slo=data["slo"], rows_equal_uncaptured=equal, b3_launches=b3,
               latency=stats["latency"], seconds=time.perf_counter() - t_phase)
    emit("live_run_server", **row)
    require(all(t == dict(submit=1, queue_wait=1, resolve=1, batch=1) for t in traces.values())
            and len(traces) == n, f"live_run_server: traces {traces}")
    require(requests == n, f"live_run_server: likelihood.requests {requests} != {n}")
    require(readyz["before"][0] == 200 and readyz["during"][0] == 503
            and readyz["during"][1].get("state") == "slo-breach",
            f"live_run_server: /readyz {readyz}")
    require(equal, "live_run_server: rows differ from the uncaptured server's")
    return b3


def _json_or_text(body):
    try:
        return json.loads(body)
    except (ValueError, TypeError):
        return {"text": body[:200].decode(errors="replace") if isinstance(body, bytes) else body}


# ---------------------------------------------------------- time attribution

#: the time-attribution phase (A.16.4b): the flagship sweep, reduced, fit,
#: depth 2, in chunks of 200, under a capture and a device trace; the same
#: sweep untraced (the rate reading) and under a capture with one seeded
#: transient dispatch fault and one retry
ATTRIBUTION_NREAL, ATTRIBUTION_CHUNK, ATTRIBUTION_DEPTH = 2000, 200, 2
ATTRIBUTION_FAULT_SEED = 22
ATTRIBUTION_RETRY = dict(max_attempts=2, base_delay_s=0.0, jitter=0.0)
#: chunks of the run_pipelined arms (a trace scope and none) under torch.profiler
ATTRIBUTION_PIPELINED_CHUNKS = 6
#: B.1's two kernels, by the names CUPTI gives them
B1_KERNELS = ("cw_fold_planes", "cw_catalog_kernel")
#: the sections the report of the in-process capture renders
ATTRIBUTION_SECTIONS = ("critical path (attribution over the phase window):",
                        "roofline (per kernel label):", "device trace: device_trace")
ATTRIBUTION_CLI_TIMEOUT_S = 600


def _capture_problems(directory):
    """The checks of the JAX package's scripts/check_telemetry_schema.py on
    a capture, jax-free: every events.jsonl record against the port's
    EVENT_SCHEMA (trace ids 32 hex digits, span ids 16), critpath.json's
    schema version, numbers, stages and ranked verdict, and each
    registered device trace's directory."""
    from pta_replicator_tpu_torch.obs.critpath import CRITPATH_SCHEMA_VERSION
    from pta_replicator_tpu_torch.obs.trace import EVENT_SCHEMA

    problems = []
    for k, rec in enumerate(_events_of(directory)):
        schema = EVENT_SCHEMA.get(rec.get("type"))
        if schema is None or any(not isinstance(rec.get(f), t) for f, t in schema.items()):
            problems.append(f"events.jsonl:{k}: {rec}")
        for field, nhex in (("trace_id", 32), ("span_id", 16), ("parent_id", 16)):
            val = rec.get(field)
            if val is not None and (len(val) != nhex or set(val) - set("0123456789abcdef")):
                problems.append(f"events.jsonl:{k}: {field} {val!r}")
    doc = _read_json(Path(directory) / "critpath.json")
    if not isinstance(doc, dict) or not isinstance(doc.get("schema_version"), int) \
            or doc["schema_version"] > CRITPATH_SCHEMA_VERSION:
        return problems + [f"critpath.json: {str(doc)[:200]}"]
    stages = doc.get("stages") or {}
    for field in ("critical_path_s", "blocked_s", "attributed_fraction"):
        if not isinstance(doc.get(field), (int, float)):
            problems.append(f"critpath.json: {field}")
    for name, st in stages.items():
        if not all(isinstance(st.get(f), (int, float))
                   for f in ("busy_s", "critical_s", "critical_share")):
            problems.append(f"critpath.json: stage {name}")
    verdict = doc.get("verdict") or {}
    if not isinstance(verdict.get("summary"), str) or any(
            r.get("stage") not in stages for r in verdict.get("ranked") or [None]):
        problems.append(f"critpath.json: verdict {verdict}")
    meta = _read_json(Path(directory) / "meta.json") or {}
    for entry in meta.get("device_traces") or []:
        if not (Path(directory) / entry).is_dir():
            problems.append(f"meta.json: device trace {entry} missing")
    return problems


def _events_of(directory):
    from pta_replicator_tpu_torch.obs.report import load_events

    return load_events(str(Path(directory) / "events.jsonl"))


def _chunk_chains(events, path):
    """chunk -> (the stage names of its chain, the trace ids they carry),
    and the trace id each chunk's scope gives."""
    from pta_replicator_tpu_torch.obs.trace import chunk_trace_context

    chains = {}
    for e in events:
        if e.get("type") == "span" and e.get("name") in ("dispatch", "drain", "io_write") \
                and "chunk" in (e.get("attrs") or {}):
            names_, ids = chains.setdefault(e["attrs"]["chunk"], (set(), set()))
            names_.add(e["name"])
            ids.add(e.get("trace_id"))
    want = {i: chunk_trace_context(str(path), i).trace_id for i in chains}
    return chains, want


def _device_view(directory, doc):
    """The merged timeline read for the gates: B.1's kernels, each with the
    innermost host span holding its launch (the runtime call of the same
    correlation id); the chunk flows; the open marker's readings; the
    threads the profiler saw."""
    from pta_replicator_tpu_torch.obs.devprof import OPEN_MARKER, WARMUP_LAUNCHES

    events = doc["traceEvents"]
    device = [e for e in events if isinstance(e.get("pid"), int) and e["pid"] >= 1 << 21]
    host = sorted((e for e in events if e.get("cat") == "host" and e.get("ph") == "X"),
                  key=lambda e: e["dur"])
    kernels = [e for e in device if e.get("cat") == "kernel"]
    runtime = [e for e in device if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launch_of = {(e.get("args") or {}).get("correlation"): e for e in runtime}
    b1 = []
    for k in kernels:
        which = next((n for n in B1_KERNELS if n in k["name"]), None)
        if which is None:
            continue
        launch = launch_of.get((k.get("args") or {}).get("correlation"))
        span = None if launch is None else next(
            (h for h in host if h["ts"] <= launch["ts"] <= h["ts"] + h["dur"]), None)
        b1.append(dict(kernel=which, ts=k["ts"],
                       launch_ts=None if launch is None else launch["ts"],
                       span=None if span is None else span["name"],
                       span_ts=None if span is None else span["ts"]))
    flows = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "chunk":
            flows[e["id"]].append(e["ph"])
    marker = [e for e in device if e.get("name") == OPEN_MARKER]
    stamped = [e["ts"] for e in device if isinstance(e.get("ts"), (int, float))
               and e.get("ph") != "M"]
    span = next(r for r in _events_of(directory) if r.get("name") == "device_trace")
    raw = {}
    for f in (Path(directory) / "device_trace").glob("*.trace.json"):
        raw = json.loads(f.read_text())
    base_ns = raw.get("baseTimeNanoseconds")
    raw_marker = [e["ts"] for e in raw.get("traceEvents", []) if e.get("name") == OPEN_MARKER]
    first = min((e["ts"] for e in device if e.get("cat") == "kernel"
                 and (not marker or e["ts"] >= marker[0]["ts"])), default=None)
    # the session's warm-up kernels, before the marker: how many records of a
    # session's first kernels the profiler lost (obs/devprof.py)
    warmup = sum(1 for e in kernels if marker and e["ts"] < marker[0]["ts"])
    # every kernel against its launch: negative where the device's clock
    # runs behind the host's in the trace
    lag = sorted(k["ts"] - launch_of[c]["ts"] for k in kernels
                 if (c := (k.get("args") or {}).get("correlation")) in launch_of)
    return dict(
        device_events=doc["otherData"]["device_events"], kernels=len(kernels),
        runtime_calls=len(runtime),
        first_kernel_after_marker_ms=(first - marker[0]["ts"]) / 1e3
        if marker and first is not None else None,
        warmup_lost=WARMUP_LAUNCHES - warmup,
        kernel_after_launch_ms=[lag[0] / 1e3, lag[len(lag) // 2] / 1e3] if lag else None,
        b1=b1, flows={int(k): v for k, v in flows.items()},
        marker_count=len(marker),
        # how far the JAX rule (the earliest event at t_wall_open) would sit
        # from the marker's anchor: the profiler's start-up before the marker
        jax_rule_offset_ms=(marker[0]["ts"] - min(stamped)) / 1e3 if marker else None,
        # the marker on the profiler's own wall clock (its base time) against
        # t_wall_open, when the trace carries a base time
        marker_vs_wall_open_ms=(base_ns / 1e6 + raw_marker[0] / 1e3
                                - span["attrs"]["t_wall_open"] * 1e3)
        if base_ns and raw_marker else None,
        # the B.1 launches' least distance past the start of their host span
        launch_slack_ms=min((b["launch_ts"] - b["span_ts"]) / 1e3 for b in b1
                            if b["span_ts"] is not None) if any(
                                b["span_ts"] is not None for b in b1) else None,
        threads=dict(cuda_runtime=len({e.get("tid") for e in runtime}),
                     cpu_op=len({e.get("tid") for e in device if e.get("cat") == "cpu_op"})),
        trace_mb=sum(f.stat().st_size for f in (Path(directory) / "device_trace").iterdir())
        / 2**20,
    )


def _attribution_gates(tag, directory, path, nchunks, view):
    """The gates both arms share: the capture passes the schema checks;
    critpath.json attributes every chunk, each chain dispatch -> drain ->
    io_write under its own trace id; the merged timeline has device events
    with both B.1 kernels, each starting no earlier than the host span whose
    thread launched it began, and one flow chain a chunk."""
    problems = _capture_problems(directory)
    require(not problems, f"time_attribution {tag}: schema {problems[:5]}")
    doc = _read_json(Path(directory) / "critpath.json")
    require(doc["chunks"]["count"] == nchunks and doc["chunks"]["trace_coherent_fraction"] == 1.0,
            f"time_attribution {tag}: critpath chunks {doc['chunks']}")
    chains, want = _chunk_chains(_events_of(directory), path)
    require(sorted(chains) == list(range(nchunks)) and all(
        chains[i][0] == {"dispatch", "drain", "io_write"} and chains[i][1] == {want[i]}
        for i in chains), f"time_attribution {tag}: chunk chains {chains} {want}")
    require(view["device_events"] > 0 and view["marker_count"] == 1,
            f"time_attribution {tag}: device events {view['device_events']}, "
            f"markers {view['marker_count']}")
    seen = {n for n in B1_KERNELS if any(n in b["kernel"] for b in view["b1"])}
    require(seen == set(B1_KERNELS), f"time_attribution {tag}: B.1 kernels {view}")
    require(all(b["span_ts"] is not None and b["ts"] >= b["span_ts"] for b in view["b1"]),
            f"time_attribution {tag}: B.1 kernel before its host span {view['b1']}")
    require(view["flows"] == {i: ["s", "t", "f"] for i in range(nchunks)},
            f"time_attribution {tag}: chunk flows {view['flows']}")


def _read_capture(tag, directory, path, nchunks):
    """``critpath DIR`` and ``timeline DIR`` through the CLI's entry point in
    this process, then the gates; the readings."""
    t0 = time.perf_counter()
    code_cp, text = _cli_in_process("critpath", str(directory))
    code_tl, summary = _cli_in_process("timeline", str(directory))
    read_s = time.perf_counter() - t0
    require(code_cp == 0 and code_tl == 0, f"time_attribution {tag}: exits {code_cp} {code_tl}")
    summary = json.loads(summary)
    doc = json.loads(Path(summary["out"]).read_text())
    require(doc["otherData"]["problems"] == [],
            f"time_attribution {tag}: timeline problems {doc['otherData']['problems']}")
    view = _device_view(directory, doc)
    _attribution_gates(tag, directory, path, nchunks, view)
    cp = _read_json(Path(directory) / "critpath.json")
    del doc
    return dict(read_s=read_s, verdict=cp["verdict"]["summary"],
                attributed_fraction=cp["attributed_fraction"],
                analyzer_overhead_s=cp["analyzer"]["overhead_s"],
                timeline_summary={k: summary[k] for k in (
                    "events", "host_spans", "flow_events", "device_events", "critpath_slices")},
                **{k: v for k, v in view.items() if k != "b1"},
                b1_kernels=len(view["b1"]), b1_spans=sorted({b["span"] for b in view["b1"]}))


def _attribution_sweep(batch, recipe, path, directory=None, traced=False, schedule=None,
                       then=None):
    """The phase's flagship sweep, under a capture into ``directory`` when
    given (with a device trace around the sweep when ``traced``, a fault
    schedule armed when given, and ``then()`` run in the capture after the
    sweep): its result, the sweep call's wall s, and the device trace's
    open and close s (its close writes the trace)."""
    import contextlib

    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.faults import RetryPolicy
    from pta_replicator_tpu_torch.faults import inject

    _drop_checkpoint(path, ATTRIBUTION_NREAL // ATTRIBUTION_CHUNK)
    if directory is not None:
        obs.start_capture(str(directory), flight_recorder=False)
    if schedule is not None:
        inject.arm(schedule)
    try:
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            t_open = time.perf_counter()
            if traced:
                stack.enter_context(obs.devprof.device_trace(device=batch.device))
            t0 = time.perf_counter()
            out = sweep(SWEEP_SEED, batch, recipe, ATTRIBUTION_NREAL, str(path),
                        chunk=ATTRIBUTION_CHUNK, fit=True, pipeline_depth=ATTRIBUTION_DEPTH,
                        chunk_retries=1, retry_policy=RetryPolicy(**ATTRIBUTION_RETRY),
                        device=batch.device)
            wall = time.perf_counter() - t0
            t_close = time.perf_counter()
        trace_s = dict(open_s=t0 - t_open, close_s=time.perf_counter() - t_close)
        if then is not None:
            then()
    finally:
        inject.disarm()
        if directory is not None:
            obs.finish_capture(context={"phase": "time_attribution"})
            obs.configure(None)
    return out, wall, trace_s


def _pipelined_arm(batch, recipe, static, traced):
    """ATTRIBUTION_PIPELINED_CHUNKS reduced flagship chunks through
    ``run_pipelined`` with a trace scope (``traced``), or through the same
    three stages declared with none."""
    from pta_replicator_tpu_torch.parallel.pipeline import (
        PinnedReadback, dispatch_stage, drain_stage, io_write_stage, run_pipelined,
    )
    from pta_replicator_tpu_torch.parallel.stages import StageGraph

    readback = PinnedReadback(batch.device, ATTRIBUTION_DEPTH + 1)

    def dispatch(i):
        gen = torch.Generator(device=batch.device).manual_seed(chunk_seed(SWEEP_SEED, i))
        res = realize(gen, batch, recipe, ATTRIBUTION_CHUNK, fit=True, static=static,
                      device=batch.device)
        return readback.mark(sweep_mod._default_reduce(res, batch))

    chunks = range(ATTRIBUTION_PIPELINED_CHUNKS)
    try:
        if traced:
            run_pipelined(chunks, dispatch, lambda i, b: None, depth=ATTRIBUTION_DEPTH,
                          fetch=readback.fetch, release=readback.release,
                          trace_scope="time_attribution")
        else:
            StageGraph([dispatch_stage(dispatch), drain_stage(readback.fetch, ATTRIBUTION_DEPTH),
                        io_write_stage(lambda i, b: None, readback.release)],
                       window=ATTRIBUTION_DEPTH, name="sweep").run(chunks)
    finally:
        readback.close()


class _AttributionCli:
    """The phase's CLI arm, in the background beside the likelihood CLI:
    ``realize --telemetry DIR --device-trace --checkpoint --nreal 400
    --chunk 200 --fit`` on the dataset path's par/tim; :meth:`finish` joins
    it and reads its capture with ``critpath DIR`` and ``timeline DIR``."""

    def __init__(self, workdir):
        self.dir, self.ck = workdir / "attribution_cli", workdir / "attribution_ck.npz"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pta_replicator_tpu_torch", "realize", "--pardir",
             str(workdir / "par"), "--timdir", str(workdir / "tim"), "--recipe",
             str(workdir / "recipe.json"), "--nreal", str(TELEMETRY_NREAL), "--chunk",
             str(TELEMETRY_CHUNK), "--fit", "--seed", str(DATASET_SEED), "--out",
             str(workdir / "attribution_cube.npz"), "--checkpoint", str(self.ck),
             "--telemetry", str(self.dir), "--device-trace"],
            cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def finish(self):
        try:
            out, err = self.proc.communicate(timeout=ATTRIBUTION_CLI_TIMEOUT_S)
        finally:
            self.kill()
        cli_s = time.perf_counter() - self.t0
        require(self.proc.returncode == 0,
                f"time_attribution: CLI exit {self.proc.returncode}: {err[-1500:]}")
        row = dict(cli_s=cli_s, **_read_capture("cli", self.dir, self.ck,
                                                TELEMETRY_NREAL // TELEMETRY_CHUNK))
        emit("time_attribution_cli", **row)
        return row


def phase_time_attribution(batch, recipe, batch64, recipe64, design, smi):
    """Time attribution and device profiling on the card (A.16.4b). The
    flagship sweep (68 x 7,758, float32, fit, reduced, ATTRIBUTION_NREAL in
    chunks of 200 at depth 2) runs untraced (the rate reading), then under a
    capture and ``devprof.device_trace``, with the tuner's search of B.3 at
    the flagship's Q = 123 (float64) after it in the same capture; then
    ``critpath DIR`` and ``timeline DIR`` over it through the CLI's entry
    point in process. A second sweep, untraced, under a capture with one
    seeded transient ``dispatch`` fault and one retry. Then run_pipelined
    with a trace scope and the same stages without one, each under
    torch.profiler. Gates: the schema checks (:func:`_capture_problems`);
    critpath.json's chunks = the sweep's, each chain dispatch -> drain ->
    io_write under its chunk's trace id; the merged timeline's device events
    with B.1's two kernels, each starting no earlier than its launching host
    span, and one flow chain a chunk; the retried chunk's trace holds two
    dispatch attempts and the ``faults.retry`` event; the report renders the
    critical path, the roofline and the device trace, with
    ``fused_woodbury_update``'s % of roofline in (0, 100]; the traced and
    untraced pipelines make equal ``cudaLaunchKernel`` and synchronizing
    calls. Returns the kernels' launches on its main path (the traced sweep
    and the tuner's search)."""
    import random

    from pta_replicator_tpu_torch.obs import report as obs_report
    from pta_replicator_tpu_torch.obs.trace import chunk_trace_context

    t_phase = time.perf_counter()
    nchunks = ATTRIBUTION_NREAL // ATTRIBUTION_CHUNK
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_attribution_"))
    path = workdir / "attribution.npz"
    row = dict(nvidia_smi=smi, nreal=ATTRIBUTION_NREAL, chunk=ATTRIBUTION_CHUNK,
               depth=ATTRIBUTION_DEPTH, part_s={})
    T, w, r = _woodbury_operands(batch64, recipe64, design)
    try:
        with _ProcessState():
            t_part = time.perf_counter()
            _attribution_sweep(batch, recipe, path)  # warm
            plain, plain_s, _ = _attribution_sweep(batch, recipe, path)
            traced_dir = workdir / "traced"
            choice = {}
            launches.clear()
            traced, traced_s, trace_s = _attribution_sweep(
                batch, recipe, path, traced_dir, traced=True,
                then=lambda: choice.update(tuner.autotune(
                    T, w, r, reps=TUNER_REPS, write=False,
                    cache_path=str(workdir / "tuner.json"))))
            counts = dict(launches)
            row["part_s"]["sweeps"] = time.perf_counter() - t_part
            row["sweep"] = dict(plain_s=plain_s, traced_s=traced_s,
                                traced_rate_over_plain=plain_s / traced_s, **trace_s,
                                outputs_equal=bool(np.array_equal(plain, traced)),
                                tuner_winner=choice.get("nsplit"))
            t_part = time.perf_counter()
            row["traced"] = _read_capture("in_process", traced_dir, path, nchunks)
            report_text = obs_report.render_report(str(traced_dir))
            metrics = _read_json(traced_dir / "metrics.json") or {}
            row["roofline"] = {
                inst["labels"]["label"]: inst["value"]
                for inst in metrics.get("cuda.roofline.pct_of_roofline", [])}
            row["report_sections"] = {s: s in report_text for s in ATTRIBUTION_SECTIONS}
            row["part_s"]["read"] = time.perf_counter() - t_part

            # the retry arm: one seeded transient dispatch fault, one retry
            t_part = time.perf_counter()
            k = random.Random(ATTRIBUTION_FAULT_SEED).randrange(1, nchunks)
            retry_dir = workdir / "retried"
            retried, _, _ = _attribution_sweep(batch, recipe, path, retry_dir,
                                               schedule=f"dispatch:raise@chunk={k}")
            events = _events_of(retry_dir)
            want = chunk_trace_context(str(path), k).trace_id
            row["retry"] = dict(
                chunk=k, trace_id=want,
                attempts=[e.get("trace_id") for e in events if e.get("name") == "dispatch"
                          and (e.get("attrs") or {}).get("chunk") == k],
                retry_events=[dict(trace_id=e.get("trace_id"), chunk=e["attrs"].get("chunk"))
                              for e in events if e.get("type") == "event"
                              and e.get("name") == "faults.retry"],
                outputs_equal=bool(np.array_equal(retried, plain)))
            row["part_s"]["retry"] = time.perf_counter() - t_part

            # a trace scope adds no launch and no synchronizing call
            t_part = time.perf_counter()
            static = deterministic_delays(batch, recipe, device=batch.device)
            row["pipelined"] = {
                mode: _sync_calls(lambda t=traced_: _pipelined_arm(batch, recipe, static, t),
                                  calls=NUMERICS_RUNTIME_CALLS)[0]
                for mode, traced_ in (("scoped", True), ("unscoped", False))}
            del static
            row["part_s"]["pipelined"] = time.perf_counter() - t_part
    finally:
        del T, w, r
        shutil.rmtree(workdir, ignore_errors=True)
    row["launches"] = counts
    row["seconds_in_process"] = time.perf_counter() - t_phase
    emit("time_attribution", **row)
    require(row["sweep"]["outputs_equal"], "time_attribution: the trace changed the sweep's output")
    require(all(row["report_sections"].values()),
            f"time_attribution: report sections {row['report_sections']}")
    woodbury = {k: v for k, v in row["roofline"].items()
                if k.startswith("fused_woodbury_update")}
    require(woodbury and all(0 < v <= 100 for v in woodbury.values()),
            f"time_attribution: fused_woodbury_update % of roofline {row['roofline']}")
    retry = row["retry"]
    require(retry["attempts"] == [retry["trace_id"]] * 2
            and retry["retry_events"] == [dict(trace_id=retry["trace_id"], chunk=retry["chunk"])]
            and retry["outputs_equal"], f"time_attribution: retried chunk {retry}")
    scoped, unscoped = row["pipelined"]["scoped"], row["pipelined"]["unscoped"]
    require(all(scoped[c] == unscoped[c] for c in ("cudaLaunchKernel", *SYNC_CALLS)),
            f"time_attribution: trace scope changed the CUDA calls {row['pipelined']}")
    require(counts.get("cw_catalog_response", 0) > 0 and counts.get("cw_fold_planes", 0) > 0
            and counts.get("fused_woodbury_update", 0) > 0,
            f"time_attribution: launches {counts}")
    return counts


def fuzz_cover_n():
    """The smallest n whose specs ``sample_spec(0, 0..n-1)`` carry every
    token of REQUIRED_COVERAGE (``spec_families``) and hold a scenario the
    sweep-identity arm checks (a sweep plan at an index divisible by
    FUZZ_SWEEP_EVERY); no compile, no run. FUZZ_CAP when no n below it
    does."""
    missing, checked = set(REQUIRED_COVERAGE), False
    for i in range(FUZZ_CAP):
        spec = sample_spec(0, i)
        missing -= set(spec_families(spec))
        checked = checked or (spec.sweep is not None and i % FUZZ_SWEEP_EVERY == 0)
        if not missing and checked:
            return i + 1
    return FUZZ_CAP


def _fuzz_card_vs_cpu(fz, n):
    """The batched families of the first ``n`` scenarios at root 0 on the
    card against the same on the CPU, where each wrapper runs its kernel's
    plain version, under the CPU's draws copied to the card: the largest
    relative deviation per family (``fuzz._rel``)."""
    worst = {}
    for i in range(n):
        spec = sample_spec(0, i)
        cpu = compile_spec(spec, validate=False, device="cpu")
        card = compile_spec(spec, validate=False, device="cuda")
        draws = fz.realization_draws(cpu)
        want = fz.batched_family_delays(cpu, draws)
        got = fz.batched_family_delays(card, {k: v.to("cuda") for k, v in draws.items()})
        for fam in want:
            worst[fam] = max(worst.get(fam, 0.0), fz._rel(got[fam], want[fam]))
    return worst


def phase_fuzz(workdir):
    """The differential fuzz harness on the card, through its entry point:
    ``fuzz(n, root_seed=0, sweep_every=4)``, n from fuzz_cover_n(), with
    the launch counts cleared before and read after; then the
    planted-defect arm (ECORR scaled by 1.01 in 6 scenarios at root 5,
    shrunk, written and replayed without the defect); then ``scenario fuzz
    --fast`` and ``scenario replay`` of a minimal spec, each in a fresh
    interpreter; then the card's batched families against the port's CPU
    run over the first 8 scenarios under the same draws (B.1 against its
    plain version at the generator's shapes: scenario 0's catalog on the
    accumulating launch in tiles of two sources, scenarios 1, 3, 5 and 7's
    in one), the counts cleared before and read after. Gates: agreement
    1.0 with every family within the unchanged FAMILY_TOLERANCES; every
    sweep-identity check bit-identical (cube and checkpoint bytes); the
    coverage complete; B.1's response, fold and accumulating launches each
    > 0; every spec with ECORR detected, each minimal spec's families
    ("ecorr",), each written, replayed, and agreeing without the defect;
    both CLI calls exit 0; card against CPU within FAMILY_TOLERANCES (B.1's
    cw family within 3e-3, TOL[float32]), with B.1's response and
    accumulating launches > 0."""
    from pta_replicator_tpu_torch.scenarios import fuzz as fz

    n_cover = fuzz_cover_n()
    torch.cuda.synchronize()
    launches.clear()
    report = fz.fuzz(n_cover, root_seed=0, sweep_every=FUZZ_SWEEP_EVERY, device="cuda")
    torch.cuda.synchronize()
    counts = dict(launches)

    planted_dir = workdir / "planted"
    planted = fz.fuzz(FUZZ_PLANTED["n"], root_seed=FUZZ_PLANTED["root_seed"],
                      out_dir=str(planted_dir), perturb=FUZZ_PLANTED["perturb"],
                      device="cuda")
    with_ecorr = [i for i in range(FUZZ_PLANTED["n"])
                  if sample_spec(FUZZ_PLANTED["root_seed"], i).ecorr is not None]
    replays = {f["index"]: fz.replay(f["replay_file"], device="cuda").agree
               for f in planted["failures"] if "replay_file" in f}

    cli = {}
    replay_file = planted["failures"][0]["replay_file"] if planted["failures"] else None
    with ThreadPoolExecutor(max_workers=2) as pool:  # two independent interpreters
        fast_call = pool.submit(_module_cli, "scenario", "fuzz", "--fast", "--out-dir",
                                str(workdir / "cli_failures"))
        replay_call = (pool.submit(_module_cli, "scenario", "replay", replay_file)
                       if replay_file else None)
        cli["fuzz_fast"] = fast_call.result()
        cli["replay"] = (replay_call.result() if replay_call is not None
                         else (None, "", "no minimal spec to replay", 0.0))
    fast = json.loads(cli["fuzz_fast"][1]) if cli["fuzz_fast"][0] == 0 else {}
    torch.cuda.synchronize()
    launches.clear()
    card_vs_cpu = _fuzz_card_vs_cpu(fz, min(FUZZ_CARD_VS_CPU, n_cover))
    torch.cuda.synchronize()
    card_vs_cpu_launches = dict(launches)

    over = {fam: rel for fam, rel in report["max_rel_by_family"].items()
            if rel > fz.FAMILY_TOLERANCES[fam]}
    over_cpu = {fam: rel for fam, rel in card_vs_cpu.items()
                if rel > fz.FAMILY_TOLERANCES[fam]}
    missing = sorted(set(REQUIRED_COVERAGE) - set(report["coverage"]))
    row = dict(
        n_cover=n_cover, cap=FUZZ_CAP, scenarios_per_s=report["scenarios_per_s"],
        elapsed_s=report["elapsed_s"], agreement_rate=report["agreement_rate"],
        max_rel_by_family=report["max_rel_by_family"], tolerances=report["tolerances"],
        families_over_tolerance=over, coverage=report["coverage"],
        coverage_missing=missing, combo_histogram_size=report["combo_histogram_size"],
        sweep_identity=report["sweep_identity"], launches=counts,
        failures=report["failures"],
        planted=dict(n_scenarios=planted["n_scenarios"], with_ecorr=with_ecorr,
                     detected=[f["index"] for f in planted["failures"]],
                     minimal_families=[f["minimal_families"] for f in planted["failures"]],
                     minimal_spec_hashes=[f["minimal_spec_hash"] for f in planted["failures"]],
                     shrink_steps=[f["shrink_steps"] for f in planted["failures"]],
                     replayed_agree=replays, elapsed_s=planted["elapsed_s"]),
        cli={name: dict(exit=c[0], seconds=c[3], stderr_tail=c[2].strip()[-300:])
             for name, c in cli.items()},
        cli_fast=dict(n_scenarios=fast.get("n_scenarios"),
                      agreement_rate=fast.get("agreement_rate"),
                      scenarios_per_s=fast.get("scenarios_per_s")),
        card_vs_cpu_first=min(FUZZ_CARD_VS_CPU, n_cover), card_vs_cpu=card_vs_cpu,
        card_vs_cpu_over=over_cpu, card_vs_cpu_launches=card_vs_cpu_launches,
    )
    emit("fuzz", **row)
    require(n_cover < FUZZ_CAP, f"fuzz: no n below {FUZZ_CAP} covers every token")
    require(report["agreement_rate"] == 1.0 and not report["failures"],
            f"fuzz: disagreements on the card: {report['failures']}")
    require(not over, f"fuzz: families over their tolerance on the card: {over}")
    require(report["sweep_identity"]["checked"] > 0
            and report["sweep_identity"]["all_bit_identical"] is True,
            f"fuzz: sweep identity: {report['sweep_identity']}")
    require(not missing, f"fuzz: coverage misses {missing}")
    require(all(counts.get(k, 0) > 0 for k in
                ("cw_catalog_response", "cw_fold_planes", "cw_catalog_accumulate")),
            f"fuzz: B.1 not launched on every route: {counts}")
    require(with_ecorr and [f["index"] for f in planted["failures"]] == with_ecorr,
            f"fuzz planted: detected {row['planted']['detected']}, ECORR in {with_ecorr}")
    require(all(f["minimal_families"] == ["ecorr"] for f in planted["failures"]),
            f"fuzz planted: minimal families {row['planted']['minimal_families']}")
    require(len(replays) == len(planted["failures"]) and all(replays.values()),
            f"fuzz planted: replays {replays}")
    require(cli["fuzz_fast"][0] == 0 and fast.get("agreement_rate") == 1.0,
            f"scenario fuzz --fast: {row['cli']['fuzz_fast']}")
    require(cli["replay"][0] == 0, f"scenario replay: {row['cli']['replay']}")
    require("cw" in card_vs_cpu and not over_cpu,
            f"fuzz card vs CPU: over {over_cpu} of {card_vs_cpu}")
    require(all(card_vs_cpu_launches.get(k, 0) > 0 for k in
                ("cw_catalog_response", "cw_catalog_accumulate")),
            f"fuzz card vs CPU: B.1 not launched on both routes: {card_vs_cpu_launches}")
    return counts


def _likelihood_by_cli(workdir, name, dataset, extra=()):
    """``python -m pta_replicator_tpu_torch likelihood`` in a fresh
    interpreter on the card, over LIKELIHOOD_CLI_GRID with the MAP field
    LIKELIHOOD_CLI_MAP (on bank row 0): (its JSON result, host seconds)."""
    out = workdir / f"{name}.json"
    args = ["likelihood", *dataset]
    for axis in LIKELIHOOD_CLI_GRID:
        args += ["--grid", axis]
    args += ["--map", LIKELIHOOD_CLI_MAP, *extra, "--out", str(out)]
    code, _, stderr, seconds = _module_cli(*args, timeout=900)
    require(code == 0, f"likelihood CLI ({name}) exit {code}: {stderr[-3000:]}")
    return json.loads(out.read_text()), seconds


def _likelihood_in_process(result, bank, batch, recipe):
    """The CLI's grid against ``bank_loglikelihood`` in process on the same
    bank: (the largest deviation of the means relative to the largest
    mean, over the points finite in both; whether the same points are
    NaN, float32's S losing definiteness at some (``likelihood_float32``);
    the in-process best index, by ``np.argmax`` as the CLI takes it;
    seconds)."""
    from pta_replicator_tpu_torch.__main__ import _axis_specs

    grid, _ = lk.grid_cartesian(_axis_specs(LIKELIHOOD_CLI_GRID, "grid"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = lk.bank_loglikelihood(bank, batch, recipe, grid=grid, device=batch.device)
    mean = ll.cpu().numpy().mean(axis=1)
    seconds = time.perf_counter() - t0
    got = np.array(result["grid"]["loglikelihood_mean"])
    finite = np.isfinite(got) & np.isfinite(mean)
    rel = (float(np.abs(got - mean)[finite].max() / np.abs(mean[finite]).max())
           if finite.any() else float("nan"))
    same_nan = bool(np.array_equal(np.isnan(got), np.isnan(mean)))
    return rel, same_nan, int(np.argmax(mean)), seconds


def _require_cli_grid(name, result, rel, same_nan, best):
    """The gates both arms share: the CLI's grid = the in-process one, its
    MAP converged and finite."""
    require(rel <= TOL_LIKELIHOOD_CLI and same_nan and result["grid"]["best"]["index"] == best,
            f"likelihood CLI ({name}) grid vs in process: {rel}, NaN at the same points "
            f"{same_nan}, best {result['grid']['best']['index']} vs {best}")
    require(result["map"]["converged"] and np.all(np.isfinite(result["map"]["x"]))
            and np.all(np.isfinite(result["map"]["sigma"])),
            f"likelihood CLI ({name}) MAP: {result['map']}")


def phase_likelihood_cli(workdir):
    """``python -m pta_replicator_tpu_torch likelihood`` in fresh
    interpreters on the card, priced unfused and without a design (the JAX
    CLI's route) in torch's default float32, each grid against
    ``bank_loglikelihood`` in process on the same bank. (1) The bank the
    dataset path's CLI ``realize --full-fit --checkpoint`` wrote (400
    realizations at the full 68-pulsar width, in chunks of 200) with its
    par/tim and recipe: two 8-point GWB axes, a MAP fit of the GWB
    amplitude on row 0, and 32 served requests from 4 clients; in process
    the same ingest, freeze and recipe (the set-up, timed). Its MAP is no
    truth check: the model leaves out what the bank holds (the removed
    mean, the refit, the CW catalog, the GWB's power below 1/T). (2) The
    truth arm: a bank its noise model describes (see
    LIKELIHOOD_TRUTH_NREAL), drawn on the card and saved as .npy, through
    ``--synthetic 68x7758``: the same grid and MAP field, and the MAP of
    row 0 again on the CPU (float64 inside map_fit, as on the card; the
    CPU tests hold it to the JAX CLI's).
    Gates: exit 0; grid means within 1e-12 relative of the in-process
    call's where finite, NaN at the same points (float32's S can lose
    definiteness), the same best point; the MAP converged and finite; (1)
    every request answered, with no failures; (2) the MAP inside the
    grid's amplitude span and within TOL_LIKELIHOOD_TRUTH_SIGMAS Fisher
    sigmas of the injected log10 A, the grid's best finite amplitude off
    the span's edges, and the card's MAP x and sigma within
    TOL_MAP_CARD_VS_CPU of the CPU's in as many iterations."""
    from pta_replicator_tpu_torch.__main__ import _build_recipe
    from pta_replicator_tpu_torch.batch import freeze
    from pta_replicator_tpu_torch.simulate import load_from_directories, make_ideal

    recipe_path = workdir / "recipe.json"
    result, seconds = _likelihood_by_cli(
        workdir, "likelihood",
        ["--bank", str(workdir / "cli_ck.npz"), "--recipe", str(recipe_path),
         "--pardir", str(workdir / "par"), "--timdir", str(workdir / "tim")],
        ["--serve", str(LIKELIHOOD_CLI_SERVE)])
    t0 = time.perf_counter()
    psrs = load_from_directories(str(workdir / "par"), str(workdir / "tim"))
    for p in psrs:
        make_ideal(p)
    batch = freeze(psrs, dtype=torch.get_default_dtype(), device="cuda")
    recipe = _build_recipe(json.loads(recipe_path.read_text()), psrs).to("cuda")
    bank = lk.RealizationBank.from_checkpoint(str(workdir / "cli_ck.npz"))
    setup_s = time.perf_counter() - t0
    rel, same_nan, best, grid_s = _likelihood_in_process(result, bank, batch, recipe)
    serve = result["serve"]
    row = dict(
        bank_shape=[bank.nreal, *bank.shape[1:]], dtype=str(batch.dtype),
        grid_shape=result["grid"]["shape"], cli_s=seconds, in_process_setup_s=setup_s,
        in_process_grid_s=grid_s, grid_rel_vs_in_process=rel, tol=TOL_LIKELIHOOD_CLI,
        grid_nan_at_same_points=same_nan,
        grid_finite_share=float(np.isfinite(result["grid"]["loglikelihood_mean"]).mean()),
        best=result["grid"]["best"], best_in_process=best, map=result["map"],
        serve={k: serve[k] for k in ("requests", "batches", "coalesce_efficiency",
                                     "evals_per_s", "requests_per_s", "rejected",
                                     "deadline_expired", "latency")},
        serve_p50_ms=serve["latency"].get("p50", float("nan")) * 1e3,
        serve_p99_ms=serve["latency"].get("p99", float("nan")) * 1e3,
        serve_failures=serve.get("failures", []),
    )
    emit("likelihood_cli", **row)
    _require_cli_grid("dataset", result, rel, same_nan, best)
    require(serve["requests"] == LIKELIHOOD_CLI_SERVE and not row["serve_failures"],
            f"likelihood CLI serve: {row['serve']}, failures {row['serve_failures']}")
    del batch, recipe, bank
    _likelihood_cli_truth(workdir)


def _likelihood_cli_truth(workdir):
    """phase_likelihood_cli's truth arm (2), its row ``likelihood_cli_truth``;
    beside it, ungated, the MAP of row 0 through realize()'s tail (the
    weighted mean removed) and of a row drawn on the default 600-point
    synthesis grid, each priced as the CLI prices (ROADMAP C.11)."""
    from pta_replicator_tpu_torch.__main__ import _axis_specs, _build_recipe
    from pta_replicator_tpu_torch.batch import synthetic_batch
    from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe

    npsr, ntoa = FLAGSHIP["npsr"], FLAGSHIP["ntoa"]
    spec = {k: v for k, v in ng15_like_recipe(npsr).items() if not k.startswith("cgw_")}
    spec.update(orf="none", gwb_howml=1.0)
    coarse = _build_recipe(spec, None).to("cuda")  # the default synthesis grid
    spec["gwb_npts"] = LIKELIHOOD_TRUTH_NPTS
    truth_path, bank_path = workdir / "truth_recipe.json", workdir / "truth_bank.npy"
    truth_path.write_text(json.dumps(spec))
    batch = synthetic_batch(npsr=npsr, ntoa=ntoa, seed=0, dtype=torch.get_default_dtype())
    recipe = _build_recipe(json.loads(truth_path.read_text()), None).to("cuda")
    draw = lambda r, n: B.draw_noise(
        torch.Generator(device="cuda").manual_seed(LIKELIHOOD_TRUTH_SEED), batch, r, n)
    delays = B.realization_delays(batch, recipe, draw(recipe, LIKELIHOOD_TRUTH_NREAL))
    np.save(bank_path, delays.cpu().numpy())
    # C.11's two parts on row 0, reported: realize()'s tail (the weighted
    # mean removed), and the default synthesis grid
    start = _axis_specs([LIKELIHOOD_CLI_MAP], "map")
    c11 = {"residualized": lk.map_fit(B.finalize_residuals(delays[:1], batch, recipe, False)[0],
                                      batch, recipe, start),
           "default_grid": lk.map_fit(B.realization_delays(batch, coarse, draw(coarse, 1))[0],
                                      batch, coarse, start)}
    del delays, coarse
    result, seconds = _likelihood_by_cli(
        workdir, "likelihood_truth",
        ["--bank", str(bank_path), "--recipe", str(truth_path), "--synthetic", f"{npsr}x{ntoa}"])
    bank = lk.RealizationBank.from_array(np.load(bank_path))
    rel, same_nan, best, grid_s = _likelihood_in_process(result, bank, batch, recipe)
    t0 = time.perf_counter()
    ref = lk.map_fit(bank.row(0), batch.to("cpu"), recipe.to("cpu"), start, device="cpu")
    cpu_map_s = time.perf_counter() - t0
    amplitude = _axis_specs(LIKELIHOOD_CLI_GRID, "grid")["gwb_log10_amplitude"]
    lo, hi = float(amplitude.min()), float(amplitude.max())
    x, sigma = result["map"]["x"][0], result["map"]["sigma"][0]
    injected = spec["gwb_log10_amplitude"]
    means = np.array(result["grid"]["loglikelihood_mean"])
    grid, _ = lk.grid_cartesian(_axis_specs(LIKELIHOOD_CLI_GRID, "grid"))
    finite_best = int(np.nanargmax(means))
    best_amplitude = float(grid["gwb_log10_amplitude"][finite_best])
    row = dict(
        bank_shape=[bank.nreal, *bank.shape[1:]], dtype=str(batch.dtype), cli_s=seconds,
        in_process_grid_s=grid_s, grid_rel_vs_in_process=rel, tol=TOL_LIKELIHOOD_CLI,
        grid_nan_at_same_points=same_nan, grid_finite_share=float(np.isfinite(means).mean()),
        best=result["grid"]["best"], best_in_process=best,
        best_finite={"index": finite_best, **{k: float(v[finite_best]) for k, v in grid.items()}},
        map=result["map"],
        injected_log10_amplitude=injected, map_minus_injected_dex=x - injected,
        map_minus_injected_sigmas=(x - injected) / sigma,
        tol_sigmas=TOL_LIKELIHOOD_TRUTH_SIGMAS, grid_amplitude_span=[lo, hi],
        cpu_map=ref.as_dict(), cpu_map_s=cpu_map_s,
        map_rel_x_vs_cpu=abs(x - ref.x[0]) / abs(ref.x[0]),
        map_rel_sigma_vs_cpu=abs(sigma - ref.sigma[0]) / abs(ref.sigma[0]),
        tol_map_vs_cpu=TOL_MAP_CARD_VS_CPU,
        c11={k: dict(map=m.as_dict(), minus_injected_dex=float(m.x[0]) - injected,
                     minus_injected_sigmas=(float(m.x[0]) - injected) / float(m.sigma[0]))
             for k, m in c11.items()},
    )
    emit("likelihood_cli_truth", **row)
    _require_cli_grid("truth", result, rel, same_nan, best)
    require(result["map"]["iterations"] == ref.iterations and ref.converged
            and max(row["map_rel_x_vs_cpu"], row["map_rel_sigma_vs_cpu"]) <= TOL_MAP_CARD_VS_CPU,
            f"likelihood CLI truth: the card's MAP against the CPU's: {row}")
    require(lo < x < hi and abs(x - injected) <= TOL_LIKELIHOOD_TRUTH_SIGMAS * sigma,
            f"likelihood CLI truth: MAP {x} +- {sigma} against the injected {injected}: {row}")
    require(lo < best_amplitude < hi,
            f"likelihood CLI truth: the grid's best finite amplitude {best_amplitude} on its edge")
    del batch, recipe, bank
    torch.cuda.empty_cache()


def _within(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|): <= 1 passes
    numpy's ``assert_allclose``."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _oracle_gls_recipe(batch, run):
    """tests/test_batched.py:959-975's recipe on the card (per-backend EFAC,
    EQUAD and ECORR; red and chromatic noise; the GWB auto-term): ``nested``
    as is (the nested Woodbury), ``banded`` without ECORR with a banded
    noise_cov (B.4/B.5), ``dense`` with ECORR and a dense noise_cov (the
    dense rung: the blocked Cholesky on B.2)."""
    nb = len(batch.backend_names)
    rng = np.random.default_rng(5)
    r = B.Recipe(
        efac=rng.uniform(0.9, 1.4, (batch.npsr, nb)),
        log10_equad=rng.uniform(-6.8, -6.2, (batch.npsr, nb)),
        log10_ecorr=rng.uniform(-6.9, -6.4, (batch.npsr, nb)),
        rn_log10_amplitude=rng.uniform(-13.8, -13.2, batch.npsr),
        rn_gamma=rng.uniform(3.0, 4.5, batch.npsr),
        chrom_log10_amplitude=rng.uniform(-13.9, -13.4, batch.npsr),
        chrom_gamma=rng.uniform(2.5, 4.0, batch.npsr), chrom_index=2.0,
        gwb_log10_amplitude=-14.2, gwb_gamma=13.0 / 3.0,
    ).to(batch.device)
    f64 = torch.float64
    if run == "banded":
        op = banded_from_times(batch.toas_s, batch.mask, **BANDED, dtype=f64, device=batch.device)
        return dataclasses.replace(r, log10_ecorr=None, noise_cov=op, cov_log10_sigma=torch.tensor(
            BANDED_LOG10_SIGMA, dtype=f64, device=batch.device))
    if run == "dense":
        from pta_replicator_tpu_torch.covariance import dense_from_times

        op = dense_from_times(batch.toas_s, batch.mask, corr_s=ORACLE_DENSE_CORR_S, dtype=f64,
                              device=batch.device)
        return dataclasses.replace(r, noise_cov=op, cov_log10_sigma=torch.tensor(
            ORACLE_DENSE_LOG10_SIGMA, dtype=f64, device=batch.device))
    return r


def phase_oracle_path(workdir, smi):
    """The per-pulsar oracle path on the dataset path's 68 pulsars, and its
    joins to the card's batched engine (the twins of tests/test_batched.py:
    267-293, 439-483, 930-1008). (1) Host float64 numpy through the entry
    points: ``load_from_directories``, ``make_ideal``, the regression recipe
    (``add_gwb`` -14 / 4.33 seed 123456; ``add_measurement_noise`` EFAC 1
    and ``add_jitter`` ECORR 3e-7; ``add_red_noise`` -15 / 4.2, 30 modes,
    libstempo convention; ``add_cgw``), then ``add_chromatic_noise``, the
    100-source ``add_catalog_of_cws``, ``add_burst``, ``add_gw_memory`` and
    ``add_noise_transient``; host seconds per operator. Gate: each
    pulsar's ledger decomposes its TOA shifts and, through the timing
    model, its residuals to <= 5e-9 s (the first-order form, the ledger's
    sum less its weighted mean, is reported: it misses by the timing
    model's Doppler factor). (2) The pulsars as they stand before the
    deterministic block frozen to the card in float64 and float32, the
    launch counts cleared, the same catalog through ``cgw_catalog_delays``
    (B.1), the counts read: float64 against each oracle ledger entry at
    rtol 1e-8, atol 1e-15; float32's relative RMS reported. (3)
    ``gw_memory_delays``, ``burst_delays`` and ``transient_delays`` against
    the oracle (rtol 1e-9; 1e-5 of the RMS). (4) The GLS refit of the
    full timing design on the shortest and the 7,758-TOA pulsar, three
    recipes (nested Woodbury; banded noise_cov on B.4/B.5; dense noise_cov
    with ECORR on the dense rung and B.2), each with the counts cleared
    before and read after: ``gls_fit_subtract`` and
    ``gls_fit_uncertainties`` without the engine's ridge (the oracle's
    linear system) against ``covariance_from_recipe`` (reading the recipe
    on the card) + ``gls_fit`` at relative RMS < 1e-6 and sigmas rtol
    1e-6, padding columns exactly 0; with the default ridge, reported and
    held to 10 ridge / lambda_min (ROADMAP C.10). Then
    ``SimulatedPulsar.fit("gls", recipe=...)`` and ``fit("wls")`` on both,
    ``write_partim`` and a reload: the par carries the fitted values and
    errors."""
    import pta_replicator_tpu_torch as ptr
    from pta_replicator_tpu_torch.batch import freeze
    from pta_replicator_tpu_torch.simulate import Residuals, load_from_directories, load_pulsar
    from pta_replicator_tpu_torch.simulate import make_ideal
    from pta_replicator_tpu_torch.timing.components import full_design_matrix
    from pta_replicator_tpu_torch.timing.fit import covariance_from_recipe, design_tensor, gls_fit
    from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe

    t_phase = time.perf_counter()
    host = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        host[name] = host.get(name, 0.0) + time.perf_counter() - t0
        return out

    # (1) the oracle, host float64
    psrs = timed("load", load_from_directories, str(workdir / "par"), str(workdir / "tim"))
    for p in psrs:
        timed("make_ideal", make_ideal, p)
    ideal = [p.toas.mjd.copy() for p in psrs]
    timed("add_gwb", ptr.add_gwb, psrs, -14, 4.33, seed=123456)
    for ii, p in enumerate(psrs):
        timed("add_measurement_noise", ptr.add_measurement_noise, p, efac=1.00, log10_equad=None,
              seed=54321 + ii, tnequad=False)
        timed("add_jitter", ptr.add_jitter, p, log10_ecorr=np.log10(3e-7), seed=54321 + ii)
    for ii, p in enumerate(psrs):
        timed("add_red_noise", ptr.add_red_noise, p, -15, 4.2, components=30, Tspan=None,
              seed=12345 + ii, libstempo_convention=True)
    for p in psrs:
        timed("add_cgw", ptr.add_cgw, p, gwtheta=np.pi / 2, gwphi=2.5, mc=1e9, dist=5.0,
              fgw=1e-8, phase0=0.5, psi=1.5, inc=np.pi / 4, pdist=1.0, pphase=None,
              psrTerm=True, evolve=True, phase_approx=False, tref=ORACLE_TREF_S)
    for ii, p in enumerate(psrs):
        timed("add_chromatic_noise", ptr.add_chromatic_noise, p, **{
            **ORACLE_CHROMATIC, "seed": ORACLE_CHROMATIC["seed"] + ii})

    # (2)-(3) the card's batch, frozen before the deterministic block (the
    # block then moves each TOA by <= ~1e-6 s, which the atol floors cover)
    batch64 = freeze(psrs, dtype=torch.float64)
    batch32 = freeze(psrs, dtype=torch.float32)
    cat = np.asarray(ng15_like_recipe(len(psrs))["cgw_params"], np.float64)
    lists = dict(zip(("gwtheta_list", "gwphi_list", "mc_list", "dist_list", "fgw_list",
                      "phase0_list", "psi_list", "inc_list"), cat))
    for p in psrs:
        timed("add_catalog_of_cws", ptr.add_catalog_of_cws, p, **lists, tref=ORACLE_TREF_S)
    tref_s = float(batch64.tref_mjd) * DAY_S
    t0 = float(batch64.toas_s[batch64.mask > 0].mean())
    width = ORACLE_BURST_WIDTH_S
    hp = lambda t: 4e-9 * np.exp(-0.5 * ((t - t0) / width) ** 2)
    hc = lambda t: 2e-9 * np.sin((t - t0) / width) * np.exp(-0.5 * ((t - t0) / width) ** 2)
    lo, hi = t0 - 8 * width, t0 + 8 * width
    grid = np.linspace(lo, hi, ORACLE_BURST_GRID)
    t0_mjd = float(np.median(psrs[0].toas.get_mjds()))
    for p in psrs:
        timed("add_burst", ptr.add_burst, p, 0.9, 4.1, hp, hc, psi=0.6, tref=tref_s)
        timed("add_gw_memory", ptr.add_gw_memory, p, t0_mjd=t0_mjd, **ORACLE_MEMORY)
    timed("add_noise_transient", ptr.add_noise_transient, psrs[ORACLE_TRANSIENT_PSR], hp,
          tref=tref_s)

    ledger = {"toa_shift_max_s": 0.0, "through_model_max_s": 0.0, "first_order_max_s": 0.0,
              "first_order_over_delay_max": 0.0}
    for p, mjd0 in zip(psrs, ideal):
        total = np.sum(list(p.added_signals_time.values()), axis=0)
        shift = np.asarray((p.toas.mjd - mjd0) * np.longdouble(DAY_S), np.float64)
        base = dataclasses.replace(p.toas, mjd=mjd0.copy())
        base.adjust_seconds(total)
        model = np.abs(Residuals(base, p.model).resids_value - p.residuals.resids_value).max()
        w = 1.0 / p.toas.errors_s**2
        first = np.abs(p.residuals.resids_value - (total - np.sum(w * total) / np.sum(w))).max()
        for key, v in (("toa_shift_max_s", np.abs(shift - total).max()),
                       ("through_model_max_s", model), ("first_order_max_s", first),
                       ("first_order_over_delay_max", first / np.abs(total).max())):
            ledger[key] = max(ledger[key], float(v))

    def oracle_rows(name):
        return [p.added_signals_time[f"{p.name}_{name}"] for p in psrs]

    def vs_oracle(dev, name, rtol, atol_of):
        dev = dev.double().cpu().numpy()
        out = 0.0
        for i, want in enumerate(oracle_rows(name)):
            n = len(want)
            out = max(out, _within(dev[i, :n], want, rtol, atol_of(want)))
            require(np.all(dev[i, n:] == 0.0), f"oracle_path {name}: padding row {i} not 0")
        return out

    torch.cuda.synchronize()
    launches.clear()
    cw64 = B.cgw_catalog_delays(batch64, *cat, tref_s=ORACLE_TREF_S)
    cw32 = B.cgw_catalog_delays(batch32, *cat, tref_s=ORACLE_TREF_S)
    torch.cuda.synchronize()
    cw_counts = {k: launches[k] for k in ("cw_catalog_response", "cw_fold_planes")}
    rtol, atol = TOL_ORACLE_CW
    cw_within = vs_oracle(cw64, "cw_catalog", rtol, lambda w: atol)
    mask = batch64.mask.cpu().numpy() > 0
    want = np.zeros(mask.shape)
    for i, row_ in enumerate(oracle_rows("cw_catalog")):
        want[i, :len(row_)] = row_
    f32_rel = float(np.sqrt(np.mean((cw32.double().cpu().numpy()[mask] - want[mask]) ** 2)
                            / np.mean(want[mask] ** 2)))
    # B.1's time on this batch: the entry point (host planes, fold and
    # response), and the response kernel alone on prebuilt planes
    b1_ms = {}
    for b in (batch64, batch32):
        u = b.toas_s - torch.tensor(b.start_s, dtype=b.dtype, device=b.device)
        src, psr_planes = _catalog_planes(b, cat, True, ORACLE_TREF_S)
        b1_ms[str(b.dtype)] = {
            "cgw_catalog_delays": cuda_ms(lambda: B.cgw_catalog_delays(
                b, *cat, tref_s=ORACLE_TREF_S), 5),
            "response_kernel": cuda_ms(lambda: cw.cw_catalog_response(
                u, src, psr_planes, True, True), 20)}
        del u, src, psr_planes
    rtol_m, atol_m = TOL_ORACLE_MEMORY
    memory = vs_oracle(B.gw_memory_delays(batch64, ORACLE_MEMORY["strain"],
                                          ORACLE_MEMORY["gwtheta"], ORACLE_MEMORY["gwphi"],
                                          ORACLE_MEMORY["bwm_pol"], t0_mjd),
                       "gw_memory", rtol_m, lambda w: atol_m)
    rms_atol = lambda w: TOL_ORACLE_BURST * max(float(np.sqrt(np.mean(w**2))), 1e-30)
    burst = vs_oracle(B.burst_delays(batch64, 0.9, 4.1, hp(grid), hc(grid), lo, hi, psi=0.6),
                      "burst", 0.0, rms_atol)
    devt = B.transient_delays(batch64, ORACLE_TRANSIENT_PSR, hp(grid), lo, hi).cpu().numpy()
    tp = psrs[ORACLE_TRANSIENT_PSR]
    want_t = tp.added_signals_time[f"{tp.name}_noise_transient"]
    transient = _within(devt[ORACLE_TRANSIENT_PSR, :len(want_t)], want_t, 0.0, rms_atol(want_t))
    transient_others_zero = bool(np.all(np.delete(devt, ORACLE_TRANSIENT_PSR, axis=0) == 0.0))
    del cw64, cw32, batch32

    # (4) the GLS refit of the full design against the dense oracle
    ntoas = [p.toas.ntoas for p in psrs]
    pick = [int(np.argmin(ntoas)), int(np.argmax(ntoas))]
    two = [psrs[i] for i in pick]
    batch = freeze(two, dtype=torch.float64)
    design_np = design_tensor(two, ntoa_max=batch.ntoa_max)[0]
    design = torch.from_numpy(design_np).to(batch.device)
    rng = np.random.default_rng(5)
    delays_np = rng.standard_normal(tuple(batch.toas_s.shape)) * 1e-6 * batch.mask.cpu().numpy()
    delays = torch.from_numpy(delays_np).to(batch.device)
    designs = [full_design_matrix(p.par, p.toas.get_mjds(), freqs_mhz=p.toas.freqs_mhz,
                                  f0=p.model.f0, flags=p.toas.flags)[0] for p in two]
    gls, gls_counts, recipes = {}, {}, {}
    for run in ("nested", "banded", "dense"):
        rec = recipes[run] = _oracle_gls_recipe(batch, run)
        torch.cuda.synchronize()
        launches.clear()
        (post, sig), card_ms = _timed_ms(lambda: (
            B.gls_fit_subtract(delays, batch, design, rec, ridge=0.0),
            B.gls_fit_uncertainties(batch, design, rec, ridge=0.0)), reps=1)
        gls_counts[run] = {k: launches[k] for k in COV_KERNELS}
        post_d = B.gls_fit_subtract(delays, batch, design, rec).cpu().numpy()
        sig_d = B.gls_fit_uncertainties(batch, design, rec).cpu().numpy()
        lam = torch.linalg.eigvalsh(B._gls_design_system(batch, design, rec, 0.0)[0]).cpu().numpy()
        post, sig = post.cpu().numpy(), sig.cpu().numpy()
        row = {"card_ms": card_ms, "oracle_s": [], "post_rel_rms": [], "sigma_rel_max": [],
               "padding_zero": [], "default_ridge_post_rel_rms": [],
               "default_ridge_sigma_rel_max": [], "lambda_min": lam.min(axis=-1).tolist()}
        for i, p in enumerate(two):
            n = p.toas.ntoas
            t1 = time.perf_counter()
            C = covariance_from_recipe(p, rec, psr_index=i, backend_names=batch.backend_names)
            _, ref_post, ref_cov = gls_fit(delays_np[i][:n], C, designs[i], return_cov=True)
            row["oracle_s"].append(time.perf_counter() - t1)
            del C
            ref_sig = np.sqrt(np.clip(np.diag(ref_cov), 0.0, None))
            k = len(ref_sig)
            den = np.sqrt(np.mean(ref_post**2))
            row["post_rel_rms"].append(float(np.sqrt(np.mean((post[i][:n] - ref_post) ** 2)) / den))
            row["sigma_rel_max"].append(float(np.max(np.abs(sig[i][:k] / ref_sig - 1.0))))
            row["padding_zero"].append(bool(np.all(sig[i][k:] == 0.0)))
            row["default_ridge_post_rel_rms"].append(
                float(np.sqrt(np.mean((post_d[i][:n] - ref_post) ** 2)) / den))
            row["default_ridge_sigma_rel_max"].append(
                float(np.max(np.abs(sig_d[i][:k] / ref_sig - 1.0))))
        gls[run] = row
        del post, sig, post_d, sig_d
        torch.cuda.empty_cache()

    # SimulatedPulsar.fit, GLS from the dense recipe read on the card, then
    # WLS; each written and reloaded
    fits, written = {}, {}
    for fitter in ("gls", "wls"):
        fits[fitter] = []
        for i, p in enumerate(two):
            t1 = time.perf_counter()
            if fitter == "gls":
                p.fit("gls", recipe=recipes["dense"], psr_index=i,
                      backend_names=batch.backend_names)
            else:
                p.fit("wls")
            fits[fitter].append(time.perf_counter() - t1)
            par, tim = str(workdir / f"fit_{fitter}_{p.name}.par"), str(workdir / "fit.tim")
            p.write_partim(par, tim)
            back = load_pulsar(par, tim)
            f0 = back.par.params["F0"]
            written[f"{fitter}_{p.name}"] = bool(
                back.par.lines == p.par.lines and back.par.f0 == p.model.f0
                and float(f0[2]) == p.fit_uncertainties["F0"]
                and len(p.fit_results) == designs[i].shape[1])
    del recipes, batch, batch64, design, delays
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase

    row = dict(
        nvidia_smi=smi, npsr=len(psrs), ntoas_min_max=[min(ntoas), max(ntoas)],
        host_s=host, ledger=ledger, tol_ledger_s=TOL_LEDGER_S,
        cw=dict(launches=cw_counts, sources=int(cat.shape[1]), f64_within=cw_within,
                tol=list(TOL_ORACLE_CW), f32_rel_rms_vs_oracle=f32_rel, ms=b1_ms),
        memory_within=memory, burst_within=burst, transient_within=transient,
        transient_others_zero=transient_others_zero,
        gls_psrs=[p.name for p in two], gls_ntoas=[p.toas.ntoas for p in two],
        gls_columns=[int(m.shape[1]) for m in designs], gls=gls, gls_launches=gls_counts,
        tol_gls=TOL_ORACLE_GLS, ridge=B._RIDGE, fit_s=fits, written_par_carries_fit=written,
        phase_s=phase_s,
    )
    emit("oracle_path", **row)
    require(max(ledger["toa_shift_max_s"], ledger["through_model_max_s"]) <= TOL_LEDGER_S,
            f"oracle_path: the ledger does not decompose the residuals: {ledger}")
    require(min(cw_counts.values()) > 0, f"oracle_path never launched B.1: {cw_counts}")
    require(cw_within <= 1.0, f"oracle_path: B.1 f64 vs the oracle catalog: {cw_within}")
    require(f32_rel <= TOL[torch.float32], f"oracle_path: B.1 f32 vs the oracle: {f32_rel}")
    require(memory <= 1.0 and burst <= 1.0 and transient <= 1.0 and transient_others_zero,
            f"oracle_path memory / burst / transient: {memory} / {burst} / {transient}")
    for run, r in gls.items():
        require(max(r["post_rel_rms"]) < TOL_ORACLE_GLS and max(r["sigma_rel_max"]) < TOL_ORACLE_GLS
                and all(r["padding_zero"]), f"oracle_path GLS {run}: {r}")
        bias = [10 * B._RIDGE / lam for lam in r["lambda_min"]]
        require(all(x <= b for x, b in zip(r["default_ridge_post_rel_rms"], bias))
                and all(x <= b for x, b in zip(r["default_ridge_sigma_rel_max"], bias)),
                f"oracle_path GLS {run}: the default ridge moves more than its bias: {r}")
    require(all(gls_counts["banded"][k] > 0 for k in COV_KERNELS if k != "cov_syrk_update"),
            f"oracle_path: the banded GLS refit missed B.4/B.5: {gls_counts['banded']}")
    require(gls_counts["dense"]["cov_syrk_update"] > 0,
            f"oracle_path: the dense GLS refit missed B.2: {gls_counts['dense']}")
    require(all(written.values()), f"oracle_path: a written par lacks the fit: {written}")
    return cw_counts, gls_counts


NO_LIBRARY = "none: no single PyTorch call computes it"
#: the instruction account is the CW kernel's (kernels/cw_study.py); the
#: other kernels have none
NO_ISSUE_ACCOUNT = {"issue_ms": "not measured", "instructions_per_element": "not measured"}


def _width_row(row):
    """A kernel row's numbers at one more launch shape, for the kernels line."""
    return {k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}


def _cov_kernel_entry(name, source, replaces, launches_, row, fuzz_launches):
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches_, "fuzz_launches": fuzz_launches,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             **NO_ISSUE_ACCOUNT}
    if row["library_ms"] is None:
        entry["library"] = NO_LIBRARY
    return entry


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = phase_device()
    sass, clock = phase_build()
    population = flagship_workload(**POPULATION)
    cw_rows = phase_kernels(FLAGSHIP, population[1].cgw_params.cpu().numpy(), sass, clock)
    kernel_row = cw_rows["torch.float32", "flagship", True, True]
    batch, recipe, static, generator, (count, fold_count), res = phase_main_path(FLAGSHIP)
    phase_cw_population(*population, sass, clock)
    accumulate_count, accumulate_row = phase_cw_stream(population)
    del population
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_scenario_"))
    try:
        scenario_count, scenario_row, compiled = phase_scenario_population(workdir)
        phase_scenario_cli(workdir, compiled)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del compiled
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_fuzz_"))
    try:
        fuzz_counts = phase_fuzz(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_dataset_"))
    try:
        dataset_count, dataset_row = phase_dataset_path(workdir, smi)
        telemetry_count = phase_telemetry(workdir, smi)
        chaos_b1, chaos_accumulate, chaos_fold = phase_chaos(workdir, batch, recipe, smi)
        numerics_counts = phase_numerics_observatory(workdir, batch, recipe, smi)
        live_row, live_arms, live_counts = phase_live_run(workdir, batch, recipe, smi)
        # the live-run and time-attribution CLI arms run beside the likelihood
        # CLI's phase
        attribution_cli = _AttributionCli(workdir)
        try:
            try:
                phase_likelihood_cli(workdir)
            except BaseException:
                live_arms.kill()
                raise
            phase_live_run_cli(live_row, live_arms)
            attribution_cli.finish()
        finally:
            attribution_cli.kill()
        oracle_cw_counts, oracle_gls_counts = phase_oracle_path(workdir, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_breakdown(batch, recipe, static, generator)
    phase_card_vs_cpu(SMALL)
    phase_full_fit(batch, recipe, static, generator)
    families_count = phase_deterministic_families(batch, recipe, generator)
    batch64, recipe64 = flagship_workload(**FLAGSHIP, dtype=torch.float64)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    try:
        phase_sweep(batch, recipe, batch64, recipe64, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        mesh_b1, mesh_gls = phase_mesh_sweep(batch, recipe, batch64, recipe64, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    design = B.quadratic_design(batch64)
    woodbury_row = phase_woodbury_kernel(batch64, recipe64, design, "flagship")
    bf16_rows = phase_woodbury_bf16(batch64, recipe64, design, "flagship",
                                    (torch.float64, torch.float32))
    chrom64 = chromatic_recipe(batch64, recipe64)
    phase_woodbury_kernel(batch64, chrom64, design, "flagship + chromatic")
    phase_likelihood_chromatic(batch64, chrom64, torch.Generator(device=batch64.device).manual_seed(2))
    del chrom64
    bank = res.double()
    del res
    woodbury_count, ll = phase_likelihood(bank, batch64, recipe64, design)
    phase_likelihood_float32(bank, batch, recipe, ll)
    bf16_count = phase_likelihood_bf16(bank, batch64, recipe64, design, ll)
    phase_likelihood_server(bank, batch64, recipe64, design, ll)
    chaos_server_b3 = phase_chaos_server(bank, batch64, recipe64, design)
    live_server_b3 = phase_live_run_server(bank, batch64, recipe64, design)
    phase_likelihood_card_vs_cpu(SMALL)
    del bank
    torch.cuda.empty_cache()
    phase_tuner_woodbury(batch64, recipe64, design)
    attribution_counts = phase_time_attribution(batch, recipe, batch64, recipe64, design, smi)
    phase_map_fit(batch64, recipe64, torch.Generator(device=batch64.device).manual_seed(6))
    phase_map_fit_card_vs_cpu(SMALL)
    torch.cuda.empty_cache()
    gls_bank_count, gls_bank_row, gls_bank_bf16_row = phase_full_fit_likelihood(
        batch64, recipe64, torch.Generator(device=batch64.device).manual_seed(5))
    del batch64, recipe64, design
    cov_rows = phase_cov_kernels()
    tridiag_counts = phase_covariance_banded(batch, recipe, static, generator)
    _card_vs_cpu("covariance_banded_card_vs_cpu",
                 lambda b, r: _config_b(b, r, torch.float64), SMALL_BANK)
    fit_tridiag_counts = phase_full_fit_banded(batch, recipe, static, generator)
    syrk_count = phase_covariance_dense()
    _card_vs_cpu("covariance_dense_card_vs_cpu", _config_d, SMALL_BANK)
    fit_syrk_count = phase_full_fit_dense()
    torch.cuda.empty_cache()
    adjoint_rows = phase_cov_adjoint_kernels()
    map_cov_counts = phase_map_fit_covariance(torch.Generator(device="cuda").manual_seed(23))
    phase_map_fit_covariance_card_vs_cpu()
    phase_covariance_round_trip(torch.Generator(device="cuda").manual_seed(11))
    f64 = torch.float64
    print(json.dumps({"kernels": [{
        "name": "cw_catalog_response", "route": "cuda",
        "source": "pta_replicator_tpu_torch/csrc/cw_catalog.cu",
        "replaces": "pta_replicator_tpu/ops/pallas_cw.py:526",
        "launches": count, "max_abs_err": kernel_row["max_abs_err"],
        "ms": kernel_row["ms"], "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"], "bound_by": kernel_row["bound_by"],
        "library_ms": None, "library": NO_LIBRARY, "kernel_ms": kernel_row["kernel_ms"],
        "fold_launches": fold_count, "fold_ms": kernel_row["fold_ms"],
        "accumulate_launches": accumulate_count,
        "accumulate_max_abs_err": accumulate_row["max_abs_err"],
        "accumulate_ms": accumulate_row["ms"], "accumulate_plain_ms": accumulate_row["plain_ms"],
        "issue_ms": kernel_row["issue_ms"],
        "instructions_per_element": kernel_row["instructions_per_element"],
        "families_launches": families_count,
        "scenario_launches": scenario_count,
        "scenario_catalog": _width_row({**scenario_row, "library_ms": None}),
        "dataset_launches": dataset_count,
        "telemetry_launches": telemetry_count,
        "chaos_launches": chaos_b1, "chaos_accumulate_launches": chaos_accumulate,
        "chaos_fold_launches": chaos_fold,
        "numerics_launches": numerics_counts.get("cw_catalog_response", 0),
        "live_run_launches": live_counts.get("cw_catalog_response", 0),
        "live_run_fold_launches": live_counts.get("cw_fold_planes", 0),
        "time_attribution_launches": attribution_counts.get("cw_catalog_response", 0),
        "time_attribution_fold_launches": attribution_counts.get("cw_fold_planes", 0),
        "dataset_catalog": _width_row({**dataset_row, "library_ms": None}),
        "oracle_launches": oracle_cw_counts["cw_catalog_response"],
        "oracle_fold_launches": oracle_cw_counts["cw_fold_planes"],
        "fuzz_launches": fuzz_counts.get("cw_catalog_response", 0),
        "fuzz_fold_launches": fuzz_counts.get("cw_fold_planes", 0),
        "fuzz_accumulate_launches": fuzz_counts.get("cw_catalog_accumulate", 0),
        "mesh_sweep_launches": mesh_b1,
    }, {
        "name": "fused_woodbury_update", "route": "cuda",
        "source": "pta_replicator_tpu_torch/csrc/fused_woodbury.cu",
        "replaces": "pta_replicator_tpu/ops/pallas_gp.py:160",
        "launches": woodbury_count, "max_abs_err": woodbury_row["max_abs_err"],
        "ms": woodbury_row["ms"], "plain_ms": woodbury_row["plain_ms"],
        "bound_ms": woodbury_row["bound_ms"], "bound_by": woodbury_row["bound_by"],
        "library_ms": woodbury_row["library_ms"], **NO_ISSUE_ACCOUNT,
        "gls_bank_launches": gls_bank_count, "gls_bank_q286": _width_row(gls_bank_row),
        "fuzz_launches": fuzz_counts.get("fused_woodbury_update", 0),
        "chaos_server_launches": chaos_server_b3,
        "live_run_server_launches": live_server_b3,
        "time_attribution_tuner_launches": attribution_counts.get("fused_woodbury_update", 0),
    }, {
        "name": "fused_woodbury_update_bf16", "route": "cuda",
        "source": "pta_replicator_tpu_torch/csrc/fused_woodbury.cu",
        "replaces": 'pta_replicator_tpu/ops/pallas_gp.py:160 (precision="bf16")',
        "launches": bf16_count, "max_abs_err": bf16_rows[f64]["max_abs_err"],
        "ms": bf16_rows[f64]["ms"], "plain_ms": bf16_rows[f64]["plain_ms"],
        "bound_ms": bf16_rows[f64]["bound_ms"], "bound_by": bf16_rows[f64]["bound_by"],
        "library_ms": bf16_rows[f64]["library_ms"],
        "library": "torch.bmm of the bf16 operands, float32 output",
        "library_convert_ms": bf16_rows[f64]["library_convert_ms"],
        "plan": bf16_rows[f64]["plan"],
        **NO_ISSUE_ACCOUNT,
        "float32_inputs": {**_width_row(bf16_rows[torch.float32]),
                           "library_convert_ms": bf16_rows[torch.float32]["library_convert_ms"]},
        "gls_bank_q286": {**_width_row(gls_bank_bf16_row),
                          "library_convert_ms": gls_bank_bf16_row["library_convert_ms"],
                          "plan": gls_bank_bf16_row["plan"]},
        "fuzz_launches": fuzz_counts.get("fused_woodbury_update_bf16", 0),
    },
        {**_cov_kernel_entry("cov_syrk_update", "pta_replicator_tpu_torch/csrc/cov_syrk.cu",
                             "pta_replicator_tpu/ops/pallas_cw.py:484", syrk_count,
                             cov_rows["cov_syrk_update", f64],
                             fuzz_counts.get("cov_syrk_update", 0)),
         "gls_fit_launches": fit_syrk_count,
         "oracle_gls_launches": oracle_gls_counts["dense"]["cov_syrk_update"],
         "numerics_launches": numerics_counts.get("cov_syrk_update", 0)},
        {**_cov_kernel_entry("tridiag_factor_solve_fwd", "pta_replicator_tpu_torch/csrc/block_tridiag.cu",
                             "pta_replicator_tpu/ops/pallas_gp.py:428",
                             tridiag_counts["tridiag_factor_solve_fwd"], cov_rows["factor", f64],
                             fuzz_counts.get("tridiag_factor_solve_fwd", 0)),
         "gls_fit_launches": fit_tridiag_counts["tridiag_factor_solve_fwd"],
         "oracle_gls_launches": oracle_gls_counts["banded"]["tridiag_factor_solve_fwd"],
         "mesh_gls_launches": mesh_gls["tridiag_factor_solve_fwd"],
         "numerics_launches": numerics_counts.get("tridiag_factor_solve_fwd", 0)},
        {**_cov_kernel_entry("tridiag_solve_fwd", "pta_replicator_tpu_torch/csrc/block_tridiag.cu",
                             "pta_replicator_tpu/ops/pallas_gp.py:428",
                             tridiag_counts["tridiag_solve_fwd"], cov_rows["solve", f64],
                             fuzz_counts.get("tridiag_solve_fwd", 0)),
         "gls_fit_launches": fit_tridiag_counts["tridiag_solve_fwd"],
         "oracle_gls_launches": oracle_gls_counts["banded"]["tridiag_solve_fwd"],
         "mesh_gls_launches": mesh_gls["tridiag_solve_fwd"],
         "fit_widths": {str(q): _width_row(cov_rows["solve", f64, q]) for q in FIT_WIDTHS}},
        {**_cov_kernel_entry("tridiag_factor_solve_bwd", "pta_replicator_tpu_torch/csrc/block_tridiag.cu",
                             "pta_replicator_tpu/ops/pallas_gp.py:458",
                             tridiag_counts["tridiag_factor_solve_bwd"], cov_rows["backward", f64],
                             fuzz_counts.get("tridiag_factor_solve_bwd", 0)),
         "gls_fit_launches": fit_tridiag_counts["tridiag_factor_solve_bwd"],
         "oracle_gls_launches": oracle_gls_counts["banded"]["tridiag_factor_solve_bwd"],
         "mesh_gls_launches": mesh_gls["tridiag_factor_solve_bwd"],
         "fit_widths": {str(q): _width_row(cov_rows["backward", f64, q]) for q in FIT_WIDTHS}},
        *({**_cov_kernel_entry(name, "pta_replicator_tpu_torch/csrc/block_tridiag.cu",
                               "none: the backward of pta_replicator_tpu/ops/pallas_gp.py:428's "
                               "factor sweep, which XLA differentiates there",
                               map_cov_counts.get(name, 0), adjoint_rows[name], 0)}
          for name in ADJOINT_KERNELS),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
