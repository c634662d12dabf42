"""Registry of the telemetry names the port emits.

Counterpart of ``pta_replicator_tpu/obs/names.py``, copied as data: every
span, counter, gauge, histogram and event name is declared here once, with
the same string as the JAX package's, so either package's ``report`` reads
either package's capture. Producers import the constant
(``gauge(names.SWEEP_CHUNKS_DONE)``) or use the literal string.

The ``jax.*`` names stay registered (the report groups them), but the port
emits none of them. The span/event record schema is a separate contract
(:data:`.trace.EVENT_SCHEMA`).
"""
from __future__ import annotations

# --------------------------------------------------------------- spans
# ingest / freeze / oracle path
SPAN_FREEZE = "freeze"
SPAN_MAKE_IDEAL = "make_ideal"
SPAN_LOAD_PULSARS = "load_pulsars"
SPAN_ORACLE_FIT = "oracle_fit"
SPAN_READ_PAR = "read_par"
SPAN_READ_TIM = "read_tim"
SPAN_DESIGN_TENSOR = "design_tensor"
SPAN_COVARIANCE_FROM_RECIPE = "covariance_from_recipe"

# mesh / device path
SPAN_MAKE_MESH = "make_mesh"
SPAN_SHARD_BATCH = "shard_batch"
SPAN_STATIC_DELAYS = "static_delays"
SPAN_SHARDED_REALIZE = "sharded_realize"
SPAN_SHARDMAP_REALIZE = "shardmap_realize"

# sweep / pipeline executor
SPAN_SWEEP_CHUNK = "sweep_chunk"
SPAN_READBACK_FENCE = "readback_fence"
SPAN_SWEEP_PIPELINE = "sweep_pipeline"
SPAN_DISPATCH = "dispatch"
SPAN_DRAIN = "drain"
SPAN_IO_WRITE = "io_write"
#: phase span wrapping a whole mesh-sharded sweep (utils/sweep.py): the
#: static precompute, the pipelined chunk loop, and consolidation — the
#: occupancy window for multi-chip bottleneck attribution
SPAN_MULTICHIP_SWEEP = "multichip_sweep"
#: per-chunk CW static-delays stream build in the FUSED sweep graph
#: (utils/sweep.py fused_stream=True): chunk i+1's tile-build/H2D
#: stages run under this span concurrently with chunk i's compute,
#: readback, and checkpoint write — rendered as the ``stage:
#: static_build`` track in chrome-trace exports (docs/streaming.md)
SPAN_STATIC_BUILD = "static_build"
#: one shard writer of the parallel sharded-archive writer (utils/
#: sweep.py write_shard_archive): the pwrite + overlapped fdatasync of
#: a single ``shard{k}`` member, labeled ``shard=``, nested inside the
#: chunk's ``io_write`` span (occupancy.NESTED_STAGES keeps it out of
#: the serial counterfactual — it is io_write's internal breakdown)
SPAN_SHARD_WRITE = "shard_write"

# streamed CW-catalog plane pipeline (parallel/prefetch.py,
# models/batched.py cw_stream_response)
SPAN_CW_STREAM_STAGE = "cw_stream_stage"
SPAN_CW_STREAM_RESPONSE = "cw_stream_response"

# likelihood engine + serving path (likelihood/)
#: one coalesced device evaluation of a request batch (likelihood/serve.py)
SPAN_LIKELIHOOD_BATCH = "likelihood_batch"
#: server lifetime phase span (start()..stop()) — the SLO window
SPAN_LIKELIHOOD_SERVE = "likelihood_serve"
#: one-time bank projection pass through the ReducedGP precompute
SPAN_LIKELIHOOD_PROJECT = "likelihood_project"
# request-trace hops (PR 14, docs/tracing.md): each request's causal
# trace stitches submit -> queue-wait -> (likelihood_batch via links=)
# -> future resolution; the submit span is live on the client thread,
# the other two are synthesized from timestamps (Tracer.record_span)
SPAN_LIKELIHOOD_SUBMIT = "likelihood_submit"
SPAN_LIKELIHOOD_QUEUE_WAIT = "likelihood_queue_wait"
SPAN_LIKELIHOOD_RESOLVE = "likelihood_resolve"
#: one roofline-driven tile-size search of the fused-kernel autotuner
#: (likelihood/tuner.py autotune) — cache misses only; cache hits are
#: span-free by design (CI and laptops never pay the search)
SPAN_GP_TUNE = "gp_tune"

# scenario compiler + differential fuzz harness (scenarios/)
#: one spec -> (batch, recipe, plan) compile (scenarios/compile.py)
SPAN_SCENARIO_COMPILE = "scenario_compile"
#: one fuzz case: compile + batched-vs-oracle differential
#: (scenarios/fuzz.py run_scenario)
SPAN_SCENARIO_FUZZ_CASE = "scenario_fuzz_case"

# structured-covariance subsystem (covariance/)
#: one eager structured solve through a CovOp (covariance/kernels.py
#: solve_eager — the bench ladder / oracle-harness entry)
SPAN_COV_SOLVE = "cov_solve"
#: one eager correlated-noise draw through a CovOp (covariance/
#: kernels.py sample_eager — the fuzz harness's batched-side entry)
SPAN_COV_SAMPLE = "cov_sample"

# CLI runner (the top-level span is the subcommand name). Emitted
# dynamically — __main__ runs `with obs.span(args.cmd)` — so these
# constants register the names without ever being referenced.
SPAN_CLI_REALIZE = "realize"
SPAN_CLI_INFO = "info"
SPAN_CLI_LIKELIHOOD = "likelihood"
SPAN_CLI_SCENARIO = "scenario"
SPAN_INGEST = "ingest"
SPAN_BUILD_RECIPE = "build_recipe"
SPAN_COMPUTE = "compute"
SPAN_WRITE_OUTPUT = "write_output"

# bench.py harness
SPAN_BENCH_INGEST_B1855 = "ingest_b1855"
SPAN_BENCH_AOT_COMPILE = "aot_compile"
SPAN_BENCH_WARMUP = "warmup"
SPAN_BENCH_MEASURE = "measure"
SPAN_BENCH_SWEEP_AB = "sweep_ab"

# managed jax.profiler device-trace capture (obs/devprof.py)
SPAN_DEVICE_TRACE = "device_trace"

#: one post-hoc critical-path attribution pass over a finished capture
#: (obs/critpath.py analyze_capture) — offline-only by construction:
#: the span exists so the analyzer's own cost is measured, proving the
#: attribution layer adds zero hot-path time
SPAN_CRITPATH_ANALYZE = "critpath_analyze"

#: one shadow-oracle drift sample (obs/numerics.py on_drain): a
#: 1-in-N-chunks replay of one realization's PRNG streams through the
#: fuzzer's f64 oracle paths — the span makes the sampler's cost
#: visible in the capture (it rides the drain, off the device's
#: critical path, but it is NOT free)
SPAN_NUMERICS_DRIFT = "numerics_drift_sample"

SPANS = frozenset({
    SPAN_FREEZE, SPAN_MAKE_IDEAL, SPAN_LOAD_PULSARS, SPAN_ORACLE_FIT,
    SPAN_READ_PAR, SPAN_READ_TIM, SPAN_DESIGN_TENSOR,
    SPAN_COVARIANCE_FROM_RECIPE,
    SPAN_MAKE_MESH, SPAN_SHARD_BATCH, SPAN_STATIC_DELAYS,
    SPAN_SHARDED_REALIZE, SPAN_SHARDMAP_REALIZE,
    SPAN_SWEEP_CHUNK, SPAN_READBACK_FENCE, SPAN_SWEEP_PIPELINE,
    SPAN_DISPATCH, SPAN_DRAIN, SPAN_IO_WRITE, SPAN_MULTICHIP_SWEEP,
    SPAN_STATIC_BUILD, SPAN_SHARD_WRITE,
    SPAN_CW_STREAM_STAGE, SPAN_CW_STREAM_RESPONSE,
    SPAN_LIKELIHOOD_BATCH, SPAN_LIKELIHOOD_SERVE, SPAN_LIKELIHOOD_PROJECT,
    SPAN_LIKELIHOOD_SUBMIT, SPAN_LIKELIHOOD_QUEUE_WAIT,
    SPAN_LIKELIHOOD_RESOLVE, SPAN_GP_TUNE,
    SPAN_SCENARIO_COMPILE, SPAN_SCENARIO_FUZZ_CASE,
    SPAN_COV_SOLVE, SPAN_COV_SAMPLE,
    SPAN_CLI_REALIZE, SPAN_CLI_INFO, SPAN_CLI_LIKELIHOOD,
    SPAN_CLI_SCENARIO,
    SPAN_INGEST, SPAN_BUILD_RECIPE,
    SPAN_COMPUTE, SPAN_WRITE_OUTPUT,
    SPAN_BENCH_INGEST_B1855, SPAN_BENCH_AOT_COMPILE, SPAN_BENCH_WARMUP,
    SPAN_BENCH_MEASURE, SPAN_BENCH_SWEEP_AB,
    SPAN_DEVICE_TRACE,
    SPAN_CRITPATH_ANALYZE,
    SPAN_NUMERICS_DRIFT,
})

# -------------------------------------------------------------- events
EVENT_FLIGHTREC_STALL = "flightrec.stall"
#: a managed jax.profiler trace finished and registered its directory
#: as a capture artifact (obs/devprof.py)
EVENT_DEVICE_TRACE = "devprof.device_trace"
#: a scheduled fault fired at an injection site (faults/inject.py) —
#: the ring-buffer breadcrumb that makes a chaos run's faults visible
#: in `watch`/postmortem
EVENT_FAULT_FIRED = "faults.fired"
#: a supervised-recovery retry happened (faults/retry.py retry_call,
#: or the sweep's chunk-retry loop) — a retrying run emits these where
#: a wedged one goes silent
EVENT_FAULT_RETRY = "faults.retry"

#: an SLO objective's fast-window burn rate crossed its breach
#: threshold (obs/slo.py) — once per breach episode, re-armed on
#: recovery, mirrored into /readyz's verdict
EVENT_SLO_BREACH = "slo.breach"
#: a submit was refused by admission control / a queued request's
#: deadline passed (likelihood/serve.py). Each carries the request's
#: trace_id, so the caller holding the stamped exception can grep the
#: capture for exactly their request. (The identically-named METRICS
#: below are the aggregate counters; these are the per-request
#: flight-recorder breadcrumbs.)
EVENT_LIKELIHOOD_REJECTED = "likelihood.rejected"
EVENT_LIKELIHOOD_DEADLINE_EXPIRED = "likelihood.deadline_expired"

#: a probe site opened a non-finite episode (obs/numerics.py): the
#: first NaN/Inf seen at a clean site — once per episode, re-armed
#: after EPISODE_CLEAR_AFTER clean calls, mirrored into /readyz
EVENT_NUMERICS_EPISODE = "numerics.nonfinite_episode"

EVENTS = frozenset({
    EVENT_FLIGHTREC_STALL, EVENT_DEVICE_TRACE,
    EVENT_FAULT_FIRED, EVENT_FAULT_RETRY,
    EVENT_SLO_BREACH,
    EVENT_LIKELIHOOD_REJECTED, EVENT_LIKELIHOOD_DEADLINE_EXPIRED,
    EVENT_NUMERICS_EPISODE,
})

# ------------------------------------------------------------- metrics
# io / ingest counters
IO_TIM_FILES = "io.tim.files"
IO_TIM_TOAS = "io.tim.toas"
IO_PAR_FILES = "io.par.files"
BATCH_FREEZES = "batch.freezes"
BATCH_TOAS_FROZEN = "batch.toas_frozen"
SIMULATE_LEDGER_DISAMBIGUATED = "simulate.ledger_disambiguated"
SIMULATE_PULSARS_LOADED = "simulate.pulsars_loaded"

# mesh / sweep / pipeline
MESH_DEVICES = "mesh.devices"
SWEEP_CHUNKS_TOTAL = "sweep.chunks_total"
SWEEP_CHUNKS_DONE = "sweep.chunks_done"
SWEEP_REALIZATIONS = "sweep.realizations"
SWEEP_INFLIGHT_CHUNKS = "sweep.inflight_chunks"
SWEEP_LAST_DISPATCHED_CHUNK = "sweep.last_dispatched_chunk"
#: per-shard device_get copies currently in flight during a mesh-sweep
#: chunk readback (parallel/mesh.py fetch_shard_blocks): nonzero while
#: the overlapped D2H drains, 0 between chunks
SWEEP_SHARDS_INFLIGHT = "sweep.shards_inflight"
#: shard writers of the parallel sharded-archive writer currently
#: inside their pwrite/fdatasync (utils/sweep.py write_shard_archive
#: via parallel.stages.fan_out): >1 while per-shard disk writes
#: genuinely overlap, 0 between chunk archives
SWEEP_SHARD_WRITERS_BUSY = "sweep.shard_writers_busy"
#: per-shard fdatasync calls issued by the parallel archive writer
#: under ``durable=True`` — each one is a flush of one shard member
#: riding the writer pool's overlap window instead of the final
#: pre-rename fsync (which then finds the data already on disk)
SWEEP_SHARD_FSYNCS = "sweep.shard_fsyncs"
PIPELINE_DRAIN_TIMEOUTS = "pipeline.drain_timeouts"
#: transient chunk failures absorbed by the sweep's supervised-recovery
#: loop (utils/sweep.py): each bump is one resume-from-sidecar retry of
#: a failed chunk, bounded by the sweep's chunk_retries budget
SWEEP_CHUNK_RETRIES = "sweep.chunk_retries"

# streamed CW-catalog plane pipeline: tiles consumed by the device
# accumulator, bytes staged host->device by the prefetcher, and the
# cumulative seconds the consumer starved waiting on a tile
CW_STREAM_TILES_DONE = "cw_stream.tiles_done"
CW_STREAM_BYTES_STAGED = "cw_stream.bytes_staged"
CW_STREAM_PREFETCH_STALL_S = "cw_stream.prefetch_stall_s"
#: transient staging failures retried once in place by the prefetch
#: workers (parallel/prefetch.py) before escalating to the caller
CW_STREAM_STAGE_RETRIES = "cw_stream.stage_retries"

# likelihood serving path (likelihood/serve.py): requests accepted,
# coalesced device batches run, the last batch's fill (requests per
# batch), cumulative theta x realization likelihood evaluations, the
# rolling coalescing efficiency (served requests / batch-slot
# capacity), and the live request-queue depth
LIKELIHOOD_REQUESTS = "likelihood.requests"
LIKELIHOOD_BATCHES = "likelihood.batches"
LIKELIHOOD_BATCH_SIZE = "likelihood.batch_size"
LIKELIHOOD_EVALS = "likelihood.evals"
LIKELIHOOD_COALESCE_EFFICIENCY = "likelihood.coalesce_efficiency"
LIKELIHOOD_QUEUE_DEPTH = "likelihood.queue_depth"
#: server SLO counters (PR 11 hardening): requests refused by the
#: bounded-queue admission control, and futures failed with
#: DeadlineExpired instead of being served past their deadline
LIKELIHOOD_REJECTED = "likelihood.rejected"
LIKELIHOOD_DEADLINE_EXPIRED = "likelihood.deadline_expired"

#: fault-injection layer (faults/inject.py): scheduled faults fired,
#: labeled site=/kind= — zero in any run that didn't arm a schedule
FAULTS_INJECTED = "faults.injected"

# stage-graph executor (parallel/stages.py): items queued per graph
# edge (labeled edge="a->b"), cumulative per-stage busy seconds
# (labeled stage=, device= for replica stages), and operations that
# tripped the graph deadline. Every graph — the ported sweep pipeline,
# both prefetchers, and the fused sweep — reports through these; the
# ported declarations additionally keep their historical names
# (sweep.inflight_chunks, pipeline.drain_timeouts, occupancy.busy_s,
# cw_stream.prefetch_stall_s) via the graph's config hooks.
STAGES_EDGE_INFLIGHT = "stages.edge_inflight"
STAGES_BUSY_S = "stages.busy_s"
STAGES_DRAIN_TIMEOUTS = "stages.drain_timeouts"

# structured-covariance layer (covariance/kernels.py eager helpers):
# eager CovOp solves priced, and the running fraction of them that
# took a structured (banded/Kronecker/blocked) path instead of the
# dense reference — the ladder's adoption gauge
COV_SOLVES = "cov.solves"
COV_BLOCKED_FRACTION = "cov.blocked_fraction"

# scenario layer (scenarios/): specs compiled, fuzz cases run,
# batched-vs-oracle disagreements found (0 in a healthy tree), and
# shrinker candidate evaluations spent minimizing failures
SCENARIO_COMPILED = "scenario.compiled"
SCENARIO_FUZZ_CASES = "scenario.fuzz_cases"
SCENARIO_FUZZ_DISAGREEMENTS = "scenario.fuzz_disagreements"
SCENARIO_SHRINK_STEPS = "scenario.shrink_steps"

# fused-kernel tile autotuner (likelihood/tuner.py): roofline searches
# actually run (cache misses — labeled backend=/bucket=), and lookups
# served from the fingerprint-keyed cache file without any search
TUNER_SEARCHES = "tuner.searches"
TUNER_CACHE_HITS = "tuner.cache_hits"

# SLO engine (obs/slo.py): per-objective gauges over the rolling
# windows — the remaining fraction of the error budget (1.0 = untouched,
# < 0 = blown), the fast/slow-window burn rates (1.0 = consuming budget
# exactly at the sustainable rate), and the cumulative breach-episode
# counter. All labeled objective=<name>.
SLO_ERROR_BUDGET_REMAINING = "slo.error_budget_remaining"
SLO_BURN_RATE_FAST = "slo.burn_rate_fast"
SLO_BURN_RATE_SLOW = "slo.burn_rate_slow"
SLO_BREACHES = "slo.breaches"

#: request traces submitted but not yet resolved/expired (obs/trace.py
#: open-request registry; the postmortem flushes the survivors)
TRACE_OPEN_REQUESTS = "trace.open_requests"

# flight recorder
FLIGHTREC_STALLS = "flightrec.stalls"

# telemetry self-accounting (obs/series.py + obs/flightrec.py): the
# cumulative seconds the flight recorder's sampler tick spent on
# telemetry work (heartbeat + series sampling + live artifact writes) —
# the series that proves the temporal layer stays <1% of wall — and the
# sampled process resident set size (host-RSS creep over a long run)
OBS_OVERHEAD_S = "obs.overhead_s"
PROC_RSS_BYTES = "proc.rss_bytes"

# stage occupancy (obs/occupancy.py): live per-stage duty cycle over the
# flight recorder's rolling window, and the cumulative busy seconds a
# staged executor's worker spent inside its stage
OCCUPANCY_DUTY_CYCLE = "occupancy.duty_cycle"
OCCUPANCY_BUSY_S = "occupancy.busy_s"

# critical-path attribution (obs/critpath.py): chunks the analyzer
# attributed on the last pass, and how many mesh devices it flagged as
# stragglers (busy time above the straggler threshold vs the median) —
# gauges stamped by the offline analyze pass, never by a hot path
CRITPATH_CHUNKS = "critpath.chunks"
CRITPATH_STRAGGLERS = "critpath.stragglers"

# cross-round performance ledger (obs/ledger.py): bench-artifact rounds
# ingested into PERF_LEDGER.json, and gated metrics flagged by the
# windowed monotone-regression gate on the last `perf gate` pass
LEDGER_ROUNDS = "ledger.rounds"
LEDGER_REGRESSIONS = "ledger.regressions"

# numerics observatory (obs/numerics.py): non-finite elements seen by
# any probe (the SLO-able corruption counter — unlabeled total plus a
# site= labeled instance per probe site), the per-site overflow margin
# in bits (distance of the |max| watermark to the dtype's finfo.max —
# the bf16-ladder headroom gauge), the per-site |max| watermark, and
# the per-family relative drift vs the f64 shadow oracle (labeled
# family=, sampled 1-in-N chunks)
NUMERICS_NONFINITE = "numerics.nonfinite"
NUMERICS_HEADROOM_BITS = "numerics.headroom_bits"
NUMERICS_MAX_ABS = "numerics.max_abs"
NUMERICS_DRIFT = "numerics.drift"

# jax accounting (obs/jaxhooks.py)
JAX_COMPILES = "jax.compiles"
JAX_COMPILE_S = "jax.compile_s"
JAX_TRACES = "jax.traces"
JAX_TRACE_S = "jax.trace_s"
JAX_LOWERING_S = "jax.lowering_s"
JAX_TRACE_COUNT = "jax.trace_count"

METRICS = frozenset({
    IO_TIM_FILES, IO_TIM_TOAS, IO_PAR_FILES,
    BATCH_FREEZES, BATCH_TOAS_FROZEN,
    SIMULATE_LEDGER_DISAMBIGUATED, SIMULATE_PULSARS_LOADED,
    MESH_DEVICES,
    SWEEP_CHUNKS_TOTAL, SWEEP_CHUNKS_DONE, SWEEP_REALIZATIONS,
    SWEEP_INFLIGHT_CHUNKS, SWEEP_LAST_DISPATCHED_CHUNK,
    SWEEP_SHARDS_INFLIGHT, SWEEP_CHUNK_RETRIES,
    SWEEP_SHARD_WRITERS_BUSY, SWEEP_SHARD_FSYNCS,
    PIPELINE_DRAIN_TIMEOUTS,
    CW_STREAM_TILES_DONE, CW_STREAM_BYTES_STAGED,
    CW_STREAM_PREFETCH_STALL_S, CW_STREAM_STAGE_RETRIES,
    LIKELIHOOD_REQUESTS, LIKELIHOOD_BATCHES, LIKELIHOOD_BATCH_SIZE,
    LIKELIHOOD_EVALS, LIKELIHOOD_COALESCE_EFFICIENCY,
    LIKELIHOOD_QUEUE_DEPTH, LIKELIHOOD_REJECTED,
    LIKELIHOOD_DEADLINE_EXPIRED,
    FAULTS_INJECTED,
    STAGES_EDGE_INFLIGHT, STAGES_BUSY_S, STAGES_DRAIN_TIMEOUTS,
    COV_SOLVES, COV_BLOCKED_FRACTION,
    TUNER_SEARCHES, TUNER_CACHE_HITS,
    SCENARIO_COMPILED, SCENARIO_FUZZ_CASES,
    SCENARIO_FUZZ_DISAGREEMENTS, SCENARIO_SHRINK_STEPS,
    SLO_ERROR_BUDGET_REMAINING, SLO_BURN_RATE_FAST, SLO_BURN_RATE_SLOW,
    SLO_BREACHES,
    TRACE_OPEN_REQUESTS,
    FLIGHTREC_STALLS,
    OBS_OVERHEAD_S, PROC_RSS_BYTES,
    OCCUPANCY_DUTY_CYCLE, OCCUPANCY_BUSY_S,
    CRITPATH_CHUNKS, CRITPATH_STRAGGLERS,
    LEDGER_ROUNDS, LEDGER_REGRESSIONS,
    NUMERICS_NONFINITE, NUMERICS_HEADROOM_BITS, NUMERICS_MAX_ABS,
    NUMERICS_DRIFT,
    JAX_COMPILES, JAX_COMPILE_S, JAX_TRACES, JAX_TRACE_S, JAX_LOWERING_S,
    JAX_TRACE_COUNT,
})

#: metric families whose full names are built at runtime (device label,
#: transfer direction, cost-analysis key) — a literal starting with one
#: of these prefixes is registered even though the exact name isn't
#: enumerable statically
JAX_MEMORY_PREFIX = "jax.memory."
JAX_TRANSFER_PREFIX = "jax.transfer."
#: XLA Compiled.cost_analysis()/memory_analysis() gauges, labeled by
#: jit label (obs/devprof.py) — sub-names come from XLA's own key set
JAX_COST_PREFIX = "jax.cost."
#: roofline gauges derived from jax.cost.* + measured elapsed time
#: (achieved FLOP/s, bytes/s, arithmetic intensity, % of roofline)
JAX_ROOFLINE_PREFIX = "jax.roofline."
METRIC_PREFIXES = (
    JAX_MEMORY_PREFIX, JAX_TRANSFER_PREFIX, JAX_COST_PREFIX,
    JAX_ROOFLINE_PREFIX,
)

#: dotted-name groups the report renderer and postmortem filter key on
JAX_PREFIX = "jax."
SWEEP_PREFIX = "sweep."
FLIGHTREC_PREFIX = "flightrec."
PIPELINE_PREFIX = "pipeline."
CW_STREAM_PREFIX = "cw_stream."
STAGES_PREFIX = "stages."
LIKELIHOOD_PREFIX = "likelihood."
FAULTS_PREFIX = "faults."
COV_PREFIX = "cov."
TUNER_PREFIX = "tuner."
SCENARIO_PREFIX = "scenario."
SLO_PREFIX = "slo."
TRACE_PREFIX = "trace."
OCCUPANCY_PREFIX = "occupancy."
CRITPATH_PREFIX = "critpath."
LEDGER_PREFIX = "ledger."
NUMERICS_PREFIX = "numerics."
OBS_PREFIX = "obs."
PROC_PREFIX = "proc."

# ----------------------------------------------- instrumented_jit labels
JIT_REALIZE_ENGINE = "batched.realize_engine"
JIT_MESH_CONSTRAINT_ENGINE = "mesh.constraint_engine"
JIT_MESH_SHARDMAP_ENGINE = "mesh.shardmap_engine"
JIT_MESH_SHARDMAP_PSR_ENGINE = "mesh.shardmap_psr_engine"
#: direct rank-reduced GP likelihood (full noise-model rebuild per
#: hyperparameter point) and the ReducedGP fast path (fixed-noise
#: precompute; the serving engine) — likelihood/infer.py
JIT_LIKELIHOOD_ENGINE = "likelihood.gp_engine"
JIT_LIKELIHOOD_REDUCED_ENGINE = "likelihood.reduced_engine"
#: blocked-Cholesky dense factor+solve engine (covariance/kernels.py
#: dense_solve) — labelled so devprof cost/roofline accounting applies
JIT_COV_CHOLESKY = "cov.blocked_cholesky"
#: fused Woodbury-assembly grid engine (likelihood/infer.py over
#: ops/pallas_gp.py) — the rung-1 fused likelihood hot path, labelled
#: so devprof roofline attribution covers the fused kernels
JIT_GP_FUSED_WOODBURY = "gp.fused_woodbury"
#: MXU-tiled block-tridiagonal factor/solve engine (covariance/
#: kernels.py block_tridiag_factor_solve backend routing)
JIT_COV_TRIDIAG_MXU = "cov.tridiag_mxu"

JIT_LABELS = frozenset({
    JIT_REALIZE_ENGINE, JIT_MESH_CONSTRAINT_ENGINE,
    JIT_MESH_SHARDMAP_ENGINE, JIT_MESH_SHARDMAP_PSR_ENGINE,
    JIT_LIKELIHOOD_ENGINE, JIT_LIKELIHOOD_REDUCED_ENGINE,
    JIT_COV_CHOLESKY, JIT_GP_FUSED_WOODBURY, JIT_COV_TRIDIAG_MXU,
})

#: every registered name, for membership checks that don't care about kind
ALL_NAMES = SPANS | EVENTS | METRICS | JIT_LABELS


def is_registered(name: str, kind: str = None) -> bool:
    """True when ``name`` is a registered telemetry name.

    ``kind`` narrows the check: "span", "event", "metric", or "jit";
    None accepts any kind. Metric names additionally match the dynamic
    :data:`METRIC_PREFIXES` families.
    """
    table = {
        "span": SPANS, "event": EVENTS, "metric": METRICS,
        "jit": JIT_LABELS, None: ALL_NAMES,
    }[kind]
    if name in table:
        return True
    if kind in ("metric", None):
        return name.startswith(METRIC_PREFIXES)
    return False
