"""Profiling facade over the port's tracer (:mod:`..obs.trace`).

Counterpart of ``pta_replicator_tpu/utils/profiling.py``. ``stage()`` /
``timings()`` / ``reset()`` are thin shims with the JAX package's
signatures and summary shape; new code uses :func:`..obs.span` directly,
which adds nesting, attributes and the capture sinks.
:func:`injection_stage_fns` is the per-stage table of the injection
pipeline, as plain torch functions.

``device_trace`` (a profiler capture of the card registered in the
capture's ``meta.json``) belongs to the device profiling of ROADMAP A.16.4b
and raises here.
"""
from __future__ import annotations

from typing import Dict

from ..obs import trace as _trace


def vm_rss_mb() -> float:
    """Current VmRSS in MB (Linux ``/proc``; 0.0 where unavailable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def stage(name: str):
    """Time a host-side stage: ``with stage('ingest'): ...``; records an
    :mod:`..obs` span named ``name``."""
    return _trace.span(name)


def timings() -> Dict[str, dict]:
    """Recorded stages by span leaf name: calls, total and mean seconds,
    over every span since the last :func:`reset` (the library's own
    instrumentation included)."""
    out: Dict[str, dict] = {}
    for path, s in _trace.summary().items():
        leaf = path.rsplit("/", 1)[-1]
        agg = out.setdefault(leaf, {"calls": 0, "total_s": 0.0})
        agg["calls"] += s["calls"]
        agg["total_s"] += s["total_s"]
    for agg in out.values():
        agg["mean_s"] = agg["total_s"] / agg["calls"]
    return out


def reset() -> None:
    """Clear recorded timings: the global tracer's buffers and aggregates
    (an ``events.jsonl`` already written is unaffected)."""
    _trace.reset()


def device_trace(logdir: str):
    """A profiler capture of the card: not ported yet."""
    raise NotImplementedError(
        "device_trace is not ported yet (ROADMAP A.16.4b, device profiling); "
        "the JAX package's utils.profiling.device_trace has it"
    )


def injection_stage_fns(batch, recipe) -> dict:
    """Per-stage functions of the injection pipeline, each
    ``fn(generator) -> tensor``: one realization of that stage's delays
    (Np, Nt) on the batch's device, drawn from ``generator`` (a
    ``torch.Generator`` on that device). The stages and their enabling
    conditions are the JAX package's: the white noise, jitter, red and
    chromatic noise, the GWB (with the uncorrelated ``sqrt(2) I`` common
    process when the recipe has no ORF), one fit (the quadratic without a
    design, else the design refit, GLS or WLS, then the residualization),
    and ``cgw_catalog_once``, which ignores its generator.

    Launches are asynchronous on the card: time a stage by queueing calls
    and fencing once with a host readback."""
    import torch

    from ..models import batched as B

    def normal(generator):
        return torch.randn(batch.toas_s.shape, generator=generator, dtype=batch.dtype,
                           device=batch.device)

    stages = {}
    if recipe.efac is not None or recipe.log10_equad is not None:
        stages["white_noise"] = lambda g: B.white_noise_delays(
            g, batch, efac=recipe.efac if recipe.efac is not None else 1.0,
            log10_equad=recipe.log10_equad, tnequad=recipe.tnequad)
    if recipe.log10_ecorr is not None:
        stages["jitter"] = lambda g: B.jitter_delays(g, batch, recipe.log10_ecorr)
    if recipe.rn_log10_amplitude is not None:
        stages["red_noise"] = lambda g: B.red_noise_delays(
            g, batch, recipe.rn_log10_amplitude, recipe.rn_gamma, nmodes=recipe.rn_nmodes)
    if recipe.chrom_log10_amplitude is not None:
        stages["chromatic_noise"] = lambda g: B.chromatic_noise_delays(
            g, batch, recipe.chrom_log10_amplitude, recipe.chrom_gamma,
            chromatic_index=recipe.chrom_index if recipe.chrom_index is not None else 2.0,
            nmodes=recipe.chrom_nmodes, ref_freq_mhz=recipe.chrom_ref_freq_mhz)
    if recipe.gwb_log10_amplitude is not None or recipe.gwb_user_spectrum is not None:
        orf_chol = (recipe.orf_cholesky if recipe.orf_cholesky is not None
                    else 2.0 ** 0.5 * torch.eye(batch.npsr, dtype=batch.dtype,
                                                 device=batch.device))
        stages["gwb"] = lambda g: B.gwb_delays(
            g, batch, recipe.gwb_log10_amplitude, recipe.gwb_gamma, orf_chol,
            npts=recipe.gwb_npts, howml=recipe.gwb_howml,
            user_spectrum=recipe.gwb_user_spectrum)
    if recipe.fit_design is None:
        stages["quad_fit"] = lambda g: B.quadratic_fit_subtract(normal(g), batch)
    elif recipe.fit_gls:
        stages["gls_fit"] = lambda g: B.residualize(
            B.gls_fit_subtract(normal(g), batch, recipe.fit_design, recipe), batch)
    else:
        stages["design_fit"] = lambda g: B.residualize(
            B.design_fit_subtract(normal(g), batch, recipe.fit_design), batch)
    if recipe.cgw_params is not None:
        params = recipe.cgw_params.cpu().unbind(0)
        stages["cgw_catalog_once"] = lambda g: B.cgw_catalog_delays(
            batch, *params, chunk=recipe.cgw_chunk)
    return stages
