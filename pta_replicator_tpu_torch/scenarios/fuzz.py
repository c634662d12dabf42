"""Property-based differential fuzzing: random scenarios through the
batched engine against the per-pulsar oracle path.

Counterpart of ``pta_replicator_tpu/scenarios/fuzz.py``. The contract
being fuzzed: for every compilable scenario, each batched injection op
(``models/batched.py``, on the card in float32) agrees with the matching
oracle pure-math function (``models/white_noise.py``, ``red_noise.py``,
``gwb.py``, ``cgw.py``, ``bursts.py``: host float64 numpy, single-pulsar
loops) to a documented per-family tolerance, **under shared draws**: one
realization's standard normals are drawn once per scenario
(:func:`realization_draws`, ``draw_noise`` from a ``torch.Generator``
seeded with :meth:`~.compile.CompiledScenario.realize_seed`) and both
sides read them. The JAX package replays its ``jax.random`` stream on the
host instead; the port does not emulate threefry's realization draws, so
it passes the draws explicitly, and a test can hand both packages' oracles
the same JAX draws. A disagreement is a code bug (or a tolerance to
re-document), never sampling noise.

Per-family tolerances (relative to the oracle family's RMS), the JAX
package's:

=============  ========  ====================================================
family         rel tol   dominant error term
=============  ========  ====================================================
white          1e-4      f32 sqrt/mul rounding on the combined variance
ecorr          1e-4      f32 scale + epoch gather
red            3e-3      f32 trig of O(100 rad) Fourier phases + f32 matmul
chromatic      3e-3      red-noise term x f32 power-law frequency scaling
gwb            3e-3      f32 DFT-synthesis matmul vs f64 hermitian ifft
cw             3e-3      f32 sin(2*phase) after the f64 plane fold (B.1)
burst          1e-3      f32 grid interpolation
memory         1e-3      f32 ramp arithmetic
transient      1e-3      f32 grid interpolation (single pulsar)
covariance     1e-3      f32 structured sampling map vs f64 dense Cholesky
                         of the same covariance under the same z
total          1e-3      engine realization vs summed oracle
=============  ========  ====================================================

Scenarios with a sweep plan can also run the **pipelined-vs-sync byte
identity** arm: the same compiled scenario through ``utils.sweep`` at
``pipeline_depth=1`` and ``2``, whose cubes and consolidated checkpoint
bytes must be identical.

On a disagreement the harness **shrinks**: it greedily drops spec sections
and simplifies sizes while the failure persists (compile-time draws are
``fold_in``-indexed per family, so deleting one section leaves every
other's untouched), and writes the minimal failing spec as a replayable
JSON file (``scenario replay FILE``).

Telemetry: a ``scenario_fuzz_case`` span per differential, and the
``scenario.fuzz_cases``, ``scenario.fuzz_disagreements`` and
``scenario.shrink_steps`` counters.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import counter, names, span
from ..utils.prng import fold_in, key_bits, prng_key
from .compile import CompiledScenario, compile_spec, spec_families
from .spec import ScenarioSpec

#: documented per-family relative tolerances (see module docstring)
FAMILY_TOLERANCES = {
    "white": 1e-4,
    "ecorr": 1e-4,
    "red": 3e-3,
    "chromatic": 3e-3,
    "gwb": 3e-3,
    "cw": 3e-3,
    "burst": 1e-3,
    "memory": 1e-3,
    "transient": 1e-3,
    # structured correlated noise: f32 (host-f64-factored) sampling map
    # vs the f64 dense-Cholesky oracle under the same z draw — the
    # factor algebra is exact (Cholesky uniqueness), so only the f32
    # matmul/cast rounding remains
    "covariance": 1e-3,
    "total": 1e-3,
}


def _rel(dev: np.ndarray, oracle: np.ndarray) -> float:
    """Max absolute deviation relative to the oracle signal's RMS —
    scale-free, and robust to near-zero individual samples."""
    rms = float(np.sqrt(np.mean(np.asarray(oracle, np.float64) ** 2)))
    denom = max(rms, 1e-30)
    return float(np.max(np.abs(
        np.asarray(dev, np.float64) - np.asarray(oracle, np.float64)
    ))) / denom


def _np(x) -> Optional[np.ndarray]:
    """A tensor (on any device), array or number as a float64 host array."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _host(x) -> np.ndarray:
    """A tensor's values on the host, in its own dtype (integer indices)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ draws

def realization_draws(compiled: CompiledScenario) -> dict:
    """One realization's standard normals of every enabled stochastic
    family, on the batch's device: ``draw_noise`` from a generator seeded
    with ``compiled.realize_seed()``, the leading realization axis
    dropped. Both sides of the differential read these."""
    from ..models.batched import draw_noise

    batch, recipe = compiled.batch, compiled.recipe
    generator = torch.Generator(device=batch.device).manual_seed(compiled.realize_seed())
    return {k: v[0] for k, v in draw_noise(generator, batch, recipe, 1).items()}


# ------------------------------------------------------------ batched side

def batched_family_delays(compiled: CompiledScenario, draws: dict) -> Dict[str, np.ndarray]:
    """Each enabled family's delays from the BATCHED ops on the batch's
    device, each stochastic family reading its slice of ``draws``
    (:func:`realization_draws`), as float64 host arrays."""
    from ..covariance.structure import recipe_cov_s2
    from ..models import batched as B

    batch, recipe = compiled.batch, compiled.recipe
    # the family ops do not go through realize, which checks the flag
    B._require_ieee_float32(batch.device)
    out = {}
    if recipe.efac is not None or recipe.log10_equad is not None:
        out["white"] = _np(B.white_noise_delays(
            None, batch, efac=recipe.efac if recipe.efac is not None else 1.0,
            log10_equad=recipe.log10_equad, tnequad=recipe.tnequad, eps=draws["white"],
        ))
    if recipe.log10_ecorr is not None:
        out["ecorr"] = _np(B.jitter_delays(None, batch, recipe.log10_ecorr, eps=draws["ecorr"]))
    if recipe.rn_log10_amplitude is not None:
        out["red"] = _np(B.red_noise_delays(
            None, batch, recipe.rn_log10_amplitude, recipe.rn_gamma,
            nmodes=recipe.rn_nmodes, eps=draws["red"],
        ))
    if recipe.chrom_log10_amplitude is not None:
        out["chromatic"] = _np(B.chromatic_noise_delays(
            None, batch, recipe.chrom_log10_amplitude, recipe.chrom_gamma,
            chromatic_index=recipe.chrom_index if recipe.chrom_index is not None else 2.0,
            nmodes=recipe.chrom_nmodes, eps=draws["chromatic"],
        ))
    if recipe.gwb_log10_amplitude is not None or recipe.gwb_user_spectrum is not None:
        if recipe.orf_cholesky is None:
            chol = math.sqrt(2.0) * torch.eye(batch.npsr, dtype=batch.dtype, device=batch.device)
        else:
            chol = recipe.orf_cholesky
        out["gwb"] = _np(B.gwb_delays(
            None, batch, recipe.gwb_log10_amplitude, recipe.gwb_gamma, chol,
            npts=recipe.gwb_npts, howml=recipe.gwb_howml, turnover=recipe.gwb_turnover,
            f0=recipe.gwb_f0, beta=recipe.gwb_beta, power=recipe.gwb_power,
            user_spectrum=recipe.gwb_user_spectrum, eps=draws["gwb"],
        ))
    if recipe.cgw_params is not None:
        params = recipe.cgw_params.cpu().unbind(0)
        kwargs = dict(
            pdist=recipe.cgw_pdist if recipe.cgw_pdist is not None else 1.0,
            pphase=recipe.cgw_pphase, psr_term=recipe.cgw_psr_term,
            evolve=recipe.cgw_evolve, phase_approx=recipe.cgw_phase_approx,
            tref_s=recipe.cgw_tref_s,
        )
        if recipe.cgw_stream_chunk is not None:
            # the streamed pipeline: B.1's accumulating launch per macro tile
            out["cw"] = _np(B.cgw_catalog_delays_streamed(
                batch, *params, chunk=recipe.cgw_stream_chunk,
                prefetch_depth=recipe.cgw_prefetch_depth, plain_chunk=recipe.cgw_chunk,
                **kwargs,
            ))
        else:
            out["cw"] = _np(B.cgw_catalog_delays(batch, *params, chunk=recipe.cgw_chunk,
                                                 **kwargs))
    if recipe.gwm_params is not None:
        out["memory"] = _np(B.gw_memory_delays(batch, *recipe.gwm_params.unbind(0)))
    if recipe.burst_sky is not None:
        sky, grid = recipe.burst_sky, recipe.burst_grid
        out["burst"] = _np(B.burst_delays(batch, sky[0], sky[1], recipe.burst_hplus,
                                          recipe.burst_hcross, grid[0], grid[1], psi=sky[2]))
    if recipe.transient_waveform is not None:
        grid = recipe.transient_grid
        out["transient"] = _np(B.transient_delays(batch, int(recipe.transient_psr),
                                                  recipe.transient_waveform, grid[0], grid[1]))
    if recipe.noise_cov is not None:
        from ..covariance.kernels import sample_eager

        sample = sample_eager(recipe.noise_cov, draws, s2=recipe_cov_s2(recipe, batch.dtype))
        out["covariance"] = _np(sample.to(batch.dtype) * batch.mask)
    return out


def batched_total(compiled: CompiledScenario, draws: dict) -> np.ndarray:
    """The engine's realization: ``realization_delays`` on ``draws`` plus
    the static plane, what ``realize`` and ``sweep`` compute per
    realization before the fit and residualization tail (which has its
    own oracle-pinned tests)."""
    from ..models.batched import realization_delays

    static = compiled.static_delays()
    return _np(realization_delays(compiled.batch, compiled.recipe, draws) + static)


# ------------------------------------------------------------- oracle side

def _per_toa_np(param, batch) -> np.ndarray:
    """Oracle-side per-backend expansion: scalar / (Np,) / (Np, NB)
    parameter onto TOAs through the integer backend index — the numpy
    mirror of the reference's string-flag expand_by_flags semantics."""
    p = _np(param)
    npsr, ntoa = tuple(batch.toas_s.shape)
    mask = _np(batch.mask)
    if p.ndim == 0:
        return np.full((npsr, ntoa), float(p)) * mask
    if p.ndim == 1:
        return p[:, None] * mask
    idx = _host(batch.backend_index)
    return np.take_along_axis(p, idx, axis=1) * mask


def oracle_family_delays(compiled: CompiledScenario, draws: dict) -> Dict[str, np.ndarray]:
    """Each enabled family's delays from the ORACLE path: host float64
    numpy single-pulsar math out of ``models/white_noise.py``,
    ``red_noise.py``, ``gwb.py``, ``cgw.py`` and ``bursts.py``, reading
    its standard normals from ``draws`` (one realization's, by family
    name, on any device or as arrays: :func:`realization_draws`, or the
    JAX package's draws rebuilt from its key split)."""
    from ..covariance.structure import recipe_cov_s2
    from ..models.bursts import memory_ramp, polarization_rotation
    from ..models.cgw import antenna_pattern, cw_delay
    from ..models.gwb import (
        characteristic_strain,
        gwb_grid,
        gwb_time_series,
        interp_to_toas,
        residual_psd_coeff,
    )
    from ..models.red_noise import red_noise_delay
    from ..models.white_noise import jitter_delay

    batch, recipe = compiled.batch, compiled.recipe
    toas = _np(batch.toas_s)
    errors = _np(batch.errors_s)
    mask = _np(batch.mask)
    npsr, ntoa = toas.shape
    out = {}

    if recipe.efac is not None or recipe.log10_equad is not None:
        # one combined-variance normal per TOA, as the batched op draws;
        # the per-TOA sigma from the oracle-style per-backend expansion
        eps = _np(draws["white"])
        efac_t = _per_toa_np(recipe.efac if recipe.efac is not None else 1.0, batch)
        var = (efac_t * errors) ** 2
        if recipe.log10_equad is not None:
            equad_t = _per_toa_np(10.0 ** _np(recipe.log10_equad), batch)
            if not recipe.tnequad:
                equad_t = efac_t * equad_t
            var = var + equad_t**2
        out["white"] = np.sqrt(var) * eps * mask

    if recipe.log10_ecorr is not None:
        nep = batch.max_epochs
        eps = _np(draws["ecorr"])
        ec = 10.0 ** _np(recipe.log10_ecorr)
        epoch_mask = _np(batch.epoch_mask)
        epoch_index = _host(batch.epoch_index)
        epoch_backend = _host(batch.epoch_backend_index)
        rows = []
        for p in range(npsr):
            if ec.ndim == 0:
                per_epoch = np.full(nep, float(ec))
            elif ec.ndim == 1:
                per_epoch = np.full(nep, ec[p])
            else:
                per_epoch = ec[p][epoch_backend[p]]
            per_epoch = per_epoch * epoch_mask[p]
            rows.append(jitter_delay(epoch_index[p], per_epoch, eps[p]))
        out["ecorr"] = np.stack(rows) * mask

    tspan = _np(batch.tspan_s)

    def oracle_red(eps, log10_amp, gamma, nmodes):
        amp = np.broadcast_to(_np(log10_amp), (npsr,))
        gam = np.broadcast_to(_np(gamma), (npsr,))
        return np.stack([
            red_noise_delay(toas[p], amp[p], gam[p], eps[p], nmodes=nmodes, tspan_s=tspan[p])
            for p in range(npsr)
        ]) * mask

    if recipe.rn_log10_amplitude is not None:
        out["red"] = oracle_red(_np(draws["red"]), recipe.rn_log10_amplitude,
                                recipe.rn_gamma, recipe.rn_nmodes)

    if recipe.chrom_log10_amplitude is not None:
        achrom = oracle_red(_np(draws["chromatic"]), recipe.chrom_log10_amplitude,
                            recipe.chrom_gamma, recipe.chrom_nmodes)
        freqs = _np(batch.freqs_mhz)
        idx = float(_np(recipe.chrom_index if recipe.chrom_index is not None else 2.0))
        scale = np.where(
            freqs > 0.0,
            (recipe.chrom_ref_freq_mhz / np.where(freqs > 0.0, freqs, 1.0)) ** idx,
            0.0,
        )
        out["chromatic"] = achrom * scale

    if recipe.gwb_log10_amplitude is not None or recipe.gwb_user_spectrum is not None:
        start, stop = float(batch.start_s), float(batch.stop_s)
        ut, dt_grid, f = gwb_grid(start, stop, recipe.gwb_npts, recipe.gwb_howml)
        M = np.sqrt(2.0) * np.eye(npsr) if recipe.orf_cholesky is None else _np(
            recipe.orf_cholesky)
        w2 = _np(draws["gwb"])
        w = w2[0] + 1j * w2[1]
        hcf = characteristic_strain(
            f,
            None if recipe.gwb_log10_amplitude is None else float(_np(recipe.gwb_log10_amplitude)),
            None if recipe.gwb_gamma is None else float(_np(recipe.gwb_gamma)),
            turnover=recipe.gwb_turnover, f0=recipe.gwb_f0, beta=recipe.gwb_beta,
            power=recipe.gwb_power, user_spectrum=_np(recipe.gwb_user_spectrum),
        )
        C = residual_psd_coeff(hcf, f, stop - start, recipe.gwb_howml)
        series = gwb_time_series(w, M, C, dt_grid, recipe.gwb_npts)
        out["gwb"] = np.stack([
            interp_to_toas(ut, series[p], toas[p]) for p in range(npsr)
        ]) * mask

    if recipe.cgw_params is not None:
        params = list(_np(recipe.cgw_params))
        pdist = _np(recipe.cgw_pdist if recipe.cgw_pdist is not None else 1.0)
        pphase = _np(recipe.cgw_pphase)
        phat = _np(batch.phat)
        t_src = float(batch.tref_mjd) * 86400.0 - recipe.cgw_tref_s + toas
        rows = []
        for p in range(npsr):
            pd = pdist[p] if pdist.ndim == 2 else pdist
            pp = None
            if pphase is not None:
                pp = pphase[p] if pphase.ndim == 2 else pphase
            res = cw_delay(
                t_src[p], phat[p], *params, pdist=pd, pphase=pp,
                psr_term=recipe.cgw_psr_term, evolve=recipe.cgw_evolve,
                phase_approx=recipe.cgw_phase_approx, nan_to_zero=True,
            )
            rows.append(np.sum(np.atleast_2d(res), axis=0))
        out["cw"] = np.stack(rows) * mask

    if recipe.gwm_params is not None:
        strain, gwtheta, gwphi, pol, t0_mjd = (float(v) for v in _np(recipe.gwm_params))
        t0_s = (t0_mjd - float(batch.tref_mjd)) * 86400.0
        rows = []
        for p in range(npsr):
            fplus, fcross, _ = antenna_pattern(gwtheta, gwphi, phat_np(batch, p))
            pol_amp = np.cos(2.0 * pol) * fplus + np.sin(2.0 * pol) * fcross
            rows.append(memory_ramp(toas[p], t0_s, pol_amp, strain))
        out["memory"] = np.stack(rows) * mask

    if recipe.burst_sky is not None:
        gwtheta, gwphi, psi = (float(v) for v in _np(recipe.burst_sky))
        g0, g1 = (float(v) for v in _np(recipe.burst_grid))
        hp = _np(recipe.burst_hplus)
        hc = _np(recipe.burst_hcross)
        tg = np.linspace(g0, g1, hp.shape[0])
        rows = []
        for p in range(npsr):
            hpt = np.interp(toas[p], tg, hp)
            hct = np.interp(toas[p], tg, hc)
            inside = (toas[p] >= g0) & (toas[p] <= g1)
            hpt, hct = hpt * inside, hct * inside
            rp, rc = polarization_rotation(hpt, hct, psi)
            fplus, fcross, _ = antenna_pattern(gwtheta, gwphi, phat_np(batch, p))
            rows.append(-fplus * rp - fcross * rc)
        out["burst"] = np.stack(rows) * mask

    if recipe.transient_waveform is not None:
        g0, g1 = (float(v) for v in _np(recipe.transient_grid))
        wf = _np(recipe.transient_waveform)
        tg = np.linspace(g0, g1, wf.shape[0])
        p = int(recipe.transient_psr)
        row = np.interp(toas[p], tg, wf)
        row = row * ((toas[p] >= g0) & (toas[p] <= g1)) * mask[p]
        block = np.zeros_like(toas)
        block[p] = row
        out["transient"] = block

    if recipe.noise_cov is not None:
        # the structured sampling map vs a dense f64 Cholesky of the
        # SAME covariance under the SAME z draw: Cholesky factors are
        # unique, so the block-tridiagonal / Kronecker-factored L *is*
        # the dense L and any disagreement is a code bug, not algebra
        z = _np(draws["cov"])
        C = recipe.noise_cov.dense(pad_identity=True)
        s2 = recipe_cov_s2(recipe)
        s2 = 1.0 if s2 is None else _np(s2)
        amp = np.sqrt(np.broadcast_to(s2, (npsr,)))
        rows = []
        for p in range(npsr):
            L = np.linalg.cholesky(C[p])  # host float64 oracle (dense() returns f64)
            rows.append(L @ z[p])
        out["covariance"] = np.stack(rows) * amp[:, None] * mask
    return out


def phat_np(batch, p: int) -> np.ndarray:
    return _np(batch.phat)[p]


# ------------------------------------------------------------ differential

@dataclass
class DiffResult:
    """One scenario's differential verdicts."""

    spec: ScenarioSpec
    spec_hash: str
    families: Tuple[str, ...]
    #: family -> {"rel": float, "tol": float, "ok": bool}
    verdicts: Dict[str, dict] = field(default_factory=dict)
    agree: bool = True
    worst_family: Optional[str] = None
    worst_rel: float = 0.0

    def to_dict(self) -> dict:
        return {
            "spec_hash": self.spec_hash,
            "families": list(self.families),
            "verdicts": self.verdicts,
            "agree": self.agree,
            "worst_family": self.worst_family,
            "worst_rel": self.worst_rel,
        }


def run_scenario(compiled: CompiledScenario, perturb: Optional[dict] = None,
                 draws: Optional[dict] = None) -> DiffResult:
    """Run one compiled scenario through the full differential, on the
    compiled batch's device, both sides reading ``draws`` (default:
    :func:`realization_draws`).

    ``perturb`` plants a controlled defect into the batched side —
    ``{"family": "ecorr", "scale": 1.01}`` multiplies that family's
    batched delays (and the engine total, consistently) before
    comparison. The planted-bug arm uses it to prove end to end that a
    real disagreement is detected, shrunk to a minimal spec, and written
    replayable; it never runs unless requested."""
    res = DiffResult(spec=compiled.spec, spec_hash=compiled.spec_hash,
                     families=compiled.families)
    with span(names.SPAN_SCENARIO_FUZZ_CASE, spec_hash=compiled.spec_hash):
        if draws is None:
            draws = realization_draws(compiled)
        dev = batched_family_delays(compiled, draws)
        oracle = oracle_family_delays(compiled, draws)
        total_dev = batched_total(compiled, draws)
        if perturb:
            fam = perturb["family"]
            scale = float(perturb.get("scale", 1.01))
            if fam in dev:
                delta = (scale - 1.0) * dev[fam]
                dev[fam] = dev[fam] + delta
                total_dev = total_dev + delta

        missing = set(dev) ^ set(oracle)
        if missing:  # a family one side skipped is itself a bug
            for fam in missing:
                res.verdicts[fam] = {
                    "rel": float("inf"), "tol": 0.0, "ok": False,
                    "note": "family present on only one side",
                }
            res.agree = False
        for fam in sorted(set(dev) & set(oracle)):
            rel = _rel(dev[fam], oracle[fam])
            tol = FAMILY_TOLERANCES[fam]
            ok = rel <= tol
            res.verdicts[fam] = {"rel": rel, "tol": tol, "ok": ok}
            if rel > res.worst_rel:
                res.worst_rel, res.worst_family = rel, fam
            res.agree = res.agree and ok

        # the engine total vs the summed oracle (catches cross-family
        # assembly bugs the per-family comparisons cannot)
        total_oracle = np.zeros_like(total_dev)
        for fam in oracle:
            total_oracle = total_oracle + oracle[fam]
        rel = _rel(total_dev, total_oracle)
        tol = FAMILY_TOLERANCES["total"]
        ok = rel <= tol
        res.verdicts["total"] = {"rel": rel, "tol": tol, "ok": ok}
        if rel > res.worst_rel:
            res.worst_rel, res.worst_family = rel, "total"
        res.agree = res.agree and ok
        counter(names.SCENARIO_FUZZ_CASES).inc()
        if not res.agree:
            counter(names.SCENARIO_FUZZ_DISAGREEMENTS).inc()
    return res


def check_sweep_identity(compiled: CompiledScenario, tmpdir: str) -> dict:
    """Pipelined-vs-sync byte identity over THIS scenario: the same
    compiled workload through utils.sweep at depth 1 and depth 2 must
    return identical cubes and consolidate identical checkpoint bytes."""
    import hashlib

    from ..utils.sweep import sweep

    plan = compiled.plan
    results, digests = [], []
    for depth in (1, 2):
        path = os.path.join(tmpdir, f"ck_depth{depth}.npz")
        out = sweep(compiled.realize_seed(), compiled.batch, compiled.recipe, plan.nreal, path,
                    chunk=plan.chunk, reduce_fn=None, fit=plan.fit, pipeline_depth=depth,
                    provenance=compiled.provenance(), device=compiled.batch.device)
        results.append(np.asarray(out))
        with open(path, "rb") as fh:
            digests.append(hashlib.sha256(fh.read()).hexdigest())
    return {
        "bit_identical": bool(np.array_equal(results[0], results[1])),
        "checkpoint_identical": digests[0] == digests[1],
        "sha256": digests[0],
    }


# --------------------------------------------------------------- generator

#: compile-cache-friendly shape buckets: the jitted engine re-lowers per
#: (shapes, static fields), so the generator draws from a few buckets
#: instead of a continuum (the scenario space stays rich through the
#: CONTENT, not the array dims)
SHAPE_BUCKETS = ((2, 64, 1), (3, 96, 2), (4, 128, 2))


def sample_spec(root_seed: int, index: int) -> ScenarioSpec:
    """Scenario ``index`` of the constrained random generator: the JAX
    package's spec ``index`` for the same ``root_seed``.

    Seed discipline: the scenario's identity comes from the key words of
    ``fold_in(PRNGKey(root_seed), index)`` (``utils/prng.py``) — their
    bits become ``spec.seed``, so scenario K's compile-time draws are
    independent of every other scenario and of K's position in the run."""
    bits = key_bits(fold_in(prng_key(root_seed), index)).astype(np.uint64)
    spec_seed = int(bits[-1] & np.uint64(0x7FFFFFFF))
    # structural choices draw from a generator-owned stream (family -1
    # would collide with compile's own streams; use the raw bits)
    rng = np.random.default_rng(int(bits[0] << np.uint64(16)) + index)

    npsr, ntoa, nbackend = SHAPE_BUCKETS[int(rng.integers(len(SHAPE_BUCKETS)))]
    d: dict = {
        "name": f"fuzz-{root_seed}-{index}",
        "seed": spec_seed,
        "array": {"npsr": npsr, "ntoa": ntoa, "nbackend": nbackend, "span_days": 2000.0},
    }

    def maybe(p):
        return rng.uniform() < p

    def val(lo, hi, p_dist=0.5, log=False):
        """A spec leaf: sometimes a concrete scalar, sometimes a
        distribution object (exercises the compiler's draw machinery)."""
        if maybe(p_dist):
            return {"dist": "loguniform" if log else "uniform", "lo": lo, "hi": hi}
        if log:
            return float(10.0 ** rng.uniform(np.log10(lo), np.log10(hi)))
        return float(rng.uniform(lo, hi))

    if maybe(0.75):
        w = {}
        if maybe(0.85):
            w["efac"] = val(0.8, 1.5)
        if maybe(0.7):
            w["log10_equad"] = val(-7.5, -6.0)
        if not w:
            w["efac"] = 1.1
        if maybe(0.5):
            w["per_backend"] = True
        if maybe(0.3):
            w["tnequad"] = True
        d["white"] = w
    if maybe(0.5):
        d["ecorr"] = {"log10_ecorr": val(-7.5, -6.3),
                      **({"per_backend": True} if maybe(0.5) else {})}
    if maybe(0.55):
        d["red"] = {"log10_amplitude": val(-14.5, -13.0), "gamma": val(2.0, 5.0),
                    "nmodes": int(rng.choice([4, 8]))}
    if maybe(0.35):
        d["chromatic"] = {"log10_amplitude": val(-14.5, -13.5), "gamma": val(1.0, 4.0),
                          "index": float(rng.choice([2.0, 4.0])), "nmodes": 4}
    orf = ["hd", "none", {"lmax": 1, "clm": [float(np.sqrt(4 * np.pi)), 0.3, -0.2, 0.1]}][
        int(rng.integers(3))
    ]
    if maybe(0.25):
        d["population"] = {
            "n_binaries": int(rng.choice([100, 300])),
            "outlier_per_bin": int(rng.integers(0, 3)),
            "nbins": 4, "npts": 64, "howml": 4.0, "orf": orf,
        }
    else:
        if maybe(0.55):
            g = {"log10_amplitude": val(-14.8, -13.8), "gamma": val(3.0, 5.0), "npts": 64,
                 "howml": 4.0, "orf": orf}
            if maybe(0.3):
                g["turnover"] = {"f0": val(5e-10, 5e-9, log=True), "beta": 1.0, "power": 1.0}
            d["gwb"] = g
        if maybe(0.45):
            c = {"nsrc": int(rng.integers(1, 4))}
            if maybe(0.4):
                c["pdist_kpc"] = val(0.5, 3.0)
            if maybe(0.3):
                c["psr_term"] = False
            if maybe(0.25):
                c["evolve"] = False
            if maybe(0.25):
                c["stream_chunk"] = 2
            d["cw"] = c
    if maybe(0.3):
        d["burst"] = {"log10_amp": val(-8.0, -6.0), "t0_frac": val(0.2, 0.8),
                      "width_frac": val(0.02, 0.1), "ngrid": 128}
    if maybe(0.3):
        d["memory"] = {"log10_strain": val(-14.0, -12.0), "t0_frac": val(0.2, 0.8)}
    if maybe(0.4):
        d["transient"] = {
            "psr": int(rng.integers(npsr)),
            "kind": "glitch" if maybe(0.5) else "gaussian",
            "log10_amp": val(-7.5, -6.0),
            "t0_frac": val(0.2, 0.8), "width_frac": val(0.02, 0.1),
            "ngrid": 128,
        }
    if maybe(0.4):
        kind = ["banded", "kron", "dense"][int(rng.integers(3))]
        c: dict = {"kind": kind, "log10_sigma": val(-7.0, -6.2)}
        if kind == "banded":
            c["rho"] = val(0.2, 0.8)
            c["corr_days"] = val(10.0, 60.0)
            c["block"] = int(rng.choice([8, 16]))
        elif kind == "kron":
            if maybe(0.3):
                # the preset route (defaults + the drawn amplitude)
                c = {"preset": "solar_wind", "log10_sigma": val(-7.0, -6.2)}
            else:
                c["channels"] = int(rng.choice([2, 4]))
                c["time_ell_days"] = val(5.0, 40.0)
                c["chan_rho"] = val(0.3, 0.9)
        else:
            c["corr_days"] = val(10.0, 60.0)
        d["covariance"] = c
    if not any(k in d for k in ("white", "ecorr", "red", "chromatic", "gwb", "population",
                                "cw", "burst", "memory", "transient", "covariance")):
        d["white"] = {"efac": 1.1}
    if maybe(0.4):
        d["sweep"] = {"nreal": 4, "chunk": 2, "pipeline_depth": 2}
    return ScenarioSpec.from_dict(d).validate()


# ---------------------------------------------------------------- shrinker

def _shrink_candidates(d: dict) -> List[dict]:
    """Ordered simplification candidates for one spec dict: drop whole
    sections first (biggest steps), then shrink sizes, then simplify
    within sections. Every candidate is a fresh dict."""
    out = []
    droppable = ("population", "cw", "gwb", "chromatic", "red", "ecorr",
                 "white", "burst", "memory", "transient", "covariance",
                 "sweep")
    present = [s for s in droppable if s in d]
    for sec in present:
        if sec != "sweep" and len([
            s for s in present if s != "sweep"
        ]) <= 1:
            continue  # keep at least one signal family (spec validity)
        c = {k: v for k, v in d.items() if k != sec}
        out.append(c)
    arr = d.get("array", {})
    for key, floor in (("npsr", 2), ("ntoa", 32), ("nbackend", 1)):
        cur = arr.get(key)
        if isinstance(cur, int) and cur > floor:
            c = json.loads(json.dumps(d))
            c["array"][key] = max(floor, cur // 2)
            out.append(c)
    for sec, key, simple in (
        ("white", "per_backend", False),
        ("ecorr", "per_backend", False),
        ("red", "nmodes", 2),
        ("chromatic", "nmodes", 2),
        ("cw", "nsrc", 1),
        ("population", "n_binaries", 50),
        ("population", "outlier_per_bin", 1),
        ("covariance", "block", 8),
        ("covariance", "channels", 2),
    ):
        if sec in d and d[sec].get(key) not in (None, simple):
            c = json.loads(json.dumps(d))
            c[sec][key] = simple
            out.append(c)
    for sec, key in (("gwb", "turnover"), ("cw", "stream_chunk"),
                     ("cw", "pdist_kpc")):
        if sec in d and key in d[sec]:
            c = json.loads(json.dumps(d))
            del c[sec][key]
            out.append(c)
    for sec in ("gwb", "population"):
        if sec in d and d[sec].get("orf", "hd") != "none":
            c = json.loads(json.dumps(d))
            c[sec]["orf"] = "none"
            out.append(c)
    return out


def shrink(spec: ScenarioSpec, fails: Callable[[ScenarioSpec], bool],
           max_steps: int = 200) -> Tuple[ScenarioSpec, int]:
    """Greedy shrink: repeatedly accept the first candidate
    simplification that still fails, until none does (or the step
    budget runs out). Returns (minimal failing spec, candidates
    evaluated). Family draws are fold_in-indexed, so dropping one
    section leaves every other section's stream bit-identical — the
    disagreement cannot dodge the shrinker by changing draws."""
    current = spec.to_dict()
    steps = 0
    progress = True
    while progress and steps < max_steps:
        progress = False
        for cand in _shrink_candidates(current):
            try:
                cspec = ScenarioSpec.from_dict(cand).validate()
            except Exception:
                continue
            steps += 1
            counter(names.SCENARIO_SHRINK_STEPS).inc()
            if steps >= max_steps:
                break
            try:
                if fails(cspec):
                    current = cspec.to_dict()
                    progress = True
                    break
            except Exception:
                # a candidate that CRASHES still reproduces a defect;
                # treat as failing so the shrinker can chase crashes too
                current = cspec.to_dict()
                progress = True
                break
    return ScenarioSpec.from_dict(current), steps


# ----------------------------------------------------------------- fuzz run

def fuzz(
    n: int,
    root_seed: int = 0,
    out_dir: Optional[str] = None,
    sweep_every: int = 0,
    perturb: Optional[dict] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device="cuda",
) -> dict:
    """Run ``n`` generated scenarios through the differential on
    ``device``; shrink and persist every failure. Returns the JAX
    package's report dict: agreement stats, the per-family worst
    deviations, the coverage histogram over signal-family combinations,
    and scenarios/s.

    ``sweep_every=k`` also runs the pipelined-vs-sync sweep
    byte-identity arm on every k-th scenario that carries a sweep plan.
    ``perturb`` plants a defect (see :func:`run_scenario`) — the
    planted-bug self-test arm."""
    import tempfile

    from ..device import resolve_device

    device = resolve_device(device)
    t0 = time.monotonic()
    coverage: Dict[str, int] = {}
    combos: Dict[str, int] = {}
    max_rel_by_family: Dict[str, float] = {}
    failures: List[dict] = []
    sweep_checks: List[dict] = []
    n_agree = 0

    for i in range(n):
        spec = sample_spec(root_seed, i)
        compiled = compile_spec(spec, validate=False, device=device)
        res = run_scenario(compiled, perturb=perturb)
        for fam in compiled.families:
            coverage[fam] = coverage.get(fam, 0) + 1
        combo = "+".join(sorted(compiled.families)) or "(none)"
        combos[combo] = combos.get(combo, 0) + 1
        for fam, v in res.verdicts.items():
            if np.isfinite(v["rel"]):
                max_rel_by_family[fam] = max(max_rel_by_family.get(fam, 0.0), v["rel"])
        if res.agree:
            n_agree += 1
        else:
            def _fails(s: ScenarioSpec, _p=perturb) -> bool:
                c = compile_spec(s, validate=False, device=device)
                return not run_scenario(c, perturb=_p).agree

            minimal, steps = shrink(spec, _fails)
            entry = {
                "index": i,
                "spec_hash": spec.content_hash,
                "worst_family": res.worst_family,
                "worst_rel": res.worst_rel,
                "minimal_spec_hash": minimal.content_hash,
                "minimal_families": list(spec_families(minimal)),
                "shrink_steps": steps,
            }
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"failing_{spec.content_hash}.json")
                minimal.save(path)
                entry["replay_file"] = path
            failures.append(entry)
        if sweep_every and spec.sweep is not None and i % sweep_every == 0:
            with tempfile.TemporaryDirectory() as td:
                chk = check_sweep_identity(compiled, td)
            chk["index"] = i
            sweep_checks.append(chk)
        if progress is not None:
            progress(i + 1, n)

    elapsed = time.monotonic() - t0
    return {
        "n_scenarios": n,
        "root_seed": root_seed,
        "elapsed_s": round(elapsed, 3),
        "scenarios_per_s": round(n / max(elapsed, 1e-9), 3),
        "agreement_rate": n_agree / max(n, 1),
        "n_disagreements": len(failures),
        "max_rel_disagreement": max(max_rel_by_family.values(), default=0.0),
        "max_rel_by_family": {k: float(v) for k, v in sorted(max_rel_by_family.items())},
        "tolerances": dict(FAMILY_TOLERANCES),
        "coverage": dict(sorted(coverage.items())),
        "combo_histogram_size": len(combos),
        "failures": failures,
        "sweep_identity": {
            "checked": len(sweep_checks),
            "all_bit_identical": all(
                c["bit_identical"] and c["checkpoint_identical"] for c in sweep_checks
            ) if sweep_checks else None,
        },
    }


def replay(path: str, device="cuda") -> DiffResult:
    """Re-run one saved (typically shrunk) spec through the differential
    on ``device`` — the debugging loop for a fuzz failure."""
    from .spec import load_spec

    spec = load_spec(path)
    return run_scenario(compile_spec(spec, validate=False, device=device))
