"""Deterministic scenario compiler: validated spec -> (batch, recipe,
sweep plan); and the flagship workload.

Counterpart of ``pta_replicator_tpu/scenarios/compile.py``. Every
compile-time draw derives from ``fold_in`` indexing, as in the JAX
package, computed by the port's numpy Threefry (``utils/prng.py``), so
the same spec compiles to the JAX package's arrays bit for bit:

* the *scenario* key is ``PRNGKey(spec.seed)``;
* each signal *family* draws from ``fold_in(scenario, FAMILY_IDS[f])``:
  adding or removing one family never perturbs another family's draws;
* host numpy draws (the synthetic batch's geometry, the population, the
  catalog's orientation angles) consume a ``default_rng`` seeded from the
  family key's bits, in one documented order per family.

The realization draws are the port's own (``torch.Generator``s seeded
from :meth:`CompiledScenario.realize_seed`), not the JAX package's.

``random_cw_catalog`` and ``flagship_workload`` (the ``bench_flagship``
preset) follow the JAX package's numpy RNG call order, hence the same
arrays and the same 16-hex content fingerprint. :func:`deterministic_families`
draws a burst, a burst with memory and a transient as the compiler draws
its ``burst``, ``memory`` and ``transient`` sections, from numpy
generators of the port's own seeding.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..batch import synthetic_batch
from ..constants import DAY_IN_SEC
from ..convert import JAX_ONLY_RECIPE_FIELDS
from ..covariance import banded_from_times, dense_from_times, kron_time_channel
from ..device import resolve_device
from ..models.batched import Recipe, deterministic_delays
from ..models.population import population_recipe, split_population
from ..ops.orf import assemble_orf, hellings_downs_matrix
from ..utils.prng import fold_in, key_bits, prng_key
from .spec import ScenarioSpec, SpecError

#: family -> fold_in index, the JAX package's. APPEND-ONLY: renumbering
#: changes every committed scenario's draws.
FAMILY_IDS = {
    "array": 0,
    "white": 1,
    "ecorr": 2,
    "red": 3,
    "chromatic": 4,
    "gwb": 5,
    "population": 6,
    "cw": 7,
    "burst": 8,
    "memory": 9,
    "transient": 10,
    "realize": 11,
    "covariance": 12,
}


def family_key(spec_seed: int, family: str) -> np.ndarray:
    """The family's key words: ``fold_in(PRNGKey(seed), family_id)``,
    (2,) uint32, as ``jax.random.key_data`` gives them."""
    return fold_in(prng_key(spec_seed), FAMILY_IDS[family])


def _key_seed(key) -> int:
    """A 64-bit integer seed from a key's words (high word first)."""
    bits = key_bits(key).astype(np.uint64)
    return int(bits[0] << np.uint64(32) | bits[-1])


def family_rng(spec_seed: int, family: str) -> np.random.Generator:
    """Host rng for a family's compile-time draws, seeded from the family
    key's bits: deterministic across processes, independent across
    families, and the JAX package's generator for the same spec."""
    return np.random.default_rng(_key_seed(family_key(spec_seed, family)))


def _draw(rng: np.random.Generator, val, size=None):
    """Resolve one spec leaf: a scalar passes through (broadcast by the
    consumer), a list becomes an array, a distribution object draws."""
    if isinstance(val, dict):
        kind = val["dist"]
        if kind == "uniform":
            return rng.uniform(val["lo"], val["hi"], size)
        if kind == "loguniform":
            return 10.0 ** rng.uniform(np.log10(val["lo"]), np.log10(val["hi"]), size)
        if kind == "normal":
            return rng.normal(val["mean"], val["sd"], size)
        raise SpecError(f"unknown distribution kind {kind!r}")
    if isinstance(val, list):
        return np.asarray(val, dtype=np.float64)
    return val


@dataclass
class SweepPlan:
    """How to run the compiled scenario through ``utils.sweep.sweep``."""

    nreal: int = 16
    chunk: int = 16
    pipeline_depth: int = 2
    fit: bool = False


def sweep_plan(spec: ScenarioSpec) -> SweepPlan:
    """The spec's sweep section as a :class:`SweepPlan` (defaults for a
    preset or a spec without one); no compile needed."""
    sw = dict(spec.sweep or {})
    nreal = int(sw.get("nreal", 16))
    return SweepPlan(
        nreal=nreal,
        chunk=int(sw.get("chunk", nreal)),
        pipeline_depth=int(sw.get("pipeline_depth", 2)),
        fit=bool(sw.get("fit", False)),
    )


@dataclass
class CompiledScenario:
    """The compiler's output: the batch and recipe the port's engines
    consume, the sweep plan, and the provenance the sweep sidecar stamps."""

    spec: ScenarioSpec
    spec_hash: str
    batch: object  # PulsarBatch
    recipe: object  # models.batched.Recipe
    plan: SweepPlan
    #: signal-family coverage tokens
    families: Tuple[str, ...] = ()
    #: workload content fingerprint: the flagship fingerprint for the
    #: ``bench_flagship`` preset, the spec's content hash otherwise
    fingerprint: str = ""
    #: compile-time draw record
    drawn: dict = field(default_factory=dict)

    def realize_seed(self) -> int:
        """Seed of this scenario's realizations, the one ``utils.sweep.
        sweep(seed, ...)`` takes: the ``"realize"`` family key's bits as one
        integer. The JAX package keys its realizations with that family
        key itself; the port's draws come from ``torch.Generator``s seeded
        from this integer, so they are the port's own, not JAX's."""
        return _key_seed(family_key(self.spec.seed, "realize"))

    def static_delays(self):
        """The deterministic (CW/burst/memory/transient) delay plane, on
        the batch's device."""
        return deterministic_delays(self.batch, self.recipe, device=self.batch.device)

    def provenance(self) -> dict:
        """The stamp ``utils.sweep.sweep`` records in the checkpoint sidecar."""
        return {
            "spec_name": self.spec.name,
            "spec_hash": self.spec_hash,
            "scenario_version": self.spec.scenario_version,
        }


def spec_families(spec: ScenarioSpec) -> Tuple[str, ...]:
    """Coverage tokens: one per enabled signal family, plus structural
    variants (ORF mode, GWB spectrum shape, glitch-vs-gaussian transients,
    streamed CW)."""
    if spec.preset is not None:
        return ("preset:" + spec.preset,)
    out = []
    for sec in ("white", "ecorr", "red", "chromatic", "burst", "memory"):
        if getattr(spec, sec) is not None:
            out.append(sec)
    if spec.gwb is not None:
        out.append("gwb_turnover" if "turnover" in spec.gwb else "gwb_powerlaw")
        out.append("orf_" + _orf_token(spec.gwb.get("orf", "hd")))
    if spec.population is not None:
        out.append("gwb_freespec")
        out.append("population_cw")
        out.append("orf_" + _orf_token(spec.population.get("orf", "hd")))
    if spec.cw is not None:
        out.append("cw")
        if spec.cw.get("stream_chunk"):
            out.append("cw_streamed")
    if spec.transient is not None:
        out.append("glitch" if spec.transient.get("kind") == "glitch" else "transient")
    if spec.covariance is not None:
        kind = spec.covariance.get(
            "kind", "kron" if spec.covariance.get("preset") == "solar_wind" else "banded",
        )
        out.append("cov_" + kind)
    return tuple(out)


def _orf_token(orf) -> str:
    if orf == "none":
        return "none"
    if isinstance(orf, dict):
        return "aniso"
    return "hd"


def _pulsar_locs(batch) -> np.ndarray:
    """(Np, 2) (azimuth, colatitude) of the batch's pulsars, float64."""
    phat = batch.phat.detach().cpu().numpy().astype(np.float64)
    return np.stack(
        [np.arctan2(phat[:, 1], phat[:, 0]), np.arccos(np.clip(phat[:, 2], -1.0, 1.0))],
        axis=1,
    )


def _orf_cholesky(orf, batch, path: str = "orf") -> Optional[np.ndarray]:
    """ORF Cholesky factor from the spec's orf mode and the batch's sky
    positions (None = uncorrelated). ``"hd"`` assembles the lmax = 0 basis,
    as the JAX compiler does, not the closed form, so that the factor has
    its bits. ``path`` names the spec field in errors (``gwb.orf``)."""
    if orf == "none":
        return None
    locs = _pulsar_locs(batch)
    if isinstance(orf, dict):
        mat = assemble_orf(locs, clm=orf.get("clm"), lmax=int(orf["lmax"]))
    else:
        mat = assemble_orf(locs, lmax=0)
    try:
        return np.linalg.cholesky(np.asarray(mat, np.float64))
    except np.linalg.LinAlgError:
        # positive definiteness depends on the clm values AND the drawn
        # sky positions: name the field instead of leaking a LinAlgError
        raise SpecError(
            f"{path}: the assembled ORF matrix is not positive "
            "definite for these clm coefficients and this array's sky "
            "positions; reduce the anisotropy amplitudes (the "
            "isotropic monopole term must dominate)"
        )


def _sine_gaussian(tg, t0, width, amp, rng):
    """Burst morphology: a Gaussian-windowed oscillation with a random
    cycle count and phase, and its quadrature, sampled on the grid."""
    env = amp * np.exp(-0.5 * ((tg - t0) / width) ** 2)
    ncyc = rng.uniform(0.5, 4.0)
    ph = rng.uniform(0.0, 2.0 * np.pi)
    arg = 2.0 * np.pi * ncyc * (tg - t0) / width + ph
    return env * np.cos(arg), env * np.sin(arg)


def compile_spec(spec: ScenarioSpec, validate: bool = True, dtype=None,
                 device="cuda") -> CompiledScenario:
    """Compile a (validated) spec into a :class:`CompiledScenario` on
    ``device``.

    Deterministic: the same spec compiles to the same batch and recipe
    bits in any process and on any device, and to the JAX package's arrays
    at the same batch dtype. ``dtype`` is the batch's (default float32);
    the recipe's arrays stay float64 (each op casts them at use). Runs
    under a ``scenario_compile`` span with the ``scenario.compiled``
    counter."""
    from ..obs import counter, names, span

    device = resolve_device(device)
    if validate:
        spec.validate()
    with span(names.SPAN_SCENARIO_COMPILE, scenario=spec.name,
              spec_hash=spec.content_hash):
        out = _compile_inner(spec, torch.float32 if dtype is None else dtype, device)
        counter(names.SCENARIO_COMPILED).inc()
        return out


def _compile_inner(spec, dtype, device):
    drawn = {}

    if spec.preset == "bench_flagship":
        # the JAX-only knobs (its CW backend choice and synthesis
        # precision) are accepted and dropped, as convert.py drops them
        params = {k: v for k, v in spec.preset_params.items()
                  if k not in JAX_ONLY_RECIPE_FIELDS}
        batch, recipe, fp = flagship_workload(with_fingerprint=True, dtype=dtype,
                                              device=device, **params)
        return CompiledScenario(
            spec=spec, spec_hash=spec.content_hash, batch=batch, recipe=recipe,
            plan=sweep_plan(spec), families=spec_families(spec), fingerprint=fp, drawn=drawn,
        )

    arr = dict(spec.array or {})
    npsr = int(arr.get("npsr", 4))
    rng_a = family_rng(spec.seed, "array")
    batch = synthetic_batch(
        npsr=npsr,
        ntoa=int(arr.get("ntoa", 256)),
        nbackend=int(arr.get("nbackend", 2)),
        span_days=float(arr.get("span_days", 365.25 * 16)),
        toaerr_s=float(arr.get("toaerr_s", 0.5e-6)),
        epoch_days=float(arr.get("epoch_days", 14.0)),
        seed=int(rng_a.integers(0, 2**31 - 1)),
        dtype=dtype,
        device=device,
    )
    nbackend = int(arr.get("nbackend", 2))
    kwargs = {}

    def per_psr(rng, val, per_backend=False):
        """Spec leaf -> per-pulsar (or per-pulsar-per-backend) float64
        array. Scalars stay scalars (broadcast downstream); lists must
        already carry the right length."""
        size = (npsr, nbackend) if per_backend else (npsr,)
        v = _draw(rng, val, size=size)
        if np.ndim(v) == 0:
            return np.array(float(v))
        v = np.asarray(v, np.float64)
        if v.shape != size:
            raise SpecError(
                f"explicit value list has shape {v.shape}, expected "
                f"{size} (npsr={npsr}, nbackend={nbackend})"
            )
        return v

    if spec.white is not None:
        rng = family_rng(spec.seed, "white")
        pb = bool(spec.white.get("per_backend", False))
        # draw order: efac then log10_equad
        if "efac" in spec.white:
            kwargs["efac"] = per_psr(rng, spec.white["efac"], pb)
        if "log10_equad" in spec.white:
            kwargs["log10_equad"] = per_psr(rng, spec.white["log10_equad"], pb)
        kwargs["tnequad"] = bool(spec.white.get("tnequad", False))

    if spec.ecorr is not None:
        rng = family_rng(spec.seed, "ecorr")
        pb = bool(spec.ecorr.get("per_backend", False))
        kwargs["log10_ecorr"] = per_psr(rng, spec.ecorr["log10_ecorr"], pb)

    if spec.red is not None:
        rng = family_rng(spec.seed, "red")
        # draw order: amplitude then gamma
        kwargs["rn_log10_amplitude"] = per_psr(rng, spec.red["log10_amplitude"])
        kwargs["rn_gamma"] = per_psr(rng, spec.red["gamma"])
        kwargs["rn_nmodes"] = int(spec.red.get("nmodes", 30))

    if spec.chromatic is not None:
        rng = family_rng(spec.seed, "chromatic")
        kwargs["chrom_log10_amplitude"] = per_psr(rng, spec.chromatic["log10_amplitude"])
        kwargs["chrom_gamma"] = per_psr(rng, spec.chromatic["gamma"])
        kwargs["chrom_index"] = np.array(float(_draw(rng, spec.chromatic.get("index", 2.0))))
        kwargs["chrom_nmodes"] = int(spec.chromatic.get("nmodes", 30))

    if spec.gwb is not None:
        rng = family_rng(spec.seed, "gwb")
        kwargs["gwb_log10_amplitude"] = np.array(float(_draw(rng, spec.gwb["log10_amplitude"])))
        kwargs["gwb_gamma"] = np.array(float(_draw(rng, spec.gwb["gamma"])))
        chol = _orf_cholesky(spec.gwb.get("orf", "hd"), batch, path="gwb.orf")
        if chol is not None:
            kwargs["orf_cholesky"] = chol
        if "turnover" in spec.gwb:
            t = spec.gwb["turnover"]
            kwargs["gwb_turnover"] = True
            kwargs["gwb_f0"] = float(_draw(rng, t.get("f0", 1e-9)))
            kwargs["gwb_beta"] = float(_draw(rng, t.get("beta", 1.0)))
            kwargs["gwb_power"] = float(_draw(rng, t.get("power", 1.0)))
        kwargs["gwb_npts"] = int(spec.gwb.get("npts", 600))
        kwargs["gwb_howml"] = float(spec.gwb.get("howml", 10.0))
        if "gls_nmodes" in spec.gwb:
            kwargs["gwb_gls_nmodes"] = int(spec.gwb["gls_nmodes"])

    if spec.cw is not None:
        rng = family_rng(spec.seed, "cw")
        nsrc = int(spec.cw.get("nsrc", 1))
        # draw order: sky (theta, phi), chirp mass, distance, frequency,
        # phase, polarization, inclination, one vector each
        cat = np.stack([
            np.arccos(rng.uniform(-1.0, 1.0, nsrc)),
            rng.uniform(0.0, 2.0 * np.pi, nsrc),
            _cw_vec(rng, spec.cw.get("log10_mc_msun",
                                     {"dist": "uniform", "lo": 8.0, "hi": 9.5}),
                    nsrc, log10=True),
            _cw_vec(rng, spec.cw.get("dist_mpc",
                                     {"dist": "uniform", "lo": 50.0, "hi": 1000.0}), nsrc),
            _cw_vec(rng, spec.cw.get("log10_fgw_hz",
                                     {"dist": "uniform", "lo": -8.8, "hi": -7.6}),
                    nsrc, log10=True),
            rng.uniform(0.0, 2.0 * np.pi, nsrc),
            rng.uniform(0.0, np.pi, nsrc),
            np.arccos(rng.uniform(-1.0, 1.0, nsrc)),
        ])
        kwargs["cgw_params"] = cat
        if "pdist_kpc" in spec.cw:
            kwargs["cgw_pdist"] = _cw_vec(rng, spec.cw["pdist_kpc"], nsrc)
        kwargs["cgw_psr_term"] = bool(spec.cw.get("psr_term", True))
        kwargs["cgw_evolve"] = bool(spec.cw.get("evolve", True))
        if spec.cw.get("stream_chunk"):
            kwargs["cgw_stream_chunk"] = int(spec.cw["stream_chunk"])
            kwargs["cgw_prefetch_depth"] = int(spec.cw.get("prefetch_depth", 2))
        drawn["cw_catalog"] = cat

    if spec.population is not None:
        kwargs = _compile_population(spec, batch, kwargs, drawn)

    start_s = float(batch.start_s)
    stop_s = float(batch.stop_s)
    span_s = stop_s - start_s

    if spec.burst is not None:
        rng = family_rng(spec.seed, "burst")
        amp = 10.0 ** float(_draw(rng, spec.burst["log10_amp"]))
        t0 = start_s + float(_draw(rng, spec.burst.get("t0_frac", 0.5))) * span_s
        width = float(_draw(rng, spec.burst.get("width_frac", 0.05))) * span_s
        ngrid = int(spec.burst.get("ngrid", 256))
        g0 = max(start_s, t0 - 5.0 * width)
        g1 = min(stop_s, t0 + 5.0 * width)
        tg = np.linspace(g0, g1, ngrid)
        hp, hc = _sine_gaussian(tg, t0, width, amp, rng)
        kwargs["burst_sky"] = np.array([
            np.arccos(rng.uniform(-1.0, 1.0)),
            rng.uniform(0.0, 2.0 * np.pi),
            rng.uniform(0.0, np.pi),
        ])
        kwargs["burst_hplus"] = hp
        kwargs["burst_hcross"] = hc
        kwargs["burst_grid"] = np.array([g0, g1])

    if spec.memory is not None:
        rng = family_rng(spec.seed, "memory")
        strain = 10.0 ** float(_draw(rng, spec.memory["log10_strain"]))
        t0_frac = float(_draw(rng, spec.memory.get("t0_frac", 0.5)))
        span_days = float((spec.array or {}).get("span_days", 365.25 * 16))
        t0_mjd = float(batch.tref_mjd) + (t0_frac - 0.5) * span_days
        kwargs["gwm_params"] = np.array([
            strain,
            np.arccos(rng.uniform(-1.0, 1.0)),
            rng.uniform(0.0, 2.0 * np.pi),
            rng.uniform(0.0, np.pi),
            t0_mjd,
        ])

    if spec.transient is not None:
        rng = family_rng(spec.seed, "transient")
        amp = 10.0 ** float(_draw(rng, spec.transient["log10_amp"]))
        t0 = start_s + float(_draw(rng, spec.transient.get("t0_frac", 0.5))) * span_s
        width = float(_draw(rng, spec.transient.get("width_frac", 0.05))) * span_s
        ngrid = int(spec.transient.get("ngrid", 256))
        if spec.transient.get("kind", "gaussian") == "glitch":
            # a step offset persists to the end of the data, so the grid
            # window must too (transient_delays zeroes outside it)
            g0 = max(start_s, t0 - width)
            g1 = stop_s
            tg = np.linspace(g0, g1, ngrid)
            wf = amp * (tg >= t0).astype(np.float64)
        else:
            g0 = max(start_s, t0 - 5.0 * width)
            g1 = min(stop_s, t0 + 5.0 * width)
            tg = np.linspace(g0, g1, ngrid)
            wf = amp * np.exp(-0.5 * ((tg - t0) / width) ** 2)
        kwargs["transient_waveform"] = wf
        kwargs["transient_grid"] = np.array([g0, g1])
        kwargs["transient_psr"] = int(spec.transient.get("psr", 0))
        drawn["transient_t0"] = t0

    if spec.covariance is not None:
        rng = family_rng(spec.seed, "covariance")
        cd = dict(spec.covariance)
        if cd.get("preset") == "solar_wind":
            # the chromatic solar-wind shape: correlation across epochs
            # (x) correlation across the observing band
            base = {"kind": "kron", "log10_sigma": -6.6, "channels": 4,
                    "time_ell_days": 20.0, "chan_rho": 0.9, "nugget": 0.05}
            base.update({k: v for k, v in cd.items() if k != "preset"})
            cd = base
        kind = cd["kind"]
        # draw order: log10_sigma first, then the structure parameters
        kwargs["cov_log10_sigma"] = per_psr(rng, cd["log10_sigma"])
        toas = batch.toas_s.cpu().numpy().astype(np.float64)
        mask = batch.mask.cpu().numpy().astype(np.float64)
        host = dict(dtype=batch.dtype, device="cpu")
        if kind == "banded":
            rho = float(_draw(rng, cd.get("rho", 0.5)))
            corr_d = float(_draw(rng, cd.get("corr_days", 30.0)))
            op = banded_from_times(toas, mask, rho=rho, corr_s=corr_d * DAY_IN_SEC,
                                   block=int(cd.get("block", 16)), **host)
        elif kind == "kron":
            ell_d = float(_draw(rng, cd.get("time_ell_days", 20.0)))
            chan_rho = float(_draw(rng, cd.get("chan_rho", 0.8)))
            op = kron_time_channel(toas, channels=int(cd.get("channels", 4)),
                                   time_ell_s=ell_d * DAY_IN_SEC, chan_rho=chan_rho,
                                   nugget=float(cd.get("nugget", 0.05)), mask=mask, **host)
        else:
            corr_d = float(_draw(rng, cd.get("corr_days", 30.0)))
            op = dense_from_times(toas, mask, corr_s=corr_d * DAY_IN_SEC,
                                  nugget=float(cd.get("nugget", 0.05)), **host)
        kwargs["noise_cov"] = op
        drawn["covariance_kind"] = kind

    recipe = Recipe(**kwargs).to(device)
    families = spec_families(spec)
    if spec.population is not None and not drawn.get("population_outliers"):
        # a zero-outlier split injects no CW catalog: the compiled
        # scenario does not claim population_cw coverage
        families = tuple(f for f in families if f != "population_cw")
    return CompiledScenario(
        spec=spec, spec_hash=spec.content_hash, batch=batch, recipe=recipe,
        plan=sweep_plan(spec), families=families, fingerprint=spec.content_hash, drawn=drawn,
    )


def _cw_vec(rng, val, nsrc, log10=False):
    """CW catalog column: distribution draws size nsrc; scalars/lists
    broadcast. ``log10`` raises 10**x AFTER a uniform draw (the spec's
    log10_* parameters draw uniformly in the exponent)."""
    v = _draw(rng, val, size=nsrc)
    v = np.broadcast_to(np.asarray(v, np.float64), (nsrc,)).copy()
    return 10.0**v if log10 else v


def _draw_population(spec, batch):
    """The population section's binaries, drawn from the ``population``
    family in the documented order and split by :func:`split_population`;
    with the seed of the outliers' orientation draws (the family stream's
    next draw)."""
    d = spec.population
    rng = family_rng(spec.seed, "population")
    n = int(d.get("n_binaries", 500))
    # draw order: mtot, mass ratio, redshift, observed frequency
    mtot_g = 10.0 ** _cw_vec(
        rng, d.get("log10_mtot_msun", {"dist": "uniform", "lo": 8.0, "hi": 10.0}), n
    ) * 1.98892e33  # Msun -> grams (cgs rest-frame masses)
    mrat = _cw_vec(rng, d.get("mass_ratio", {"dist": "uniform", "lo": 0.1, "hi": 1.0}), n)
    redz = _cw_vec(rng, d.get("redshift", {"dist": "uniform", "lo": 0.05, "hi": 2.0}), n)
    T_obs = float(batch.stop_s) - float(batch.start_s)
    nbins = int(d.get("nbins", 8))
    fobs_edges = np.geomspace(1.0 / T_obs, (nbins + 1.0) / T_obs, nbins + 1)
    fo = 10.0 ** rng.uniform(np.log10(fobs_edges[0]), np.log10(fobs_edges[-1]), n)
    split = split_population([mtot_g, mrat, redz, fo], np.ones(n), fobs_edges, T_obs,
                             outlier_per_bin=int(d.get("outlier_per_bin", 2)))
    return split, int(rng.integers(0, 2**31 - 1))


def _compile_population(spec, batch, kwargs, drawn):
    """SMBHB population section: the remainder of the split as a
    free-spectrum GWB, the loudest binaries as the CW catalog
    (:func:`population_recipe`). Returns the kwargs with the population's
    fields, on the host."""
    d = spec.population
    split, orientation_seed = _draw_population(spec, batch)
    drawn["population_outliers"] = int(split.outlier_fo.shape[0])
    chol = _orf_cholesky(d.get("orf", "hd"), batch, path="population.orf")
    rec = population_recipe(
        None, None, None, None,
        orf_cholesky=chol if chol is not None else np.sqrt(2.0) * np.eye(batch.npsr),
        seed=orientation_seed,
        howml=float(d.get("howml", 10.0)),
        gwb_npts=int(d.get("npts", 600)),
        base_recipe=Recipe(**kwargs),
        split=split,
        device="cpu",
    )
    # population_recipe returns a whole Recipe; the burst, memory and
    # transient sections continue from the kwargs
    return dict(vars(rec))


# ------------------------------------------------------ flagship preset

#: the JAX package's realization-stream version (its STREAM_VERSION),
#: hashed into the workload fingerprint so that both packages name the
#: same workload by the same fingerprint
WORKLOAD_STREAM_VERSION = 4


def random_cw_catalog(rng, ncw: int) -> np.ndarray:
    """(8, ncw) CW-catalog parameter stack in the order gwtheta, gwphi,
    mc [Msun], dist [Mpc], fgw [Hz], phase0, psi, inc — realistic SMBHB
    outlier ranges."""
    return np.stack(
        [
            np.arccos(rng.uniform(-1, 1, ncw)),
            rng.uniform(0, 2 * np.pi, ncw),
            10 ** rng.uniform(8, 9.5, ncw),
            rng.uniform(50, 1000, ncw),
            10 ** rng.uniform(-8.8, -7.6, ncw),
            rng.uniform(0, 2 * np.pi, ncw),
            rng.uniform(0, np.pi, ncw),
            np.arccos(rng.uniform(-1, 1, ncw)),
        ]
    )


def flagship_workload(npsr: int = 68, ntoa: int = 7758, nbackend: int = 4,
                      ncw: int = 100, with_fingerprint: bool = False,
                      dtype=torch.float32, device="cuda"):
    """The flagship realization workload: an NG15-scale synthetic batch
    (``dtype``) and a recipe with per-backend EFAC/EQUAD/ECORR, 30-mode
    red noise, a Hellings-Downs GWB (npts=600, howml=10) and an
    ``ncw``-source CW catalog, all on ``device``.

    The RNG call order below is the workload's definition.
    ``with_fingerprint=True`` also returns the content hash of the build
    parameters and of every host draw feeding the recipe."""
    device = resolve_device(device)
    batch = synthetic_batch(npsr=npsr, ntoa=ntoa, nbackend=nbackend, seed=0,
                            dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    orf = hellings_downs_matrix(_pulsar_locs(batch))
    draws = {
        "cgw_params": random_cw_catalog(rng, ncw),
        "efac": rng.uniform(0.9, 1.3, (npsr, nbackend)),
        "log10_equad": rng.uniform(-7.5, -6.0, (npsr, nbackend)),
        "log10_ecorr": rng.uniform(-7.5, -6.3, (npsr, nbackend)),
        "rn_log10_amplitude": rng.uniform(-14.5, -13.0, npsr),
        "rn_gamma": rng.uniform(2.0, 5.0, npsr),
        "orf_cholesky": np.linalg.cholesky(np.asarray(orf, np.float64)),
    }
    recipe = Recipe(
        **draws,
        gwb_log10_amplitude=np.array(-14.0),
        gwb_gamma=np.array(4.33),
        gwb_npts=600,
        gwb_howml=10.0,
        cgw_chunk=100,
    ).to(device)
    if not with_fingerprint:
        return batch, recipe

    h = hashlib.sha256()
    h.update(
        f"npsr={npsr};ntoa={ntoa};nbackend={nbackend};ncw={ncw};"
        f"seed=0;stream={WORKLOAD_STREAM_VERSION}".encode()
    )
    for name in sorted(draws):
        h.update(name.encode())
        h.update(np.ascontiguousarray(draws[name]).tobytes())
    return batch, recipe, h.hexdigest()[:16]


#: the families' amplitudes: the port's choice (the reference's compiler
#: takes each ``log10_amp``/``log10_strain`` from the spec, with no default)
BURST_LOG10_AMP, MEMORY_LOG10_STRAIN, TRANSIENT_LOG10_AMP = -7.0, -13.0, -6.5
#: the reference compiler's defaults: epoch and width as fractions of the
#: span, waveform grid points, and the array span behind the memory's epoch
T0_FRAC, WIDTH_FRAC, NGRID, SPAN_DAYS = 0.5, 0.05, 256, 365.25 * 16


def deterministic_families(batch, seed: int = 0, transient_psr: int = 0) -> dict:
    """Recipe fields of one burst, one burst with memory and one Gaussian
    transient (in pulsar ``transient_psr``), drawn as the reference's
    compiler draws them (``pta_replicator_tpu/scenarios/compile.py``, its
    burst, memory and transient sections at their default ``t0_frac``,
    ``width_frac`` and ``ngrid``): the sine-Gaussian burst with its sky
    and polarization, the memory's sky and polarization at epoch t0, the
    transient on a window of +-5 widths. Float64 numpy arrays; each family
    from ``np.random.default_rng((seed, family))``."""
    start_s, stop_s = float(batch.start_s), float(batch.stop_s)
    span_s = stop_s - start_s
    t0 = start_s + T0_FRAC * span_s
    width = WIDTH_FRAC * span_s
    g0, g1 = max(start_s, t0 - 5.0 * width), min(stop_s, t0 + 5.0 * width)
    tg = np.linspace(g0, g1, NGRID)

    rng = np.random.default_rng((seed, 0))
    hp, hc = _sine_gaussian(tg, t0, width, 10.0**BURST_LOG10_AMP, rng)
    burst_sky = np.array([np.arccos(rng.uniform(-1.0, 1.0)), rng.uniform(0.0, 2.0 * np.pi),
                          rng.uniform(0.0, np.pi)])
    rng = np.random.default_rng((seed, 1))
    t0_mjd = float(batch.tref_mjd) + (T0_FRAC - 0.5) * SPAN_DAYS
    gwm = np.array([10.0**MEMORY_LOG10_STRAIN, np.arccos(rng.uniform(-1.0, 1.0)),
                    rng.uniform(0.0, 2.0 * np.pi), rng.uniform(0.0, np.pi), t0_mjd])
    wf = 10.0**TRANSIENT_LOG10_AMP * np.exp(-0.5 * ((tg - t0) / width) ** 2)
    return dict(gwm_params=gwm, burst_sky=burst_sky, burst_hplus=hp, burst_hcross=hc,
                burst_grid=np.array([g0, g1]), transient_waveform=wf,
                transient_grid=np.array([g0, g1]), transient_psr=int(transient_psr))
