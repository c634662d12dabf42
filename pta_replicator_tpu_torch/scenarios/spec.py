"""Declarative, versioned scenario specifications.

Counterpart of ``pta_replicator_tpu/scenarios/spec.py``, copied so that
the port imports nothing of the JAX package (it is stdlib only): the same
schema, the same validation messages, field names included, and the same
canonical form, so a spec has the same ``content_hash`` in both packages.

A :class:`ScenarioSpec` is the serializable description of ONE synthetic
PTA dataset: pulsar-array geometry and cadence, the noise structure
(white / ECORR / achromatic / chromatic red), the GW content (power-law
or turnover or free-spectrum GWB under an HD / uncorrelated /
anisotropic ORF, SMBHB population splits, CW catalogs, bursts, bursts
with memory), per-pulsar transients and glitch step offsets, the
streamed-CW knobs, a structured noise covariance, and a sweep plan. The
compiler (:mod:`.compile`) turns a validated spec into the
``(PulsarBatch, Recipe, SweepPlan)`` triple the rest of the port consumes.

* **Validated early, by field name.** ``spec.validate()`` (run by the
  compiler and the CLI) rejects unknown sections, unknown keys, wrong
  types, out-of-range values, and mutually inconsistent sections with a
  message naming the offending dotted path (``gwb.orf.lmax``).
* **Serializable both ways.** ``to_dict``/``from_dict`` round-trip
  losslessly through JSON (TOML is accepted on load via stdlib
  ``tomllib``), and :meth:`ScenarioSpec.content_hash` is a stable digest
  of the canonical JSON form: two specs with the same hash compile to
  the same workload, so the hash is the provenance stamp the sweep
  sidecar carries.
* **Numeric leaves may be distributions.** Any numeric parameter may be
  a scalar, a list (explicit per-pulsar values), or a ``{"dist": ...}``
  object drawn at compile time from the scenario's own fold_in-derived
  key (see :mod:`.compile` for the seed discipline).
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional

#: bump when the spec schema changes incompatibly; readers refuse specs
#: stamped newer than they know (same convention as the evidence JSONs)
SCENARIO_SPEC_VERSION = 1

#: distribution kinds a numeric leaf may request, with required params
DIST_KINDS = {
    "uniform": ("lo", "hi"),
    "loguniform": ("lo", "hi"),  # uniform in log10 between log10(lo/hi)
    "normal": ("mean", "sd"),
}


class SpecError(ValueError):
    """A scenario spec failed validation; the message names the field."""


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _check_value(path: str, val, *, lo=None, hi=None, allow_dist=True,
                 allow_list=False):
    """Validate one numeric leaf: scalar, list, or distribution object."""
    if isinstance(val, dict):
        if not allow_dist:
            raise SpecError(f"{path}: a distribution is not allowed here")
        kind = val.get("dist")
        if kind not in DIST_KINDS:
            raise SpecError(
                f"{path}.dist must be one of {sorted(DIST_KINDS)}, "
                f"got {kind!r}"
            )
        required = DIST_KINDS[kind]
        extra = set(val) - {"dist", *required}
        if extra:
            raise SpecError(
                f"{path}: unknown distribution key(s) {sorted(extra)} "
                f"(a {kind} draw takes {list(required)})"
            )
        for p in required:
            if p not in val:
                raise SpecError(f"{path}: {kind} draw needs {p!r}")
            if not _is_num(val[p]):
                raise SpecError(f"{path}.{p} must be a number")
        if kind in ("uniform", "loguniform") and val["lo"] > val["hi"]:
            raise SpecError(f"{path}: lo must be <= hi")
        if kind == "loguniform" and val["lo"] <= 0:
            raise SpecError(f"{path}: loguniform needs lo > 0")
        if kind == "normal" and val["sd"] < 0:
            raise SpecError(f"{path}.sd must be >= 0")
        return
    if isinstance(val, list):
        if not allow_list:
            raise SpecError(f"{path}: a list is not allowed here")
        if not val or not all(_is_num(v) for v in val):
            raise SpecError(f"{path} must be a non-empty list of numbers")
        vals = val
    elif _is_num(val):
        vals = [val]
    else:
        raise SpecError(
            f"{path} must be a number, a list of numbers, or a "
            f"{{'dist': ...}} object, got {type(val).__name__}"
        )
    for v in vals:
        if lo is not None and v < lo:
            raise SpecError(f"{path} must be >= {lo}, got {v}")
        if hi is not None and v > hi:
            raise SpecError(f"{path} must be <= {hi}, got {v}")


def _check_int(path: str, val, *, lo=None, hi=None):
    if not isinstance(val, int) or isinstance(val, bool):
        raise SpecError(f"{path} must be an integer")
    if lo is not None and val < lo:
        raise SpecError(f"{path} must be >= {lo}, got {val}")
    if hi is not None and val > hi:
        raise SpecError(f"{path} must be <= {hi}, got {val}")


def _check_bool(path: str, val):
    if not isinstance(val, bool):
        raise SpecError(f"{path} must be true or false")


def _check_keys(section: str, d: dict, allowed):
    unknown = set(d) - set(allowed)
    if unknown:
        raise SpecError(
            f"{section}: unknown key(s) {sorted(unknown)} "
            f"(allowed: {sorted(allowed)})"
        )


def _check_psr_list(path: str, val, spec, per_backend: bool = False):
    """Explicit per-pulsar value lists must match array.npsr HERE, not
    as a compile-time shape error (the early-validation contract); and
    they cannot combine with per_backend (a flat list is ambiguous —
    per-backend tables are drawn at compile time)."""
    if not isinstance(val, list):
        return
    if per_backend:
        raise SpecError(
            f"{path}: an explicit value list cannot combine with "
            "per_backend=true (write a scalar or a distribution; the "
            "per-backend table is drawn at compile time)"
        )
    npsr = (spec.array or {}).get("npsr", 4)
    if isinstance(npsr, int) and len(val) != npsr:
        raise SpecError(
            f"{path}: explicit list has {len(val)} value(s) but "
            f"array.npsr = {npsr}"
        )


# The per-section validators.  Each takes (section dict, spec) and
# raises SpecError naming the offending dotted path.

def _v_array(d: dict, spec: "ScenarioSpec"):
    _check_keys("array", d, {
        "npsr", "ntoa", "nbackend", "span_days", "toaerr_s", "epoch_days",
    })
    _check_int("array.npsr", d.get("npsr", 4), lo=1, hi=4096)
    _check_int("array.ntoa", d.get("ntoa", 256), lo=8, hi=10**6)
    _check_int("array.nbackend", d.get("nbackend", 2), lo=1, hi=64)
    _check_value("array.span_days", d.get("span_days", 365.25 * 16),
                 lo=30.0, allow_dist=False)
    _check_value("array.toaerr_s", d.get("toaerr_s", 0.5e-6), lo=1e-9,
                 allow_dist=False)
    _check_value("array.epoch_days", d.get("epoch_days", 14.0), lo=0.1,
                 allow_dist=False)


def _v_white(d: dict, spec):
    _check_keys("white", d, {"efac", "log10_equad", "per_backend",
                             "tnequad"})
    pb = bool(d.get("per_backend", False))
    if "efac" in d:
        _check_value("white.efac", d["efac"], lo=0.0, allow_list=True)
        _check_psr_list("white.efac", d["efac"], spec, pb)
    if "log10_equad" in d:
        _check_value("white.log10_equad", d["log10_equad"], lo=-12.0,
                     hi=0.0, allow_list=True)
        _check_psr_list("white.log10_equad", d["log10_equad"], spec, pb)
    if "efac" not in d and "log10_equad" not in d:
        raise SpecError("white: needs efac and/or log10_equad")
    if "per_backend" in d:
        _check_bool("white.per_backend", d["per_backend"])
    if "tnequad" in d:
        _check_bool("white.tnequad", d["tnequad"])


def _v_ecorr(d: dict, spec):
    _check_keys("ecorr", d, {"log10_ecorr", "per_backend"})
    if "log10_ecorr" not in d:
        raise SpecError("ecorr: needs log10_ecorr")
    _check_value("ecorr.log10_ecorr", d["log10_ecorr"], lo=-12.0, hi=0.0,
                 allow_list=True)
    _check_psr_list("ecorr.log10_ecorr", d["log10_ecorr"], spec,
                    bool(d.get("per_backend", False)))
    if "per_backend" in d:
        _check_bool("ecorr.per_backend", d["per_backend"])


def _v_red(d: dict, spec, section="red"):
    _check_keys(section, d, {"log10_amplitude", "gamma", "nmodes",
                             "index"} if section == "chromatic"
                else {"log10_amplitude", "gamma", "nmodes"})
    for k in ("log10_amplitude", "gamma"):
        if k not in d:
            raise SpecError(f"{section}: needs {k}")
    _check_value(f"{section}.log10_amplitude", d["log10_amplitude"],
                 lo=-20.0, hi=-8.0, allow_list=True)
    _check_psr_list(f"{section}.log10_amplitude", d["log10_amplitude"],
                    spec)
    _check_value(f"{section}.gamma", d["gamma"], lo=0.0, hi=10.0,
                 allow_list=True)
    _check_psr_list(f"{section}.gamma", d["gamma"], spec)
    if "nmodes" in d:
        _check_int(f"{section}.nmodes", d["nmodes"], lo=1, hi=512)
    if section == "chromatic" and "index" in d:
        _check_value("chromatic.index", d["index"], lo=0.0, hi=8.0)


def _v_chromatic(d: dict, spec):
    _v_red(d, spec, section="chromatic")


def _v_orf(path: str, orf):
    if orf in ("hd", "none"):
        return
    if isinstance(orf, dict):
        _check_keys(path, orf, {"lmax", "clm"})
        if "lmax" not in orf:
            raise SpecError(f"{path}: anisotropic ORF needs lmax")
        _check_int(f"{path}.lmax", orf["lmax"], lo=0, hi=8)
        nlm = (orf["lmax"] + 1) ** 2
        clm = orf.get("clm")
        if clm is not None:
            if (not isinstance(clm, list) or len(clm) != nlm
                    or not all(_is_num(c) for c in clm)):
                raise SpecError(
                    f"{path}.clm must be a list of (lmax+1)^2 = {nlm} "
                    "numbers"
                )
        return
    raise SpecError(
        f'{path} must be "hd", "none", or {{"lmax": L, "clm": [...]}}, '
        f"got {orf!r}"
    )


def _v_gwb(d: dict, spec):
    _check_keys("gwb", d, {
        "log10_amplitude", "gamma", "orf", "turnover", "npts", "howml",
        "gls_nmodes",
    })
    if "log10_amplitude" not in d or "gamma" not in d:
        raise SpecError("gwb: needs log10_amplitude and gamma (use the "
                        "population section for a free-spectrum GWB)")
    _check_value("gwb.log10_amplitude", d["log10_amplitude"], lo=-20.0,
                 hi=-10.0)
    _check_value("gwb.gamma", d["gamma"], lo=0.0, hi=10.0)
    _v_orf("gwb.orf", d.get("orf", "hd"))
    if "turnover" in d:
        t = d["turnover"]
        if not isinstance(t, dict):
            raise SpecError("gwb.turnover must be an object")
        _check_keys("gwb.turnover", t, {"f0", "beta", "power"})
        if "f0" in t:
            _check_value("gwb.turnover.f0", t["f0"], lo=1e-12, hi=1e-6)
        if "beta" in t:
            _check_value("gwb.turnover.beta", t["beta"], lo=0.0, hi=10.0)
        if "power" in t:
            _check_value("gwb.turnover.power", t["power"], lo=0.1, hi=10.0)
    if "npts" in d:
        _check_int("gwb.npts", d["npts"], lo=16, hi=100000)
    if "howml" in d:
        _check_value("gwb.howml", d["howml"], lo=1.0, hi=100.0,
                     allow_dist=False)
    if "gls_nmodes" in d:
        _check_int("gwb.gls_nmodes", d["gls_nmodes"], lo=1, hi=512)


def _v_population(d: dict, spec):
    _check_keys("population", d, {
        "n_binaries", "outlier_per_bin", "nbins", "log10_mtot_msun",
        "mass_ratio", "redshift", "orf", "npts", "howml",
    })
    _check_int("population.n_binaries", d.get("n_binaries", 500), lo=1,
               hi=10**7)
    _check_int("population.outlier_per_bin", d.get("outlier_per_bin", 2),
               lo=0, hi=10**4)
    _check_int("population.nbins", d.get("nbins", 8), lo=2, hi=256)
    if "log10_mtot_msun" in d:
        _check_value("population.log10_mtot_msun", d["log10_mtot_msun"],
                     lo=6.0, hi=11.0)
    if "mass_ratio" in d:
        _check_value("population.mass_ratio", d["mass_ratio"], lo=0.01,
                     hi=1.0)
    if "redshift" in d:
        _check_value("population.redshift", d["redshift"], lo=0.0, hi=6.0)
    _v_orf("population.orf", d.get("orf", "hd"))
    if "npts" in d:
        _check_int("population.npts", d["npts"], lo=16, hi=100000)
    if "howml" in d:
        _check_value("population.howml", d["howml"], lo=1.0, hi=100.0,
                     allow_dist=False)
    if spec.gwb is not None:
        raise SpecError(
            "population and gwb are mutually exclusive: the population "
            "split already injects its free-spectrum GWB (drop the gwb "
            "section, or drop population and keep the power law)"
        )
    if spec.cw is not None:
        raise SpecError(
            "population and cw are mutually exclusive: the population "
            "split already injects its loudest binaries as the CW "
            "catalog (drop the cw section)"
        )


def _v_cw(d: dict, spec):
    _check_keys("cw", d, {
        "nsrc", "log10_mc_msun", "dist_mpc", "log10_fgw_hz", "pdist_kpc",
        "psr_term", "evolve", "stream_chunk", "prefetch_depth",
    })
    _check_int("cw.nsrc", d.get("nsrc", 1), lo=1, hi=10**8)
    if "log10_mc_msun" in d:
        _check_value("cw.log10_mc_msun", d["log10_mc_msun"], lo=6.0,
                     hi=11.0)
    if "dist_mpc" in d:
        _check_value("cw.dist_mpc", d["dist_mpc"], lo=1.0, hi=10**5)
    if "log10_fgw_hz" in d:
        _check_value("cw.log10_fgw_hz", d["log10_fgw_hz"], lo=-9.5,
                     hi=-6.5)
    if "pdist_kpc" in d:
        _check_value("cw.pdist_kpc", d["pdist_kpc"], lo=0.01, hi=100.0)
    for k in ("psr_term", "evolve"):
        if k in d:
            _check_bool(f"cw.{k}", d[k])
    if "stream_chunk" in d:
        _check_int("cw.stream_chunk", d["stream_chunk"], lo=1)
    if "prefetch_depth" in d:
        _check_int("cw.prefetch_depth", d["prefetch_depth"], lo=1, hi=64)


def _v_burst(d: dict, spec):
    _check_keys("burst", d, {"log10_amp", "t0_frac", "width_frac",
                             "ngrid"})
    if "log10_amp" not in d:
        raise SpecError("burst: needs log10_amp")
    _check_value("burst.log10_amp", d["log10_amp"], lo=-20.0, hi=0.0)
    _check_value("burst.t0_frac", d.get("t0_frac", 0.5), lo=0.0, hi=1.0)
    _check_value("burst.width_frac", d.get("width_frac", 0.05), lo=1e-4,
                 hi=1.0)
    if "ngrid" in d:
        _check_int("burst.ngrid", d["ngrid"], lo=16, hi=10**6)


def _v_memory(d: dict, spec):
    _check_keys("memory", d, {"log10_strain", "t0_frac"})
    if "log10_strain" not in d:
        raise SpecError("memory: needs log10_strain")
    _check_value("memory.log10_strain", d["log10_strain"], lo=-22.0,
                 hi=-8.0)
    _check_value("memory.t0_frac", d.get("t0_frac", 0.5), lo=0.0, hi=1.0)


def _v_transient(d: dict, spec):
    _check_keys("transient", d, {"psr", "kind", "log10_amp", "t0_frac",
                                 "width_frac", "ngrid"})
    if "log10_amp" not in d:
        raise SpecError("transient: needs log10_amp")
    _check_int("transient.psr", d.get("psr", 0), lo=0)
    kind = d.get("kind", "gaussian")
    if kind not in ("gaussian", "glitch"):
        raise SpecError(
            f'transient.kind must be "gaussian" (incoherent bump) or '
            f'"glitch" (step offset), got {kind!r}'
        )
    _check_value("transient.log10_amp", d["log10_amp"], lo=-20.0, hi=0.0)
    _check_value("transient.t0_frac", d.get("t0_frac", 0.5), lo=0.0,
                 hi=1.0)
    _check_value("transient.width_frac", d.get("width_frac", 0.05),
                 lo=1e-4, hi=1.0)
    if "ngrid" in d:
        _check_int("transient.ngrid", d["ngrid"], lo=16, hi=10**6)
    npsr = (spec.array or {}).get("npsr", 4)
    if isinstance(npsr, int) and d.get("psr", 0) >= npsr:
        raise SpecError(
            f"transient.psr = {d.get('psr', 0)} is out of range for "
            f"array.npsr = {npsr}"
        )


#: structure-specific covariance keys, by kind (shared keys aside)
_COV_KIND_KEYS = {
    "banded": {"rho", "corr_days", "block"},
    "kron": {"channels", "time_ell_days", "chan_rho", "nugget"},
    "dense": {"corr_days", "nugget"},
}
_COV_PRESETS = ("solar_wind",)


def _v_covariance(d: dict, spec):
    """Beyond-diagonal correlated-noise section: a structured CovOp
    (banded inter-epoch / Kronecker time-channel / dense temporal)
    sampled into every realization and priced by the covariance-aware
    GLS/likelihood paths (docs/covariance.md)."""
    _check_keys("covariance", d, {
        "kind", "preset", "log10_sigma",
        *_COV_KIND_KEYS["banded"], *_COV_KIND_KEYS["kron"],
        *_COV_KIND_KEYS["dense"],
    })
    preset = d.get("preset")
    if preset is not None and preset not in _COV_PRESETS:
        raise SpecError(
            f"covariance.preset must be one of {list(_COV_PRESETS)}, "
            f"got {preset!r}"
        )
    kind = d.get("kind", "kron" if preset == "solar_wind" else None)
    if kind not in _COV_KIND_KEYS:
        raise SpecError(
            'covariance.kind must be "banded", "kron", or "dense" '
            f"(or use preset: solar_wind), got {kind!r}"
        )
    if preset == "solar_wind" and kind != "kron":
        raise SpecError(
            "covariance.kind: the solar_wind preset IS the Kronecker "
            "time-channel structure; drop kind or set it to kron"
        )
    if "log10_sigma" not in d and preset is None:
        raise SpecError("covariance: needs log10_sigma (the correlated-"
                        "noise amplitude; presets carry a default)")
    if "log10_sigma" in d:
        _check_value("covariance.log10_sigma", d["log10_sigma"],
                     lo=-12.0, hi=0.0, allow_list=True)
        _check_psr_list("covariance.log10_sigma", d["log10_sigma"], spec)
    wrong = set(d) & set().union(*(
        v for k, v in _COV_KIND_KEYS.items() if k != kind
    )) - _COV_KIND_KEYS[kind]
    if wrong:
        raise SpecError(
            f"covariance: key(s) {sorted(wrong)} do not apply to kind "
            f"{kind!r} (accepted: {sorted(_COV_KIND_KEYS[kind])})"
        )
    if "rho" in d:
        _check_value("covariance.rho", d["rho"], lo=0.0, hi=0.95)
    if "corr_days" in d:
        _check_value("covariance.corr_days", d["corr_days"], lo=0.1,
                     hi=10000.0)
    if "block" in d:
        _check_int("covariance.block", d["block"], lo=2, hi=256)
    if "channels" in d:
        _check_int("covariance.channels", d["channels"], lo=2, hi=64)
    if kind == "kron":
        # the divisibility contract must hold for the DEFAULT channel
        # count too (the solar_wind preset's 4), not just an explicit
        # key — a miss here must be a named SpecError at validate
        # time, never a raw compile-time ValueError
        channels = d.get("channels", 4)
        ntoa = (spec.array or {}).get("ntoa", 256)
        if isinstance(ntoa, int) and isinstance(channels, int) \
                and ntoa % channels:
            raise SpecError(
                f"covariance.channels = {channels} must divide "
                f"array.ntoa = {ntoa} (the Kronecker structure needs a "
                "full (epochs x channels) TOA grid)"
            )
    if "time_ell_days" in d:
        _check_value("covariance.time_ell_days", d["time_ell_days"],
                     lo=0.1, hi=10000.0)
    if "chan_rho" in d:
        _check_value("covariance.chan_rho", d["chan_rho"], lo=0.0,
                     hi=0.95)
    if "nugget" in d:
        _check_value("covariance.nugget", d["nugget"], lo=1e-4, hi=1.0)


def _v_sweep(d: dict, spec):
    _check_keys("sweep", d, {"nreal", "chunk", "pipeline_depth", "fit"})
    nreal = d.get("nreal", 16)
    chunk = d.get("chunk", nreal)
    _check_int("sweep.nreal", nreal, lo=1)
    _check_int("sweep.chunk", chunk, lo=1)
    if nreal % chunk:
        raise SpecError(
            f"sweep.nreal = {nreal} must be a multiple of sweep.chunk = "
            f"{chunk} (utils.sweep's chunking contract)"
        )
    if "pipeline_depth" in d:
        _check_int("sweep.pipeline_depth", d["pipeline_depth"], lo=1,
                   hi=64)
    if "fit" in d:
        _check_bool("sweep.fit", d["fit"])


#: section name -> validator; also the canonical section order
SECTIONS = {
    "array": _v_array,
    "white": _v_white,
    "ecorr": _v_ecorr,
    "red": _v_red,
    "chromatic": _v_chromatic,
    "gwb": _v_gwb,
    "population": _v_population,
    "cw": _v_cw,
    "burst": _v_burst,
    "memory": _v_memory,
    "transient": _v_transient,
    "covariance": _v_covariance,
    "sweep": _v_sweep,
}

#: presets the compiler resolves procedurally instead of section by
#: section (the flagship bench workload keeps its exact legacy RNG call
#: order — and therefore its fingerprint — through this escape hatch),
#: with the parameter keys each accepts (validated here, so a
#: misspelled preset param is a named SpecError at validate time, not
#: a TypeError deep inside compile)
PRESETS = ("bench_flagship",)
PRESET_PARAMS = {
    "bench_flagship": frozenset({
        "npsr", "ntoa", "nbackend", "ncw", "cgw_backend",
        "gwb_synthesis_precision",
    }),
}


@dataclass
class ScenarioSpec:
    """One declarative scenario. All sections optional except ``array``
    (a preset spec needs neither). ``seed`` is the scenario's identity
    in PRNG space: every compile-time draw derives from
    ``fold_in(PRNGKey(seed), family)`` (see :mod:`.compile`), so two
    specs with equal content compile identically in any process, and a
    fuzz run's scenario K is unaffected by scenarios 0..K-1."""

    name: str = "scenario"
    seed: int = 0
    scenario_version: int = SCENARIO_SPEC_VERSION
    preset: Optional[str] = None
    preset_params: dict = field(default_factory=dict)
    array: Optional[dict] = None
    white: Optional[dict] = None
    ecorr: Optional[dict] = None
    red: Optional[dict] = None
    chromatic: Optional[dict] = None
    gwb: Optional[dict] = None
    population: Optional[dict] = None
    cw: Optional[dict] = None
    burst: Optional[dict] = None
    memory: Optional[dict] = None
    transient: Optional[dict] = None
    covariance: Optional[dict] = None
    sweep: Optional[dict] = None

    # ------------------------------------------------------- validation
    def validate(self) -> "ScenarioSpec":
        """Check the whole spec; raise :class:`SpecError` naming the
        offending field. Returns self so call sites can chain."""
        if not isinstance(self.name, str) or not self.name:
            raise SpecError("name must be a non-empty string")
        _check_int("seed", self.seed, lo=0)
        _check_int("scenario_version", self.scenario_version, lo=1)
        if self.scenario_version > SCENARIO_SPEC_VERSION:
            raise SpecError(
                f"scenario_version {self.scenario_version} is newer than "
                f"this reader ({SCENARIO_SPEC_VERSION}); upgrade before "
                "compiling"
            )
        if self.preset is not None:
            if self.preset not in PRESETS:
                raise SpecError(
                    f"preset must be one of {list(PRESETS)}, got "
                    f"{self.preset!r}"
                )
            if not isinstance(self.preset_params, dict):
                raise SpecError("preset_params must be an object")
            unknown = set(self.preset_params) - PRESET_PARAMS[self.preset]
            if unknown:
                raise SpecError(
                    f"preset_params: unknown key(s) {sorted(unknown)} "
                    f"for preset {self.preset!r} (accepted: "
                    f"{sorted(PRESET_PARAMS[self.preset])})"
                )
            for sec in SECTIONS:
                if getattr(self, sec) is not None:
                    raise SpecError(
                        f"a preset spec must not also carry the {sec!r} "
                        "section (the preset builds the whole workload)"
                    )
            return self
        if self.array is None:
            raise SpecError("array section is required (or use a preset)")
        for sec, validator in SECTIONS.items():
            d = getattr(self, sec)
            if d is None:
                continue
            if not isinstance(d, dict):
                raise SpecError(f"{sec} must be an object")
            validator(d, self)
        if not any(
            getattr(self, sec) is not None for sec in SECTIONS
            if sec not in ("array", "sweep")
        ):
            raise SpecError(
                "spec enables no signal family at all (add white/red/"
                "gwb/... — an empty scenario realizes exact zeros)"
            )
        return self

    # ---------------------------------------------------- serialization
    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "seed": self.seed,
            "scenario_version": self.scenario_version,
        }
        if self.preset is not None:
            out["preset"] = self.preset
            if self.preset_params:
                out["preset_params"] = self.preset_params
        for sec in SECTIONS:
            d = getattr(self, sec)
            if d is not None:
                out[sec] = d
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        if not isinstance(d, dict):
            raise SpecError(f"a spec must be an object, got "
                            f"{type(d).__name__}")
        known = {"name", "seed", "scenario_version", "preset",
                 "preset_params", *SECTIONS}
        unknown = set(d) - known
        if unknown:
            raise SpecError(
                f"unknown top-level key(s) {sorted(unknown)} "
                f"(sections: {sorted(SECTIONS)})"
            )
        return cls(
            name=d.get("name", "scenario"),
            seed=d.get("seed", 0),
            scenario_version=d.get("scenario_version",
                                   SCENARIO_SPEC_VERSION),
            preset=d.get("preset"),
            preset_params=d.get("preset_params", {}),
            **{sec: d.get(sec) for sec in SECTIONS},
        )

    def canonical_json(self) -> str:
        """Canonical serialized form: sorted keys, no whitespace
        variance — the hashing/replay representation."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @property
    def content_hash(self) -> str:
        """16-hex digest of the canonical form — the provenance stamp
        carried by sweep sidecars and fuzz artifacts."""
        return hashlib.sha256(
            self.canonical_json().encode()
        ).hexdigest()[:16]

    def save(self, path: str) -> str:
        """Write the spec as pretty JSON (atomically)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return path


def load_spec(path: str) -> ScenarioSpec:
    """Load a spec from ``.json`` or ``.toml`` and validate it.

    Every load failure — missing file, malformed JSON/TOML — surfaces
    as a :class:`SpecError` naming the file, so CLI callers (which
    catch SpecError into a named exit) never print a raw traceback for
    a bad input file."""
    try:
        return _load_spec_inner(path)
    except SpecError:
        raise
    except OSError as exc:
        raise SpecError(f"{path}: cannot read spec file ({exc})")
    except ValueError as exc:  # json.JSONDecodeError / TOMLDecodeError
        raise SpecError(f"{path}: malformed spec file ({exc})")


def _load_spec_inner(path: str) -> ScenarioSpec:
    if path.endswith(".toml"):
        try:
            import tomllib
        except ImportError:  # Python < 3.11: stdlib tomllib absent
            try:
                import tomli as tomllib
            except ImportError:
                raise SpecError(
                    f"{path}: TOML specs need Python >= 3.11 (stdlib "
                    "tomllib) or the tomli package; re-save the spec "
                    "as JSON (the schema is identical)"
                )
        with open(path, "rb") as fh:
            d = tomllib.load(fh)
    else:
        with open(path) as fh:
            d = json.load(fh)
    return ScenarioSpec.from_dict(d).validate()
