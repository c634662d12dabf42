"""Declarative scenario layer: spec -> compile -> differential fuzz.

Counterpart of ``pta_replicator_tpu/scenarios``:

* :mod:`.spec`: versioned, JSON/TOML-serializable
  :class:`~.spec.ScenarioSpec` with early field-naming validation and a
  content hash for provenance;
* :mod:`.compile`: the deterministic, ``fold_in``-seeded compiler spec ->
  (PulsarBatch, Recipe, SweepPlan) on a device, and the ``bench_flagship``
  preset (``specs/flagship.json``);
* :mod:`.fuzz`: the property-based differential fuzz harness (random
  scenarios, batched engine vs the per-pulsar oracle path under shared
  draws, per-family tolerances, the shrinker, replayable failing specs);
  the package's ``fuzz`` is this module, its entry point ``fuzz.fuzz``, as in
  the JAX package.

CLI: ``python -m pta_replicator_tpu_torch scenario
{validate,compile,run,fuzz,replay}``.
"""
from __future__ import annotations

from .compile import (
    CompiledScenario,
    SweepPlan,
    compile_spec,
    family_key,
    family_rng,
    flagship_workload,
    random_cw_catalog,
    spec_families,
)
from . import fuzz
from .fuzz import (
    FAMILY_TOLERANCES,
    DiffResult,
    replay,
    run_scenario,
    sample_spec,
    shrink,
)
from .spec import SCENARIO_SPEC_VERSION, ScenarioSpec, SpecError, load_spec

__all__ = [
    "SCENARIO_SPEC_VERSION", "ScenarioSpec", "SpecError", "load_spec",
    "CompiledScenario", "SweepPlan", "compile_spec", "family_key",
    "family_rng", "flagship_workload", "random_cw_catalog",
    "spec_families", "FAMILY_TOLERANCES", "DiffResult", "fuzz",
    "replay", "run_scenario", "sample_spec", "shrink",
]
