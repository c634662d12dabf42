"""Declarative scenario layer: spec -> compile.

Counterpart of ``pta_replicator_tpu/scenarios`` without its differential
fuzz harness (ROADMAP A.15):

* :mod:`.spec`: versioned, JSON/TOML-serializable
  :class:`~.spec.ScenarioSpec` with early field-naming validation and a
  content hash for provenance;
* :mod:`.compile`: the deterministic, ``fold_in``-seeded compiler spec ->
  (PulsarBatch, Recipe, SweepPlan) on a device, and the ``bench_flagship``
  preset (``specs/flagship.json``).

CLI: ``python -m pta_replicator_tpu_torch scenario {validate,compile,run}``.
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
from .spec import SCENARIO_SPEC_VERSION, ScenarioSpec, SpecError, load_spec

__all__ = [
    "SCENARIO_SPEC_VERSION", "ScenarioSpec", "SpecError", "load_spec",
    "CompiledScenario", "SweepPlan", "compile_spec", "family_key",
    "family_rng", "flagship_workload", "random_cw_catalog",
    "spec_families",
]
