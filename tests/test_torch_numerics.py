"""The port's numerics ledger (``obs/numerics.py``) against the JAX
package's: the same probes on the same arrays give the same site records,
the verdict and the report read a document the same way, and the capture
is written whole. CPU; the JAX probes run eagerly (their callback mode)."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.obs import numerics as jnum
from pta_replicator_tpu_torch.obs import numerics as tnum

#: the site record's fields that both packages fill from the same data;
#: max_abs and min_nonzero are exact (one element each), headroom is
#: computed from them by the same formula
FIELDS = ("calls", "elements", "nonfinite", "episodes", "episode_active", "max_abs",
          "min_nonzero", "headroom_bits", "dtype")


@pytest.fixture(autouse=True)
def clean_ledgers():
    tnum.reset()
    jnum.reset()
    yield
    tnum.reset()
    jnum.reset()


def _arrays():
    """float64 and float32 arrays, one past the probe's sample cap, one
    with NaN and inf inside the sample, one all zero."""
    rng = np.random.default_rng(3)
    big = rng.standard_normal(tnum.PROBE_SAMPLE_CAP + 1000) * 1e5
    big[-1] = np.nan  # past the cap: not seen
    bad = rng.standard_normal((7, 13)).astype(np.float32)
    bad[2, 3], bad[5, 1] = np.nan, np.inf
    return {"big": big, "bad": bad, "zero": np.zeros((4, 4)), "tiny": rng.standard_normal(5) * 1e-300}


def _probe_both(name, x):
    tnum.probe(name, torch.from_numpy(x))
    jnum.probe(name, jnp.asarray(x))
    jax.effects_barrier()


def test_disarmed_probe_is_the_identity_and_records_nothing():
    x = torch.arange(6.0)
    assert tnum.probe("a", x) is x
    L = torch.eye(3)
    assert tnum.probe_cholesky("b", L) is L
    assert tnum.snapshot()["sites"] == {}


def test_armed_probes_record_what_jax_records():
    tnum.arm()
    jnum.arm(clear_caches=False)
    for name, x in _arrays().items():
        _probe_both(name, x)
    _probe_both("big", _arrays()["big"][::-1].copy())  # a second call folds in
    tsites, jsites = tnum.snapshot()["sites"], jnum.snapshot()["sites"]
    assert set(tsites) == set(jsites) == {"big", "bad", "zero", "tiny"}
    for site in tsites:
        for field in FIELDS:
            got, want = tsites[site][field], jsites[site][field]
            if isinstance(want, float):
                assert math.isclose(got, want, rel_tol=1e-12), (site, field, got, want)
            else:
                assert got == want, (site, field, got, want)
    assert tsites["big"]["elements"] == 2 * tnum.PROBE_SAMPLE_CAP
    assert tsites["big"]["nonfinite"] == 1  # the reversed copy puts the NaN first
    assert tsites["bad"]["nonfinite"] == 2 and tsites["bad"]["dtype"] == "float32"
    assert tsites["zero"]["headroom_bits"] is None


def test_probe_cholesky_reads_the_diagonal_and_keeps_the_factor():
    tnum.arm()
    L = torch.tensor([[[2.0, 0.0], [5.0, float("nan")]]], dtype=torch.float64)
    assert tnum.probe_cholesky("chol", L) is L
    rec = tnum.snapshot()["sites"]["chol"]
    assert rec["elements"] == 2 and rec["nonfinite"] == 1 and rec["max_abs"] == 2.0


def test_probe_passes_gradients_through():
    tnum.arm()
    x = torch.tensor([1.0, -3.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(tnum.probe("g", x * 2.0) ** 2), x)
    assert torch.equal(g, 8.0 * x.detach())


def test_a_non_finite_episode_clears_after_three_clean_calls():
    tnum.arm()
    tnum.probe("s", torch.tensor([float("nan")]))
    assert tnum.snapshot()["episodes_active"] == ["s"]
    for _ in range(tnum.EPISODE_CLEAR_AFTER):
        tnum.probe("s", torch.tensor([1.0]))
    doc = tnum.snapshot()
    assert doc["episodes_active"] == [] and doc["sites"]["s"]["episodes"] == 1
    assert doc["nonfinite_total"] == 1


def test_disarm_stops_the_ledger_and_reset_clears_it():
    tnum.arm()
    tnum.probe("s", torch.ones(3))
    tnum.disarm()
    tnum.probe("s", torch.ones(3))
    assert tnum.snapshot()["sites"]["s"]["calls"] == 1 and not tnum.is_armed()
    tnum.reset()
    assert tnum.snapshot()["sites"] == {}


def test_arm_from_env():
    assert not tnum.arm_from_env({"PTA_NUMERICS": "0"}) and not tnum.is_armed()
    assert tnum.arm_from_env({"PTA_NUMERICS": "on"}) and tnum.is_armed()


#: documents the verdict must read as the reference does: a clean site, a
#: site past the headroom, one with non-finites, and drift-family sites
#: with and without samples within tolerance
DOCS = [
    {"sites": {}},
    {"schema_version": 1, "sites": {
        "gp.fused_tnt": {"nonfinite": 0, "headroom_bits": 970.0},
        "gp.fused_d": {"nonfinite": 3, "headroom_bits": None},
        "gp.fused_rnr": {"nonfinite": 0, "headroom_bits": 5.5},
        "realization.white": {"nonfinite": 0, "headroom_bits": 100.0},
        "realization.red": {"nonfinite": 0, "headroom_bits": 100.0},
        "cw.stream_tile": {"nonfinite": 0, "headroom_bits": 100.0},
    }, "drift": {"white": {"worst": 1e-9, "tolerance": 1e-6, "samples": 2},
                 "red": {"worst": 1e-3, "tolerance": 1e-6, "samples": 1}}},
]


@pytest.mark.parametrize("doc", DOCS)
@pytest.mark.parametrize("headroom", [8.0, 6.0])
def test_ladder_verdict_reads_a_document_as_jax_does(doc, headroom):
    assert tnum.ladder_verdict(doc, headroom) == jnum.ladder_verdict(doc, headroom)


def test_write_is_whole_and_the_report_matches_jax(tmp_path):
    tnum.arm()
    for name, x in _arrays().items():
        tnum.probe(name, torch.from_numpy(x))
    path = tnum.write(str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == ["numerics.json"]
    doc = json.loads(open(path).read())
    assert doc == json.loads(json.dumps(tnum.snapshot()))
    assert doc["schema_version"] == jnum.NUMERICS_SCHEMA_VERSION == tnum.NUMERICS_SCHEMA_VERSION
    tnum.probe("bad", torch.ones(3))  # clears nothing yet: the episode stays open
    assert tnum.render_report(str(tmp_path)) == jnum.render_report(str(tmp_path)).replace(
        "  (/readyz serves 503 until it clears)", "")
    assert "no numerics.json" in tnum.render_report(str(tmp_path / "missing"))
