"""The port's launch-plan tuner (``likelihood/tuner.py``) on the CPU, as
the reference's tuner tests hold its cache: a hit returns the tuned knob,
a miss, a wrong-schema file and garbage read as no cache; the search
writes what the lookup reads; and without a cache the fused build gives
today's bits."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.models.batched import Recipe
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch.likelihood import gp as tgp
from pta_replicator_tpu_torch.likelihood import infer as tinfer
from pta_replicator_tpu_torch.likelihood import tuner
from pta_replicator_tpu_torch.ops import gp as ops_gp


@pytest.fixture(scope="module")
def setup():
    batch = synthetic_batch(npsr=6, ntoa=180, nbackend=2, seed=3, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    recipe = Recipe(
        efac=jnp.asarray(rng.uniform(0.9, 1.4, (6, 2))),
        log10_ecorr=jnp.asarray(rng.uniform(-6.9, -6.4, (6, 2))),
        rn_log10_amplitude=jnp.asarray(rng.uniform(-13.8, -13.2, 6)),
        rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, 6)), rn_nmodes=8,
        gwb_log10_amplitude=jnp.asarray(-14.2), gwb_gamma=jnp.asarray(13.0 / 3.0),
        gwb_gls_nmodes=6)
    tb = convert.batch_from_arrays(vars(batch), device="cpu")
    tr = convert.recipe_from_arrays(vars(recipe), device="cpu")
    res = np.random.default_rng(11).standard_normal(tuple(tb.mask.shape)) * 1e-6
    return tb, tr, res


@pytest.fixture
def no_env_cache(monkeypatch, tmp_path):
    """The default cache points into an empty temporary directory."""
    monkeypatch.setenv("PTA_GP_TUNER_CACHE", str(tmp_path / "default.json"))
    return tmp_path / "default.json"


def _basis(npsr=6, ntoa=180, q=5, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(0).standard_normal((npsr, ntoa, q))).to(dtype)


def test_tuner_cache_hit_miss_and_corruption(tmp_path):
    T = _basis()
    path = str(tmp_path / "cache.json")
    assert tuner.woodbury_knob(T, cache_path=path) == {}  # miss: no file
    key = tuner.fingerprint("plain", tuner.shape_bucket(6, 180), T.dtype, "highest", "cpu")
    tuner.save_cache({key: {"tile": 128}}, cache_path=path)
    assert tuner.woodbury_knob(T, cache_path=path) == {"tile": 128}  # hit
    # another kernel variant misses the same entry: precision, dtype
    assert tuner.woodbury_knob(T, "bf16", cache_path=path) == {}
    assert tuner.woodbury_knob(T.float(), cache_path=path) == {}
    (tmp_path / "cache.json").write_text(json.dumps({"schema": -1, "entries": {key: {"tile": 128}}}))
    assert tuner.woodbury_knob(T, cache_path=path) == {}  # wrong schema
    assert tuner.load_cache(path) == {}
    (tmp_path / "cache.json").write_text("{not json")
    assert tuner.woodbury_knob(T, cache_path=path) == {}  # garbage
    (tmp_path / "cache.json").write_text(json.dumps({"schema": tuner.TUNER_SCHEMA_VERSION,
                                                     "entries": {key: {"tile": "big"}}}))
    assert tuner.woodbury_knob(T, cache_path=path) == {}  # not an int


def test_save_cache_merges_and_leaves_no_temporary(tmp_path):
    path = str(tmp_path / "cache.json")
    tuner.save_cache({"a": {"tile": 128}}, cache_path=path)
    tuner.save_cache({"b": {"tile": 512}}, cache_path=path)
    assert tuner.load_cache(path) == {"a": {"tile": 128}, "b": {"tile": 512}}
    assert [p.name for p in tmp_path.iterdir()] == ["cache.json"]


def test_autotune_writes_cache_the_lookup_reads(tmp_path):
    T = _basis()
    w = torch.ones(T.shape[:2], dtype=T.dtype)
    r = torch.zeros(T.shape[:2], dtype=T.dtype)
    path = str(tmp_path / "cache.json")
    choice = tuner.autotune(T, w, r, candidates=(32, 64), reps=1, cache_path=path)
    assert choice["tile"] in (32, 64) and choice["route"] == "plain"
    assert [s["tile"] for s in choice["scored"]] == [32, 64]
    assert tuner.woodbury_knob(T, cache_path=path) == {"tile": choice["tile"]}
    # the default candidates are the reference's
    default = tuner.autotune(T, w, r, "bf16", reps=1, cache_path=path, write=False)
    assert default["candidates"] == list(tuner.WOODBURY_CANDIDATES)
    assert tuner.woodbury_knob(T, "bf16", cache_path=path) == {}


def test_shape_bucket_and_fingerprint():
    assert tuner.shape_bucket(68, 7758) == "np128_nt8192"
    assert tuner.shape_bucket(68, 7758, 123) == "np128_nt8192_panels2"
    assert tuner.shape_bucket(68, 7758, 127) == "np128_nt8192_panels2"
    assert tuner.shape_bucket(68, 7758, 128) == "np128_nt8192_panels3"
    keys = {tuner.fingerprint(route, "b", dtype, prec, "cpu")
            for route in ("plain", "cuda") for dtype in (torch.float32, torch.float64)
            for prec in ("highest", "bf16")}
    assert len(keys) == 8
    assert tuner.device_kind("cpu") == "cpu"


def test_build_without_a_cache_gives_todays_bits(setup, no_env_cache):
    """tile=None with no cache is the untuned default tile; a tuned tile
    reaches the plain version through the lookup, as an explicit one."""
    tb, tr, res = setup
    r = torch.from_numpy(res)
    assert not no_env_cache.exists()
    red, proj = tgp.ReducedGP.build_fused(tb, tr, residuals=r)
    red_d, proj_d = tgp.ReducedGP.build_fused(tb, tr, residuals=r, tile=ops_gp.DEFAULT_WOODBURY_TILE)
    assert torch.equal(red.TNT, red_d.TNT) and torch.equal(proj.d, proj_d.d)
    assert torch.equal(proj.rNr, proj_d.rNr)
    T = red.T
    key = tuner.fingerprint("plain", tuner.shape_bucket(*T.shape[:2]), T.dtype, "highest", "cpu")
    tuner.save_cache({key: {"tile": 64}})
    tuned, _ = tgp.ReducedGP.build_fused(tb, tr, residuals=r)
    explicit, _ = tgp.ReducedGP.build_fused(tb, tr, residuals=r, tile=64)
    assert torch.equal(tuned.TNT, explicit.TNT)
    grid = {"rn_log10_amplitude": np.linspace(-14.0, -13.4, 3)}
    a = tinfer.grid_loglikelihood(res, tb, tr, grid, fused=True, device="cpu")
    b = tinfer.grid_loglikelihood(res, tb, tr, grid, fused=True, tile=64, device="cpu")
    assert torch.equal(a, b)


def test_split_candidates_follow_the_plan():
    """On the card the knob is the split count: 1, the plan's, its half
    and double, and one chunk a split, each with no empty split."""
    for npsr, ntoa, q in ((68, 7758, 123), (68, 7758, 286), (3, 100, 7), (1, 5, 40)):
        plan = ops_gp.woodbury_plan(npsr, ntoa, q, 132)[2]
        cands = ops_gp.woodbury_split_candidates(npsr, ntoa, q, 132)
        assert cands[0] == 1 and plan in cands and cands[-1] == ops_gp.woodbury_max_splits(ntoa)
        rows = [-(-ntoa // n) for n in cands]
        assert all((n - 1) * k < ntoa for n, k in zip(cands, rows))
    assert ops_gp.woodbury_split_candidates(68, 7758, 123, 132) == [1, 5, 10, 20, 485]
