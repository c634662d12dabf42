"""The rest of the numerics observatory on the port (``obs/numerics.py``:
collector mode, the drain hook, drift sampling, the heartbeat block) and
its probe sites against the JAX package's on the CPU.

The armed sweep's ledger (``realization.*`` in collector mode, one call a
site a chunk, ``elements`` = slab x realizations; ``drain`` from the host
scan) equals the JAX package's on the same draws (``tests/_torch_parity.py``):
sites, calls, elements, non-finites and episodes exactly, the watermarks
and headroom to rtol 1e-6 in float64 and 1e-4 in float32. The ``cov.*``
sites equal JAX's on small config B- and D-shaped factors (the JAX side
through its ``scan`` and ``xla`` routes), ``cov.tridiag_pivot`` with one
record a block column. ``drift_offset``, ``scan_block`` and
``heartbeat_block`` equal JAX's; a planted NaN is named at ``drain`` alone
and a planted f32 overflow at ``realization.white`` alone; drift sampled
on every chunk stays within the fuzz tolerances and its replayed draws
rebuild cube row 0; the capture passes the JAX schema checker, and each
package's ``numerics report`` reads the other's capture. An armed cube
equals a disarmed one bit for bit."""
import importlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.__main__ import main as jax_main
from pta_replicator_tpu.covariance import kernels as jkernels
from pta_replicator_tpu.faults import inject as jinject
from pta_replicator_tpu.obs import numerics as jnum
from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.covariance import kernels as tkernels
from pta_replicator_tpu_torch.faults import inject
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.obs import REGISTRY, counter, names
from pta_replicator_tpu_torch.obs import numerics as tnum
from pta_replicator_tpu_torch.scenarios.fuzz import FAMILY_TOLERANCES
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe
from pta_replicator_tpu_torch.utils.sweep import sweep

from _torch_dataset import small_pulsars, write_with

jsw = importlib.import_module("pta_replicator_tpu.utils.sweep")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import check_telemetry_schema  # noqa: E402

SHAPE = dict(npsr=3, ntoa=64, ncw=2)
NREAL, CHUNK, SEED = 8, 4, 3
NO_DRIFT = 10**9
#: the record's fields both packages fill from the same data, exactly
EXACT = ("calls", "elements", "nonfinite", "episodes", "episode_active", "dtype")
CLOSE = ("max_abs", "min_nonzero", "headroom_bits")
RTOL = {"float64": 1e-6, "float32": 1e-4}


@pytest.fixture(autouse=True)
def clean():
    for mod in (tnum, jnum):
        mod.reset()
    inject.disarm()
    jinject.disarm()
    yield
    for mod in (tnum, jnum):
        mod.reset()
    inject.disarm()
    jinject.disarm()


def _f32(x):
    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
        return x.astype(jnp.float32)
    return x


@pytest.fixture(scope="module")
def workloads():
    jb, jr = jax_flagship(**SHAPE)
    out = {}
    for name, cast in (("float64", lambda x: x), ("float32", _f32)):
        jbd, jrd = jax.tree_util.tree_map(cast, jb), jax.tree_util.tree_map(cast, jr)
        out[name] = (jbd, jrd, convert.batch_from_arrays(vars(jbd), device="cpu"),
                     convert.recipe_from_arrays(vars(jrd), device="cpu"))
    return out


def _jax_noise(key, jb, jr):
    return lambda i: jax_realize_draws(jax.random.fold_in(key, i), jb, jr, CHUNK)


def _assert_ledgers_equal(tdoc, jdoc, rtol):
    assert set(tdoc["sites"]) == set(jdoc["sites"])
    for site, want in jdoc["sites"].items():
        got = tdoc["sites"][site]
        for field in EXACT:
            assert got[field] == want[field], (site, field, got[field], want[field])
        for field in CLOSE:
            if want[field] is None:
                assert got[field] is None, (site, field)
            else:
                assert math.isclose(got[field], want[field], rel_tol=rtol), (
                    site, field, got[field], want[field])


def _jax_sweep(jb, jr, path, key, **kw):
    return np.asarray(jsw.sweep(key, jb, jr, NREAL, str(path), chunk=CHUNK, reduce_fn=None, **kw))


def _port_sweep(tb, tr, path, **kw):
    return sweep(SEED, tb, tr, NREAL, str(path), chunk=CHUNK, reduce_fn=None, device="cpu", **kw)


# ------------------------------------------------------ the sweep ledger

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_armed_sweep_ledger_equals_jax(workloads, tmp_path, dtype):
    jb, jr, tb, tr = workloads[dtype]
    key = jax.random.PRNGKey(SEED)
    jnum.arm(drift_every=NO_DRIFT)
    _jax_sweep(jb, jr, tmp_path / "jax.npz", key)
    jnum.flush()
    tnum.arm(drift_every=NO_DRIFT)
    _port_sweep(tb, tr, tmp_path / "port.npz", noise=_jax_noise(key, jb, jr))
    tdoc, jdoc = tnum.snapshot(), jnum.snapshot()
    _assert_ledgers_equal(tdoc, jdoc, RTOL[dtype])
    assert {"realization.white", "realization.ecorr", "realization.red", "realization.gwb",
            "drain"} <= set(tdoc["sites"])
    white = tdoc["sites"]["realization.white"]
    assert white["calls"] == NREAL // CHUNK and white["dtype"] == dtype
    assert white["elements"] == SHAPE["npsr"] * SHAPE["ntoa"] * NREAL  # under the slab cap
    assert tdoc["sites"]["drain"]["elements"] == NREAL * SHAPE["npsr"] * SHAPE["ntoa"]


def test_an_armed_cube_equals_a_disarmed_one(workloads, tmp_path):
    _jb, _jr, tb, tr = workloads["float32"]
    a = _port_sweep(tb, tr, tmp_path / "a.npz")
    tnum.arm()
    b = _port_sweep(tb, tr, tmp_path / "b.npz", pipeline_depth=1)
    tnum.disarm()
    c = _port_sweep(tb, tr, tmp_path / "c.npz")
    assert a.tobytes() == b.tobytes() == c.tobytes()
    assert tnum.snapshot()["sites"]["drain"]["calls"] == NREAL // CHUNK


def test_the_collector_reads_nothing_until_the_drain(workloads):
    _jb, _jr, tb, tr = workloads["float64"]
    tnum.arm()
    B.realize(torch.Generator().manual_seed(0), tb, tr, 5, device="cpu")
    # queued, not read: the stats wait for the drain (snapshot folds what is
    # ready, as the drain does)
    assert tnum._SITES == {} and len(tnum._PENDING) == 1
    tnum.flush()
    doc = tnum.snapshot()
    assert not tnum._PENDING and doc["sites"]["realization.gwb"]["calls"] == 1
    assert doc["sites"]["realization.gwb"]["elements"] == 5 * SHAPE["npsr"] * SHAPE["ntoa"]


@pytest.mark.parametrize("shape,slab", [((64, 4096), (1, 1024)), ((3, 400), (2, 400)),
                                        ((3, 64), (3, 64)), ((2000, 1), (1024, 1))])
def test_the_collector_slab_is_jax_s(shape, slab):
    x = torch.ones((2,) + shape)
    assert tuple(tnum._slab(x, 1).shape) == (2,) + slab
    col = jnum.Collector()
    col.add("s", jnp.ones(shape))
    col.take()
    assert jnum._SITE_META["s"][0] == math.prod(slab)


# ------------------------------------------------------------ cov sites

def _spd_blocks(rng, npsr, nb, b):
    """A random SPD block-tridiagonal (D, E) (diagonally dominant)."""
    D = rng.standard_normal((npsr, nb, b, b)) * 0.1
    D = D @ np.swapaxes(D, -1, -2) + 2.0 * np.eye(b)
    E = rng.standard_normal((npsr, nb - 1, b, b)) * 0.2
    return D, E


def _cov_ledgers(run_port, run_jax):
    tnum.arm()
    jnum.arm(clear_caches=False)
    run_port()
    run_jax()
    jax.effects_barrier()
    return tnum.snapshot(), jnum.snapshot()


@pytest.mark.parametrize("poison_block", [None, 4])
def test_tridiag_pivot_records_every_block_column_as_jax(poison_block):
    """Config B's shape in small: one record a block column, so a late
    column driven indefinite is named at its own record."""
    D, E = _spd_blocks(np.random.default_rng(1), 3, 7, 4)
    if poison_block is not None:
        D[1, poison_block] = -D[1, poison_block]  # indefinite from this column on
    tdoc, jdoc = _cov_ledgers(
        lambda: tkernels.block_tridiag_cholesky(torch.from_numpy(D), torch.from_numpy(E)),
        lambda: jkernels.block_tridiag_cholesky(jnp.asarray(D), jnp.asarray(E)))
    _assert_ledgers_equal(tdoc, jdoc, 1e-12)
    rec = tdoc["sites"]["cov.tridiag_pivot"]
    assert rec["calls"] == 7 and rec["elements"] == 7 * 3 * 4
    assert (rec["nonfinite"] > 0) == (poison_block is not None)


def test_blocked_dense_fused_and_kron_sites_equal_jax():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((2, 20, 20))
    A = M @ np.swapaxes(M, -1, -2) + 20.0 * np.eye(20)
    D, E = _spd_blocks(rng, 2, 5, 4)
    X = rng.standard_normal((2, 5, 4, 3))
    Ct = A[:, :5, :5]
    Cf = A[:, 5:9, 5:9]
    t = torch.from_numpy

    def port():
        tkernels.blocked_cholesky(t(A), block=8)
        tkernels.dense_cholesky(t(A))
        tkernels.block_tridiag_factor_solve(t(D), t(E), t(X))
        tkernels.kron_cholesky(t(Ct), t(Cf))

    def jax_side():
        jkernels.blocked_cholesky(jnp.asarray(A), block=8, backend="xla")
        jkernels.dense_cholesky(jnp.asarray(A), method="xla")
        jkernels.block_tridiag_factor_solve(jnp.asarray(D), jnp.asarray(E), jnp.asarray(X),
                                            backend="xla")
        jkernels.kron_cholesky(jnp.asarray(Ct), jnp.asarray(Cf))

    tdoc, jdoc = _cov_ledgers(port, jax_side)
    _assert_ledgers_equal(tdoc, jdoc, 1e-10)
    assert tdoc["sites"]["cov.blocked_pivot"]["calls"] == 3
    assert {"cov.dense_cholesky", "cov.tridiag_mxu_pivot", "cov.tridiag_mxu_solve",
            "cov.kron_epoch", "cov.kron_channel"} <= set(tdoc["sites"])


# ------------------------------------- drift offset, scan and heartbeat

@pytest.mark.parametrize("every", [1, 5, 16])
def test_drift_offset_equals_jax(every):
    for seed in range(10):
        assert tnum.drift_offset(every, seed) == jnum.drift_offset(every, seed)


def test_scan_block_and_heartbeat_equal_jax():
    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal((4, 3, 16)), rng.standard_normal((2, 8)).astype(np.float32),
              np.zeros((3, 3)), np.arange(10, dtype=np.int64)]
    blocks[0][1, 2, 3] = np.nan
    blocks[1][0, 5] = np.inf
    tnum.arm()
    jnum.arm(clear_caches=False)
    for blk in blocks + [np.ones(5)] * 3:
        assert tnum.scan_block("drain", blk) == jnum.scan_block("drain", blk)
    tnum.probe("solver.winv", torch.tensor([1e30, 2.0], dtype=torch.float32))
    jnum.probe("solver.winv", jnp.asarray(np.array([1e30, 2.0], np.float32)))
    jax.effects_barrier()
    _assert_ledgers_equal(tnum.snapshot(), jnum.snapshot(), 1e-12)
    assert tnum.heartbeat_block() == jnum.heartbeat_block()
    assert tnum.snapshot()["sites"]["drain"]["nonfinite"] == 2
    assert tnum.scan_block("drain", torch.ones(3)) == 0  # a tensor is read whole


def test_arm_from_env_reads_the_drift_options():
    assert not tnum.arm_from_env({})
    assert tnum.arm_from_env({"PTA_NUMERICS": "1", "PTA_NUMERICS_DRIFT_EVERY": "5",
                              "PTA_NUMERICS_SEED": "3"})
    assert tnum.drift_offset() == jnum.drift_offset(5, 3) and tnum.is_armed()
    tnum.reset()
    assert not tnum.is_armed() and tnum.drift_offset() == jnum.drift_offset(16, 0)


# ------------------------------------------------------ planted faults

def test_a_planted_nan_is_named_at_drain_alone(workloads, tmp_path):
    jb, jr, tb, tr = workloads["float64"]
    key = jax.random.PRNGKey(SEED)
    REGISTRY.reset()
    tnum.arm(drift_every=NO_DRIFT)
    with inject.armed("drain:nan@chunk=1"):
        cube = _port_sweep(tb, tr, tmp_path / "nan.npz", noise=_jax_noise(key, jb, jr))
    tdoc = tnum.snapshot()
    bad = {s for s, r in tdoc["sites"].items() if r["nonfinite"]}
    assert bad == {"drain"} and tdoc["nonfinite_total"] == 1
    assert counter(names.NUMERICS_NONFINITE).value == 1
    assert np.isnan(cube[CHUNK:]).sum() == 1 and np.isfinite(cube[:CHUNK]).all()
    jnum.arm(drift_every=NO_DRIFT)
    with jinject.armed("drain:nan@chunk=1"):
        _jax_sweep(jb, jr, tmp_path / "jnan.npz", key)
    jnum.flush()
    assert {s for s, r in jnum.snapshot()["sites"].items() if r["nonfinite"]} == bad


def test_a_planted_f32_overflow_is_named_at_realization_white_alone(workloads):
    _jb, _jr, tb, tr = workloads["float32"]
    import dataclasses

    r = dataclasses.replace(tr, log10_equad=torch.full_like(tr.log10_equad, 25.0))
    tnum.arm()
    B.realize(torch.Generator().manual_seed(0), tb, r, 4, device="cpu")
    tnum.flush()
    sites = tnum.snapshot()["sites"]
    bad = {s for s, rec in sites.items() if rec["nonfinite"]}
    assert bad == {"realization.white"}, sites
    assert {"realization.ecorr", "realization.red", "realization.gwb"} <= set(sites)


# ---------------------------------------------------------------- drift

def test_drift_on_every_chunk_is_within_tolerance_and_replays_row_0(workloads, tmp_path):
    _jb, _jr, tb, tr = workloads["float64"]
    tnum.arm(drift_every=1)
    cube = _port_sweep(tb, tr, tmp_path / "drift.npz")
    drift = tnum.snapshot()["drift"]
    assert {"white", "ecorr", "red", "gwb", "cw"} <= set(drift)
    for family, rec in drift.items():
        assert rec["samples"] == NREAL // CHUNK, family
        assert rec["tolerance"] == FAMILY_TOLERANCES[family]
        assert rec["worst"] <= rec["tolerance"], (family, rec)
    verdict = tnum.ladder_verdict()
    assert all("no drift samples" not in " ".join(v["reasons"]) for v in verdict.values())
    static = B.deterministic_delays(tb, tr, device="cpu")
    for i in range(NREAL // CHUNK):
        draws = tnum.replay_draws(tb, tr, SEED, i, CHUNK)
        row0 = B.residualize(B.realization_delays(tb, tr, draws) + static, tb).numpy()
        np.testing.assert_allclose(row0, cube[i * CHUNK], rtol=0,
                                   atol=1e-12 * np.abs(cube[i * CHUNK]).max())


# ---------------------------------------------------------- capture, CLI

@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A port capture of ``realize --checkpoint`` with ``PTA_NUMERICS=1``
    and a JAX ledger written from the same kind of run."""
    root = tmp_path_factory.mktemp("numerics_cli")
    pardir, timdir = write_with(tsim, small_pulsars(), str(root))
    (root / "r.json").write_text(json.dumps(ng15_like_recipe(4, ncw=1, gwb_npts=100,
                                                             gwb_howml=4.0)))
    argv = ["realize", "--pardir", pardir, "--timdir", timdir, "--recipe",
            str(root / "r.json"), "--nreal", "8", "--chunk", "4", "--fit"]
    mp = pytest.MonkeyPatch()
    mp.setenv("PTA_NUMERICS", "1")
    mp.setenv("PTA_NUMERICS_DRIFT_EVERY", "1")
    try:
        main(argv + ["--out", str(root / "t.npz"), "--checkpoint", str(root / "t_ck.npz"),
                     "--device", "cpu", "--telemetry", str(root / "tel_port")])
        tnum.reset()
        jax_main(argv + ["--out", str(root / "j.npz"), "--checkpoint", str(root / "j_ck.npz"),
                         "--telemetry", str(root / "tel_jax"), "--platform", "cpu"])
    finally:
        mp.undo()
        tnum.reset()
        jnum.reset()
    return root


def test_the_capture_passes_the_jax_schema_checker(captures):
    path = captures / "tel_port" / "numerics.json"
    doc = json.loads(path.read_text())
    assert check_telemetry_schema.validate_numerics_file(str(path)) == []
    assert "realization.white" in doc["sites"] and doc["drift"]
    assert doc["sites"]["drain"]["calls"] == 2


@pytest.mark.parametrize("writer", ["tel_port", "tel_jax"])
def test_each_package_s_numerics_report_reads_the_other_s_capture(captures, capsys, writer):
    directory = str(captures / writer)
    main(["numerics", "report", directory])
    port_text = capsys.readouterr().out
    jax_main(["numerics", "report", directory])
    jax_text = capsys.readouterr().out
    assert port_text == jax_text.replace("  (/readyz serves 503 until it clears)", "")
    assert "realization.white" in port_text and "drift vs the f64 shadow oracle" in port_text
