"""The port's device mesh (``pta_replicator_tpu_torch/parallel/mesh.py``),
its mesh sweep and sharded chunk archives (``utils/sweep.py``),
``parallel/stages.py::fan_out`` and ``realize --sharded`` / ``--mesh-shape``,
on the CPU over meshes of repeated ``cpu`` devices.

The cases of the JAX package's ``tests/test_sharding.py`` and
``tests/test_multichip.py`` that the port has: sharding is a layout, so a
sharded result equals the unsharded one bitwise for an elementwise recipe
and to 1e-12 of the largest entry (float64) otherwise; the mesh sweep given
the JAX mesh sweep's draws equals it (on the 8 virtual devices of
``tests/conftest.py``) to 1e-9 of the RMS, ``tests/test_torch_sweep.py``'s
tolerance; the sharded archive is the JAX package's byte for byte, and
each package reads the other's."""
import dataclasses
import glob
import importlib
import json
import os
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_dataset import small_pulsars, write_with
from _torch_parity import jax_realize_draws
from pta_replicator_tpu.parallel import make_mesh as jax_make_mesh
from pta_replicator_tpu_torch import convert, flagship_workload, realize
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.batch import synthetic_batch
from pta_replicator_tpu_torch.covariance import banded_from_times
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.obs import TRACER, counter, gauge, names
from pta_replicator_tpu_torch.ops.orf import hellings_downs_matrix
from pta_replicator_tpu_torch.parallel import mesh as M
from pta_replicator_tpu_torch.parallel.stages import fan_out
from pta_replicator_tpu_torch.utils import sweep as tsw

jsw = importlib.import_module("pta_replicator_tpu.utils.sweep")

F64 = torch.float64
#: the largest |difference| over the largest |entry| of a sharded result
#: against the unsharded one where products are windowed (float64)
TOL_WINDOWED = 1e-12
#: the same for the CLI, which realizes in float32
TOL_WINDOWED_F32 = 1e-5
#: the port's sweep against the JAX sweep on the same draws, over the RMS
TOL_JAX = 1e-9
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]


def cpu_mesh(n_real, n_psr):
    return M.make_mesh(n_real, n_psr, devices=["cpu"] * (n_real * n_psr))


def _close(got, want, tol=TOL_WINDOWED):
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    assert got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, err


@pytest.fixture(scope="module")
def small_setup():
    """test_sharding.py's small setup: per-backend white noise and ECORR,
    red noise, an HD GWB, 4 pulsars x 64 TOAs, float64."""
    batch = synthetic_batch(npsr=4, ntoa=64, nbackend=2, seed=1, dtype=F64, device="cpu")
    phat = batch.phat.numpy()
    locs = np.stack([np.arctan2(phat[:, 1], phat[:, 0]), np.arccos(phat[:, 2])], axis=1)
    recipe = B.Recipe(
        efac=torch.ones((4, 2), dtype=F64), log10_equad=torch.full((4, 2), -6.3, dtype=F64),
        log10_ecorr=torch.full((4, 2), -6.5, dtype=F64),
        rn_log10_amplitude=torch.full((4,), -14.0, dtype=F64),
        rn_gamma=torch.full((4,), 4.33, dtype=F64),
        gwb_log10_amplitude=torch.tensor(-14.0, dtype=F64), gwb_gamma=torch.tensor(4.33, dtype=F64),
        orf_cholesky=torch.as_tensor(np.linalg.cholesky(np.asarray(hellings_downs_matrix(locs)))),
        gwb_npts=100, gwb_howml=4.0,
    )
    return batch, recipe


def _catalog(seed=3, ncw=6):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([
        np.arccos(rng.uniform(-1, 1, ncw)), rng.uniform(0, 2 * np.pi, ncw),
        10 ** rng.uniform(8, 9.3, ncw), rng.uniform(50, 900, ncw),
        10 ** rng.uniform(-8.6, -7.8, ncw), rng.uniform(0, 2 * np.pi, ncw),
        rng.uniform(0, np.pi, ncw), np.arccos(rng.uniform(-1, 1, ncw)),
    ]))


def _variant(batch, recipe, name):
    """The recipes of the JAX engine tests: the CW catalog, an uncorrelated
    GWB, a full-design WLS fit, a transient, and the GLS refit over a
    banded covariance (config B's structure)."""
    if name == "cw":
        return dataclasses.replace(recipe, cgw_params=_catalog(), cgw_chunk=4)
    if name == "uncorrelated_gwb":
        return dataclasses.replace(recipe, orf_cholesky=None)
    if name == "design_fit":
        D = np.random.default_rng(5).normal(size=(batch.npsr, batch.ntoa_max, 5))
        return dataclasses.replace(recipe, fit_design=torch.as_tensor(D))
    if name == "transient":
        return dataclasses.replace(
            recipe, transient_waveform=torch.linspace(0, 1e-6, 16, dtype=F64),
            transient_grid=torch.tensor([-2e8, 2e8], dtype=F64), transient_psr=2)
    if name == "gls_banded":
        t = batch.toas_s / batch.tspan_s[:, None]
        D = torch.stack([torch.ones_like(t), t, (batch.backend_index == 1).to(F64)], dim=-1)
        cov = banded_from_times(batch.toas_s, batch.mask, rho=0.5, corr_s=30 * 86400.0,
                                block=16, dtype=F64, device="cpu")
        return dataclasses.replace(recipe, log10_ecorr=None, noise_cov=cov,
                                   cov_log10_sigma=torch.tensor(-6.4, dtype=F64),
                                   fit_design=D, fit_gls=True)
    raise KeyError(name)


# ------------------------------------------------------------------ the mesh

def test_mesh_shapes():
    mesh = cpu_mesh(4, 2)
    assert mesh.shape == {"real": 4, "psr": 2} and mesh.size == 8
    assert mesh.devices.shape == (4, 2) and mesh.label == "4x2"
    # a prefix of the devices; a larger shape raises, with JAX's message
    assert M.make_mesh(3, 2, devices=["cpu"] * 8).shape == {"real": 3, "psr": 2}
    assert M.make_mesh(devices=["cpu"] * 8, n_psr=2).shape == {"real": 4, "psr": 2}
    with pytest.raises(ValueError, match="needs 10 devices, only 8 available"):
        M.make_mesh(5, 2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="one kind"):
        M.make_mesh(2, 1, devices=["cpu", "meta"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh(1, 1)  # the default devices are the cards


@pytest.mark.parametrize("engine", ["sharded_realize", "shardmap_realize"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_realize(small_setup, shape, engine):
    batch, recipe = small_setup
    ref = realize(torch.Generator().manual_seed(42), batch, recipe, 8, fit=True, device="cpu")
    out = getattr(M, engine)(42, batch, recipe, 8, mesh=cpu_mesh(*shape), fit=True)
    assert out.shape == (8, 4, 64) and len(out.shards) == shape[0] * shape[1]
    _close(out.assemble(), ref)


@pytest.mark.parametrize("variant", ["cw", "uncorrelated_gwb", "design_fit", "transient",
                                     "gls_banded"])
@pytest.mark.parametrize("shape", [(4, 2), (1, 4)])
def test_sharded_recipes_match_realize(small_setup, variant, shape):
    batch, recipe = small_setup
    recipe = _variant(batch, recipe, variant)
    ref = realize(torch.Generator().manual_seed(21), batch, recipe, 8, fit=True, device="cpu")
    out = M.sharded_realize(21, batch, recipe, 8, mesh=cpu_mesh(*shape), fit=True)
    _close(out.assemble(), ref)


def test_gls_refit_assembles_per_pulsar_window(small_setup):
    """On a pulsar-sharded mesh each (device, pulsar window) gets its own
    GLS system, whose C0 factor and solves are that window's (the
    block-tridiagonal sweeps run per 'psr' shard)."""
    batch, recipe = small_setup
    recipe = _variant(batch, recipe, "gls_banded")
    mesh = cpu_mesh(2, 2)
    plan = M.shard_plan(mesh, 8, batch.npsr)
    inputs = M.shard_batch(batch, mesh, recipe)
    systems = M.shard_fit_systems(inputs, plan)
    assert sorted(p for _d, p in systems) == [(0, 2), (2, 4)]
    whole = B.fit_system(batch, recipe)
    delays = torch.randn((3,) + tuple(batch.toas_s.shape), dtype=F64,
                         generator=torch.Generator().manual_seed(1))
    for (_d, (p0, p1)), system in systems.items():
        _close(system.subtract(delays[:, p0:p1]), whole.subtract(delays)[:, p0:p1])


def test_sharded_guards(small_setup):
    batch, recipe = small_setup
    with pytest.raises(ValueError, match="divisible"):
        M.sharded_realize(0, batch, recipe, 6, mesh=cpu_mesh(4, 2))
    b3 = synthetic_batch(npsr=3, ntoa=32, nbackend=2, seed=2, dtype=F64, device="cpu")
    r3 = B.Recipe(efac=torch.ones(3, dtype=F64))
    with pytest.raises(ValueError, match="npsr=3 not divisible"):
        M.sharded_realize(0, b3, r3, 8, mesh=cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="leading dim"):
        M.sharded_realize(0, batch, dataclasses.replace(recipe, efac=torch.ones(6, dtype=F64)),
                          8, mesh=cpu_mesh(2, 2))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_engines_accept_precomputed_static(small_setup, shape):
    batch, recipe = small_setup
    recipe = _variant(batch, recipe, "cw")
    mesh = cpu_mesh(*shape)
    static = M.static_delays(batch, recipe, mesh)
    assert max(float(t.abs().max()) for _i, t in static.shards) > 0
    ref = M.sharded_realize(33, batch, recipe, 8, mesh=mesh, fit=True)
    out = M.sharded_realize(33, batch, recipe, 8, mesh=mesh, fit=True, static=static)
    np.testing.assert_array_equal(out.assemble().numpy(), ref.assemble().numpy())
    # the whole (Np, Nt) tensor, as realize takes it, is windowed the same way
    whole = B.deterministic_delays(batch, recipe, device="cpu")
    out = M.sharded_realize(33, batch, recipe, 8, mesh=mesh, fit=True, static=whole)
    np.testing.assert_array_equal(out.assemble().numpy(), ref.assemble().numpy())


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_dispatch_stats(small_setup, shape):
    """``stats`` gets one dispatch time and one launch count per shard, and
    asking for them leaves the result as it is."""
    batch, recipe = small_setup
    stats = {}
    out = M.sharded_realize(4, batch, recipe, 8, mesh=cpu_mesh(*shape), stats=stats)
    assert len(stats["shard_dispatch_ms"]) == 4 and min(stats["shard_dispatch_ms"]) > 0
    # the CPU runs no hand-written kernel: every shard's count is empty
    assert stats["shard_launches"] == [{}] * 4
    ref = M.sharded_realize(4, batch, recipe, 8, mesh=cpu_mesh(*shape))
    np.testing.assert_array_equal(out.assemble().numpy(), ref.assemble().numpy())


# ------------------------------------------------------------- row sums

@pytest.mark.parametrize("x_shape,w_shape", [((3, 5, 37), (5, 37)), ((5, 37), None)])
def test_row_sums_is_the_plain_sum_on_the_host(x_shape, w_shape):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=x_shape))
    w = None if w_shape is None else torch.as_tensor(rng.uniform(size=w_shape))
    want = (x if w is None else x * w).sum(-1, keepdim=True)
    assert torch.equal(B.row_sums(x, w), want)


@pytest.mark.cuda
@pytest.mark.parametrize("window,ntoa", [(4, 1000), (17, 7758)], ids=["few_rows", "odd_offset"])
def test_row_sums_of_a_window_are_the_whole_arrays_on_the_card(window, ntoa):
    """A window of rows (fewer than 16; at an odd offset of rows that
    start 8 bytes off a 16-byte boundary) sums bit for bit as the same
    rows of the whole array."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row layout is the card's reduction's")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((2 * window + 1, ntoa), generator=gen, device="cuda")
    w = torch.rand((2 * window + 1, ntoa), generator=gen, device="cuda")
    part = slice(window, 2 * window + 1)
    assert torch.equal(B.row_sums(x[part], w[part]), B.row_sums(x, w)[part])
    assert torch.equal(B.row_sums(x[part]), B.row_sums(x)[part])


# ----------------------------------------------------- per-shard readback

def test_put_sharded_and_fetch_assemble_bit_identical():
    mesh = cpu_mesh(4, 2)
    x = np.arange(8 * 6 * 10, dtype=np.float64).reshape(8, 6, 10)
    arr = M.put_sharded(x, mesh, ("real", "psr"))
    assert M.put_sharded(arr, mesh, ("real", "psr")) is arr
    blk = M.fetch_shard_blocks(arr)
    assert isinstance(blk, tsw.ShardedBlock) and len(blk.shards) == 8
    assert blk.nbytes == x.nbytes
    np.testing.assert_array_equal(blk.assemble(), x)
    np.testing.assert_array_equal(arr.assemble().numpy(), x)


def test_fetch_shard_blocks_dedups_replicated_axis():
    mesh = cpu_mesh(4, 2)
    x = np.arange(8 * 5, dtype=np.float64).reshape(8, 5)
    arr = M.put_sharded(x, mesh, ("real", None))
    assert len(arr.shards) == 8
    gauge(names.SWEEP_SHARDS_INFLIGHT).set(-1)
    blk = M.fetch_shard_blocks(arr)
    assert len(blk.shards) == 4 and blk.nbytes == x.nbytes
    assert gauge(names.SWEEP_SHARDS_INFLIGHT).value == 0
    np.testing.assert_array_equal(blk.assemble(), x)


def test_fetch_shard_blocks_single_shard_passthrough():
    out = M.fetch_shard_blocks(M.put_sharded(np.arange(12.0), cpu_mesh(1, 1), ()))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(12.0))


def test_sharded_block_refuses_partial_cover():
    blk = tsw.ShardedBlock((4, 2), np.float64, [(((0, 2), (0, 2)), np.zeros((2, 2)))])
    with pytest.raises(ValueError, match="partial"):
        blk.assemble()
    arr = M.ShardedArray((4, 2), F64, [(((0, 2), (0, 2)), torch.zeros((2, 2), dtype=F64))])
    with pytest.raises(ValueError, match="partial"):
        arr.assemble()


# ------------------------------------------------------- the archive format

def _block():
    x = np.arange(8 * 6 * 10, dtype=np.float64).reshape(8, 6, 10)
    return x, M.fetch_shard_blocks(M.put_sharded(x, cpu_mesh(4, 2), ("real", "psr")))


@pytest.mark.parametrize("writers", [1, 2, 4, None])
def test_shard_archive_is_the_reference_bytes(tmp_path, writers):
    x, blk = _block()
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tsw.write_shard_archive(mine, blk, writers=writers)
    jsw.write_shard_archive(theirs, jsw.ShardedBlock(blk.shape, blk.dtype, blk.shards))
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for load in (tsw.load_shard_archive, jsw.load_shard_archive):
        np.testing.assert_array_equal(load(mine), x)
        np.testing.assert_array_equal(load(theirs), x)
    with zipfile.ZipFile(mine) as zf:
        assert zf.testzip() is None and zf.namelist()[-1] == "manifest.npy"


def test_shard_archive_zip64_fallback_reads_back(tmp_path, monkeypatch):
    x, blk = _block()
    monkeypatch.setattr(tsw, "_ZIP_LIMIT", 64)  # every archive is past the classic limits
    path = str(tmp_path / "z64.npz")
    tsw.write_shard_archive(path, blk)
    np.testing.assert_array_equal(tsw.load_shard_archive(path), x)
    np.testing.assert_array_equal(jsw.load_shard_archive(path), x)


def test_shard_archive_refuses_torn_file(tmp_path):
    path = str(tmp_path / "torn.npz")
    with zipfile.ZipFile(path, "w") as zf:
        with zf.open("shard000000.npy", "w") as fh:
            fh.write(tsw.npy_bytes(np.zeros(3)))
    with pytest.raises(ValueError, match="manifest"):
        tsw.load_shard_archive(path)


def test_shard_archive_writer_telemetry(tmp_path):
    x = np.arange(4 * 6, dtype=np.float64).reshape(4, 6)
    blk = M.fetch_shard_blocks(M.put_sharded(x, cpu_mesh(2, 2), ("real", "psr")))
    TRACER.reset()
    f0 = counter(names.SWEEP_SHARD_FSYNCS).value
    tsw.write_shard_archive(str(tmp_path / "t.npz"), blk, durable=True)
    spans = [e for e in TRACER.events()
             if e.get("type") == "span" and e.get("name") == names.SPAN_SHARD_WRITE]
    assert sorted(e["attrs"]["shard"] for e in spans) == [0, 1, 2, 3]
    assert all(e["attrs"]["nbytes"] > 0 for e in spans)
    assert counter(names.SWEEP_SHARD_FSYNCS).value == f0 + 4


# ------------------------------------------------------------------ fan_out

@pytest.mark.parametrize("workers", [1, 3, None])
def test_fan_out_order_and_gauge(workers):
    seen = []

    def task(k):
        def run():
            seen.append(gauge("test.fan_out_busy").value)
            return k * k
        return run

    assert fan_out([task(k) for k in range(7)], workers=workers,
                   busy_gauge="test.fan_out_busy") == [k * k for k in range(7)]
    assert min(seen) >= 1 and gauge("test.fan_out_busy").value == 0
    assert fan_out([], workers=workers) == []


def test_fan_out_reraises_the_first_error_after_quiesce():
    release = threading.Event()
    finished = []

    def slow():
        release.wait(5.0)
        finished.append("slow")
        return 1

    def boom():
        release.set()
        raise KeyError("shard 1")

    with pytest.raises(KeyError, match="shard 1"):
        fan_out([slow, boom, lambda: 3], workers=2)
    assert finished == ["slow"]  # the peer ran to its end before the raise


def test_fan_out_spans_nest_under_the_caller():
    from pta_replicator_tpu_torch.obs import span

    def inner():
        with span("inner"):
            return threading.current_thread().name

    TRACER.reset()
    with span("outer"):
        threads = fan_out([inner] * 2, workers=2, name="nest")
    assert all(t.startswith("nest-") for t in threads)
    paths = [e["path"] for e in TRACER.events() if e.get("type") == "span" and e["name"] == "inner"]
    assert paths == ["outer/inner"] * 2


# ------------------------------------------------------------ the mesh sweep

@pytest.fixture(scope="module")
def white_sweep():
    """The elementwise recipe (no contraction): bitwise on every mesh."""
    b = synthetic_batch(npsr=4, ntoa=64, nbackend=2, seed=2, dtype=F64, device="cpu")
    return b, B.Recipe(efac=torch.full((4, 2), 1.1, dtype=F64),
                       log10_equad=torch.full((4, 2), -6.5, dtype=F64))


def _sweep(b, r, path, **kw):
    kw.setdefault("chunk", 8)
    return tsw.sweep(5, b, r, kw.pop("nreal", 32), str(path), device="cpu", **kw)


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)])
def test_mesh_sweep_bit_identity(tmp_path, white_sweep, shape, depth):
    b, recipe = white_sweep
    ref = _sweep(b, recipe, tmp_path / "ref.npz", reduce_fn=None)
    out = _sweep(b, recipe, tmp_path / "mesh.npz", reduce_fn=None, mesh=cpu_mesh(*shape),
                 pipeline_depth=depth)
    np.testing.assert_array_equal(out, ref)
    assert _bytes(tmp_path / "mesh.npz") == _bytes(tmp_path / "ref.npz")
    assert glob.glob(str(tmp_path / "mesh.npz") + ".chunk*") == []
    # the default reduction runs per shard: the same RMS bits
    rms = _sweep(b, recipe, tmp_path / "rms.npz", mesh=cpu_mesh(*shape), pipeline_depth=depth)
    np.testing.assert_array_equal(rms, _sweep(b, recipe, tmp_path / "rms_ref.npz"))


def test_fused_stream_on_a_one_device_mesh(tmp_path, white_sweep):
    """A one-device mesh is the unsharded engine, the fused graph included
    (the fused graph on a multi-device mesh is A.17b's)."""
    b, recipe = white_sweep
    ref = _sweep(b, recipe, tmp_path / "ref.npz", reduce_fn=None)
    out = _sweep(b, recipe, tmp_path / "fused.npz", reduce_fn=None, mesh=cpu_mesh(1, 1),
                 fused_stream=True)
    np.testing.assert_array_equal(out, ref)
    assert _bytes(tmp_path / "fused.npz") == _bytes(tmp_path / "ref.npz")


def test_mesh_sweep_flagship_close_and_format_identical(tmp_path):
    """Red noise, the GWB, a CW catalog and the fit add windowed products:
    1e-12 across topologies, while on one mesh the sharded-checkpoint
    format changes nothing (equal archives with shard_checkpoint off)."""
    b, r = flagship_workload(npsr=4, ntoa=128, ncw=4, dtype=F64, device="cpu")
    kw = dict(nreal=16, chunk=4, fit=True)
    sharded = _sweep(b, r, tmp_path / "s.npz", mesh=cpu_mesh(2, 2), **kw)
    plain = _sweep(b, r, tmp_path / "p.npz", mesh=cpu_mesh(2, 2), shard_checkpoint=False, **kw)
    np.testing.assert_array_equal(sharded, plain)
    assert _bytes(tmp_path / "s.npz") == _bytes(tmp_path / "p.npz")
    _close(sharded, _sweep(b, r, tmp_path / "ref.npz", **kw))


def test_mesh_sweep_matches_the_jax_mesh_sweep(tmp_path):
    """The port's mesh sweep on the JAX mesh sweep's draws (its
    ``fold_in(K, i)`` chunks) against the JAX mesh sweep on 4 x 2 of the
    8 virtual devices; both meshes shard pulsars."""
    from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship

    jb, jr = jax_flagship(npsr=4, ntoa=128, ncw=4)
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsw.sweep(key, jb, jr, 16, str(tmp_path / "jax.npz"), chunk=8, fit=True,
                               mesh=jax_make_mesh(4, 2)))
    noise = lambda i: jax_realize_draws(jax.random.fold_in(key, i), jb, jr, 8)
    got = tsw.sweep(3, tb, tr, 16, str(tmp_path / "port.npz"), chunk=8, fit=True, noise=noise,
                    device="cpu", mesh=cpu_mesh(4, 2))
    assert got.shape == ref.shape == (16, 4)
    assert np.max(np.abs(got - ref)) <= TOL_JAX * np.sqrt(np.mean(ref**2))


def _interrupted(fn, after):
    class Stop(Exception):
        pass

    def bomb(done, total):
        if done == after:
            raise Stop

    with pytest.raises(Stop):
        fn(bomb)


def test_mesh_sweep_writes_sharded_chunk_files(tmp_path, white_sweep):
    b, recipe = white_sweep
    ck = tmp_path / "s.npz"
    _interrupted(lambda progress: _sweep(b, recipe, ck, mesh=cpu_mesh(2, 2), progress=progress), 2)
    chunks = sorted(glob.glob(str(ck) + ".chunk*"))
    assert chunks and all(c.endswith(".npz") for c in chunks)
    with zipfile.ZipFile(chunks[0]) as zf:
        members = zf.namelist()
    assert members[-1] == "manifest.npy" and sum(m.startswith("shard") for m in members) == 4
    # a sweep in progress reads through both packages' loaders
    np.testing.assert_array_equal(tsw.load_checkpoint_chunk(str(ck), 1),
                                  jsw.load_checkpoint_chunk(str(ck), 1))
    assert [i for i, _ in jsw.iter_checkpoint_chunks(str(ck))] == [0, 1]


def test_crash_mid_shard_write_resumes(tmp_path, white_sweep, monkeypatch):
    """Killed between a chunk's sharded archive and its sidecar, then
    resumed on another mesh shape: the uninterrupted single-device bytes."""
    b, recipe = white_sweep
    ref = _sweep(b, recipe, tmp_path / "ref.npz", reduce_fn=None)

    class KillSim(BaseException):
        pass

    orig, seen = tsw._atomic_write, {"json": 0}

    def bombed(write_fn, final_path, suffix, durable=False):
        if suffix == ".json":
            seen["json"] += 1
            if seen["json"] == 3:  # chunk 2's sidecar
                raise KillSim()
        return orig(write_fn, final_path, suffix, durable=durable)

    monkeypatch.setattr(tsw, "_atomic_write", bombed)
    ck = tmp_path / "crash.npz"
    with pytest.raises(KillSim):
        _sweep(b, recipe, ck, reduce_fn=None, mesh=cpu_mesh(2, 2))
    monkeypatch.undo()
    assert os.path.exists(str(ck) + ".chunk000002.npz")
    calls = []
    out = _sweep(b, recipe, ck, reduce_fn=None, mesh=cpu_mesh(4, 2),
                 progress=lambda d, t: calls.append(d))
    assert calls == [3, 4]
    np.testing.assert_array_equal(out, ref)
    assert _bytes(ck) == _bytes(tmp_path / "ref.npz")


@pytest.mark.parametrize("direction", ["mesh_to_single", "single_to_mesh", "mesh_to_mesh"])
def test_resume_across_topology_change(tmp_path, white_sweep, direction):
    b, recipe = white_sweep
    ref = _sweep(b, recipe, tmp_path / "ref.npz")
    first, second = {"mesh_to_single": (cpu_mesh(2, 2), None),
                     "single_to_mesh": (None, cpu_mesh(4, 2)),
                     "mesh_to_mesh": (cpu_mesh(2, 2), cpu_mesh(1, 2))}[direction]
    ck = tmp_path / "topo.npz"
    _interrupted(lambda progress: _sweep(b, recipe, ck, mesh=first, progress=progress), 2)
    calls = []
    out = _sweep(b, recipe, ck, mesh=second, progress=lambda d, t: calls.append(d))
    assert calls == [3, 4]
    np.testing.assert_array_equal(out, ref)
    assert _bytes(ck) == _bytes(tmp_path / "ref.npz")


def test_a_torn_shard_write_is_retried_byte_identical(tmp_path, white_sweep):
    """A ``torn`` fault at a shard writer's site truncates the archive mid
    shard; the supervised retry rewrites it and the sweep ends with the
    uninterrupted bytes."""
    from pta_replicator_tpu_torch.faults import inject
    from pta_replicator_tpu_torch.faults.retry import RetryPolicy

    b, recipe = white_sweep
    ref = _sweep(b, recipe, tmp_path / "ref.npz")
    with inject.armed("checkpoint_write:torn@call=3"):
        out = _sweep(b, recipe, tmp_path / "torn.npz", mesh=cpu_mesh(2, 2),
                     retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0))
        assert len(inject.fired()) == 1
    np.testing.assert_array_equal(out, ref)
    assert _bytes(tmp_path / "torn.npz") == _bytes(tmp_path / "ref.npz")


def test_mesh_sweep_refusals(tmp_path, white_sweep):
    b, recipe = white_sweep
    with pytest.raises(ValueError, match="multi-device mesh"):
        _sweep(b, recipe, tmp_path / "a.npz", shard_checkpoint=True)
    with pytest.raises(ValueError, match="multi-device mesh"):
        _sweep(b, recipe, tmp_path / "b.npz", shard_checkpoint=True, mesh=cpu_mesh(1, 1))
    with pytest.raises(ValueError, match="A.17b"):
        _sweep(b, recipe, tmp_path / "c.npz", fused_stream=True, mesh=cpu_mesh(2, 1))
    with pytest.raises(ValueError, match="pulsar axis second"):
        _sweep(b, recipe, tmp_path / "d.npz", mesh=cpu_mesh(1, 2),
               reduce_fn=lambda res, batch: res.sum(dim=(1, 2)))
    with pytest.raises(ValueError, match="divisible"):
        _sweep(b, recipe, tmp_path / "e.npz", mesh=cpu_mesh(3, 1), chunk=8)


def test_mesh_sweep_telemetry(tmp_path, white_sweep):
    b, recipe = white_sweep
    TRACER.reset()
    _sweep(b, recipe, tmp_path / "t.npz", mesh=cpu_mesh(2, 2), nreal=16)
    spans = [e["name"] for e in TRACER.events() if e.get("type") == "span"]
    for name in (names.SPAN_MULTICHIP_SWEEP, names.SPAN_MAKE_MESH, names.SPAN_SHARD_BATCH,
                 names.SPAN_STATIC_DELAYS, names.SPAN_SHARDED_REALIZE, names.SPAN_SHARD_WRITE):
        assert name in spans, name
    assert spans.count(names.SPAN_SHARD_WRITE) == 2 * 4


# --------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_dataset")
    dirs = write_with(tsim, small_pulsars(), str(root))
    recipe = root / "r.json"
    recipe.write_text(json.dumps({"efac": 1.1, "log10_equad": -6.5, "rn_log10_amplitude": -14.0,
                                  "rn_gamma": 4.33, "rn_nmodes": 10, "gwb_log10_amplitude": -14.5,
                                  "gwb_gamma": 4.33, "gwb_npts": 100, "gwb_howml": 4.0}))
    return dirs, str(recipe)


#: the CLI's mesh flags and the mesh each lays out on the host: --sharded
#: takes every visible device (one), --mesh-devices may repeat one
CLI_MESHES = [(["--sharded"], "1x1"),
              (["--mesh-shape", "2x2", "--mesh-devices", "cpu,cpu,cpu,cpu"], "2x2")]


@pytest.mark.parametrize("mesh_flags,label", CLI_MESHES, ids=["sharded", "mesh_devices_2x2"])
@pytest.mark.parametrize("extra", [[], ["--checkpoint", "ck.npz", "--chunk", "2"]])
def test_cli_sharded_equals_unsharded(tmp_path, dataset, extra, mesh_flags, label, capsys):
    """The fit with red noise and the GWB in float32: bitwise on the
    one-device mesh, to TOL_WINDOWED_F32 where the pulsars are windowed;
    the summary names the mesh."""
    (pardir, timdir), recipe = dataset
    outs = []
    for k, flags in enumerate(([], mesh_flags)):
        run = [a.replace("ck.npz", str(tmp_path / f"ck{k}.npz")) for a in extra]
        main(["realize", "--pardir", pardir, "--timdir", timdir, "--recipe", recipe,
              "--nreal", "4", "--fit", "--out", str(tmp_path / f"o{k}.npz"), "--device", "cpu",
              *run, *flags])
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    with np.load(tmp_path / "o0.npz") as a, np.load(tmp_path / "o1.npz") as b:
        if label == "1x1":
            np.testing.assert_array_equal(a["residuals"], b["residuals"])
        else:
            _close(b["residuals"], a["residuals"], TOL_WINDOWED_F32)
    assert "mesh" not in outs[0] and outs[1].pop("mesh") == label
    rms = (outs[0].pop("rms_s"), outs[1].pop("rms_s"))
    assert rms[1] == pytest.approx(rms[0], rel=TOL_WINDOWED_F32)
    assert outs[0] == {**outs[1], "out": outs[0]["out"]}


def test_cli_mesh_devices_elementwise_bitwise(tmp_path, dataset, capsys):
    """The elementwise recipe through --mesh-shape 2x2 on four repeated
    host devices: byte-equal to realize."""
    (pardir, timdir), _ = dataset
    recipe = tmp_path / "white.json"
    recipe.write_text(json.dumps({"efac": 1.1, "log10_equad": -6.5}))
    for k, flags in enumerate(([], CLI_MESHES[1][0])):
        main(["realize", "--pardir", pardir, "--timdir", timdir, "--recipe", str(recipe),
              "--nreal", "4", "--out", str(tmp_path / f"w{k}.npz"), "--device", "cpu", *flags])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mesh"] == "2x2"
    with np.load(tmp_path / "w0.npz") as a, np.load(tmp_path / "w1.npz") as b:
        np.testing.assert_array_equal(a["residuals"], b["residuals"])


@pytest.mark.parametrize("flags,message", [
    (["--mesh-shape", "2x2"], "needs 4 devices, only 1 available"),
    (["--mesh-shape", "2by2"], "must look like 4x2"),
    (["--sharded", "--checkpoint", "ck.npz", "--fused-stream"], "A.17b"),
    (["--mesh-devices", "cpu,cpu", "--checkpoint", "ck.npz", "--fused-stream"], "A.17b"),
    (["--mesh-shape", "1x2", "--mesh-devices", "cpu,cuda:0"], "every device must be a cpu"),
    (["--mesh-shape", "2x2", "--mesh-devices", "cpu,cpu"], "needs 4 devices, only 2"),
])
def test_cli_mesh_refusals_before_ingest(tmp_path, flags, message):
    missing = str(tmp_path / "no-such-dir")
    with pytest.raises(SystemExit, match=message):
        main(["realize", "--pardir", missing, "--timdir", missing, "--recipe", "r.json",
              "--out", "o.npz", "--device", "cpu", *flags])
