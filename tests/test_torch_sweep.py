"""The port's resumable sweep (``pta_replicator_tpu_torch/utils/sweep.py``),
its checkpoint format and ``save_batch``/``load_batch``, against the JAX
package on the CPU, and the sweep's own contracts.

Parity: the JAX ``sweep`` runs with key K; the port's ``sweep`` runs with
``noise=`` the draws of JAX's ``fold_in(K, i)`` for chunk ``i``
(``tests/_torch_parity.py::jax_realize_draws``). float64 batches; the
results agree to <=1e-9 of the RMS, the tolerance of
``tests/test_torch_realize.py``. Checkpoints read across the two packages
in both directions, and their sidecars refuse to resume across them."""
import errno
import glob
import importlib
import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.faults.retry import RetryPolicy, is_transient
from pta_replicator_tpu_torch.models.batched import quadratic_design
from pta_replicator_tpu_torch.parallel.stages import DrainTimeout
from pta_replicator_tpu_torch.utils import checkpoint as tck
from pta_replicator_tpu_torch.utils import sweep as tsw

jsw = importlib.import_module("pta_replicator_tpu.utils.sweep")
jck = importlib.import_module("pta_replicator_tpu.utils.checkpoint")

SHAPE = dict(npsr=3, ntoa=128, ncw=4)
NREAL, CHUNK = 8, 4
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


@pytest.fixture(scope="module")
def workloads():
    jb, jr = jax_flagship(**SHAPE)
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    return jb, jr, tb, tr


def _jax_noise(key, jb, jr, chunk=CHUNK):
    """Chunk ``i``'s draws of the JAX sweep with key ``key``."""
    return lambda i: jax_realize_draws(jax.random.fold_in(key, i), jb, jr, chunk)


def _port(tmp_path, tb, tr, name, nreal=NREAL, **kw):
    path = str(tmp_path / name)
    kw.setdefault("fit", True)
    return tsw.sweep(3, tb, tr, nreal, path, chunk=CHUNK, device="cpu", **kw), path


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


# ------------------------------------------------------ against the JAX sweep

@pytest.mark.parametrize("reduce", ["rms", "cube"])
def test_sweep_matches_jax_sweep(tmp_path, workloads, reduce):
    jb, jr, tb, tr = workloads
    key = jax.random.PRNGKey(11)
    jkw = {} if reduce == "rms" else {"reduce_fn": None}
    tkw = {} if reduce == "rms" else {"reduce_fn": None}
    ref = jsw.sweep(key, jb, jr, NREAL, str(tmp_path / "jax.npz"), chunk=CHUNK, fit=True, **jkw)
    got, _ = _port(tmp_path, tb, tr, "port.npz", noise=_jax_noise(key, jb, jr), **tkw)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert got.shape == ((NREAL, SHAPE["npsr"]) if reduce == "rms"
                         else (NREAL, SHAPE["npsr"], SHAPE["ntoa"]))
    assert np.max(np.abs(got - ref)) <= 1e-9 * np.sqrt(np.mean(ref**2))


def _interrupted(sweep_fn, after):
    """Run ``sweep_fn(progress)`` and stop it once ``after`` chunks are done."""

    class Stop(Exception):
        pass

    def bomb(done, total):
        if done == after:
            raise Stop

    with pytest.raises(Stop):
        sweep_fn(bomb)


def test_port_checkpoint_reads_through_the_reference_loaders(tmp_path, workloads):
    _, _, tb, tr = workloads
    full, done_path = _port(tmp_path, tb, tr, "done.npz", reduce_fn=None)
    path = str(tmp_path / "partial.npz")
    _interrupted(lambda progress: tsw.sweep(3, tb, tr, NREAL, path, chunk=CHUNK, fit=True,
                                            reduce_fn=None, device="cpu", progress=progress), 1)
    # the consolidated archive and the chunk file of a sweep in progress
    for i in range(NREAL // CHUNK):
        np.testing.assert_array_equal(jsw.load_checkpoint_chunk(done_path, i),
                                      full[i * CHUNK:(i + 1) * CHUNK])
    assert [i for i, _ in jsw.iter_checkpoint_chunks(done_path)] == [0, 1]
    assert [s for _i, s, _d in jsw.iter_checkpoint_chunk_infos(done_path)] == [
        (CHUNK, SHAPE["npsr"], SHAPE["ntoa"])] * 2
    chunks = list(jsw.iter_checkpoint_chunks(path))
    assert [i for i, _ in chunks] == [0]
    np.testing.assert_array_equal(chunks[0][1], full[:CHUNK])


def test_jax_checkpoint_reads_through_the_port_loaders(tmp_path, workloads):
    jb, jr, _, _ = workloads
    key = jax.random.PRNGKey(2)
    done_path = str(tmp_path / "jdone.npz")
    full = np.asarray(jsw.sweep(key, jb, jr, NREAL, done_path, chunk=CHUNK, reduce_fn=None))
    path = str(tmp_path / "jpartial.npz")
    _interrupted(lambda progress: jsw.sweep(key, jb, jr, NREAL, path, chunk=CHUNK,
                                            reduce_fn=None, progress=progress), 1)
    for i in range(NREAL // CHUNK):
        np.testing.assert_array_equal(tsw.load_checkpoint_chunk(done_path, i),
                                      full[i * CHUNK:(i + 1) * CHUNK])
    np.testing.assert_array_equal(lk.RealizationBank.from_checkpoint(done_path).load(), full)
    bank = lk.RealizationBank.from_checkpoint(path)  # a sweep in progress
    assert bank.shape == (CHUNK, SHAPE["npsr"], SHAPE["ntoa"])
    np.testing.assert_array_equal(bank.row(1), full[1])


def test_jax_sharded_archive_reads_through_the_port_loaders(tmp_path, workloads):
    """A JAX mesh sweep's per-chunk sharded archives (two virtual CPU
    devices, ``xla_force_host_platform_device_count``) reassemble through
    the port's loaders and bank."""
    from pta_replicator_tpu.parallel import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs two JAX devices (xla_force_host_platform_device_count)")
    jb, jr, _, _ = workloads
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jsw.sweep(key, jb, jr, NREAL, str(tmp_path / "ref.npz"), chunk=CHUNK,
                               reduce_fn=None))
    path = str(tmp_path / "sharded.npz")
    _interrupted(lambda progress: jsw.sweep(key, jb, jr, NREAL, path, chunk=CHUNK,
                                            reduce_fn=None, mesh=make_mesh(2, 1),
                                            shard_checkpoint=True, progress=progress), 1)
    assert os.path.exists(path + ".chunk000000.npz")
    want = jsw.load_shard_archive(path + ".chunk000000.npz")
    # a mesh sweep agrees with the single-device one up to reduction order
    np.testing.assert_allclose(want, ref[:CHUNK], rtol=0,
                               atol=1e-12 * np.max(np.abs(ref)))
    np.testing.assert_array_equal(tsw.load_shard_archive(path + ".chunk000000.npz"), want)
    np.testing.assert_array_equal(tsw.load_checkpoint_chunk(path, 0), want)
    assert [s for _i, s, _d in tsw.iter_checkpoint_chunk_infos(path)] == [
        (CHUNK, SHAPE["npsr"], SHAPE["ntoa"])]
    np.testing.assert_array_equal(lk.RealizationBank.from_checkpoint(path).load(), want)


def test_batch_checkpoint_round_trips_both_ways(tmp_path, workloads):
    jb, _, tb, _ = workloads
    tck.save_batch(tb, str(tmp_path / "port.npz"))
    jck.save_batch(jb, str(tmp_path / "jax.npz"))
    from_port = jck.load_batch(str(tmp_path / "port.npz"))
    from_jax = tck.load_batch(str(tmp_path / "jax.npz"), device="cpu")
    again = tck.load_batch(str(tmp_path / "port.npz"), device="cpu")
    for name in ("toas_s", "errors_s", "mask", "phat", "epoch_index", "backend_index",
                 "tspan_s", "ntoas", "freqs_mhz", "epoch_mask"):
        want = np.asarray(getattr(jb, name))
        np.testing.assert_array_equal(np.asarray(getattr(from_port, name)), want, err_msg=name)
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(), want, err_msg=name)
        assert torch.equal(getattr(again, name), getattr(tb, name)), name
    for name in ("tref_mjd", "names", "backend_names", "start_s", "stop_s"):
        assert getattr(from_jax, name) == getattr(jb, name) == getattr(from_port, name)
    assert from_jax.epoch_index.dtype == torch.int64
    f32 = tck.load_batch(str(tmp_path / "jax.npz"), dtype=torch.float32, device="cpu")
    assert f32.toas_s.dtype == torch.float32 and f32.epoch_index.dtype == torch.int64


# ------------------------------------------------------ the port's contracts

def test_checkpoints_byte_identical_across_depths_and_fused(tmp_path, workloads):
    _, _, tb, tr = workloads
    runs = {}
    for name, kw in (("d1", dict(pipeline_depth=1)), ("d2", dict(pipeline_depth=2)),
                     ("d4", dict(pipeline_depth=4)),
                     ("fused", dict(pipeline_depth=2, fused_stream=True))):
        runs[name] = _port(tmp_path, tb, tr, f"{name}.npz", nreal=16, **kw)
    ref, ref_path = runs["d1"]
    for name, (res, path) in runs.items():
        assert _bytes(path) == _bytes(ref_path), name
        assert _bytes(path + ".meta.json") == _bytes(ref_path + ".meta.json"), name
        np.testing.assert_array_equal(res, ref)
        assert glob.glob(path + ".chunk*") == [] and not os.path.exists(path + ".partial")


def test_durable_writes_identical(tmp_path, workloads):
    _, _, tb, tr = workloads
    _, a = _port(tmp_path, tb, tr, "plain.npz")
    _, b = _port(tmp_path, tb, tr, "durable.npz", durable=True)
    assert _bytes(a) == _bytes(b)


class _KillSim(BaseException):
    """A 'process died here' marker that no except-Exception handler takes."""


@pytest.mark.parametrize("depth", [1, 2])
def test_crash_between_chunk_and_sidecar_resumes(tmp_path, workloads, monkeypatch, depth):
    """Killed after chunk 2's file landed and before its sidecar: the
    resume recomputes chunks 2 and 3 only, and matches byte for byte."""
    _, _, tb, tr = workloads
    ref, ref_path = _port(tmp_path, tb, tr, "ref.npz", nreal=16)
    orig = tsw._atomic_write
    seen = [0]

    def bombed(write_fn, final_path, suffix, durable=False):
        if suffix == ".json":
            seen[0] += 1
            if seen[0] == 3:
                raise _KillSim()
        return orig(write_fn, final_path, suffix, durable=durable)

    monkeypatch.setattr(tsw, "_atomic_write", bombed)
    with pytest.raises(_KillSim):
        _port(tmp_path, tb, tr, "crash.npz", nreal=16, pipeline_depth=depth)
    monkeypatch.undo()
    path = str(tmp_path / "crash.npz")
    assert os.path.exists(path + ".chunk000002.npy")
    calls = []
    out, _ = _port(tmp_path, tb, tr, "crash.npz", nreal=16, pipeline_depth=depth,
                   progress=lambda d, t: calls.append(d))
    assert calls == [3, 4]
    np.testing.assert_array_equal(out, ref)
    assert _bytes(path) == _bytes(ref_path)


def test_abort_by_progress_resumes_byte_identical(tmp_path, workloads):
    """A ``progress`` callback that raises is fatal (no retry); the resume
    continues after the last completed chunk."""
    _, _, tb, tr = workloads
    ref, ref_path = _port(tmp_path, tb, tr, "ref.npz", nreal=16)
    path = str(tmp_path / "abort.npz")
    _interrupted(lambda progress: tsw.sweep(3, tb, tr, 16, path, chunk=CHUNK, fit=True,
                                            device="cpu", progress=progress), 2)
    calls = []
    out = tsw.sweep(3, tb, tr, 16, path, chunk=CHUNK, fit=True, device="cpu",
                    progress=lambda d, t: calls.append(d))
    assert calls == [3, 4]
    np.testing.assert_array_equal(out, ref)
    assert _bytes(path) == _bytes(ref_path)


def test_stale_partial_archive_reaped(tmp_path, workloads):
    _, _, tb, tr = workloads
    path = str(tmp_path / "s.npz")
    with open(path + ".partial", "wb") as fh:
        fh.write(b"stale-partial-from-a-killed-run")
    out, _ = _port(tmp_path, tb, tr, "s.npz", pipeline_depth=2)
    assert out.shape == (NREAL, SHAPE["npsr"])
    assert not os.path.exists(path + ".partial")
    with np.load(path) as z:
        assert set(z.files) == {"chunk0", "chunk1"}


def _sidecar_of(tmp_path, tb, tr, name):
    _interrupted(lambda progress: tsw.sweep(3, tb, tr, NREAL, str(tmp_path / name),
                                            chunk=CHUNK, fit=True, device="cpu",
                                            progress=progress), 1)
    return str(tmp_path / name)


@pytest.mark.parametrize("change", ["physics", "reduce", "stream", "jax_sidecar"])
def test_resume_refuses_a_different_sweep(tmp_path, workloads, change):
    jb, jr, tb, tr = workloads
    path = _sidecar_of(tmp_path, tb, tr, "s.npz")
    kw = dict(chunk=CHUNK, fit=True, device="cpu")
    if change == "physics":
        kw["batch"] = tb.astype(torch.float32)
    elif change == "reduce":
        kw["reduce_fn"] = lambda res, batch: res.mean(-1)
    elif change == "stream":
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        meta["stream"] = "pta_replicator_tpu_torch/cuda/torch-0.0"
        with open(path + ".meta.json", "w") as fh:
            json.dump(meta, fh)
    else:  # a JAX sweep's sidecar at the same path
        os.remove(path + ".meta.json")
        os.remove(path + ".chunk000000.npy")
        _interrupted(lambda progress: jsw.sweep(jax.random.PRNGKey(3), jb, jr, NREAL, path,
                                                chunk=CHUNK, fit=True, progress=progress), 1)
        with open(path + ".meta.json") as fh:
            assert json.load(fh)["stream"] == 4
    batch = kw.pop("batch", tb)
    with pytest.raises(ValueError, match="belongs to a different sweep"):
        tsw.sweep(3, batch, tr, NREAL, path, **kw)


def test_jax_sweep_refuses_the_port_sidecar(tmp_path, workloads):
    jb, jr, tb, tr = workloads
    path = _sidecar_of(tmp_path, tb, tr, "s.npz")
    with open(path + ".meta.json") as fh:
        assert json.load(fh)["stream"] == tsw.stream_id("cpu")
    with pytest.raises(ValueError, match="belongs to a different sweep"):
        jsw.sweep(jax.random.PRNGKey(3), jb, jr, NREAL, path, chunk=CHUNK, fit=True)


def test_transient_enospc_is_absorbed_by_chunk_retries(tmp_path, workloads, monkeypatch):
    _, _, tb, tr = workloads
    ref, ref_path = _port(tmp_path, tb, tr, "ref.npz", nreal=16)
    orig = tsw._write_npy
    failures, writes = [0], [0]

    def full_disk_once(path, arr):
        writes[0] += 1
        if writes[0] == 2 and failures[0] == 0:  # chunk 1's file
            failures[0] += 1
            raise OSError(errno.ENOSPC, "No space left on device")
        return orig(path, arr)

    monkeypatch.setattr(tsw, "_write_npy", full_disk_once)
    out, path = _port(tmp_path, tb, tr, "retry.npz", nreal=16, retry_policy=FAST_RETRY)
    assert failures[0] == 1
    np.testing.assert_array_equal(out, ref)
    assert _bytes(path) == _bytes(ref_path)
    failures[0], writes[0] = 0, 0
    with pytest.raises(OSError):
        _port(tmp_path, tb, tr, "no_retry.npz", nreal=16, chunk_retries=0)


@pytest.mark.parametrize("exc,transient", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or unavailable"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("cublas_status_execution_failed when calling cublasSgemm"), False),
    (OSError(errno.ENOSPC, "No space left on device"), True),
    (OSError(errno.ENOENT, "No such file"), False),
    (DrainTimeout("host readback exceeded 900s"), True),
    (ConnectionError("peer went away"), True),
    (RuntimeError("connection reset by peer"), True),
    (ValueError("belongs to a different sweep"), False),
])
def test_cuda_errors_and_oom_are_fatal(exc, transient):
    assert is_transient(exc) is transient


def test_a_cuda_error_in_a_chunk_is_not_retried(tmp_path, workloads, monkeypatch):
    _, _, tb, tr = workloads
    calls = [0]
    orig = tsw._write_npy

    def sticky(path, arr):
        calls[0] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tsw, "_write_npy", sticky)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _port(tmp_path, tb, tr, "sticky.npz", retry_policy=FAST_RETRY)
    assert calls[0] == 1
    monkeypatch.setattr(tsw, "_write_npy", orig)


def test_full_cubes_and_the_bank_from_the_checkpoint(tmp_path, workloads):
    """``reduce_fn=None`` keeps (chunk, Np, Nt) cubes at every depth; the
    bank from the checkpoint prices as the array does (float64)."""
    _, _, tb, tr = workloads
    full, p1 = _port(tmp_path, tb, tr, "cube1.npz", reduce_fn=None, pipeline_depth=1)
    piped, p2 = _port(tmp_path, tb, tr, "cube2.npz", reduce_fn=None, pipeline_depth=2)
    np.testing.assert_array_equal(piped, full)
    assert _bytes(p1) == _bytes(p2)
    bank = lk.RealizationBank.from_checkpoint(p2)
    assert bank.shape == full.shape and bank.nreal == NREAL
    np.testing.assert_array_equal(bank.row(5), full[5])
    grid, _ = lk.grid_cartesian({"gwb_log10_amplitude": [-14.5, -14.0],
                                 "gwb_gamma": [4.0, 4.5]})
    design = quadratic_design(tb)
    a = lk.bank_loglikelihood(bank, tb, tr, grid=grid, design=design, device="cpu")
    b = lk.bank_loglikelihood(torch.as_tensor(full), tb, tr, grid=grid, design=design,
                              device="cpu")
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="residual cubes"):
        lk.RealizationBank.from_checkpoint(_port(tmp_path, tb, tr, "rms.npz")[1])


def test_chunk_summary_reduce_matches_sync(tmp_path, workloads):
    _, _, tb, tr = workloads
    summarize = lambda res, batch: res.mean(dim=0, keepdim=True)
    sync, p1 = _port(tmp_path, tb, tr, "sum1.npz", nreal=16, reduce_fn=summarize,
                     pipeline_depth=1)
    piped, p2 = _port(tmp_path, tb, tr, "sum2.npz", nreal=16, reduce_fn=summarize,
                      pipeline_depth=2)
    assert sync.shape == (4, SHAPE["npsr"], SHAPE["ntoa"])
    np.testing.assert_array_equal(piped, sync)
    assert _bytes(p1) == _bytes(p2)


def test_finished_sweep_returns_from_the_archive(tmp_path, workloads):
    _, _, tb, tr = workloads
    first, path = _port(tmp_path, tb, tr, "f.npz")
    calls = []
    again = tsw.sweep(3, tb, tr, NREAL, path, chunk=CHUNK, fit=True, device="cpu",
                      progress=lambda d, t: calls.append(d))
    assert calls == []
    np.testing.assert_array_equal(again, first)


def test_generator_seeds_and_argument_checks(tmp_path, workloads):
    _, _, tb, tr = workloads
    seeds = [tsw.chunk_seed(3, i) for i in range(4)]
    assert seeds == [tsw.chunk_seed(3, i) for i in range(4)]
    assert len(set(seeds + [tsw.chunk_seed(4, 0)])) == 5
    assert all(0 <= s < 2**63 for s in seeds)
    a, _ = _port(tmp_path, tb, tr, "a.npz")
    b = tsw.sweep(4, tb, tr, NREAL, str(tmp_path / "b.npz"), chunk=CHUNK, fit=True,
                  device="cpu")
    assert not np.array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of chunk"):
        _port(tmp_path, tb, tr, "c.npz", nreal=6)
    with pytest.raises(ValueError, match="pipeline_depth >= 2"):
        _port(tmp_path, tb, tr, "d.npz", pipeline_depth=1, fused_stream=True)


def test_fn_id_matches_the_reference_and_hashes_tensors_by_value():
    w = np.asarray([1.0, 2.0, 3.0])
    f = lambda res, batch: res * w  # noqa: E731
    assert tsw._fn_id(f) == jsw._fn_id(f)
    mk = lambda v: (lambda res, batch: res * v)  # noqa: E731
    a = mk(torch.tensor([1.0, 2.0, 3.0]))
    b = mk(torch.tensor([1.0, 2.0, 3.0]))
    c = mk(torch.tensor([1.0, 2.0, 4.0]))
    assert tsw._fn_id(a) == tsw._fn_id(b) != tsw._fn_id(c)
    assert tsw._fn_id(None) is None


@pytest.mark.parametrize("arr", [
    np.arange(24, dtype=np.float32).reshape(2, 3, 4), np.float64(3.5) * np.ones(()),
    np.zeros((0, 5)), np.arange(10, dtype=np.int64), np.ones((3, 4), order="F"),
    np.arange(12.0).reshape(3, 4)[:, ::2],
])
def test_chunk_files_and_archive_members_are_the_npy_bytes(tmp_path, arr):
    """A chunk file, a member of the consolidated archive and the
    in-memory serialization are np.save's bytes, as in the reference."""
    path = str(tmp_path / "c.npy")
    tsw._write_npy(path, arr)
    assert _bytes(path) == bytes(tsw._npy_bytes(arr)) == bytes(jsw._npy_bytes(arr))
    ckpt = str(tmp_path / "c.npz")
    tsw._consolidate(ckpt, [arr, arr], durable=False)
    assert not os.path.exists(tsw._partial_path(ckpt))
    with zipfile.ZipFile(ckpt) as zf:
        assert zf.namelist() == ["chunk0.npy", "chunk1.npy"]
        assert zf.read("chunk0.npy") == bytes(tsw._npy_bytes(arr))
    np.testing.assert_array_equal(tsw.load_checkpoint_chunk(ckpt, 0), arr)


# ---------------------------------------------------- chunk trace contexts

#: the stage spans of a chunk, by depth: the synchronous loop's chunk span
#: and write, the pipeline's three stages
CHUNK_SPANS = {1: {"sweep_chunk", "io_write"}, 2: {"dispatch", "drain", "io_write"},
               4: {"dispatch", "drain", "io_write"}}


def _chunk_traces(events, spans):
    """chunk -> {(span name, trace id)} of the stage spans in ``events``."""
    out = {}
    for e in events:
        if e.get("type") == "span" and e.get("name") in spans and "chunk" in e.get("attrs", {}):
            out.setdefault(e["attrs"]["chunk"], set()).add((e["name"], e.get("trace_id")))
    return out


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_chunk_trace_ids_are_the_jax_packages_at_every_depth_and_across_a_resume(
        tmp_path, workloads, depth):
    from pta_replicator_tpu.obs.trace import chunk_trace_context as jax_chunk_trace_context
    from pta_replicator_tpu_torch import obs

    _, _, tb, tr = workloads
    path = str(tmp_path / "traced.npz")
    nreal = 3 * CHUNK
    obs.configure(None)
    obs.reset_all()
    _interrupted(lambda progress: tsw.sweep(3, tb, tr, nreal, path, chunk=CHUNK, fit=True,
                                            device="cpu", pipeline_depth=depth,
                                            progress=progress), after=1)
    first = _chunk_traces(obs.TRACER.events(), CHUNK_SPANS[depth])
    obs.reset_all()
    tsw.sweep(3, tb, tr, nreal, path, chunk=CHUNK, fit=True, device="cpu",
              pipeline_depth=depth)
    resumed = _chunk_traces(obs.TRACER.events(), CHUNK_SPANS[depth])
    assert 0 in first and set(resumed) == {1, 2}
    for traces in (first, resumed):
        for i, seen in traces.items():
            want = jax_chunk_trace_context(path, i).trace_id
            assert {t for _, t in seen} == {want}, (i, seen)
    # the resumed chunks carry every stage of their chain
    assert all({n for n, _ in resumed[i]} == CHUNK_SPANS[depth] for i in (1, 2))


@pytest.mark.parametrize("depth", [1, 2])
def test_a_retried_chunk_is_one_trace_with_its_attempts(tmp_path, workloads, depth):
    from pta_replicator_tpu.obs.trace import chunk_trace_context as jax_chunk_trace_context
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.faults import inject

    _, _, tb, tr = workloads
    path = str(tmp_path / "retried.npz")
    obs.configure(None)
    obs.reset_all()
    with inject.armed("drain:raise@chunk=1"):
        tsw.sweep(3, tb, tr, 3 * CHUNK, path, chunk=CHUNK, fit=True, device="cpu",
                  pipeline_depth=depth, chunk_retries=1, retry_policy=FAST_RETRY)
    events = obs.TRACER.events()
    want = jax_chunk_trace_context(path, 1).trace_id
    retries = [e for e in events if e.get("type") == "event" and e["name"] == "faults.retry"]
    assert len(retries) == 1 and retries[0]["attrs"]["chunk"] == 1
    assert retries[0]["trace_id"] == want
    first_stage = "sweep_chunk" if depth == 1 else "dispatch"
    attempts = [e for e in events if e.get("name") == first_stage
                and e.get("attrs", {}).get("chunk") == 1]
    assert len(attempts) == 2 and {e["trace_id"] for e in attempts} == {want}
    # the fault fired inside the failing attempt's drain, in the same trace
    fired = [e for e in events if e.get("type") == "event" and e["name"] == "faults.fired"]
    assert [e["trace_id"] for e in fired] == [want]
