"""The port's fault injection (``pta_replicator_tpu_torch/faults/``) against
the JAX package's on the CPU, and the recovery paths it exercises.

Parity: the schedule grammar (``parse_schedule``, ``spec_str`` and the
malformed-schedule messages), the seeded ``p=`` firings, the ``call=``
firings at one site, ``fired()`` and ``poison``'s seeded element over
1,000 calls equal the JAX package's. Recovery, on the port's sweep (as the
JAX package's ``tests/test_faults.py`` covers its own): a transient drain
failure, a torn checkpoint write, a stall past the drain deadline and a
lost device are absorbed with the checkpoint equal member for member to
the fault-free run's; a fatal fault is not retried; ``chunk_retries=0``
fails fast; the budget is per failing chunk (at depth 1, where each chunk
is written before the next is dispatched, so no test decides on a
wall-clock race). Then the prefetch staging retry, the server's engine
retry, the CLI's ``--faults`` and ``PTA_FAULTS``, and a disarmed ``fire``
that imports nothing. Every stall here is 10x its deadline; together they
sleep under 3 s."""
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.faults import inject as jinject
from pta_replicator_tpu_torch import flagship_workload
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import main
from pta_replicator_tpu_torch.faults import inject
from pta_replicator_tpu_torch.faults.inject import InjectedFault
from pta_replicator_tpu_torch.faults.retry import RetryPolicy, is_transient, retry_call
from pta_replicator_tpu_torch.obs import counter, names
from pta_replicator_tpu_torch.parallel.prefetch import prefetch_to_device
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe
from pta_replicator_tpu_torch.utils.sweep import sweep

from _torch_dataset import small_pulsars, write_with

REPO = Path(__file__).resolve().parent.parent
#: fast in-process recovery (the default policy backs off 0.5 s and more)
FAST = RetryPolicy(max_attempts=4, base_delay_s=0.01, multiplier=2.0, max_delay_s=0.1,
                   jitter=0.0)
NREAL, CHUNK, SEED = 16, 4, 5
#: a stall and its drain deadline: 10x apart
STALL_S, DEADLINE_S = 1.0, 0.1

SCHEDULES = [
    "drain:raise@chunk=2",
    "checkpoint_write:torn@call=3",
    "dispatch:stall=2.5@chunk=1x2",
    "cw_stream_stage:device_lost@p=0.1",
    "io_write:enospc@call=1x3",
    "drain:nan@chunk=1",
    "likelihood_batch:fatal@call=2",
    "checkpoint_fsync:torn@p=0.25x4",
    " drain:raise@chunk=0 ; io_write:raise@call=2 ",
    "drain:stall=0.5@p=1",
]
MALFORMED = [
    "nosite:raise@chunk=1", "drain:explode@chunk=1", "drain:raise@tick=1", "drain:raise",
    "drain:torn@call=1", "drain:raise@p=1.5", "drain:raise@call=0", "drain:raise=3@chunk=1",
    "io_write:nan@chunk=0", "drain:raise@chunk=x",
]


@pytest.fixture(autouse=True)
def _disarmed():
    inject.disarm()
    jinject.disarm()
    yield
    inject.disarm()
    jinject.disarm()


# ------------------------------------------------------- grammar parity

@pytest.mark.parametrize("text", SCHEDULES)
def test_schedules_parse_as_jax_parses_them(text):
    got, want = inject.parse_schedule(text), jinject.parse_schedule(text)
    assert [s.spec_str() for s in got] == [s.spec_str() for s in want]
    for g, w in zip(got, want):
        assert (g.site, g.kind, g.stall_s, g.chunk, g.call, g.p, g.max_fires) == (
            w.site, w.kind, w.stall_s, w.chunk, w.call, w.p, w.max_fires)
    assert inject.SITES == jinject.SITES and inject.KINDS == jinject.KINDS


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_schedules_refuse_with_jax_messages(bad):
    with pytest.raises(ValueError) as got:
        inject.parse_schedule(bad)
    with pytest.raises(ValueError) as want:
        jinject.parse_schedule(bad)
    assert str(got.value) == str(want.value) and "bad fault spec" in str(got.value)


def _drive(mod, schedule, seed):
    """1,000 calls at two sites and the drain's poison, as ``mod`` fires
    them: the indices that raised, the poisoned elements, and ``fired()``."""
    raised, poisoned = [], []
    block = np.arange(64.0).reshape(4, 16)
    mod.arm(schedule, seed=seed)
    for k in range(1000):
        for site in ("drain", "io_write"):
            try:
                mod.fire(site, chunk=k % 37)
            except (mod.InjectedFault, OSError) as exc:
                raised.append((k, site, type(exc).__name__))
        out = mod.poison("drain", block, chunk=k % 37)
        if out is not block:
            poisoned.append((k, int(np.flatnonzero(np.isnan(out))[0])))
    log = mod.fired()
    mod.disarm()
    return raised, poisoned, log


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_firings_and_poison_equal_jax_over_1000_calls(seed):
    schedule = ("drain:raise@p=0.05x40;drain:raise@call=3;drain:raise@call=4;"
                "io_write:enospc@p=0.2x500;drain:nan@p=0.01x20;drain:nan@chunk=5x3")
    got, want = _drive(inject, schedule, seed), _drive(jinject, schedule, seed)
    assert got == want
    raised, poisoned, log = got
    assert len(raised) > 100 and len(poisoned) >= 10
    assert len(log) == min(inject.LOG_CAP, len(raised) + len(poisoned))


def test_fire_and_poison_are_disjoint_by_kind():
    inject.arm("drain:nan@call=1;drain:raise@call=2")
    block = np.ones(8, dtype=np.float32)
    inject.fire("drain")
    out = inject.poison("drain", block)
    assert np.isnan(out).sum() == 1 and np.isfinite(block).all()
    with pytest.raises(InjectedFault) as exc:
        inject.fire("drain")
    assert exc.value.kind == "raise" and is_transient(exc.value)
    assert inject.poison("drain", block) is block


def test_poison_copies_a_tensor_and_leaves_it_untouched():
    """The drain may hand a pinned readback buffer: poison works on a copy."""
    block = torch.arange(12.0).reshape(3, 4)
    inject.arm("drain:nan@chunk=2", seed=3)
    assert inject.poison("drain", block, chunk=1) is block
    out = inject.poison("drain", block, chunk=2)
    assert isinstance(out, np.ndarray) and np.isnan(out).sum() == 1
    assert torch.isfinite(block).all()
    jinject.arm("drain:nan@chunk=2", seed=3)
    want = jinject.poison("drain", block.numpy(), chunk=2)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(want))


def test_kinds_classify_and_torn_truncates(tmp_path):
    assert not is_transient(InjectedFault("drain", "fatal", transient=False))
    assert is_transient(InjectedFault("drain", "device_lost"))
    path = tmp_path / "f.tmp"
    path.write_bytes(b"x" * 100)
    inject.arm("checkpoint_write:torn@call=1;io_write:enospc@call=1;dispatch:fatal@call=1")
    with pytest.raises(InjectedFault, match="truncated"):
        inject.fire("checkpoint_write", path=str(path))
    assert path.stat().st_size == 50
    with pytest.raises(OSError) as exc:
        inject.fire("io_write")
    assert is_transient(exc.value)
    with pytest.raises(InjectedFault) as exc:
        inject.fire("dispatch")
    assert not is_transient(exc.value)


def test_retry_call_absorbs_transients_within_its_budget():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFault("likelihood_batch", "raise")
        return 42

    assert retry_call(flaky, policy=FAST, sleep=lambda s: None) == 42 and len(calls) == 3
    calls.clear()
    with pytest.raises(ValueError):
        retry_call(lambda: calls.append(1) or (_ for _ in ()).throw(ValueError("no")),
                   policy=FAST, sleep=lambda s: None)
    assert len(calls) == 1


def test_a_disarmed_fire_imports_nothing():
    """The module alone (standard library only), fired and poisoned while
    disarmed, pulls in neither torch nor any module of the port."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('inj', {str(REPO / 'pta_replicator_tpu_torch' / 'faults' / 'inject.py')!r})\n"
        "mod = sys.modules['inj'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "before = set(sys.modules)\n"
        "mod.fire('drain', chunk=3)\n"
        "assert mod.poison('drain', 'block', chunk=1) == 'block'\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'pta_replicator_tpu_torch')]\n"
        "assert not new and not bad, (new, bad)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------- sweep recovery

@pytest.fixture(scope="module")
def workload():
    return flagship_workload(npsr=3, ntoa=64, ncw=2, dtype=torch.float64, device="cpu")


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def _sweep(workload, path, **kw):
    b, r = workload
    kw.setdefault("retry_policy", FAST)
    return sweep(SEED, b, r, NREAL, str(path), chunk=CHUNK, reduce_fn=None, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(workload, tmp_path_factory):
    path = tmp_path_factory.mktemp("faults_ref") / "ref.npz"
    return _sweep(workload, path), _members(path)


@pytest.mark.parametrize("schedule,kw,faults", [
    ("drain:raise@chunk=2", {}, 1),
    ("checkpoint_write:torn@call=3", {}, 1),
    (f"drain:stall={STALL_S:g}@chunk=1", {"drain_timeout_s": DEADLINE_S}, 1),
    ("dispatch:device_lost@chunk=1", {"pipeline_depth": 1}, 1),
    ("drain:raise@chunk=1;io_write:raise@chunk=3", {"pipeline_depth": 1}, 2),
])
def test_sweep_recovers_member_identical(workload, reference, tmp_path, schedule, kw, faults):
    ref, ref_members = reference
    r0 = counter(names.SWEEP_CHUNK_RETRIES).value
    with inject.armed(schedule):
        out = _sweep(workload, tmp_path / "chaos.npz", **kw)
        fired = inject.fired()
    np.testing.assert_array_equal(out, ref)
    assert _members(tmp_path / "chaos.npz") == ref_members
    assert counter(names.SWEEP_CHUNK_RETRIES).value == r0 + faults
    assert [f["spec"] for f in fired] == [s.spec_str() for s in inject.parse_schedule(schedule)]
    if "stall" in schedule:
        assert counter(names.PIPELINE_DRAIN_TIMEOUTS).value >= 1


def test_sweep_fatal_fault_is_not_retried(workload, tmp_path):
    r0 = counter(names.SWEEP_CHUNK_RETRIES).value
    with inject.armed("drain:fatal@chunk=1"):
        with pytest.raises(InjectedFault, match="fatal"):
            _sweep(workload, tmp_path / "fatal.npz")
        assert len(inject.fired()) == 1
    assert counter(names.SWEEP_CHUNK_RETRIES).value == r0


def test_sweep_chunk_retries_zero_fails_fast(workload, tmp_path):
    with inject.armed("drain:raise@chunk=1"):
        with pytest.raises(InjectedFault):
            _sweep(workload, tmp_path / "ff.npz", chunk_retries=0)
        assert len(inject.fired()) == 1


def test_sweep_budget_is_per_failing_chunk(workload, reference, tmp_path):
    """Depth 1: chunk i is written before chunk i + 1 is dispatched, so the
    sidecar's progress between two failures is fixed, not raced."""
    out = None
    with inject.armed("drain:raise@chunk=1;drain:raise@chunk=3"):
        out = _sweep(workload, tmp_path / "two.npz", chunk_retries=1, pipeline_depth=1)
    np.testing.assert_array_equal(out, reference[0])
    with inject.armed("drain:raise@chunk=1x5"):
        with pytest.raises(InjectedFault):
            _sweep(workload, tmp_path / "exhaust.npz", chunk_retries=2, pipeline_depth=1)
        assert len(inject.fired()) == 3  # the first try and two retries


# --------------------------------------------- prefetch and server

def test_prefetch_retries_a_transient_staging_once():
    tiles = [np.full((4, 4), k, dtype=np.float64) for k in range(6)]
    r0 = counter(names.CW_STREAM_STAGE_RETRIES).value
    with inject.armed("cw_stream_stage:device_lost@call=2"):
        got = list(prefetch_to_device(iter(tiles), depth=2, device="cpu"))
    assert [g.numpy().tolist() for g in got] == [t.tolist() for t in tiles]
    assert counter(names.CW_STREAM_STAGE_RETRIES).value == r0 + 1
    # a second transient failure of the same tile escalates after its one retry
    with inject.armed("cw_stream_stage:raise@p=1x2"):
        with pytest.raises(InjectedFault):
            list(prefetch_to_device(iter(tiles), depth=1, device="cpu"))
    assert counter(names.CW_STREAM_STAGE_RETRIES).value == r0 + 2
    with inject.armed("cw_stream_stage:fatal@chunk=1"):
        with pytest.raises(InjectedFault):
            list(prefetch_to_device(iter(tiles), depth=2, device="cpu"))
    assert counter(names.CW_STREAM_STAGE_RETRIES).value == r0 + 2  # fatal: no retry


def test_server_retries_a_transient_engine_call_and_fails_fast_on_a_fatal(workload):
    b, r = workload
    bank = np.random.default_rng(0).standard_normal((3, b.npsr, b.ntoa_max)) * 1e-7
    axes = ("gwb_log10_amplitude",)
    points = [-14.5 + 0.1 * k for k in range(6)]

    def serve(schedule):
        with inject.armed(schedule):
            with lk.LikelihoodServer(lk.RealizationBank.from_array(bank), b, r, axes,
                                     max_batch=2, max_delay_s=0.0, device="cpu") as server:
                futures = [server.submit(gwb_log10_amplitude=p) for p in points]
                out = []
                for f in futures:
                    try:
                        out.append(f.result(timeout=60))
                    except InjectedFault as exc:
                        out.append(exc)
            return out, inject.fired()

    clean, _ = serve("likelihood_batch:raise@call=1000")
    flapped, fired = serve("likelihood_batch:raise@call=2")
    assert len(fired) == 1
    for a, c in zip(flapped, clean):
        np.testing.assert_array_equal(a, c)
    failed, fired = serve("likelihood_batch:fatal@call=1")
    assert len(fired) == 1
    bad = [x for x in failed if isinstance(x, InjectedFault)]
    assert 1 <= len(bad) <= 2 and all(x.kind == "fatal" for x in bad)
    assert all(isinstance(x, InjectedFault) or np.all(np.isfinite(x)) for x in failed)


# ------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("faults_cli")
    pardir, timdir = write_with(tsim, small_pulsars(), str(root))
    (root / "r.json").write_text(json.dumps(ng15_like_recipe(4, ncw=1, gwb_npts=100,
                                                             gwb_howml=4.0)))
    return root, ["--pardir", pardir, "--timdir", timdir, "--recipe", str(root / "r.json"),
                  "--nreal", "8", "--chunk", "2", "--fit", "--device", "cpu"]


def _events(directory):
    with open(os.path.join(directory, "events.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_cli_faults_and_env_arm_the_sweep_and_the_capture_records_them(dataset, monkeypatch):
    root, common = dataset
    schedule = "drain:raise@chunk=1;checkpoint_write:torn@call=2"
    runs = {"clean": [], "flag": ["--faults", schedule], "env": []}
    for tag, extra in runs.items():
        if tag == "env":
            monkeypatch.setenv("PTA_FAULTS", schedule)
        main(["realize", *common, "--out", str(root / f"{tag}.npz"), "--checkpoint",
              str(root / f"{tag}_ck.npz"), "--telemetry", str(root / f"tel_{tag}"), *extra])
        monkeypatch.delenv("PTA_FAULTS", raising=False)
        assert not inject.is_armed()
    for tag in ("flag", "env"):
        assert _members(root / f"{tag}_ck.npz") == _members(root / "clean_ck.npz")
        with np.load(root / f"{tag}.npz") as got, np.load(root / "clean.npz") as want:
            np.testing.assert_array_equal(got["residuals"], want["residuals"])
        metrics = json.loads((root / f"tel_{tag}" / "metrics.json").read_text())
        injected = {tuple(sorted(m["labels"].items())): m["value"]
                    for m in metrics[names.FAULTS_INJECTED]}
        assert injected == {(("kind", "raise"), ("site", "drain")): 1,
                            (("kind", "torn"), ("site", "checkpoint_write")): 1}
        fired = [e for e in _events(root / f"tel_{tag}")
                 if e.get("type") == "event" and e.get("name") == names.EVENT_FAULT_FIRED]
        assert sorted(e["attrs"]["site"] for e in fired) == ["checkpoint_write", "drain"]
    clean = json.loads((root / "tel_clean" / "metrics.json").read_text())
    assert names.FAULTS_INJECTED not in clean
    monkeypatch.setenv("PTA_FAULTS", "drain:boom@chunk=1")
    with pytest.raises(SystemExit, match="unknown kind 'boom'"):
        main(["info", "--pardir", str(root / "missing"), "--timdir", str(root / "missing")])
