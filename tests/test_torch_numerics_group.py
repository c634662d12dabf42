"""The collector's staged groups (``obs/numerics.py``): blocks of one
device, stream, row size and dtype reduced together, each block still its
own records.

On the card an armed sweep reduces :data:`_GROUP_BLOCKS` chunks' slabs at
once; on the host a block is reduced when it ends. The host's group size
is raised here so that the grouping runs on the CPU: the ledger of a
grouped armed sweep equals the ungrouped one field for field, and the
JAX package's on the same draws; a partial group waits staged until
``snapshot`` or ``flush``; a block of another row size reduces the staged
group first; a planted float32 overflow is still named at
``realization.white`` alone; ``reset`` drops the staged blocks."""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.obs import numerics as jnum
from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.obs import numerics as tnum
from pta_replicator_tpu_torch.utils.sweep import sweep

jsw = importlib.import_module("pta_replicator_tpu.utils.sweep")

SHAPE = dict(npsr=3, ntoa=64, ncw=2)
NREAL, CHUNK, SEED = 12, 2, 3
NO_DRIFT = 10**9
FIELDS = ("calls", "elements", "nonfinite", "episodes", "episode_active", "dtype",
          "max_abs", "min_nonzero", "headroom_bits")


@pytest.fixture(autouse=True)
def clean():
    for mod in (tnum, jnum):
        mod.reset()
    yield
    for mod in (tnum, jnum):
        mod.reset()


@pytest.fixture(scope="module")
def workloads():
    jb, jr = jax_flagship(**SHAPE)
    out = {}
    for name, cast in (("float64", lambda x: x),
                       ("float32", lambda x: x.astype(jnp.float32)
                        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x)):
        jbd, jrd = jax.tree_util.tree_map(cast, jb), jax.tree_util.tree_map(cast, jr)
        out[name] = (jbd, jrd, convert.batch_from_arrays(vars(jbd), device="cpu"),
                     convert.recipe_from_arrays(vars(jrd), device="cpu"))
    return out


def _armed_sweep_ledger(tb, tr, path, noise=None):
    tnum.arm(drift_every=NO_DRIFT)
    sweep(SEED, tb, tr, NREAL, str(path), chunk=CHUNK, reduce_fn=None, device="cpu",
          noise=noise)
    tnum.flush()
    doc = tnum.snapshot()
    tnum.reset()
    return doc


def _fields(doc):
    return {s: {k: r[k] for k in FIELDS} for s, r in doc["sites"].items()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_a_grouped_sweep_ledger_equals_the_ungrouped(workloads, tmp_path, monkeypatch,
                                                     dtype, blocks):
    _jb, _jr, tb, tr = workloads[dtype]
    one = _armed_sweep_ledger(tb, tr, tmp_path / "one.npz")
    monkeypatch.setattr(tnum, "_GROUP_BLOCKS_HOST", blocks)
    grouped = _armed_sweep_ledger(tb, tr, tmp_path / "grouped.npz")
    assert _fields(grouped) == _fields(one)
    assert grouped["sites"]["realization.white"]["calls"] == NREAL // CHUNK


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_a_grouped_sweep_ledger_equals_jax(workloads, tmp_path, monkeypatch, dtype):
    jb, jr, tb, tr = workloads[dtype]
    key = jax.random.PRNGKey(SEED)
    jnum.arm(drift_every=NO_DRIFT)
    jsw.sweep(key, jb, jr, NREAL, str(tmp_path / "jax.npz"), chunk=CHUNK, reduce_fn=None)
    jnum.flush()
    jdoc = jnum.snapshot()
    monkeypatch.setattr(tnum, "_GROUP_BLOCKS_HOST", 4)
    noise = lambda i: jax_realize_draws(jax.random.fold_in(key, i), jb, jr, CHUNK)
    tdoc = _armed_sweep_ledger(tb, tr, tmp_path / "port.npz", noise=noise)
    rtol = 1e-6 if dtype == "float64" else 1e-4
    realization = [s for s in jdoc["sites"] if s.startswith("realization.")]
    assert realization and set(realization) <= set(tdoc["sites"])
    for site in realization:
        t, j = tdoc["sites"][site], jdoc["sites"][site]
        for k in ("calls", "elements", "nonfinite", "episodes", "episode_active", "dtype"):
            assert t[k] == j[k], (site, k)
        for k in ("max_abs", "min_nonzero"):
            assert t[k] == pytest.approx(j[k], rel=rtol), (site, k)


def test_a_partial_group_waits_until_snapshot(workloads, monkeypatch):
    _jb, _jr, tb, tr = workloads["float64"]
    monkeypatch.setattr(tnum, "_GROUP_BLOCKS_HOST", 3)
    tnum.arm()
    for k in range(5):
        B.realize(torch.Generator().manual_seed(k), tb, tr, 2, device="cpu")
    # the first three reduced together and queued as one item, two staged
    assert len(tnum._PENDING) == 1 and len(tnum._PENDING[0][0]) == 3
    assert len(tnum._GROUP) == 2 and tnum._SITES == {}
    doc = tnum.snapshot()
    assert not tnum._GROUP and not tnum._PENDING
    assert doc["sites"]["realization.gwb"]["calls"] == 5


def test_another_row_size_reduces_the_staged_group_first(workloads, monkeypatch):
    _jb, _jr, tb, tr = workloads["float64"]
    sizes = (2, 2, 3, 2)

    def ledger():
        tnum.arm()
        for k, n in enumerate(sizes):
            B.realize(torch.Generator().manual_seed(k), tb, tr, n, device="cpu")
        tnum.flush()
        doc = tnum.snapshot()
        tnum.reset()
        return doc

    one = ledger()
    monkeypatch.setattr(tnum, "_GROUP_BLOCKS_HOST", 8)
    tnum.arm()
    for k, n in enumerate(sizes[:3]):
        B.realize(torch.Generator().manual_seed(k), tb, tr, n, device="cpu")
    # the two 2-realization blocks reduced when the 3-realization one came
    assert [len(item[0]) for item in tnum._PENDING] == [2] and len(tnum._GROUP) == 1
    tnum.reset()
    assert _fields(ledger()) == _fields(one)
    assert one["sites"]["realization.gwb"]["elements"] == sum(sizes) * SHAPE["npsr"] * SHAPE["ntoa"]


def test_a_planted_overflow_in_a_group_is_named_at_white_alone(workloads, monkeypatch):
    _jb, _jr, tb, tr = workloads["float32"]
    equad = dataclasses.replace(tr, log10_equad=torch.full_like(tr.log10_equad, 25.0))
    monkeypatch.setattr(tnum, "_GROUP_BLOCKS_HOST", 4)
    tnum.arm()
    # one group of four blocks: the overflow first, then three clean ones,
    # which close its episode only when folded in block order
    for k, r in enumerate((equad, tr, tr, tr)):
        B.realize(torch.Generator().manual_seed(k), tb, r, 2, device="cpu")
    assert len(tnum._PENDING) == 1 and len(tnum._PENDING[0][0]) == 4
    tnum.flush()
    sites = tnum.snapshot()["sites"]
    assert {s for s, r in sites.items() if r["nonfinite"]} == {"realization.white"}
    white = sites["realization.white"]
    assert (white["calls"], white["episodes"], white["episode_active"]) == (4, 1, False)


def test_reset_drops_the_staged_blocks(workloads, monkeypatch):
    _jb, _jr, tb, tr = workloads["float64"]
    monkeypatch.setattr(tnum, "_GROUP_BLOCKS_HOST", 4)
    tnum.arm()
    B.realize(torch.Generator().manual_seed(0), tb, tr, 2, device="cpu")
    assert len(tnum._GROUP) == 1
    tnum.reset()
    assert not tnum._GROUP and not tnum._PENDING
    assert tnum.snapshot()["sites"] == {}
