"""The port's streamed CW catalog: the host plane tiles against the JAX
package's ``cw_catalog_plane_tiles`` (bit for bit), the streamed response
against JAX's ``cgw_catalog_delays_streamed`` (<=1e-12 relative, float64)
and against the port's monolithic plain response (bit for bit when the
tile width is a multiple of ``cgw_chunk``), the prefetcher's order,
bounds, exceptions and stall timeout, and the plane-tile cache in the
reference's format. On the card, the kernel's accumulating launch is held
in ``tests/test_torch_cuda_kernels.py``."""
import dataclasses
import threading
import time
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.batch import synthetic_batch as jax_synthetic_batch
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.ops import pallas_cw
from pta_replicator_tpu.parallel import prefetch as jpf
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch.models import batched as TB
from pta_replicator_tpu_torch.ops import cw as tcw
from pta_replicator_tpu_torch.parallel.prefetch import (
    DrainTimeout,
    load_plane_tiles,
    load_plane_tiles_meta,
    prefetch_to_device,
    save_plane_tiles,
)
from pta_replicator_tpu_torch.scenarios.compile import random_cw_catalog

NSRC = 700


@pytest.fixture(scope="module")
def cw_setup():
    jb = jax_synthetic_batch(npsr=3, ntoa=160, nbackend=2, seed=0, dtype=jnp.float64)
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    cat = random_cw_catalog(np.random.default_rng(3), NSRC)
    return jb, tb, cat


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------ plane tiles

@pytest.mark.parametrize("chunk", [64, 100, 700, 1000])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plane_tiles_bit_equal_to_jax(cw_setup, chunk, dtype):
    jb, _, cat = cw_setup
    phat = np.asarray(jb.phat, np.float64)
    rng = np.random.default_rng(9)
    pdist = rng.uniform(0.5, 2.0, (3, NSRC))
    kw = dict(pdist=pdist, t_fold=-7.7e7, chunk=chunk, dtype=dtype)
    got = list(tcw.cw_catalog_plane_tiles(phat, *cat, **kw))
    want = list(pallas_cw.cw_catalog_plane_tiles(phat, *cat, **kw))
    assert len(got) == len(want) == -(-NSRC // chunk)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gs.dtype == ws.dtype == dtype
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)


def test_plane_tiles_are_column_slices_of_the_whole_catalog(cw_setup):
    _, tb, cat = cw_setup
    pphase = np.random.default_rng(4).uniform(0, 2 * np.pi, NSRC)
    src, psr, _ = TB.cw_catalog_planes_for(tb, *cat, pphase=pphase)
    tiles = list(TB.cw_catalog_plane_tiles_for(tb, *cat, pphase=pphase, chunk=128))
    assert len(tiles) == 6 and tiles[-1][0].shape[-1] == NSRC - 5 * 128
    np.testing.assert_array_equal(np.concatenate([s for s, _ in tiles], -1), src.numpy())
    np.testing.assert_array_equal(np.concatenate([p for _, p in tiles], -1), psr.numpy())
    with pytest.raises(ValueError, match="positive"):
        next(tcw.cw_catalog_plane_tiles(np.eye(3), *cat, chunk=0))


# --------------------------------------------------------- streamed response

@pytest.mark.parametrize("mode", ["evolve_psr", "evolve_earth", "linear_psr"])
def test_streamed_response_matches_jax_streamed(cw_setup, mode):
    jb, tb, cat = cw_setup
    kw = dict(evolve=mode != "linear_psr", psr_term=mode != "evolve_earth")
    want = JB.cgw_catalog_delays_streamed(jb, *[jnp.asarray(r) for r in cat], chunk=128,
                                          prefetch_depth=2, **kw)
    got = TB.cgw_catalog_delays_streamed(tb, *cat, chunk=128, prefetch_depth=2, **kw)
    assert np.any(np.asarray(want) != 0.0)
    assert _rel_max(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_streamed_plain_bit_equal_to_monolithic(cw_setup, depth):
    """Tiles of 128 sources with the plain version's blocks of 64: the
    streamed sum is the monolithic plain response's, bit for bit."""
    _, tb, cat = cw_setup
    mono = TB.cgw_catalog_delays(tb, *cat, chunk=64)
    streamed = TB.cgw_catalog_delays_streamed(tb, *cat, chunk=128, prefetch_depth=depth,
                                              plain_chunk=64)
    torch.testing.assert_close(streamed, mono, rtol=0, atol=0)


@pytest.mark.parametrize("tiles_per_step", [1, 3, 8])
def test_streamed_bit_equal_across_groupings(cw_setup, tiles_per_step):
    _, tb, cat = cw_setup
    mono = TB.cgw_catalog_delays(tb, *cat, chunk=32)
    streamed = TB.cgw_catalog_delays_streamed(tb, *cat, chunk=96, plain_chunk=32,
                                              tiles_per_step=tiles_per_step)
    torch.testing.assert_close(streamed, mono, rtol=0, atol=0)


def test_misaligned_tile_rejected_in_both_packages(cw_setup):
    """A tile wider than the stream's width, or any tile after a narrower
    one, raises in both packages."""
    jb, tb, cat = cw_setup
    tiles = list(TB.cw_catalog_plane_tiles_for(tb, *cat, chunk=200))
    bad = [tiles[1], tiles[3], tiles[0]]  # 200, 100 (narrower), then 200
    with pytest.raises(ValueError, match="uniform"):
        TB.cw_stream_response(tb, iter(bad), evolve=True)
    with pytest.raises(ValueError, match="uniform"):
        JB.cw_stream_response(jb, iter(bad), evolve=True)
    with pytest.raises(ValueError, match="tiles_per_step"):
        TB.cw_stream_response(tb, iter(tiles), evolve=True, tiles_per_step=0)


def test_recipe_streamed_routing_bit_equal(cw_setup):
    """``Recipe.cgw_stream_chunk`` routes deterministic_delays through the
    stream; a multiple of ``cgw_chunk`` gives the monolithic bits."""
    _, tb, cat = cw_setup
    mono = TB.Recipe(cgw_params=cat, cgw_chunk=50)
    streamed = dataclasses.replace(mono, cgw_stream_chunk=150, cgw_prefetch_depth=3)
    a = TB.deterministic_delays(tb, mono, device="cpu")
    b = TB.deterministic_delays(tb, streamed, device="cpu")
    assert bool(torch.any(a != 0))
    torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_stream_fields_carry_across_from_jax(cw_setup):
    jb, tb, cat = cw_setup
    jr = JB.Recipe(cgw_params=jnp.asarray(cat), cgw_stream_chunk=256, cgw_prefetch_depth=3,
                   cgw_chunk=128)
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    assert (tr.cgw_stream_chunk, tr.cgw_prefetch_depth) == (256, 3)
    want = np.asarray(JB.deterministic_delays(jb, jr))
    assert _rel_max(TB.deterministic_delays(tb, tr, device="cpu").numpy(), want) <= 1e-12


def test_plain_accumulate_adds_to_the_running_sum(cw_setup):
    _, tb, cat = cw_setup
    src, psr, _ = TB.cw_catalog_planes_for(tb, *cat)
    u = tb.toas_s - tb.start_s
    acc = torch.linspace(-1e-7, 1e-7, u.numel(), dtype=u.dtype).reshape(u.shape)
    before = acc.clone()
    got = tcw.cw_catalog_response(u, src, psr, chunk=64, out=acc)
    torch.testing.assert_close(acc, before, rtol=0, atol=0)  # not written on the CPU
    want = before + tcw.cw_catalog_response_plain(u, src, psr, chunk=64)
    assert _rel_max(got.numpy(), want.numpy()) <= 1e-14


# ------------------------------------------------------------------ prefetch

def test_prefetch_orders_and_bounds():
    outstanding, peak, lock = [0], [0], threading.Lock()

    def tiles():
        for i in range(12):
            with lock:
                outstanding[0] += 1
                peak[0] = max(peak[0], outstanding[0])
            yield np.full((4,), i)

    got = []
    for staged in prefetch_to_device(tiles(), depth=3, device="cpu"):
        time.sleep(0.005)
        assert isinstance(staged, torch.Tensor)
        got.append(int(staged[0]))
        with lock:
            outstanding[0] -= 1
    assert got == list(range(12))
    assert peak[0] <= 3 + 1


def test_prefetch_stages_tuples_and_reports_stats():
    stats = {}
    tiles = [(np.full((2,), i, np.float32), np.arange(3.0) + i) for i in range(5)]
    out = list(prefetch_to_device(iter(tiles), depth=2, device="cpu", stats=stats))
    assert [tuple(t.dtype for t in o) for o in out] == [(torch.float32, torch.float64)] * 5
    for (a, b), (x, y) in zip(out, tiles):
        np.testing.assert_array_equal(a.numpy(), x)
        np.testing.assert_array_equal(b.numpy(), y)
    assert stats["items"] == 5 and "cw_stream_stage" in stats["stage_busy_s"]


def test_prefetch_depth1_is_serial():
    events = []

    def tiles():
        for i in range(4):
            events.append(("build", i))
            yield np.asarray([i])

    for i, _ in enumerate(prefetch_to_device(tiles(), depth=1, device="cpu")):
        time.sleep(0.02)
        events.append(("consume", i))
    first = events.index(("consume", 0))
    assert [e for e in events[:first] if e[0] == "build"] == [("build", 0)]


def test_prefetch_runs_on_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch_to_device(iter([np.zeros(1)]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch_to_device(iter([np.zeros(1)]), place=lambda tile: tile)
    got = list(prefetch_to_device(iter([np.zeros(1)]), device="cpu"))
    assert len(got) == 1 and got[0].device.type == "cpu"


def test_prefetch_depth0_rejected():
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_device(iter([np.zeros(1)]), depth=0, device="cpu")


def test_prefetch_propagates_tile_build_exception_unchanged():
    class Boom(Exception):
        pass

    def tiles():
        yield np.asarray([0])
        yield np.asarray([1])
        raise Boom("tile build failed")

    got = []
    with pytest.raises(Boom):
        for staged in prefetch_to_device(tiles(), depth=2, device="cpu"):
            got.append(int(staged[0]))
    assert got == [0, 1]


def test_prefetch_propagates_place_exception_unchanged():
    class Boom(Exception):
        pass

    def place(tile):
        if int(tile[0]) == 2:
            raise Boom("staging failed")
        return tile

    got = []
    with pytest.raises(Boom):
        for staged in prefetch_to_device((np.asarray([i]) for i in range(5)), depth=2,
                                         device="cpu", place=place):
            got.append(int(staged[0]))
    assert got == [0, 1]


def test_prefetch_retries_a_transient_staging_failure_once():
    calls = []

    def place(tile):
        calls.append(int(tile[0]))
        if calls.count(1) == 1 and int(tile[0]) == 1:
            raise ConnectionError("copy engine went away")
        return tile

    got = [int(t[0]) for t in prefetch_to_device((np.asarray([i]) for i in range(3)),
                                                 depth=2, device="cpu", place=place)]
    assert got == [0, 1, 2] and calls == [0, 1, 1, 2]


def test_prefetch_stall_timeout():
    hang = threading.Event()

    def place(tile):
        hang.wait(20.0)
        return tile

    t0 = time.monotonic()
    with pytest.raises(DrainTimeout):
        for _ in prefetch_to_device((np.asarray([i]) for i in range(3)), depth=2,
                                    device="cpu", place=place, stall_timeout_s=0.4):
            pass
    assert time.monotonic() - t0 < 10.0
    hang.set()


def test_prefetch_consumer_abandon_stops_worker():
    built = [0]

    def tiles():
        for i in range(100):
            built[0] += 1
            yield np.asarray([i])

    gen = prefetch_to_device(tiles(), depth=2, device="cpu")
    next(gen)
    gen.close()
    time.sleep(0.3)
    assert built[0] <= 5


# ---------------------------------------------------------------- tile cache

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tile_cache_round_trip_identity(tmp_path, cw_setup, writer):
    """A cache written by either package streams to the monolithic bits
    through the port, and the port's archive reads through the JAX
    loader."""
    _, tb, cat = cw_setup
    path = str(tmp_path / "tiles.npz")
    save = save_plane_tiles if writer == "port" else jpf.save_plane_tiles
    n = save(path, TB.cw_catalog_plane_tiles_for(tb, *cat, chunk=128), fingerprint="fp-abc",
             meta={"evolve": True, "chunk": 128})
    assert n == 6
    meta, tiles = load_plane_tiles(path, expect_fingerprint="fp-abc")
    assert meta["ntiles"] == 6 and meta["chunk"] == 128
    mono = TB.cgw_catalog_delays(tb, *cat, chunk=64)
    torch.testing.assert_close(TB.cw_stream_response(tb, tiles, evolve=True), mono,
                               rtol=0, atol=0)
    jmeta, jtiles = jpf.load_plane_tiles(path, expect_fingerprint="fp-abc")
    want = list(TB.cw_catalog_plane_tiles_for(tb, *cat, chunk=128))
    for (s, p), (ws, wp) in zip(jtiles, want):
        np.testing.assert_array_equal(s, ws)
        np.testing.assert_array_equal(p, wp)
    assert jmeta == meta


def test_tile_cache_fingerprint_refusal(tmp_path, cw_setup):
    _, tb, cat = cw_setup
    path = str(tmp_path / "tiles.npz")
    save_plane_tiles(path, TB.cw_catalog_plane_tiles_for(tb, *cat, chunk=512),
                     fingerprint="fp-old")
    with pytest.raises(ValueError, match="fingerprint"):
        load_plane_tiles(path, expect_fingerprint="fp-new")
    meta, _ = load_plane_tiles(path)
    assert meta["fingerprint"] == "fp-old"


def test_tile_cache_truncated_archive_refused(tmp_path):
    import io

    path = str(tmp_path / "trunc.npz")
    with zipfile.ZipFile(path, "w") as zf:
        with zf.open("src000000.npy", "w") as fh:
            b = io.BytesIO()
            np.save(b, np.zeros((9, 4)), allow_pickle=False)
            fh.write(b.getbuffer())
    with pytest.raises(ValueError, match="meta"):
        load_plane_tiles_meta(path)
