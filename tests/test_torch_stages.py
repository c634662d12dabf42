"""The port's stage-graph executor and sweep pipeline
(``pta_replicator_tpu_torch/parallel/{stages,pipeline}.py``): order and
window bounds, exceptions re-raised unchanged and in order, the
DrainTimeout deadline, a consumer that abandons the generator, the
per-thread context; and the same items through the JAX package's
``StageGraph``, which must give the same output order and stats keys."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.parallel import stages as jax_stages
from pta_replicator_tpu_torch.parallel import stages as port_stages
from pta_replicator_tpu_torch.parallel.pipeline import (
    DrainTimeout as PipelineDrainTimeout,
    failed_chunk,
    run_pipelined,
)
from pta_replicator_tpu_torch.parallel.stages import DrainTimeout, Stage, StageGraph


def _chain(mod, written, inflight, peak, lock):
    """produce -> transform (releases the window) -> sink, declared with
    ``mod``'s Stage (the port's or the JAX package's)."""

    def produce(i, _p, sp):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        return i

    def transform(i, v, sp):
        time.sleep(0.005)  # let the source run ahead into the window
        with lock:
            inflight[0] -= 1
        return v * 10

    return [mod.Stage("produce", fn=produce),
            mod.Stage("transform", fn=transform, releases_window=True, out_maxsize=3),
            mod.Stage("sink", fn=lambda i, v, sp: written.append((i, v)))]


def test_run_orders_bounds_and_stats():
    written, inflight, peak, lock = [], [0], [0], threading.Lock()
    g = StageGraph(_chain(port_stages, written, inflight, peak, lock), window=3,
                   drain_timeout_s=30.0)
    stats = g.run(range(10))
    assert written == [(i, i * 10) for i in range(10)]
    assert peak[0] <= 3
    assert stats["items"] == 10 and stats["max_inflight"] <= 3
    assert set(stats) == {"items", "wall_s", "max_inflight", "window_wait_s", "stall_s",
                          "stage_busy_s", "occupancy"}
    assert set(stats["stage_busy_s"]) == {"produce", "transform", "sink"}


def test_same_items_through_the_jax_graph():
    """The same declaration through both executors: the same output order,
    and the JAX stats keys, the ``occupancy`` block's among them."""
    outs, keys = {}, {}
    for name, mod in (("port", port_stages), ("jax", jax_stages)):
        written, inflight, peak, lock = [], [0], [0], threading.Lock()
        stats = mod.StageGraph(_chain(mod, written, inflight, peak, lock), window=2,
                               drain_timeout_s=30.0).run(range(7))
        outs[name], keys[name] = written, set(stats)
        assert peak[0] <= 2
    assert outs["port"] == outs["jax"] == [(i, i * 10) for i in range(7)]
    assert keys["port"] == keys["jax"]


def test_run_inline_is_synchronous():
    events = []
    main = threading.get_ident()
    StageGraph([
        Stage("a", fn=lambda i, _p, sp: events.append(("a", i, threading.get_ident())) or i,
              placement="inline"),
        Stage("b", fn=lambda i, v, sp: events.append(("b", i, threading.get_ident())),
              placement="inline"),
    ]).run(range(3))
    assert [(s, i) for s, i, _t in events] == [
        ("a", 0), ("b", 0), ("a", 1), ("b", 1), ("a", 2), ("b", 2)]
    assert all(t == main for _s, _i, t in events)


def test_run_exception_unchanged_and_marked():
    class Boom(Exception):
        pass

    marks = []
    err = Boom("transform failed")

    def transform(i, v, sp):
        if i == 3:
            raise err
        return v

    g = StageGraph([Stage("produce", fn=lambda i, _p, sp: i),
                    Stage("transform", fn=transform, releases_window=True),
                    Stage("sink", fn=lambda i, v, sp: None)],
                   window=2, mark_item=lambda exc, i: marks.append(i))
    with pytest.raises(Boom) as info:
        g.run(range(8))
    assert info.value is err and marks == [3]


def test_run_drain_timeout_on_wedged_stage():
    hang = threading.Event()

    def wedged(i, v, sp):
        hang.wait(20.0)  # never set: a wedged readback
        return v

    t0 = time.monotonic()
    with pytest.raises(DrainTimeout, match="host readback"):
        StageGraph([Stage("produce", fn=lambda i, _p, sp: i),
                    Stage("drain", fn=wedged, releases_window=True,
                          heartbeat_label="host readback"),
                    Stage("sink", fn=lambda i, v, sp: None)],
                   window=2, drain_timeout_s=0.4).run(range(6))
    assert time.monotonic() - t0 < 10.0
    hang.set()


def test_run_window_acquired_at_declared_stage():
    """A later stage acquires the window (the fused sweep's dispatch): the
    source runs ahead only as far as its edge allows."""
    seen = []
    lock = threading.Lock()
    inflight, peak = [0], [0]

    def dispatch(i, v, sp):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        return v

    def drain(i, v, sp):
        time.sleep(0.005)
        with lock:
            inflight[0] -= 1
        return v

    StageGraph([Stage("build", fn=lambda i, _p, sp: i, out_maxsize=1),
                Stage("dispatch", fn=dispatch, acquires_window=True),
                Stage("drain", fn=drain, releases_window=True, out_maxsize=2),
                Stage("sink", fn=lambda i, v, sp: seen.append(v))],
               window=2, drain_timeout_s=30.0).run(range(9))
    assert seen == list(range(9)) and peak[0] <= 2


def test_stage_context_entered_on_its_worker_thread():
    """A stage's ``context`` is entered once, on its own thread, around its
    loop (the sweep's compute stream on a worker)."""
    entered, ran = [], []

    class Ctx:
        def __enter__(self):
            entered.append(threading.get_ident())

        def __exit__(self, *exc):
            return False

    StageGraph([Stage("produce", fn=lambda i, _p, sp: i),
                Stage("work", fn=lambda i, v, sp: ran.append(threading.get_ident()),
                      context=Ctx)]).run(range(4))
    assert len(entered) == 1 and set(ran) == set(entered)
    assert entered[0] != threading.get_ident()


def test_graph_validation_errors():
    with pytest.raises(ValueError, match="at least one"):
        StageGraph([])
    with pytest.raises(ValueError, match="window"):
        StageGraph([Stage("a", fn=lambda i, p, sp: p)], window=0)
    with pytest.raises(ValueError, match="acquire"):
        StageGraph([Stage("a", fn=lambda i, p, sp: p, acquires_window=True),
                    Stage("b", fn=lambda i, p, sp: p, acquires_window=True)])
    with pytest.raises(ValueError, match="placement"):
        StageGraph([Stage("a", fn=lambda i, p, sp: p),
                    Stage("b", fn=lambda i, p, sp: p, placement="gpu")]).run(range(1))
    with pytest.raises(ValueError, match="inline"):
        list(StageGraph([Stage("a", fn=lambda i, p, sp: p),
                         Stage("b", fn=lambda i, p, sp: p)]).iterate(range(2)))


# -------------------------------------------------------- generator mode

def test_iterate_orders_and_window():
    outstanding, peak, lock = [0], [0], threading.Lock()

    def items():
        for i in range(12):
            with lock:
                outstanding[0] += 1
                peak[0] = max(peak[0], outstanding[0])
            yield i

    got = []
    for v in StageGraph([Stage("stage", fn=lambda i, x, sp: x * 2)], window=3).iterate(items()):
        time.sleep(0.005)
        got.append(v)
        with lock:
            outstanding[0] -= 1
    assert got == [2 * i for i in range(12)]
    assert peak[0] <= 3 + 1  # the window and the item being consumed


def test_iterate_error_after_in_order_prefix():
    class Boom(Exception):
        pass

    def items():
        yield 0
        yield 1
        raise Boom("build failed")

    got = []
    with pytest.raises(Boom):
        for v in StageGraph([Stage("stage", fn=lambda i, x, sp: x)], window=2).iterate(items()):
            got.append(v)
    assert got == [0, 1]


def test_iterate_drain_timeout_and_abandon():
    hang = threading.Event()

    def wedged(i, x, sp):
        hang.wait(20.0)
        return x

    t0 = time.monotonic()
    with pytest.raises(DrainTimeout):
        for _ in StageGraph([Stage("stage", fn=wedged)], window=2,
                            drain_timeout_s=0.4).iterate(range(3)):
            pass
    assert time.monotonic() - t0 < 10.0
    hang.set()


def test_iterate_consumer_abandon_stops_worker():
    built = [0]

    def items():
        for i in range(100):
            built[0] += 1
            yield i

    gen = StageGraph([Stage("stage", fn=lambda i, x, sp: x)], window=2).iterate(items())
    next(gen)
    gen.close()
    time.sleep(0.3)
    assert built[0] <= 5


# ----------------------------------------------------------- the pipeline

def test_run_pipelined_orders_and_bounds():
    written, inflight, peak = [], [0], [0]
    lock = threading.Lock()

    def dispatch(i):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        return i

    def fetch(v):
        time.sleep(0.01)
        with lock:
            inflight[0] -= 1
        return np.asarray([v])

    released = []
    stats = run_pipelined(range(12), dispatch, lambda i, b: written.append(i), depth=3,
                          fetch=fetch, release=lambda b: released.append(int(b[0])),
                          drain_timeout_s=30.0)
    assert written == list(range(12)) and released == list(range(12))
    assert stats["chunks"] == 12 and peak[0] <= 3 and stats["max_inflight"] <= 3
    assert set(stats) == {"chunks", "max_inflight", "drain_wait_s", "wall_s", "stage_busy_s",
                          "occupancy"}


def test_run_pipelined_depth1_rejected():
    with pytest.raises(ValueError, match="depth"):
        run_pipelined(range(2), lambda i: i, lambda i, b: None, depth=1)


def test_run_pipelined_propagates_stage_exceptions_unchanged():
    class Boom(Exception):
        pass

    def bad_write(i, block):
        if i == 2:
            raise Boom("write failed")

    with pytest.raises(Boom) as info:
        run_pipelined(range(6), lambda i: i, bad_write, depth=2,
                      fetch=lambda v: np.asarray([v]))
    assert failed_chunk(info.value) == 2

    def bad_dispatch(i):
        if i == 1:
            raise Boom("dispatch failed")
        return i

    with pytest.raises(Boom):
        run_pipelined(range(6), bad_dispatch, lambda i, b: None, depth=2,
                      fetch=lambda v: np.asarray([v]))


@pytest.mark.parametrize("wedge", ["fetch", "write"])
def test_run_pipelined_drain_timeout(wedge):
    """A wedged readback or a wedged write raises DrainTimeout fast."""
    hang = threading.Event()
    fetch = lambda v: np.asarray([v])
    write = lambda i, b: None
    if wedge == "fetch":
        fetch = lambda v: hang.wait(20.0) or np.asarray([v])
    else:
        write = lambda i, b: hang.wait(20.0)
    t0 = time.monotonic()
    with pytest.raises(PipelineDrainTimeout):
        run_pipelined(range(6), lambda i: i, write, depth=2, fetch=fetch,
                      drain_timeout_s=0.4)
    assert time.monotonic() - t0 < 10.0
    hang.set()


# ------------------------------------------------------ trace handoff

def _seen_contexts(mod_stages, current_trace, trace_scope):
    """A three-thread chain (source, a worker, a sink) over 6 items under
    ``trace_scope``, declared with ``mod_stages``; each stage records the
    trace id it runs under, by item."""
    seen, lock = {}, threading.Lock()

    def record(stage):
        def fn(i, v, sp):
            ctx = current_trace()
            with lock:
                seen.setdefault(i, set()).add((stage, ctx.trace_id if ctx else None))
            return v
        return fn

    mod_stages.StageGraph(
        [mod_stages.Stage("src", fn=record("src")),
         mod_stages.Stage("mid", fn=record("mid"), releases_window=True, out_maxsize=2),
         mod_stages.Stage("sink", fn=record("sink"))],
        window=2, drain_timeout_s=30.0, trace_scope=trace_scope).run(range(6))
    return seen


def test_run_carries_each_items_trace_context_through_every_edge():
    from pta_replicator_tpu.obs import trace as jtrace
    from pta_replicator_tpu_torch.obs import trace as ttrace

    port = _seen_contexts(port_stages, ttrace.current_trace, "ck.npz")
    jax_seen = _seen_contexts(jax_stages, jtrace.current_trace, "ck.npz")
    assert port == jax_seen
    for i in range(6):
        want = jtrace.chunk_trace_context("ck.npz", i).trace_id
        assert port[i] == {("src", want), ("mid", want), ("sink", want)}
    # no scope: the stages run under the caller's own (here no) context
    untraced = _seen_contexts(port_stages, ttrace.current_trace, None)
    assert all({t for _, t in s} == {None} for s in untraced.values())


def test_iterate_carries_the_consumers_context_onto_the_worker():
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.obs import trace as ttrace

    ctx = ttrace.deterministic_trace_context("consumer", 1)
    seen = []

    def head(i, raw, sp):
        seen.append(ttrace.current_trace().trace_id)
        return raw

    obs.configure(None)
    obs.reset_all()
    graph = StageGraph([Stage("cw_stream_stage", fn=head, span="cw_stream_stage",
                              index_attr="tile")], window=2, drain_timeout_s=30.0)
    with ttrace.adopt(ctx):
        assert list(graph.iterate(range(4))) == [0, 1, 2, 3]
    assert seen == [ctx.trace_id] * 4
    spans = [e for e in obs.TRACER.events() if e.get("name") == "cw_stream_stage"]
    # four tiles and the pull that met the end of the stream
    assert len(spans) == 5 and {e["trace_id"] for e in spans} == {ctx.trace_id}
    assert {e["parent_id"] for e in spans} == {ctx.span_id}


def test_prefetch_adopts_the_consumers_trace():
    from pta_replicator_tpu_torch import obs
    from pta_replicator_tpu_torch.obs import trace as ttrace
    from pta_replicator_tpu_torch.parallel.prefetch import prefetch_to_device

    obs.configure(None)
    obs.reset_all()
    tiles = [np.full((2, 3), k, dtype=np.float64) for k in range(5)]
    ctx = ttrace.chunk_trace_context("stream", 7)
    with ttrace.adopt(ctx):
        got = list(prefetch_to_device(iter(tiles), depth=2, device="cpu"))
    assert [g.numpy().tolist() for g in got] == [t.tolist() for t in tiles]
    stages = [e for e in obs.TRACER.events() if e.get("name") == "cw_stream_stage"]
    assert len(stages) >= 5 and {e["trace_id"] for e in stages} == {ctx.trace_id}
    # an untraced consumer leaves the worker untraced
    obs.reset_all()
    list(prefetch_to_device(iter(tiles), depth=2, device="cpu"))
    assert not any("trace_id" in e for e in obs.TRACER.events()
                   if e.get("name") == "cw_stream_stage")


def test_run_pipelined_scopes_chunk_traces_per_call_or_as_given():
    from pta_replicator_tpu.obs import trace as jtrace
    from pta_replicator_tpu_torch.obs import trace as ttrace

    def traced_run(**kw):
        seen = {}

        def note(stage, i):
            seen.setdefault(i, set()).add((stage, ttrace.current_trace().trace_id))

        def dispatch(i):
            note("dispatch", i)
            return i

        def fetch(v):
            note("drain", v)
            return np.asarray([v])

        run_pipelined(range(4), dispatch, lambda i, b: note("io_write", i), depth=2,
                      fetch=fetch, drain_timeout_s=30.0, **kw)
        return {i: {t for _, t in s} for i, s in seen.items()}

    given = traced_run(trace_scope="sweep.npz")
    assert given == {i: {jtrace.chunk_trace_context("sweep.npz", i).trace_id}
                     for i in range(4)}
    first, second = traced_run(), traced_run()
    assert all(len(first[i]) == 1 and len(second[i]) == 1 for i in range(4))
    assert first[0] != second[0]  # a per-call scope by default
