"""Device meshes: realizations, and optionally pulsars, sharded over devices.

Counterpart of ``pta_replicator_tpu/parallel/mesh.py``. A :class:`Mesh` is
an ``(n_real, n_psr)`` grid of ``torch.device`` s with the axes

* ``real``: independent realizations (pure data parallel), and
* ``psr``: the pulsar axis.

The engine is the JAX package's ``shard_map`` design, run shard by shard
from one process: no shard talks to another, so no device collective is
needed. A shard on ``(real r, psr p)`` draws the whole chunk's noise on its
device from an identically seeded generator (or takes the given draws),
then keeps its window: realizations ``r`` and pulsars ``p``
(``models/batched.py::draws_window``, the JAX package's ``rows=`` idea on
both axes). The GWB's mix of a pulsar window is the window's rows of the
ORF factor times the whole draw (``recipe_window``), so the cross-pulsar
mix needs nothing from another shard either. The deterministic delays
(B.1's CW catalog, ...) are computed once on the whole batch and windowed
(:func:`static_delays`); a design refit is assembled once per (device,
pulsar window) (:func:`shard_fit_systems`), which puts the GLS refit's
B.4/B.5 sweeps on each 'psr' shard.

The draw costs each shard the whole chunk's draw stage and the whole
chunk's draws in memory (a 2 x 2 mesh on one card holds them four times
over); it keeps the port's draw layout, so every output and the sweep's
stream id stay what they are.

Devices may repeat: ``make_mesh(2, 2, devices=["cpu"] * 4)`` on the host
and ``[cuda:0] * 4`` on one card are the counterpart of the JAX package's
forced host device count. Shards on one device share its one compute
stream (cuBLAS is bitwise reproducible only on one stream); only copies
take side streams. A mesh's devices are of one kind: CUDA Philox's stream
depends on the launch grid, and so on the card's SM count.

Not ``torch.distributed``'s ``DeviceMesh``/``DTensor``: they need one
process per device, so they can neither repeat a device nor run a mesh on
one card, and the data path has no collective for them to carry. A
multi-process run (``parallel/distributed.py``) lays its processes out on
the 'real' axis: each process holds a mesh over its local devices and
computes its own shards.

Telemetry: the ``make_mesh``, ``shard_batch``, ``static_delays``,
``sharded_realize`` / ``shardmap_realize`` (with its ``dispatch`` span)
spans, the ``mesh.devices`` gauge and, in :func:`fetch_shard_blocks`, the
``sweep.shards_inflight`` gauge.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..batch import PulsarBatch
from ..device import resolve_device
from ..kernels import launches
from ..models.batched import (
    Recipe, deterministic_delays, draw_noise, draws_window, fit_system, realize, recipe_window,
)
from ..obs import gauge, names, span
from ..utils.sweep import ShardedBlock

def _device_kind(device: torch.device) -> tuple:
    """What makes two devices' random streams and kernels the same: the
    type and, for a card, its name and SM count."""
    if device.type != "cuda":
        return (device.type,)
    props = torch.cuda.get_device_properties(device)
    return (device.type, props.name, props.multi_processor_count)


class Mesh:
    """A ``(n_real, n_psr)`` grid of this process's devices, axes
    ``('real', 'psr')``. In a run of ``process_count`` processes the
    'real' axis is laid out (process, local device): this process's rows
    of the global mesh start at ``process_index * n_real``."""

    def __init__(self, devices, process_index: int = 0, process_count: int = 1):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty (n_real, n_psr) grid, got {grid.shape}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def shape(self) -> dict:
        """The global mesh's axis sizes."""
        return {"real": self.devices.shape[0] * self.process_count, "psr": self.devices.shape[1]}

    @property
    def size(self) -> int:
        """This process's devices (repeats counted)."""
        return int(self.devices.size)

    @property
    def label(self) -> str:
        return f"{self.shape['real']}x{self.shape['psr']}"

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def distinct_devices(self) -> list:
        """The devices of the grid, each once, in grid order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def visible_devices(device_type: str = "cuda") -> list:
    """Every visible card (``device_type="cuda"``, the default; raises
    without one), or the one host device (``"cpu"``)."""
    if torch.device(device_type).type == "cpu":
        return [torch.device("cpu")]
    resolve_device(device_type)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_real: Optional[int] = None, n_psr: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``('real', 'psr')`` mesh over ``devices`` (default: every visible
    card), which may repeat a device. ``n_real`` defaults to every device
    on the realization axis. Refuses a shape larger than the device list
    and devices of different kinds; a mesh never shrinks to fewer
    shards."""
    with span(names.SPAN_MAKE_MESH) as sp:
        devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d for d in devices]
        if n_real is None:
            n_real = len(devices) // n_psr
        needed = n_real * n_psr
        if n_real < 1 or n_psr < 1 or needed > len(devices):
            raise ValueError(f"mesh {n_real}x{n_psr} needs {needed} devices, "
                             f"only {len(devices)} available")
        devices = devices[:needed]
        kinds = {_device_kind(d) for d in devices}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's devices must be of one kind (their random streams "
                             f"differ otherwise), got {sorted(kinds)}")
        sp["n_real"], sp["n_psr"] = n_real, n_psr
        gauge(names.MESH_DEVICES).set(needed)
        grid = np.empty((n_real, n_psr), dtype=object)
        for k, d in enumerate(devices):
            grid[k // n_psr, k % n_psr] = d
        return Mesh(grid)


# ---------------------------------------------------------------- shards

@dataclass(frozen=True)
class Shard:
    """One shard of a ``(nreal, npsr)`` block: its global mesh coordinate,
    its device and its windows ``(start, stop)`` of realizations and
    pulsars."""

    real: int
    psr: int
    device: torch.device
    rows: tuple
    pulsars: tuple


def shard_plan(mesh: Mesh, nreal: int, npsr: int) -> list:
    """This process's shards of ``nreal`` realizations of ``npsr`` pulsars,
    row-major over the local grid. Raises unless both divide evenly."""
    n_real, n_psr = mesh.shape["real"], mesh.shape["psr"]
    if nreal % n_real:
        raise ValueError(f"nreal={nreal} not divisible by mesh 'real'={n_real}")
    if npsr % n_psr:
        raise ValueError(f"npsr={npsr} not divisible by mesh 'psr'={n_psr}")
    rs, ps = nreal // n_real, npsr // n_psr
    offset = mesh.process_index * mesh.devices.shape[0]
    return [Shard(offset + r, p, mesh.devices[r, p], ((offset + r) * rs, (offset + r + 1) * rs),
                  (p * ps, (p + 1) * ps))
            for r in range(mesh.devices.shape[0]) for p in range(n_psr)]


class ShardedArray:
    """A result as per-shard tensors on their devices: ``shards`` is
    ``[(index, tensor), ...]``, ``index`` a ``((start, stop), ...)``
    window of the whole ``shape`` per dimension (the form the sharded
    checkpoint's manifest records). Shards with equal windows are
    replicas."""

    def __init__(self, shape, dtype, shards):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.shards = list(shards)

    def assemble(self) -> torch.Tensor:
        """The whole array on the first shard's device. Refuses a partial
        cover."""
        unique = dict(self.shards)
        volume = sum(t.numel() for t in unique.values())
        if volume != int(np.prod(self.shape)):
            raise ValueError(f"sharded array covers {volume} of {int(np.prod(self.shape))} "
                             "elements — a partial shard set cannot be assembled")
        device = self.shards[0][1].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for index, t in unique.items():
            out[tuple(slice(a, b) for a, b in index)] = t.to(device)
        return out


def _spec_index(shape, spec, mesh: Mesh, real: int, psr: int) -> tuple:
    """The window of the mesh coordinate ``(real, psr)`` under ``spec``: a
    tuple of ``'real'``, ``'psr'`` or None per leading dimension (the rest
    whole), as the JAX package's ``PartitionSpec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    coord = {"real": real, "psr": psr}
    index = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            index.append((0, int(dim)))
            continue
        n = mesh.shape[axis]
        if dim % n:
            raise ValueError(f"dimension {dim} not divisible by mesh '{axis}'={n}")
        step = dim // n
        index.append((coord[axis] * step, (coord[axis] + 1) * step))
    return tuple(index)


def put_sharded(x, mesh: Mesh, spec) -> ShardedArray:
    """``x`` (a tensor or an array) placed on ``mesh`` under ``spec``: each
    of this process's devices gets its window (a view where ``x`` already
    lies on that device, else one copy). An already sharded ``x`` passes
    through."""
    if isinstance(x, ShardedArray):
        return x
    x = torch.as_tensor(x)
    pieces = []
    for r in range(mesh.devices.shape[0]):
        for p in range(mesh.devices.shape[1]):
            real = mesh.process_index * mesh.devices.shape[0] + r
            index = _spec_index(x.shape, spec, mesh, real, p)
            pieces.append((index, x[tuple(slice(a, b) for a, b in index)].to(mesh.devices[r, p])))
    return ShardedArray(x.shape, x.dtype, pieces)


def _unique(shards) -> dict:
    """One shard per distinct window, in the order given."""
    out = {}
    for index, t in shards:
        out.setdefault(index, t)
    return out


def mark_shards(arr: ShardedArray):
    """On the dispatching thread, right after ``arr``'s shards were
    launched: an event per card shard on its device's current (compute)
    stream. Returns what :func:`fetch_shard_blocks` takes with
    ``readbacks``."""
    events = {}
    for index, t in _unique(arr.shards).items():
        if t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            events[index] = ev
    return arr, events


def fetch_shard_blocks(arr, readbacks: Optional[dict] = None):
    """Per-shard host readback of a :class:`ShardedArray` (or of a
    :func:`mark_shards` pair) into a :class:`~..utils.sweep.ShardedBlock`:
    one copy per distinct window (replicas once), every copy issued before
    the first is waited for, so the device-to-host copies of all shards
    drain together. ``readbacks`` maps a card to its
    ``parallel/pipeline.py::PinnedReadback`` (the sweep's pinned rings,
    copies off the compute stream); without it a card shard is copied with
    ``non_blocking`` after an event on its current stream. A single shard,
    a tensor or an array comes back as one numpy array. The
    ``sweep.shards_inflight`` gauge counts the copies still draining."""
    from .pipeline import host_copy

    events = {}
    if isinstance(arr, tuple):
        arr, events = arr
    if not isinstance(arr, ShardedArray):
        return host_copy(arr)
    unique = _unique(arr.shards)
    if len(unique) == 1:
        (index, t), = unique.items()
        if index == tuple((0, n) for n in arr.shape):
            rb = (readbacks or {}).get(t.device)
            return rb.fetch((t, events[index])) if rb is not None else host_copy(t)
    order = sorted(unique)
    gauge(names.SWEEP_SHARDS_INFLIGHT).set(len(order))
    pending = {}
    for index in order:
        t = unique[index]
        rb = (readbacks or {}).get(t.device)
        if rb is not None:
            pending[index] = ("ring", rb, rb.issue((t, events[index])))
        elif t.device.type == "cuda":
            host = t.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(t.device))
            pending[index] = ("event", done, host)
        else:
            pending[index] = ("host", None, t)
    blocks, inflight = [], len(order)
    for index in order:
        how, waiter, handle = pending[index]
        if how == "ring":
            block = waiter.wait(handle)
        elif how == "event":
            waiter.synchronize()
            block = handle.numpy()
        else:
            block = host_copy(handle)
        blocks.append((index, block))
        inflight -= 1
        gauge(names.SWEEP_SHARDS_INFLIGHT).set(inflight)
    return ShardedBlock(arr.shape, torch.empty((), dtype=arr.dtype).numpy().dtype, blocks)


# ----------------------------------------------------------------- inputs

class ShardedInputs:
    """A batch and recipe laid out for a mesh: the whole of each on every
    distinct device (the draws are drawn at the whole chunk's shape) and
    each pulsar window of them on its device (views), from
    :func:`shard_batch`."""

    def __init__(self, batch: PulsarBatch, recipe: Recipe, mesh: Mesh):
        self.mesh = mesh
        self.npsr = batch.npsr
        self.whole = {d: (batch.to(d), recipe.to(d)) for d in mesh.distinct_devices()}
        self._windows = {}

    def window(self, device, pulsars) -> tuple:
        """``(batch, recipe)`` of pulsars ``pulsars`` on ``device``."""
        key = (device, tuple(pulsars))
        if key not in self._windows:
            b, r = self.whole[device]
            if tuple(pulsars) == (0, b.npsr):
                self._windows[key] = (b, r)
            else:
                self._windows[key] = (b.window(*pulsars), recipe_window(r, b, *pulsars))
        return self._windows[key]


def shard_batch(batch: PulsarBatch, mesh: Mesh, recipe: Optional[Recipe] = None):
    """Place ``batch`` (and ``recipe``) on ``mesh``. Returns the
    :class:`ShardedInputs`, whose ``window(device, pulsars)`` is a shard's
    pulsar window; the recipe's per-pulsar fields are checked against the
    pulsar count here (``recipe_window``)."""
    with span(names.SPAN_SHARD_BATCH, npsr=batch.npsr):
        inputs = ShardedInputs(batch, recipe if recipe is not None else Recipe(), mesh)
        for shard in shard_plan(mesh, mesh.shape["real"], batch.npsr):
            inputs.window(shard.device, shard.pulsars)
        return inputs


def static_delays(batch: PulsarBatch, recipe: Recipe, mesh: Mesh) -> ShardedArray:
    """The deterministic delays (B.1's CW catalog, bursts, memory,
    transients) computed once on the whole batch on the mesh's first
    device, then each shard's pulsar window on its device: the
    once-per-sweep precompute :func:`sharded_realize` takes as
    ``static``. A transient targets its global pulsar index, so it works
    on a pulsar-sharded mesh."""
    with span(names.SPAN_STATIC_DELAYS, npsr=batch.npsr, mesh=mesh.label):
        whole = deterministic_delays(batch, recipe, device=mesh.devices.flat[0])
        return put_sharded(whole, mesh, ("psr", None))


def shard_fit_systems(inputs: ShardedInputs, plan) -> dict:
    """The design refit's assembly (``models/batched.py::fit_system``) of
    each distinct (device, pulsar window) of ``plan``: a pulsar window's
    WLS or GLS system is the whole array's restricted to its pulsars (the
    fits are per pulsar), and on a banded covariance its C0 factor and
    solves run B.4/B.5 on that shard."""
    systems = {}
    for shard in plan:
        key = (shard.device, shard.pulsars)
        if key not in systems:
            b, r = inputs.window(*key)
            systems[key] = fit_system(b, r)
    return systems


def reduce_shards(arr: ShardedArray, reduce_fn, inputs: ShardedInputs) -> ShardedArray:
    """``reduce_fn(block, batch)`` on each shard's block with its pulsar
    window's batch (the sweep's per-chunk reduction). The output keeps the
    realization axis first; on a pulsar-sharded mesh it must keep the
    pulsar axis second (a reduction over pulsars would need the others'
    shards), and raises otherwise."""
    psr_sharded = inputs.mesh.shape["psr"] > 1
    pieces = []
    for index, t in arr.shards:
        rows, pulsars = index[0], index[1]
        out = reduce_fn(t, inputs.window(t.device, pulsars)[0])
        if out.ndim < 1 or out.shape[0] != rows[1] - rows[0]:
            raise ValueError("reduce_fn must keep the realization axis first, got "
                             f"{tuple(out.shape)} for {rows[1] - rows[0]} realizations")
        if psr_sharded:
            if out.ndim < 2 or out.shape[1] != pulsars[1] - pulsars[0]:
                raise ValueError(
                    "on a pulsar-sharded mesh reduce_fn runs on each shard and must keep "
                    f"the pulsar axis second, got {tuple(out.shape)} for "
                    f"{pulsars[1] - pulsars[0]} pulsars")
            lead = (rows, pulsars)
        else:
            lead = (rows,)
        pieces.append((lead + tuple((0, n) for n in out.shape[len(lead):]), out))
    tail = tuple(pieces[0][1].shape[2 if psr_sharded else 1:])
    shape = (arr.shape[0],) + ((inputs.npsr,) if psr_sharded else ()) + tail
    return ShardedArray(shape, pieces[0][1].dtype, pieces)


def _static_piece(static: ShardedArray, shard: Shard):
    """The shard's pulsar window of the placed static delays."""
    for index, t in static.shards:
        if index[0] == shard.pulsars and t.device == shard.device:
            return t
    for index, t in static.shards:
        if index[0] == shard.pulsars:
            return t.to(shard.device)
    raise ValueError(f"the static delays hold no window {shard.pulsars} for this mesh")


def _device_context(device):
    """The shard's device made current: the calling thread dispatches every
    shard, each on that thread's current (compute) stream of its device."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _realize_shard(shard: Shard, seed, inputs: ShardedInputs, nreal: int, fit: bool,
                   static: ShardedArray, systems: Optional[dict], noise):
    """One shard's realizations: the whole chunk's draws (``noise``, or a
    generator on the shard's device seeded with ``seed``), windowed, then
    the realization engine on the shard's pulsar window."""
    batch, recipe = inputs.window(shard.device, shard.pulsars)
    if noise is None:
        whole_b, whole_r = inputs.whole[shard.device]
        generator = torch.Generator(device=shard.device).manual_seed(int(seed))
        noise = draw_noise(generator, whole_b, whole_r, nreal)
    draws = draws_window(noise, shard.rows, shard.pulsars)
    system = None if systems is None else systems[(shard.device, shard.pulsars)]
    return realize(None, batch, recipe, shard.rows[1] - shard.rows[0], fit=fit,
                   static=_static_piece(static, shard), noise=draws, device=shard.device,
                   system=system)


def _sharded_engine(span_name: str, seed, batch, recipe, nreal, mesh, fit, static, noise,
                    inputs, systems, stats) -> ShardedArray:
    mesh = make_mesh() if mesh is None else mesh
    plan = shard_plan(mesh, nreal, batch.npsr)
    with span(span_name, nreal=nreal, mesh=mesh.label):
        if inputs is None:
            inputs = shard_batch(batch, mesh, recipe)
        static = (static_delays(batch, recipe, mesh) if static is None
                  else put_sharded(static, mesh, ("psr", None)))
        if fit and recipe.fit_design is not None and systems is None:
            systems = shard_fit_systems(inputs, plan)
        if stats is not None:
            stats["shard_dispatch_ms"], stats["shard_launches"] = [], []
        outs = []
        with span(names.SPAN_DISPATCH, engine="shard", shards=len(plan)):
            for shard in plan:
                if stats is not None:
                    before, t0 = dict(launches), time.perf_counter()
                with _device_context(shard.device):
                    outs.append(_realize_shard(shard, seed, inputs, nreal, fit, static, systems,
                                               noise))
                if stats is not None:
                    stats["shard_dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
                    stats["shard_launches"].append({
                        name: n - before.get(name, 0) for name, n in launches.items()
                        if n != before.get(name, 0)})
        shape = (nreal, batch.npsr, batch.ntoa_max)
        return ShardedArray(shape, outs[0].dtype, [
            ((s.rows, s.pulsars, (0, batch.ntoa_max)), out) for s, out in zip(plan, outs)])


def sharded_realize(seed: int, batch: PulsarBatch, recipe: Recipe, nreal: int,
                    mesh: Optional[Mesh] = None, fit: bool = False, static=None, noise=None,
                    *, inputs: Optional[ShardedInputs] = None, systems: Optional[dict] = None,
                    stats: Optional[dict] = None) -> ShardedArray:
    """``(nreal, Np, Nt)`` residual realizations, realizations sharded over
    'real' and pulsars over 'psr': each shard's ``(nreal / n_real, Np /
    n_psr, Nt)`` window on its device, unfetched (PyTorch launches
    asynchronously; :func:`fetch_shard_blocks` reads it back).

    The draws are those of ``realize(torch.Generator(device).manual_seed(
    seed), batch, recipe, nreal)``, or ``noise`` (the whole block's draws,
    :func:`~..models.batched.draw_noise`'s dict), so the result is the
    unsharded one: bitwise for elementwise recipes, to the float order of
    the windowed products otherwise. Both ``nreal`` and the pulsar count
    must divide by the mesh's axes.

    ``static`` (:func:`static_delays`, or the whole ``(Np, Nt)`` tensor),
    ``inputs`` (:func:`shard_batch`) and ``systems``
    (:func:`shard_fit_systems`) are precomputed once by a
    caller that realizes in chunks; ``None`` builds each here. The
    calling thread dispatches the shards in turn, each on its current
    stream of the shard's device. ``stats`` receives each shard's host
    dispatch milliseconds and its hand-written kernels' launches by name
    (``kernels.launches``)."""
    return _sharded_engine(names.SPAN_SHARDED_REALIZE, seed, batch, recipe, nreal, mesh, fit,
                           static, noise, inputs, systems, stats)


def shardmap_realize(seed: int, batch: PulsarBatch, recipe: Recipe, nreal: int,
                     mesh: Optional[Mesh] = None, fit: bool = False, static=None, noise=None,
                     *, inputs: Optional[ShardedInputs] = None, systems: Optional[dict] = None,
                     stats: Optional[dict] = None) -> ShardedArray:
    """:func:`sharded_realize` under the JAX package's second name. There
    the constraint engine and the ``shard_map`` engines are two jitted
    programs; the port does not jit, and both names run the one per-shard
    engine (under a ``shardmap_realize`` span)."""
    return _sharded_engine(names.SPAN_SHARDMAP_REALIZE, seed, batch, recipe, nreal, mesh, fit,
                           static, noise, inputs, systems, stats)
