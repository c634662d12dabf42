"""Resumable realization sweeps: chunks of realizations written to a
checkpoint that a crashed or preempted run resumes from.

Counterpart of ``pta_replicator_tpu/utils/sweep.py``. A sweep is
deterministic given (seed, batch, recipe, nreal, chunk): chunk ``i``
draws from its own ``torch.Generator`` seeded with :func:`chunk_seed`
``(seed, i)``, so its draws depend neither on the pipeline depth nor on
scheduling nor on resume, and a resumed sweep writes the bytes an
uninterrupted one writes. Each chunk's result passes through
``reduce_fn`` (default: the per-realization, per-pulsar RMS) so the
state on disk stays small; ``reduce_fn=None`` keeps the full residual
cubes.

On-disk format, byte for byte the reference's: one ``.npy`` per
completed chunk plus a ``.meta.json`` sidecar with the sweep's
fingerprint and the count of completed chunks; at the end the chunks
consolidate into the single ``checkpoint_path`` npz (members ``chunk0``,
``chunk1``, ...) and the chunk files are removed. The loaders also read a
reference sweep's sharded per-chunk archives (``.chunkNNNNNN.npz``), so a
checkpoint of either package loads through either package's loaders.

The sidecar records this package's stream id (:func:`stream_id`): the
package, the generator's device type and torch's major.minor version
(CPU MT19937 and CUDA Philox are different streams, and torch does not
promise ``randn``'s stream across releases). A sidecar written by the JAX
package, or under another stream, refuses to resume here, and this
package's sidecar refuses there: both raise "belongs to a different
sweep".

Execution is pipelined by default (``pipeline_depth=2``,
``parallel/pipeline.py``): chunk ``i+1`` is dispatched while chunk ``i``
is read back off the compute stream and earlier chunks' files are
written by a writer thread. The consolidated archive and the returned
array are assembled once, after the last chunk, at every depth. (The
reference also appends each block to the archive on its writer thread;
with full residual cubes on the card that serialized writer ran slower
than the synchronous loop, PERF.md.) Every stage that computes runs on one compute stream (the
caller's current stream), as the synchronous loop does: cuBLAS is
bitwise reproducible only on one stream. Only copies run on side
streams. So depth 1, depth 2 and ``fused_stream`` write byte-identical
checkpoints and return equal arrays.

Telemetry: the ``static_delays`` span; at depth 1 a ``sweep_chunk`` span
per chunk holding its ``readback_fence`` (the host copy, which waits for
the chunk's kernels) and an ``io_write`` span; at depth >= 2 one
``sweep_pipeline`` span (the pipeline's stats as attributes) holding the
stages' ``dispatch`` / ``drain`` / ``io_write`` spans (``static_build``
too when fused); the ``sweep.chunks_total``, ``sweep.chunks_done``
gauges, the ``sweep.realizations`` counter, and the
``sweep.chunk_retries`` counter with a ``faults.retry`` event per
supervised retry. Every chunk's stage spans, at every depth, carry the
chunk's deterministic trace id (``obs.trace.chunk_trace_context`` scoped
by the checkpoint path), and a retry's ``faults.retry`` event is stamped
with the failing chunk's: a retried chunk is one trace with its attempts,
and a resumed sweep keeps its chunks' ids. None of it waits for the card.

Fault sites (``faults/inject.py``, one ``None`` check while disarmed):
``dispatch``, ``drain`` and ``io_write`` in the stages' spans at every
depth, ``checkpoint_write`` on each temporary file after it is written and
before its rename (where ``torn`` truncates it) and ``checkpoint_fsync`` in
the durable path. The drain seam (:func:`_drain_seam`) runs the ``nan``
poison and the numerics observatory's drain hook (``obs/numerics.py::
on_drain``: the queued probe stats, the host non-finite scan, the sampled
drift replay) on the one reader thread, in chunk order, before a block
reaches ``io_write``; the sweep's end folds the probe stats still queued.

Not ported here: the multi-device ``mesh`` and the sharded-archive writer
(ROADMAP.md item A.17).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import tempfile
import time
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..faults import inject as faults


def _default_reduce(res, batch):
    return torch.sqrt(torch.sum(res**2 * batch.mask, dim=-1) / torch.sum(batch.mask, dim=-1))


def stream_id(device) -> str:
    """The random stream a sweep's chunks draw from: this package, the
    generator's device type and torch's major.minor version."""
    major, minor = torch.__version__.split(".")[:2]
    return f"pta_replicator_tpu_torch/{torch.device(device).type}/torch-{major}.{minor}"


def chunk_seed(seed: int, i: int) -> int:
    """The seed of chunk ``i``'s generator: a fixed hash of ``(seed, i)``
    (63 bits), the same on every run, device and depth."""
    digest = hashlib.sha256(f"pta_replicator_tpu_torch.sweep:{int(seed)}:{int(i)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") & ((1 << 63) - 1)


def _hash_value(h, value) -> None:
    if isinstance(value, torch.Tensor):
        arr = value.detach().cpu().numpy()
        h.update(arr.dtype.str.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        h.update(type(value).__name__.encode())
        for f in dataclasses.fields(value):
            h.update(f.name.encode())
            _hash_value(h, getattr(value, f.name))
    else:
        h.update(repr(value).encode())


def _fingerprint(*objs) -> str:
    """Content hash over the dataclasses' fields in field order (batch,
    recipe, and the recipe's ``noise_cov`` op): each tensor's dtype, shape
    and CPU bytes, every other value's repr."""
    h = hashlib.sha256()
    for obj in objs:
        _hash_value(h, obj)
    return h.hexdigest()


def _hash_code(h, code) -> None:
    """Hash bytecode recursively: nested code objects by their own
    bytecode, never by repr (which embeds addresses)."""
    import types

    h.update(code.co_code)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _hash_code(h, const)
        else:
            h.update(repr(const).encode())


def _fn_id(fn) -> Optional[str]:
    """A function's identity across process restarts: a hash of its
    (recursive) bytecode, constants and closure-cell values. Values
    reachable only through module globals are not hashed."""
    if fn is None:
        return None
    code = getattr(fn, "__code__", None)
    if code is None:
        return getattr(fn, "__qualname__", repr(fn))
    h = hashlib.sha256()
    _hash_code(h, code)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            val = cell.cell_contents
        except ValueError:  # empty cell
            continue
        arr = None
        if isinstance(val, torch.Tensor):
            arr = val.detach().cpu().numpy()
        elif hasattr(val, "shape") and hasattr(val, "dtype"):
            # repr() truncates large arrays: hash the whole buffer
            try:
                arr = np.asarray(val)
            except Exception:  # noqa: BLE001 — an array-like numpy cannot read
                arr = None
        if arr is not None and arr.dtype != object:
            h.update(str((arr.dtype.str, arr.shape)).encode())
            h.update(arr.tobytes())
        else:
            h.update(repr(val).encode())
    return h.hexdigest()[:16]


# ------------------------------------------------------ the on-disk format

def _chunk_path(checkpoint_path: str, i: int) -> str:
    return f"{checkpoint_path}.chunk{i:06d}.npy"


def _shard_chunk_path(checkpoint_path: str, i: int) -> str:
    """A reference mesh sweep's per-chunk sharded archive (same index
    space as :func:`_chunk_path`)."""
    return f"{checkpoint_path}.chunk{i:06d}.npz"


def _partial_path(checkpoint_path: str) -> str:
    """The consolidated archive while it is written: a fixed name, so a
    killed consolidation's is reaped (or truncated) by the next run."""
    return checkpoint_path + ".partial"


def _npy_bytes(arr: np.ndarray):
    """The exact ``np.save`` serialization of ``arr`` in memory: the bytes
    of a ``.npy`` file and of an ``np.savez`` member."""
    bio = io.BytesIO()
    np.save(bio, arr, allow_pickle=False)
    return bio.getbuffer()


def _write_npy(path: str, arr: np.ndarray) -> None:
    """A chunk file: ``np.save``'s bytes, as in the reference."""
    np.save(path, arr, allow_pickle=False)


def _cleanup_chunks(checkpoint_path: str, nchunks: int) -> None:
    for i in range(nchunks):
        for path in (_chunk_path(checkpoint_path, i), _shard_chunk_path(checkpoint_path, i)):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
    # a partial archive orphaned by a consolidation that was killed
    try:
        os.remove(_partial_path(checkpoint_path))
    except FileNotFoundError:
        pass


def _fsync_path(path: str) -> None:
    faults.fire(faults.SITE_CHECKPOINT_FSYNC, path=path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _durable_replace(tmp: str, final_path: str, durable: bool) -> None:
    """Rename ``tmp`` into place; ``durable`` fsyncs the file before the
    rename and the directory after it."""
    if durable:
        _fsync_path(tmp)
    os.replace(tmp, final_path)
    if durable:
        _fsync_path(os.path.dirname(final_path) or ".")


def _atomic_write(write_fn, final_path: str, suffix: str, durable: bool = False):
    """Write to a temporary file, then rename it into place (``durable``:
    with the fsyncs, so a completed chunk survives power loss, not only
    the process's death)."""
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=os.path.dirname(final_path) or ".")
    os.close(fd)
    try:
        write_fn(tmp)
        # written, not yet renamed: a torn fault truncates the temporary
        # file and raises, the artifact an interrupted write leaves; the
        # final path is untouched and the retry overwrites cleanly
        faults.fire(faults.SITE_CHECKPOINT_WRITE, path=tmp)
        _durable_replace(tmp, final_path, durable)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# the serialization layer under public names (the plane-tile cache of
# parallel/prefetch.py, the numerics capture and the tuner's cache write
# through it)
npy_bytes = _npy_bytes
durable_replace = _durable_replace
atomic_write = _atomic_write


def _consolidate(checkpoint_path: str, blocks, durable: bool) -> None:
    """The single npz (members ``chunk0``, ``chunk1``, ... in order, the
    bytes of ``np.savez``), written under the partial name and renamed
    into place when complete."""
    tmp = _partial_path(checkpoint_path)
    with open(tmp, "wb") as fh:
        np.savez(fh, **{f"chunk{j}": b for j, b in enumerate(blocks)})
    _durable_replace(tmp, checkpoint_path, durable)


#: a sharded archive's layout member, written last by the reference
_SHARD_MANIFEST_MEMBER = "manifest"


def load_shard_archive(path: str) -> np.ndarray:
    """Reassemble a reference mesh sweep's sharded chunk archive (a
    ``shard{k}`` member per device shard and a JSON ``manifest`` member
    with each shard's index window) into the whole block. Refuses an
    archive without its manifest (torn) and a partial cover. This package
    reads sharded archives but does not write them (ROADMAP.md item
    A.17)."""
    with np.load(path) as z:
        if _SHARD_MANIFEST_MEMBER not in z.files:
            raise ValueError(
                f"{path}: no '{_SHARD_MANIFEST_MEMBER}' member — truncated or not a "
                "sharded chunk archive"
            )
        manifest = json.loads(str(z[_SHARD_MANIFEST_MEMBER]))
        shape = tuple(int(n) for n in manifest["shape"])
        shards = [(rec["index"], z[rec["member"]]) for rec in manifest["shards"]]
    volume = sum(arr.size for _, arr in shards)
    expected = int(np.prod(shape)) if shape else 1
    if volume != expected:
        raise ValueError(
            f"sharded block covers {volume} of {expected} elements — a partial shard "
            "set cannot be assembled"
        )
    out = np.empty(shape, np.dtype(manifest["dtype"]))
    for index, arr in shards:
        out[tuple(slice(a, b) for a, b in index)] = arr
    return out


def _load_chunk(checkpoint_path: str, i: int) -> np.ndarray:
    """A completed chunk from disk: the ``.npy``, or a sharded archive."""
    path = _chunk_path(checkpoint_path, i)
    if os.path.exists(path):
        return np.load(path)
    return load_shard_archive(_shard_chunk_path(checkpoint_path, i))


def load_checkpoint_chunk(checkpoint_path: str, i: int) -> np.ndarray:
    """Exactly one completed chunk, wherever it lies: a member of the
    consolidated npz, or the per-chunk file of a sweep in progress."""
    if os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            member = f"chunk{i}"
            if member not in z.files:
                raise FileNotFoundError(f"{checkpoint_path} has no member {member!r}")
            return z[member]
    return _load_chunk(checkpoint_path, i)


def _npy_header(fh):
    """(shape, dtype) of an open .npy stream; the data is not read."""
    version = np.lib.format.read_magic(fh)
    if version == (1, 0):
        shape, _fortran, dtype = np.lib.format.read_array_header_1_0(fh)
    else:
        shape, _fortran, dtype = np.lib.format.read_array_header_2_0(fh)
    return shape, dtype


def iter_checkpoint_chunk_infos(checkpoint_path: str):
    """Yield ``(i, shape, dtype)`` per completed chunk without reading any
    data: npy headers, or a sharded archive's manifest. A bank sizes
    itself from this probe."""
    if os.path.exists(checkpoint_path):
        with zipfile.ZipFile(checkpoint_path) as zf:
            members = [m for m in zf.namelist() if m.startswith("chunk") and m.endswith(".npy")]
            for i in sorted(int(m[len("chunk"):-len(".npy")]) for m in members):
                with zf.open(f"chunk{i}.npy") as fh:
                    shape, dtype = _npy_header(fh)
                yield i, shape, dtype
        return
    i = 0
    while True:
        path = _chunk_path(checkpoint_path, i)
        if os.path.exists(path):
            with open(path, "rb") as fh:
                shape, dtype = _npy_header(fh)
        else:
            shard_path = _shard_chunk_path(checkpoint_path, i)
            if not os.path.exists(shard_path):
                break
            with np.load(shard_path) as z:
                if _SHARD_MANIFEST_MEMBER not in z.files:
                    break  # a torn archive: nothing after it is durable
                manifest = json.loads(str(z[_SHARD_MANIFEST_MEMBER]))
            shape, dtype = tuple(manifest["shape"]), np.dtype(manifest["dtype"])
        yield i, shape, dtype
        i += 1


def iter_checkpoint_chunks(checkpoint_path: str):
    """Yield ``(i, array)`` for every completed chunk, one at a time: the
    consolidated npz's members (read lazily), or the per-chunk files of a
    sweep in progress."""
    if os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            idx = sorted(int(m[len("chunk"):]) for m in z.files if m.startswith("chunk"))
            for i in idx:
                yield i, z[f"chunk{i}"]
        return
    i = 0
    while True:
        try:
            block = _load_chunk(checkpoint_path, i)
        except (FileNotFoundError, ValueError):
            break  # ValueError: a torn sharded archive
        yield i, block
        i += 1


def _drain_seam(fetch: Callable, release: Optional[Callable], start: int, **inputs) -> Callable:
    """The reader's fetch with the drain site's data hooks: the ``nan``
    poison (``faults.poison``: one element of a copy of the block) and the
    numerics drain hook (``numerics.on_drain``, given the sweep's
    ``inputs`` for the drift replay). The drain stage runs on one reader
    thread in chunk order, so a counter gives each block's chunk index.
    A poisoned copy replaces a readback buffer, which goes back to its
    ring at once. Disarmed, both hooks are one check each."""
    from ..obs import numerics

    nxt = [int(start)]

    def fetch_hooked(out):
        i = nxt[0]
        nxt[0] = i + 1
        block = fetch(out)
        poisoned = faults.poison(faults.SITE_DRAIN, block, chunk=i)
        if poisoned is not block and release is not None:
            release(block)
        numerics.on_drain(i, poisoned, **inputs)
        return poisoned

    return fetch_hooked


def _read_done_marker(meta_path: str) -> int:
    """Completed chunks per the sidecar; 0 when it is absent or torn."""
    try:
        with open(meta_path) as fh:
            return int(json.load(fh).get("done", 0))
    except (OSError, ValueError):
        return 0


# ------------------------------------------------------------------ sweep

def sweep(seed: int, batch, recipe, nreal: int, checkpoint_path: str, chunk: int = 256,
          reduce_fn: Optional[Callable] = _default_reduce, fit: bool = False,
          progress: Optional[Callable[[int, int], None]] = None, pipeline_depth: int = 2,
          drain_timeout_s: Optional[float] = 900.0, durable: bool = False,
          chunk_retries: int = 2, retry_policy=None, provenance: Optional[dict] = None,
          fused_stream: bool = False, noise: Optional[Callable] = None, device="cuda",
          stats: Optional[dict] = None) -> np.ndarray:
    """Run ``nreal`` realizations in resumable chunks of ``chunk``; return
    the stacked reduced results, (nreal, ...), as a numpy array on the
    host.

    A rerun with the same arguments resumes after the last completed
    chunk; a finished sweep returns from the consolidated checkpoint;
    different arguments (seed, sizes, ``fit``, stream, batch or recipe
    content, ``reduce_fn``, ``noise``, ``provenance``) raise
    ``ValueError``. ``device`` and ``pipeline_depth`` are not part of the
    fingerprint beyond the stream id: a sweep may resume at another
    depth.

    ``noise`` (a callable ``i -> draws``, the draws of chunk ``i`` as
    ``realize(..., noise=)`` takes them) replaces chunk ``i``'s generator
    draws; its :func:`_fn_id` goes into the sidecar. ``pipeline_depth``
    bounds the chunks in flight: 2 double-buffers, 1 runs the synchronous
    loop (dispatch, read back, write). ``drain_timeout_s`` fails a wedged
    readback or write (None: never). ``durable`` fsyncs every checkpoint
    write. ``provenance`` is a JSON stamp kept in the sidecar.

    **Supervised recovery** (``chunk_retries``): a chunk failure that
    :func:`..faults.retry.is_transient` classes transient (a wedged stage,
    a dropped connection, an interrupted or out-of-space write) resumes
    from the sidecar after a backoff; the budget is per failing chunk (a
    completed chunk since the last failure resets it). Errors from CUDA
    (sticky), out-of-memory, shape and fingerprint errors and a
    ``progress`` callback's own exception re-raise at once.

    **Fused streaming** (``fused_stream=True``, depth >= 2): one stage
    graph ``static_build -> dispatch -> drain -> io_write``; the caller's
    thread re-derives each chunk's deterministic delays (the streamed CW
    catalog's tile build and staging, with ``cgw_stream_chunk``) while a
    dispatch thread, on the same compute stream, launches earlier chunks,
    so host precompute overlaps the card. Bitwise the same static each
    chunk, so the same checkpoint bytes.

    ``stats``, when given, receives the pipeline's stats (depth >= 2) and,
    on the card, ``d2h_ms``: each chunk's readback copy time.

    With ``fit`` and a ``recipe.fit_design`` the design refit's assembly
    (``models.batched.fit_system``: A, its norms, and C^-1 with C0's
    factor) is built once per sweep and handed to every chunk, at every
    depth, as the deterministic delays are; its bits are a rebuild's. The
    sidecar's fingerprint hashes the design's bytes with the recipe's."""
    from ..faults.retry import DEFAULT_POLICY, backoff_delay, is_transient, retry_event
    from ..obs import counter, names
    from ..obs.trace import adopt, chunk_trace_context
    from ..parallel.pipeline import failed_chunk

    if fused_stream and pipeline_depth < 2:
        raise ValueError(
            "fused_stream=True needs pipeline_depth >= 2 — at depth 1 there is no "
            "concurrency for the static build to overlap with"
        )
    policy = retry_policy if retry_policy is not None else DEFAULT_POLICY
    meta_path = checkpoint_path + ".meta.json"
    attempts = 0  # consecutive failures of the current chunk
    last_done = -1
    while True:
        try:
            return _sweep_impl(
                seed, batch, recipe, nreal, checkpoint_path, chunk=chunk,
                reduce_fn=reduce_fn, fit=fit, progress=progress,
                pipeline_depth=pipeline_depth, drain_timeout_s=drain_timeout_s,
                durable=durable, provenance=provenance, fused_stream=fused_stream,
                noise=noise, device=device, stats=stats,
            )
        except BaseException as exc:  # noqa: BLE001 — classified, then re-raised
            if chunk_retries <= 0 or not is_transient(exc):
                raise
            done = _read_done_marker(meta_path)
            if done > last_done:
                attempts = 0  # progress since the last failure: a fresh budget
                last_done = done
            attempts += 1
            if attempts > chunk_retries:
                raise
            counter(names.SWEEP_CHUNK_RETRIES).inc()
            # the stage that failed named its chunk; the sidecar's done
            # marker (a depth-N failure may out-race the previous chunk's
            # sidecar write) names it only for failures outside a stage.
            # The event joins that chunk's trace, between its attempts
            fail_chunk = failed_chunk(exc)
            fail_chunk = done if fail_chunk is None else fail_chunk
            with adopt(chunk_trace_context(checkpoint_path, fail_chunk)):
                retry_event("sweep", exc, attempt=attempts, done=done, chunk=fail_chunk)
            time.sleep(backoff_delay(attempts, policy))


def _sweep_impl(seed, batch, recipe, nreal: int, checkpoint_path: str, chunk: int,
                reduce_fn, fit: bool, progress, pipeline_depth: int, drain_timeout_s,
                durable: bool, provenance, fused_stream: bool, noise, device, stats):
    from ..models.batched import deterministic_delays, fit_system, realize
    from ..obs import counter, gauge, names, numerics, span
    from ..parallel.pipeline import (
        PinnedReadback, _mark_chunk, dispatch_on_done, drain_stage, host_copy, io_write_stage,
        pipeline_stats, run_pipelined,
    )
    from ..parallel.stages import Stage, StageGraph

    if nreal % chunk:
        raise ValueError(f"nreal={nreal} must be a multiple of chunk={chunk}")
    nchunks = nreal // chunk
    device = resolve_device(device)
    batch, recipe = batch.to(device), recipe.to(device)

    meta = {
        "seed": int(seed),
        "nreal": nreal,
        "chunk": chunk,
        "fit": bool(fit),
        # the random stream: a checkpoint written under another stream
        # (the JAX package's, another device type or torch release) must
        # refuse to resume, not mix streams
        "stream": stream_id(device),
        "physics": _fingerprint(batch, recipe),
        "reduce": _fn_id(reduce_fn),
    }
    if noise is not None:
        meta["noise"] = _fn_id(noise)
    if provenance is not None:
        meta["provenance"] = dict(provenance)
    meta_path = checkpoint_path + ".meta.json"
    done = 0
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            on_disk = json.load(fh)
        saved_done = on_disk.pop("done", 0)
        if on_disk != meta:
            raise ValueError(
                f"checkpoint at {checkpoint_path} belongs to a different sweep: "
                f"{on_disk} != {meta}"
            )
        done = saved_done

    if done == nchunks and os.path.exists(checkpoint_path):
        # reap chunk files orphaned between the consolidation's rename and
        # the cleanup
        _cleanup_chunks(checkpoint_path, nchunks)
        with np.load(checkpoint_path) as z:
            return np.concatenate([z[f"chunk{i}"] for i in range(nchunks)], axis=0)

    blocks = [_load_chunk(checkpoint_path, i) for i in range(done)]

    def static_delays():
        with span(names.SPAN_STATIC_DELAYS, npsr=batch.npsr):
            return deterministic_delays(batch, recipe, device=device)

    # the deterministic delays depend only on (batch, recipe): once per
    # sweep, except in the fused graph, which rebuilds them per chunk
    static = None
    if done < nchunks and not fused_stream:
        static = static_delays()
    # so does the design refit's assembly (with C0's factor inside it):
    # once per sweep, at every depth
    system = None
    if done < nchunks and fit and recipe.fit_design is not None:
        system = fit_system(batch, recipe)

    # chunk progress, seeded with a resumed sweep's completed chunks
    gauge(names.SWEEP_CHUNKS_TOTAL).set(nchunks)
    gauge(names.SWEEP_CHUNKS_DONE).set(done)

    # every computing stage runs on the caller's current stream
    compute_stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

    @contextlib.contextmanager
    def compute_context():
        """A worker thread's device and current stream (PyTorch keeps both
        per thread): the caller's compute stream."""
        if compute_stream is None:
            yield
            return
        with torch.cuda.device(device), torch.cuda.stream(compute_stream):
            yield

    def realize_chunk(i: int, static_i):
        generator = torch.Generator(device=device).manual_seed(chunk_seed(seed, i))
        res = realize(generator, batch, recipe, chunk, fit=fit, static=static_i,
                      noise=None if noise is None else noise(i), device=device,
                      system=system)
        return reduce_fn(res, batch) if reduce_fn is not None else res

    def write_chunk(i: int, block) -> None:
        """Chunk file first, sidecar last: a crash between the two only
        recomputes this chunk. In chunk order, on the caller's thread at
        depth 1 and on the writer thread otherwise."""
        _atomic_write(lambda p: _write_npy(p, block),
                      _chunk_path(checkpoint_path, i), ".npy", durable=durable)
        payload = json.dumps({**meta, "done": i + 1})

        def write_meta(p, payload=payload):
            with open(p, "w") as fh:
                fh.write(payload)

        _atomic_write(write_meta, meta_path, ".json", durable=durable)
        counter(names.SWEEP_REALIZATIONS).inc(chunk)
        gauge(names.SWEEP_CHUNKS_DONE).set(i + 1)
        if progress is not None:
            progress(i + 1, nchunks)

    # what the drain hook's drift replay needs to redraw a chunk's row 0
    drain_inputs = dict(batch=batch, recipe=recipe, seed=seed, nreal=chunk, noise=noise)

    if pipeline_depth <= 1:
        # the synchronous loop: dispatch, read back, write. It is the same
        # stage graph as the pipelined path, run inline on the caller's
        # thread, with the same fault sites and drain hooks: failing
        # chunks are marked for the supervised retry
        fetch_sync = _drain_seam(host_copy, None, done, **drain_inputs)

        def compute_sync(i, _payload, _sp):
            with span(names.SPAN_SWEEP_CHUNK, chunk=i, nreal=chunk):
                faults.fire(faults.SITE_DISPATCH, chunk=i)
                out = realize_chunk(i, static)
                # the host copy waits for the chunk's kernels: the fence
                with span(names.SPAN_READBACK_FENCE):
                    faults.fire(faults.SITE_DRAIN, chunk=i)
                    return fetch_sync(out)

        def write_sync(i, block, _sp):
            write_chunk(i, block)
            blocks.append(block)

        StageGraph([Stage("sweep_chunk", fn=compute_sync, placement="inline", heartbeat=False),
                    Stage("io_write", fn=write_sync, span=names.SPAN_IO_WRITE,
                          span_attrs=lambda i, block: {"nbytes": int(block.nbytes)},
                          fault_site=faults.SITE_IO_WRITE, placement="inline",
                          heartbeat=False)],
                   trace_scope=checkpoint_path, mark_item=_mark_chunk,
                   name="sweep-sync").run(range(done, nchunks))
    elif done < nchunks:
        # the writer thread writes each chunk file and keeps the block; the
        # archive and the result are assembled once, after the last chunk,
        # as the synchronous loop does
        readback = (PinnedReadback(device, pipeline_depth + 1)
                    if device.type == "cuda" else None)
        mark = readback.mark if readback is not None else (lambda out: out)
        release = readback.release if readback is not None else None
        fetch = _drain_seam(readback.fetch if readback is not None else host_copy, release,
                            done, **drain_inputs)

        def write_and_keep(i: int, block) -> None:
            write_chunk(i, block)
            # a copy of a readback buffer, which returns to its ring
            blocks.append(np.array(block) if readback is not None else block)

        try:
            with span(names.SPAN_SWEEP_PIPELINE, depth=pipeline_depth, chunks=nchunks - done,
                      fused=fused_stream) as sp:
                if fused_stream:
                    graph = StageGraph(
                        [Stage("static_build", fn=lambda i, _p, sp: static_delays(),
                               span=names.SPAN_STATIC_BUILD,
                               # one built-ahead static beyond the dispatcher's
                               out_maxsize=1, heartbeat=False),
                         Stage("dispatch",
                               fn=lambda i, static_i, sp: mark(realize_chunk(i, static_i)),
                               span=names.SPAN_DISPATCH, fault_site=faults.SITE_DISPATCH,
                               on_done=dispatch_on_done, acquires_window=True, heartbeat_label="chunk dispatch",
                               context=compute_context, thread_name="sweep-dispatch"),
                         drain_stage(fetch, pipeline_depth),
                         io_write_stage(write_and_keep, release)],
                        window=pipeline_depth, drain_timeout_s=drain_timeout_s,
                        trace_scope=checkpoint_path,
                        timeout_counter=names.PIPELINE_DRAIN_TIMEOUTS,
                        inflight_gauge=names.SWEEP_INFLIGHT_CHUNKS,
                        mark_item=_mark_chunk, name="sweep-fused",
                    )
                    run_stats = pipeline_stats(graph.run(range(done, nchunks)))
                else:
                    run_stats = run_pipelined(
                        range(done, nchunks), lambda i: mark(realize_chunk(i, static)),
                        write_and_keep, depth=pipeline_depth, fetch=fetch,
                        release=release, drain_timeout_s=drain_timeout_s,
                        # scoped by the sweep's identity: a retry or a resume
                        # re-derives the same per-chunk trace ids
                        trace_scope=checkpoint_path,
                    )
                sp.update(run_stats)
        finally:
            if readback is not None:
                readback.close()
        if stats is not None:
            stats.update(run_stats)
            if readback is not None:
                stats["d2h_ms"] = list(readback.d2h_ms)

    # the probe stats still queued (the last chunks'), folded before the
    # sweep returns
    numerics.flush()
    # consolidate into the single npz
    _consolidate(checkpoint_path, blocks, durable)
    _cleanup_chunks(checkpoint_path, nchunks)
    return np.concatenate(blocks, axis=0)

