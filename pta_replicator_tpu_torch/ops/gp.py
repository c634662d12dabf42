"""Fused Woodbury assembly and block-tridiagonal factor/solve: plain
versions and CUDA kernels.

The block-tridiagonal half (at the end of the module) is the counterpart
of the reference's ``tridiag_factor_solve``: the forward factor sweep,
the substitution-only forward sweep and the backward sweep, whose CUDA
kernels are in ``csrc/block_tridiag.cu``, and the autograd Functions that
carry them while autograd records, with the factor sweep's adjoint and
its second-order kernel (no Pallas counterpart: the reference lets XLA
differentiate its scans). The rest of this docstring is about the
Woodbury half.

Counterpart of the fused Woodbury half of
``pta_replicator_tpu/ops/pallas_gp.py``: for a stacked column basis T
(Np, Nt, Q), masked white inverse variances w (Np, Nt) (zero at masked
and padded TOAs) and residuals r (Np, Nt), the three sums the
rank-reduced likelihood consumes, ``(T^T W T, T^T W r, r^T W r)``, in one
pass over the TOA axis without forming the (Np, Nt, Q) product W T.

* :func:`fused_woodbury_plain` is the plain PyTorch version: the
  reference's zero padding to the tile grid and its tile-sequential
  accumulation of :func:`gp_tile_terms`. CPU tensors run it; the on-card
  comparison holds the kernel against it.
* :func:`fused_woodbury_update` dispatches: CPU tensors go to the plain
  version, CUDA tensors to the hand-written kernel in
  ``csrc/fused_woodbury.cu``, which launches or raises. The kernel takes
  any basis width: it tiles [T | r]'s Gram matrix over 64-column panel
  pairs and splits the TOA axis as :func:`woodbury_plan` says (or as the
  caller's ``nsplit``, the tuner's knob, says). It sums in its own order
  (``tile`` sets only the plain version's), so the two agree to a
  tolerance, not bitwise.

``precision="bf16"`` is the reference's mixed rung: T and the products
w T and w r (formed in the input dtype) are rounded to bfloat16 as
``x.to(torch.bfloat16)`` rounds, the products summed in float32, and
r^T W r stays in float32; the outputs are float32 whatever the input
dtype. Its T^T W T is not symmetric (element [q][s] is bf16(T_q)
bf16(w T_s)), and T^T W r rounds w r, not r. The plain version emulates
it with the same arithmetic: operands rounded to bf16 and cast back to float32 (exact),
float32 sums tile by tile. The card runs it on bf16 tensor cores
(``mma.sync`` m16n8k16, float32 accumulators) over the whole padded Gram
matrix, unmirrored: each (pulsar, TOA split) is one block (P <= 2
panels), a cluster of P blocks (P <= 8) or strips of blocks (P > 8), as
:func:`woodbury_bf16_grid` says, and stages 64-row spans of T once. The
likelihood gates it on a numerics capture
(``likelihood/gp.py::require_precision_ready``); nothing here does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..kernels import build, launches

#: the reference's untuned tile along Nt (``likelihood/tuner.py`` may
#: override it on the CPU)
DEFAULT_WOODBURY_TILE = 256

#: the precision policies of the reference
PRECISIONS = ("highest", "bf16")

#: the kernel's panel width and TOA rows per pipeline stage
#: (``csrc/fused_woodbury.cu``: kPanel, kChunk)
WOODBURY_PANEL = 64
WOODBURY_CHUNK = 16
#: blocks per streaming multiprocessor the launch plan aims at, at most:
#: about four waves of the four float64 blocks an SM holds at once, which
#: measured faster at 68 x 7,758 on the H100 than the 2-4 blocks per SM
#: that fill the card once (kernels/woodbury_study.py's split sweep)
WOODBURY_BLOCKS_PER_SM = 16
#: the bf16 kernel (``csrc/fused_woodbury.cu``, second half): TOA rows of
#: a chunk (kBfRows), the panels up to which one block owns a unit
#: (kBfSingleMax) and the rows of its raw slots (kBfPieceRows), the portable
#: cluster size (kBfMaxCluster), the column panels of a strip past it
#: (kBfGroup), the pad of an X / Y row in 32-bit words (kBfPad), raw slots
#: of the staging ring at most (kBfMaxSlots), the shared bytes a block can
#: use (kSmemLimit) and the r^T W r scratch (kBfScratch)
WOODBURY_BF16_ROWS = 64
WOODBURY_BF16_SINGLE_MAX = 2
WOODBURY_BF16_PIECE_ROWS = 32
WOODBURY_BF16_MAX_CLUSTER = 8
WOODBURY_BF16_GROUP = 8
WOODBURY_BF16_PAD = 8
WOODBURY_BF16_MAX_SLOTS = 6
WOODBURY_SMEM_LIMIT = 232448
WOODBURY_BF16_SCRATCH = 128
#: the bf16 plan's split count: at most WOODBURY_BF16_UNITS_PER_SM (pulsar,
#: split) units and WOODBURY_BF16_BLOCKS_PER_SM blocks per SM. A block
#: holds most of an SM's shared memory, so units count waves: about four
#: of single-block units measured fastest at 68 x 7,758 x 123 on the H100,
#: and three splits for clusters of five at Q = 286, whose workspace grows
#: as (64 P)^2 a split (kernels/woodbury_study.py's split sweep)
WOODBURY_BF16_UNITS_PER_SM = 4
WOODBURY_BF16_BLOCKS_PER_SM = 8


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def woodbury_operations(npsr: int, ntoa: int, q: int, precision: str = "highest") -> int:
    """Floating-point operations of the assembly. ``"highest"``, per TOA:
    the lower triangle of T^T W T (Q(Q+1)), plus 4Q + 3 for the scaling W
    T, T^T W r and r^T W r. ``"bf16"``: the full (Q + 1)-square Gram matrix
    of [T | r] on the tensor cores, 2 (Q + 1)^2 per TOA (both triangles;
    the products w T and r^T W r are a few per entry more)."""
    if precision == "bf16":
        return 2 * npsr * ntoa * (q + 1) ** 2
    return npsr * ntoa * (q * (q + 1) + 4 * q + 3)


def woodbury_bytes(npsr: int, ntoa: int, q: int, itemsize: int,
                   precision: str = "highest") -> int:
    """Bytes the assembly must move, each input read once and each output
    written once: T, w and r in their dtype (``itemsize`` bytes), T^T W T,
    T^T W r and r^T W r in it too, or in float32 for ``"bf16"``."""
    out_size = 4 if precision == "bf16" else itemsize
    return (itemsize * (npsr * ntoa * q + 2 * npsr * ntoa)
            + out_size * (npsr * q * q + npsr * q + npsr))


def _check_operands(T, w, r):
    if T.ndim != 3 or w.shape != T.shape[:2] or r.shape != T.shape[:2]:
        raise ValueError(
            f"fused_woodbury_update: T {tuple(T.shape)}, w {tuple(w.shape)} and "
            f"r {tuple(r.shape)} do not fit (want (Np, Nt, Q), (Np, Nt), (Np, Nt))"
        )
    if T.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_woodbury_update: dtype {T.dtype} is neither float32 nor float64")
    if any(x.dtype != T.dtype or x.device != T.device for x in (w, r)):
        raise TypeError("fused_woodbury_update: T, w and r must share dtype and device")


def _bf16(x):
    """``x`` rounded to bfloat16 as ``x.to(torch.bfloat16)`` rounds (a
    float64 tensor goes through float32), returned as float32 (exact)."""
    return x.to(torch.bfloat16).to(torch.float32)


def gp_tile_terms(t, w, r, precision: str = "highest"):
    """One Nt-tile's contribution ``(t^T W t (Np, Q, Q), t^T W r (Np, Q),
    r^T W r (Np,))`` for a tile ``t`` (Np, tile, Q), ``w`` and ``r`` (Np,
    tile). ``precision="bf16"``: the two design contractions from bf16
    operands (t, and w t or w r formed in the input dtype) summed in
    float32, r^T W r from float32 r and w r; float32 outputs."""
    wr = w * r
    if precision == "bf16":
        f32 = torch.float32
        tb = _bf16(t)
        tnt = torch.einsum("pnq,pns->pqs", tb, _bf16(t * w[..., None]))
        d = torch.einsum("pnq,pn->pq", tb, _bf16(wr))
        rnr = torch.einsum("pn,pn->p", r.to(f32), wr.to(f32))
        return tnt, d, rnr
    tnt = torch.einsum("pnq,pns->pqs", t, t * w[..., None])
    d = torch.einsum("pnq,pn->pq", t, wr)
    rnr = torch.einsum("pn,pn->p", r, wr)
    return tnt, d, rnr


def fused_woodbury_plain(T, w, r, tile: int = DEFAULT_WOODBURY_TILE,
                         precision: str = "highest"):
    """``(T^T W T, T^T W r, r^T W r)`` in plain PyTorch: Nt zero-padded to
    the ``tile`` grid (padded rows carry w = 0) and the tiles accumulated
    in order from zero, as the reference's tiled fallback does; in the
    input dtype, or float32 with ``precision="bf16"``."""
    _check_precision(precision)
    _check_operands(T, w, r)
    npsr, ntoa, q = T.shape
    pad = (-ntoa) % tile
    if pad:
        T = torch.nn.functional.pad(T, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
        r = torch.nn.functional.pad(r, (0, pad))
    acc = torch.float32 if precision == "bf16" else T.dtype
    tnt = T.new_zeros((npsr, q, q), dtype=acc)
    d = T.new_zeros((npsr, q), dtype=acc)
    rnr = T.new_zeros((npsr,), dtype=acc)
    for lo in range(0, ntoa + pad, tile):
        dt, dd, dq = gp_tile_terms(T[:, lo:lo + tile], w[:, lo:lo + tile], r[:, lo:lo + tile],
                                   precision)
        tnt, d, rnr = tnt + dt, d + dd, rnr + dq
    return tnt, d, rnr


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def woodbury_pair(k: int):
    """Panels ``(i, j)``, ``j <= i``, of the kernel's lower-triangle panel
    pair ``k = i (i + 1) / 2 + j`` (``tri_pair`` in the kernel)."""
    i = int(((8 * k + 1) ** 0.5 - 1) / 2)
    while i * (i + 1) // 2 > k:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= k:
        i += 1
    return i, k - i * (i + 1) // 2


def woodbury_plan(npsr: int, ntoa: int, q: int, sms: int, precision: str = "highest"):
    """The kernel's launch plan on a card with ``sms`` streaming
    multiprocessors: ``(panels, pairs, nsplit, workspace_entries)``.

    The Q + 1 augmented columns pad to ``panels`` panels of
    ``WOODBURY_PANEL``. ``"highest"`` runs one block per lower-triangle
    panel pair (``pairs`` of them; the tile is mirrored) per pulsar and TOA
    split, and ``nsplit`` is the most splits that keep pairs x Np x nsplit
    within ``WOODBURY_BLOCKS_PER_SM`` blocks per SM. ``"bf16"`` computes
    every ordered pair (``pairs`` = panels^2; its T^T W T is not
    symmetric) with :func:`woodbury_bf16_grid`'s blocks per (pulsar,
    split), and ``nsplit`` is the most splits that keep Np x nsplit units
    within ``WOODBURY_BF16_UNITS_PER_SM`` per SM and their blocks within
    ``WOODBURY_BF16_BLOCKS_PER_SM``. Either way there
    are no more splits than ``WOODBURY_CHUNK``-row chunks and none is
    empty (the kernel gives each split ``ceil(Nt / nsplit)`` rows).
    ``workspace_entries`` counts the float partial sums the splits leave
    for the reduction (pairs x 64^2 per pulsar and split), none with one
    split."""
    _check_precision(precision)
    panels = -(-(q + 1) // WOODBURY_PANEL)
    if precision == "bf16":
        pairs = panels * panels
        blocks = woodbury_bf16_grid(npsr, q, 1, 8).blocks
        target = min(WOODBURY_BF16_UNITS_PER_SM * sms // npsr,
                     WOODBURY_BF16_BLOCKS_PER_SM * sms // (blocks * npsr))
    else:
        pairs = panels * (panels + 1) // 2
        target = WOODBURY_BLOCKS_PER_SM * sms // (pairs * npsr)
    nsplit = _whole_splits(ntoa, min(target, woodbury_max_splits(ntoa)))
    workspace = npsr * pairs * nsplit * WOODBURY_PANEL**2 if nsplit > 1 else 0
    return panels, pairs, nsplit, workspace


class Bf16Grid(NamedTuple):
    """The bf16 kernel's launch for one shape, as ``csrc/fused_woodbury.cu``
    (``bf_grid``) computes it. ``mode`` is ``"single"`` (one block owns the
    (pulsar, split) unit: P <= 2), ``"cluster"`` (a cluster of ``cluster``
    = P blocks, block i the strip of row panel i: 3 <= P <= 8) or
    ``"strips"`` (P > 8, the portable cluster size: block (i, group) owns
    row panel i against ``WOODBURY_BF16_GROUP`` column panels, no cluster).
    ``blocks`` is the blocks of one unit, ``grid`` the launch's (blocks,
    nsplit, Np), ``share_rows`` the most rows of a 64-row chunk one block
    stages, in pieces of ``piece_rows`` (one raw slot each; a single block
    stages 32-row pieces, so that more of them fit in flight), ``slots``
    its raw slots (0 for strips, which convert from device memory) and
    ``shared_bytes`` its dynamic shared memory."""
    panels: int
    mode: str
    cluster: int
    blocks: int
    grid: tuple
    share_rows: int
    piece_rows: int
    slots: int
    shared_bytes: int


#: the kernel's mode codes (BfMode)
BF16_MODES = ("single", "cluster", "strips")


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def woodbury_bf16_grid(npsr: int, q: int, nsplit: int, itemsize: int) -> Bf16Grid:
    """The bf16 kernel's launch for ``npsr`` pulsars, ``q`` columns,
    ``nsplit`` TOA splits and ``itemsize``-byte inputs (4 or 8): a mirror
    of the kernel's ``bf_grid``. Raw slots are as many as fit the block's
    shared memory, from two chunks' pieces to ``WOODBURY_BF16_MAX_SLOTS``."""
    panels = -(-(q + 1) // WOODBURY_PANEL)
    if panels <= WOODBURY_BF16_SINGLE_MAX:
        mode, cluster, blocks, rpan, cpan = "single", 1, 1, panels, panels
    elif panels <= WOODBURY_BF16_MAX_CLUSTER:
        mode, cluster, blocks, rpan, cpan = "cluster", panels, panels, 1, panels
    else:
        group = WOODBURY_BF16_GROUP
        mode, cluster, rpan, cpan = "strips", 1, 1, group
        blocks = panels * -(-panels // group)
    pairs = WOODBURY_BF16_ROWS // 2
    xbuf = 4 * pairs * (WOODBURY_PANEL * rpan + WOODBURY_BF16_PAD)
    ybuf = 4 * pairs * (WOODBURY_PANEL * cpan + WOODBURY_BF16_PAD)
    fixed = 2 * (xbuf + ybuf) + WOODBURY_BF16_SCRATCH
    share_rows = piece_rows = slots = 0
    smem = fixed
    if mode != "strips":
        share_rows = 2 * -(-pairs // cluster)
        piece_rows = WOODBURY_BF16_PIECE_ROWS if mode == "single" else share_rows
        slot = _round16(piece_rows * q * itemsize + 16) + 2 * _round16(piece_rows * itemsize + 16)
        slots = WOODBURY_BF16_MAX_SLOTS
        while slots > 2 * share_rows // piece_rows and fixed + slots * slot > WOODBURY_SMEM_LIMIT:
            slots -= 1
        smem = fixed + slots * slot
    return Bf16Grid(panels, mode, cluster, blocks, (blocks, nsplit, npsr), share_rows, piece_rows,
                    slots, smem)


def woodbury_bf16_shares(cluster: int):
    """The k pairs of a 64-row chunk each block of a ``cluster`` stages and
    converts: block b takes pairs ``[32 b / cluster, 32 (b + 1) / cluster)``
    (rows twice those)."""
    pairs = WOODBURY_BF16_ROWS // 2
    return [(pairs * b // cluster, pairs * (b + 1) // cluster) for b in range(cluster)]


def woodbury_bf16_span(offset: int, count: int, itemsize: int):
    """How the kernel's ``stage_span`` copies ``count`` elements that start
    ``offset`` elements past a 16-byte aligned address: ``(head, units,
    tail)``, the elements copied one by one before the first 16-byte
    boundary, the 16-byte copies, and the elements copied one by one after
    the last boundary. A span of T is pulsar p's rows from n0:
    ``offset = (p Nt + n0) Q``."""
    nbytes = count * itemsize
    head = offset * itemsize % 16
    hb = min(16 - head, nbytes) if head else 0
    units = (nbytes - hb) // 16
    tb = nbytes - hb - 16 * units
    return hb // itemsize, units, tb // itemsize


def woodbury_bf16_staged_bytes(npsr: int, ntoa: int, q: int, itemsize: int) -> int:
    """Bytes of T, w and r the bf16 kernel brings into its blocks per call
    (any split count): once each for one block or a cluster, which stage
    every chunk's span once; a strip block reads its row panel's and its
    group's columns of T (their padding excepted) and w, r for each row."""
    grid = woodbury_bf16_grid(npsr, q, 1, itemsize)
    if grid.mode != "strips":
        return npsr * ntoa * (q + 2) * itemsize
    width = WOODBURY_PANEL
    live = lambda lo, hi: max(0, min(hi, q + 1) - lo)  # columns of [T | r] in [lo, hi)
    cols = 0
    for i in range(grid.panels):
        for j0 in range(0, grid.panels, WOODBURY_BF16_GROUP):
            cols += live(i * width, (i + 1) * width)
            cols += live(j0 * width, (j0 + WOODBURY_BF16_GROUP) * width)
            cols += 1  # w
    return npsr * ntoa * cols * itemsize


def _whole_splits(ntoa: int, nsplit: int) -> int:
    """``nsplit`` (at least 1) lowered until no split is empty."""
    nsplit = max(1, nsplit)
    return -(-ntoa // -(-ntoa // nsplit))


def woodbury_max_splits(ntoa: int) -> int:
    """The most TOA splits a launch takes: one ``WOODBURY_CHUNK``-row chunk
    each."""
    return -(-ntoa // WOODBURY_CHUNK)


def woodbury_split_candidates(npsr: int, ntoa: int, q: int, sms: int,
                              precision: str = "highest"):
    """The split counts the tuner scores on the card, ascending: 1, the
    plan's choice, its half and its double, and the most a launch takes,
    each lowered until no split is empty."""
    plan = woodbury_plan(npsr, ntoa, q, sms, precision)[2]
    wanted = (1, plan // 2, plan, 2 * plan, woodbury_max_splits(ntoa))
    return sorted({_whole_splits(ntoa, min(n, woodbury_max_splits(ntoa))) for n in wanted})


def _bind(lib):
    lib.fused_woodbury_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_woodbury_workspace.restype = ctypes.c_longlong
    lib.fused_woodbury_bf16_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_woodbury_bf16_workspace.restype = ctypes.c_longlong
    for fn in (lib.fused_woodbury_launch, lib.fused_woodbury_bf16_launch):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fused_woodbury_bf16_grid.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_woodbury_bf16_grid.restype = ctypes.c_int
    lib.fused_woodbury_error_string.argtypes = [ctypes.c_int]
    lib.fused_woodbury_error_string.restype = ctypes.c_char_p



#: the launch counter of each precision's kernel
WOODBURY_COUNTERS = {"highest": "fused_woodbury_update", "bf16": "fused_woodbury_update_bf16"}


def _woodbury_launch(lib, T, w, r, nsplit: int, precision: str = "highest"):
    """Launch ``lib``'s kernel (the build of ``csrc/fused_woodbury.cu``)
    of ``precision`` with ``nsplit`` TOA splits on the current stream; the
    outputs (input dtype, or float32 for bf16) and the workspace come from
    ``torch.empty``."""
    npsr, ntoa, q = T.shape
    bf16 = precision == "bf16"
    acc = torch.float32 if bf16 else T.dtype
    entries = (lib.fused_woodbury_bf16_workspace if bf16 else lib.fused_woodbury_workspace)(q, nsplit)
    workspace = T.new_empty((npsr * entries,), dtype=acc)
    tnt = T.new_empty((npsr, q, q), dtype=acc)
    d = T.new_empty((npsr, q), dtype=acc)
    rnr = T.new_empty((npsr,), dtype=acc)
    launch = lib.fused_woodbury_bf16_launch if bf16 else lib.fused_woodbury_launch
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            T.data_ptr(), w.data_ptr(), r.data_ptr(),
            workspace.data_ptr() if workspace.numel() else None,
            tnt.data_ptr(), d.data_ptr(), rnr.data_ptr(),
            npsr, ntoa, q, nsplit, _DTYPE_CODES[T.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_woodbury kernel launch failed: {lib.fused_woodbury_error_string(rc).decode()}"
        )
    launches[WOODBURY_COUNTERS[precision]] += 1
    return tnt, d, rnr


def fused_woodbury_cuda(T, w, r, precision: str = "highest", nsplit=None):
    """``(T^T W T, T^T W r, r^T W r)`` from the CUDA kernel
    (``csrc/fused_woodbury.cu``) of ``precision``, launched on the current
    stream with ``nsplit`` TOA splits (None: :func:`woodbury_plan`'s).
    Any basis width runs. Raises on a malformed input, a failed build or
    a refused launch."""
    _check_precision(precision)
    _check_operands(T, w, r)
    if T.device.type != "cuda":
        raise ValueError(f"fused_woodbury_cuda needs CUDA tensors, got {T.device}")
    if not all(x.is_contiguous() for x in (T, w, r)):
        raise ValueError("fused_woodbury_update: T, w and r must be contiguous")
    npsr, ntoa, q = T.shape
    if q < 1 or ntoa < 1 or not 1 <= npsr <= 65535:
        raise ValueError(
            "fused_woodbury_update: the kernel takes at least one column, at least "
            f"one TOA and 1..65535 pulsars, got {tuple(T.shape)}"
        )
    if nsplit is None:
        sms = torch.cuda.get_device_properties(T.device).multi_processor_count
        nsplit = woodbury_plan(npsr, ntoa, q, sms, precision)[2]
    elif not 1 <= nsplit <= min(ntoa, 65535):
        raise ValueError(f"fused_woodbury_update: nsplit {nsplit} is not in 1..{min(ntoa, 65535)}")
    return _woodbury_launch(build.load("fused_woodbury", _bind), T, w, r, int(nsplit), precision)


def fused_woodbury_update(T, w, r, tile: int = DEFAULT_WOODBURY_TILE,
                          precision: str = "highest", nsplit=None):
    """``(T^T W T (Np, Q, Q), T^T W r (Np, Q), r^T W r (Np,))`` in one pass
    over Nt, in the input dtype (float32 for ``precision="bf16"``). CPU
    tensors run the plain version (``tile`` TOAs per step); CUDA tensors
    run the kernel (``nsplit`` TOA splits, None for the plan's), which
    launches or raises."""
    _check_precision(precision)
    if T.device.type == "cpu":
        return fused_woodbury_plain(T, w, r, tile, precision)
    return fused_woodbury_cuda(T, w, r, precision, nsplit)


# ------------------------------------- block-tridiagonal factor/solve
#
# Counterpart of the block-tridiagonal half of the reference module: the
# per-tile algebra of ``chol_tile``, ``tri_solve_tile``,
# ``tridiag_tile_factor_fwd`` and ``tridiag_tile_solve_bwd``, the two
# sweeps of ``tridiag_factor_solve_xla`` as the plain version, and the
# kernels of ``csrc/block_tridiag.cu``. Blocks are (Np, nb, b, b) diagonal
# ``D``, (Np, nb - 1, b, b) sub-diagonal ``E`` (``E[k]`` is the (k+1, k)
# block) and (Np, nb, b, Q) right-hand sides.

def chol_tile(a):
    """Batched (..., b, b) Cholesky as b right-looking rank-1 steps: column
    j of the factor is the working column j scaled by 1/sqrt of its pivot
    (rows >= j), then subtracted out as a rank-1 update. Exactly lower
    triangular; the caller guarantees positive definiteness."""
    n = a.shape[-1]
    below = torch.arange(n, device=a.device)
    l = torch.zeros_like(a)
    for j in range(n):
        colj = a[..., :, j]
        lcol = colj * (1.0 / torch.sqrt(colj[..., j]))[..., None] * (below >= j).to(a.dtype)
        l[..., :, j] = lcol
        a = a - lcol[..., :, None] * lcol[..., None, :]
    return l


def tri_solve_tile(l, b, trans: bool = False):
    """Triangular substitution against the (..., n, n) factor ``l`` for
    (..., n, Q) right-hand sides: ``L y = b``, or ``L^T z = b`` with
    ``trans=True``. Each step solves one row and eliminates it from the
    rows still to come."""
    n = l.shape[-1]
    rows = torch.arange(n, device=l.device)
    y = b.clone()
    for j in (reversed(range(n)) if trans else range(n)):
        xj = y[..., j, :] / l[..., j, j][..., None]
        colj = l[..., j, :] if trans else l[..., :, j]
        keep = (rows < j) if trans else (rows > j)
        y = y - (colj * keep.to(l.dtype))[..., :, None] * xj[..., None, :]
        y[..., j, :] = xj
    return y


def tridiag_tile_factor_fwd(d_k, e_k, x_k, l_prev, y_prev):
    """One forward block-column step: ``M_k = E_k L_prev^-T``, ``L_k =
    chol(D_k - M_k M_k^T)`` and ``y_k = L_k^-1 (x_k - M_k y_prev)``."""
    m = tri_solve_tile(l_prev, e_k.transpose(-1, -2)).transpose(-1, -2)
    s = d_k - m @ m.transpose(-1, -2)
    l = chol_tile(s)
    y = tri_solve_tile(l, x_k - m @ y_prev)
    return l, m, y


def tridiag_tile_solve_bwd(l_k, m_next, y_k, z_next):
    """One backward block-column step: ``z_k = L_k^-T (y_k - M_{k+1}^T
    z_next)``."""
    return tri_solve_tile(l_k, y_k - m_next.transpose(-1, -2) @ z_next, trans=True)


def _check_tridiag(name, blocks, rhs=None):
    """Shape, dtype and device checks: ``blocks`` are (Np, nb, b, b)
    tensors (the first may have nb - 1 blocks when it is E), ``rhs`` an
    (Np, nb, b, Q) tensor or None."""
    first = blocks[0]
    if first.ndim != 4 or first.shape[-1] != first.shape[-2]:
        raise ValueError(f"{name}: blocks {tuple(first.shape)} are not (Np, nb, b, b)")
    npsr, nb, b, _ = first.shape
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {first.dtype} is neither float32 nor float64")
    for x in list(blocks[1:]) + ([] if rhs is None else [rhs]):
        if x.dtype != first.dtype or x.device != first.device:
            raise TypeError(f"{name}: operands must share dtype and device")
    if rhs is not None and (rhs.ndim != 4 or tuple(rhs.shape[:3]) != (npsr, nb, b)):
        raise ValueError(f"{name}: right-hand sides {tuple(rhs.shape)} do not fit {(npsr, nb, b)}")
    return npsr, nb, b


def tridiag_forward_plain(D, E, X=None):
    """The forward factor sweep in plain PyTorch: ``(Ld, M, Y)``; ``Y`` is
    None when ``X`` is. The carry starts at the identity factor and a zero
    partial (``E_0`` is the zero pad, so ``M_0`` is exactly zero)."""
    npsr, nb, b = _check_tridiag("tridiag_forward", (D,), X)
    q = 0 if X is None else X.shape[-1]
    Epad = torch.cat([D.new_zeros((npsr, 1, b, b)), E], dim=1)
    xs = D.new_zeros((npsr, nb, b, q)) if X is None else X
    l_prev = torch.eye(b, dtype=D.dtype, device=D.device).expand(npsr, b, b)
    y_prev = D.new_zeros((npsr, b, q))
    Ld, M, Y = [], [], []
    for k in range(nb):
        l_prev, m, y_prev = tridiag_tile_factor_fwd(D[:, k], Epad[:, k], xs[:, k], l_prev, y_prev)
        Ld.append(l_prev)
        M.append(m)
        Y.append(y_prev)
    return torch.stack(Ld, 1), torch.stack(M, 1), (None if X is None else torch.stack(Y, 1))


def tridiag_forward_solve_plain(Ld, M, X):
    """The substitution-only forward sweep in plain PyTorch: ``Y`` with
    ``y_k = L_k^-1 (x_k - M_k y_{k-1})`` from a given factor."""
    npsr, nb, b = _check_tridiag("tridiag_forward_solve", (Ld, M), X)
    y = X.new_zeros((npsr, b, X.shape[-1]))
    Y = []
    for k in range(nb):
        y = tri_solve_tile(Ld[:, k], X[:, k] - M[:, k] @ y)
        Y.append(y)
    return torch.stack(Y, 1)


def tridiag_backward_plain(Ld, M, Y):
    """The backward sweep in plain PyTorch: ``Z`` with ``z_k = L_k^-T (y_k
    - M_{k+1}^T z_{k+1})`` over reversed block columns."""
    npsr, nb, b = _check_tridiag("tridiag_backward", (Ld, M), Y)
    Mnext = torch.cat([M[:, 1:], M.new_zeros((npsr, 1, b, b))], dim=1)
    z = Y.new_zeros((npsr, b, Y.shape[-1]))
    Z = [None] * nb
    for k in reversed(range(nb)):
        z = tridiag_tile_solve_bwd(Ld[:, k], Mnext[:, k], Y[:, k], z)
        Z[k] = z
    return torch.stack(Z, 1)


def tridiag_factor_solve_plain(D, E, X):
    """Fused factor + solve in plain PyTorch: ``(Ld, M, Z)`` with ``(L
    L^T) Z = X``, the two sweeps of the reference's tiled fallback."""
    Ld, M, Y = tridiag_forward_plain(D, E, X)
    return Ld, M, tridiag_backward_plain(Ld, M, Y)


def tridiag_operations(npsr: int, nb: int, b: int, q: int, factor: bool) -> int:
    """Floating-point operations of one forward sweep (``factor``: with the
    factor) or of one backward sweep (``factor=False``), per block column:
    the solve for M_k (b^3), the Schur complement (b^3), the Cholesky
    (b^3 / 3) and, per right-hand side, the M product (2 b^2) and the
    triangular solve (b^2)."""
    per = 3 * q * b * b
    if factor:
        per += 2 * b**3 + b**3 // 3
    return npsr * nb * per


def tridiag_bytes(npsr: int, nb: int, b: int, q: int, factor: bool, itemsize: int) -> int:
    """Bytes one sweep must move, each input read once and each output
    written once: the factor sweep reads D and E (and X) and writes Ld and
    M (and Y); a substitution sweep (``factor=False``) reads Ld, M and one
    (Np, nb, b, Q) operand and writes another."""
    blocks, rhs = npsr * nb * b * b, npsr * nb * b * q
    if factor:
        return itemsize * (3 * blocks + npsr * (nb - 1) * b * b + 2 * rhs)
    return itemsize * (2 * blocks + 2 * rhs)


def _bind_tridiag(lib):
    lib.tridiag_factor_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.tridiag_factor_fwd_launch.restype = ctypes.c_int
    for fn in (lib.tridiag_solve_fwd_launch, lib.tridiag_bwd_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn, pointers in ((lib.tridiag_factor_adjoint_launch, 8),
                         (lib.tridiag_factor_adjoint_vjp_launch, 12)):
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.block_tridiag_error_string.argtypes = [ctypes.c_int]
    lib.block_tridiag_error_string.restype = ctypes.c_char_p


#: the block sizes the kernels take (the reference accepts 2..256)
MAX_TRIDIAG_BLOCK = 256
#: the staged routes' limits (``csrc/block_tridiag.cu``: kStagedMaxBlock,
#: kSolveStages, kSolveMaxThreads, kSolveMaxRows, kFactorStages); the
#: kernel checks every launch against them
TRIDIAG_STAGED_MAX_BLOCK = 32
TRIDIAG_SOLVE_STAGES = 4
TRIDIAG_SOLVE_MAX_THREADS = 128
TRIDIAG_SOLVE_MAX_ROWS = 16
TRIDIAG_FACTOR_STAGES = 3
#: the per-thread route's blocks and its shared-memory cap (kColumnThreads,
#: kFactorThreads, kMaxSmem)
TRIDIAG_COLUMN_THREADS = 128
TRIDIAG_FACTOR_THREADS = 256
TRIDIAG_MAX_SMEM = 200 * 1024
#: threads per SM up to which a staged substitution sweep gives each column
#: a lane per row; past it each column takes the fewest lanes. At config B
#: that is a lane per row for Q = 1 and 7 and the fewest lanes for Q = 123
#: and 200, which measured fastest on the H100 (kernels/tridiag_study.py)
TRIDIAG_THREADS_PER_SM = 64
#: an H100's streaming multiprocessors, the plan's default card
H100_SMS = 132


class TridiagPlan(NamedTuple):
    """A block-tridiagonal sweep's launch, as ``csrc/block_tridiag.cu``
    runs it; the kernel refuses a launch whose threads or shared bytes
    differ from what it needs. ``route`` is ``"staged"`` (b <= 32) or
    ``"per_thread"``. Substitution sweeps: ``lanes`` lanes carry each
    right-hand-side column, ``columns`` columns share a block of
    ``threads`` threads, and block (x, p) takes columns x * columns ... of
    pulsar p. Factor sweep: the staged route is one warp (``lanes`` = 32)
    per pulsar, block x = pulsar x; the per-thread route one block per
    pulsar, block (0, p). ``shared_bytes`` is the block's dynamic shared
    memory."""
    route: str
    lanes: int
    columns: int
    threads: int
    grid: tuple
    shared_bytes: int


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def tridiag_staged_solve_plan(npsr: int, b: int, q: int, dtype, lanes: int,
                              columns: int) -> TridiagPlan:
    """The staged substitution sweep's launch with ``lanes`` lanes per
    column (b' or b' / min(b', 16), b' = b rounded up to a power of two)
    and ``columns`` columns per block."""
    size = torch.finfo(dtype).bits // 8
    bp = _pow2_ceil(b)
    tile = bp * (bp + 16 // size)  # a staged tile: rows of b' plus 16 bytes
    slot = -(-(2 * tile + bp) * size // 16) * 16  # L, the M block and 1/L_ii, 16-byte aligned
    threads = -(-columns * lanes // 32) * 32
    return TridiagPlan("staged", lanes, columns, threads, (-(-q // columns), npsr),
                       TRIDIAG_SOLVE_STAGES * slot)


def tridiag_plan(npsr: int, nb: int, b: int, q: int, dtype, factor: bool = False,
                 sms: int = H100_SMS) -> TridiagPlan:
    """The launch of one sweep over ``npsr`` pulsars of ``nb`` blocks of
    ``b`` with ``q`` right-hand sides in ``dtype`` on a card of ``sms``
    streaming multiprocessors: the factor sweep with ``factor`` (``q``
    may be 0), else a substitution sweep (forward or backward, ``q`` >=
    1). ``nb`` does not change the launch; it is checked with the rest.

    Blocks of b <= 32 take the staged route, apart from the fused factor +
    forward sweep (``factor`` with ``q`` > 0), which takes the per-thread
    route. The staged substitution sweeps give each column a lane per row
    while Np x Q x b' stays within ``TRIDIAG_THREADS_PER_SM`` threads per
    SM, else the fewest lanes (each owning ``TRIDIAG_SOLVE_MAX_ROWS`` rows,
    or all b'); and each block as many columns as four warps hold, or as
    one warp holds where four-warp blocks would outnumber the SMs. Larger
    blocks take the per-thread route."""
    if npsr < 1 or nb < 1 or not 1 <= b <= MAX_TRIDIAG_BLOCK or q < (0 if factor else 1):
        raise ValueError(f"tridiag_plan: no sweep of Np = {npsr}, nb = {nb}, b = {b}, Q = {q}")
    size = torch.finfo(dtype).bits // 8
    bp = _pow2_ceil(b)
    staged = b <= TRIDIAG_STAGED_MAX_BLOCK
    if factor:
        if staged and q == 0:
            tile = bp * (bp + 16 // size)
            smem = size * ((2 * TRIDIAG_FACTOR_STAGES + 4) * tile + 2 * (tile // bp) + 2 * bp)
            return TridiagPlan("staged", 32, 0, 32, (npsr, 1), smem)
        smem = 3 * b * b * size
        return TridiagPlan("per_thread", 1, q, TRIDIAG_FACTOR_THREADS, (1, npsr),
                           smem if smem <= TRIDIAG_MAX_SMEM else 0)
    if not staged:
        return TridiagPlan("per_thread", 1, TRIDIAG_COLUMN_THREADS, TRIDIAG_COLUMN_THREADS,
                           (-(-q // TRIDIAG_COLUMN_THREADS), npsr), 0)
    few = npsr * q * bp <= TRIDIAG_THREADS_PER_SM * sms
    lanes = bp if few else bp // min(bp, TRIDIAG_SOLVE_MAX_ROWS)
    columns = min(q, TRIDIAG_SOLVE_MAX_THREADS // lanes)
    if npsr * -(-q // columns) > sms:
        columns = min(q, 32 // lanes)
    return tridiag_staged_solve_plan(npsr, b, q, dtype, lanes, columns)


def _tridiag_launch(fn_name, device, tensors, ints, launch_name):
    """Launch one block_tridiag entry on the current stream of ``device``
    with the tensors' pointers (None: a null pointer) and the int
    arguments; raise when the launch is refused."""
    if device.type != "cuda":
        raise ValueError(f"the block-tridiagonal kernels need CUDA tensors, got {device}")
    lib = build.load("block_tridiag", _bind_tridiag)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(*[None if t is None else t.data_ptr() for t in tensors],
                                   *ints, stream)
    if rc != 0:
        raise RuntimeError(
            f"block_tridiag kernel launch failed: {lib.block_tridiag_error_string(rc).decode()}"
        )
    launches[launch_name] += 1


def _check_kernel_shape(npsr, b):
    if not 1 <= b <= MAX_TRIDIAG_BLOCK or not 1 <= npsr <= 65535:
        raise ValueError(
            f"the block-tridiagonal kernels take blocks of 1..{MAX_TRIDIAG_BLOCK} and "
            f"1..65535 pulsars, got b = {b}, Np = {npsr}"
        )


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tridiag_forward(D, E, X=None):
    """The forward factor sweep ``(Ld, M, Y)`` (``Y`` None without ``X``):
    CPU tensors run the plain version, CUDA tensors the factor kernel of
    ``csrc/block_tridiag.cu`` (the route :func:`tridiag_plan` picks), which
    launches or raises. The factor runs inside :class:`TridiagFactor`; a
    given ``X`` rides the factor's launch unless autograd records (an input
    requires grad and grad mode is on), when it goes through
    :class:`TridiagForwardSolve` on that factor."""
    if X is not None and not _recording(D, E, X):
        return _tridiag_forward(D, E, X)
    Ld, M = TridiagFactor.apply(D, E)
    return Ld, M, (None if X is None else TridiagForwardSolve.apply(Ld, M, X))


def _tridiag_forward(D, E, X=None):
    if D.device.type == "cpu":
        return tridiag_forward_plain(D, E, X)
    npsr, nb, b = _check_tridiag("tridiag_forward", (D, E), X)
    if tuple(E.shape) != (npsr, nb - 1, b, b):
        raise ValueError(f"tridiag_forward: E {tuple(E.shape)} does not fit D {tuple(D.shape)}")
    _check_kernel_shape(npsr, b)
    D, E = D.contiguous(), E.contiguous()
    X = None if X is None else X.contiguous()
    q = 0 if X is None else X.shape[-1]
    plan = tridiag_plan(npsr, nb, b, q, D.dtype, factor=True)
    Ld, M = torch.empty_like(D), torch.empty_like(D)
    Y = None if X is None else torch.empty_like(X)
    _tridiag_launch("tridiag_factor_fwd_launch", D.device, (D, E, X, Ld, M, Y),
                    (npsr, nb, b, q, int(plan.route == "staged"), plan.threads,
                     plan.shared_bytes, _DTYPE_CODES[D.dtype]), "tridiag_factor_solve_fwd")
    return Ld, M, Y


def _tridiag_solve_launch(fn_name, launch_name, Ld, M, R):
    """One substitution sweep on the card from ``R`` with the launch
    shape of :func:`tridiag_plan`."""
    npsr, nb, b, q = R.shape
    plan = tridiag_plan(npsr, nb, b, q, Ld.dtype, sms=_sms(Ld.device))
    out = torch.empty_like(R)
    lanes = plan.lanes if plan.route == "staged" else 0
    _tridiag_launch(fn_name, Ld.device, (Ld, M, R, out),
                    (npsr, nb, b, q, lanes, plan.columns, plan.threads, plan.shared_bytes,
                     _DTYPE_CODES[Ld.dtype]), launch_name)
    return out


def tridiag_forward_solve(Ld, M, X):
    """The substitution-only forward sweep ``Y`` from a given factor: CPU
    tensors run the plain version, CUDA tensors the kernel (counted as
    ``tridiag_solve_fwd``), which launches or raises; through
    :class:`TridiagForwardSolve`, which records a graph only while autograd
    records."""
    return TridiagForwardSolve.apply(Ld, M, X)


def _tridiag_forward_solve(Ld, M, X):
    if Ld.device.type == "cpu":
        return tridiag_forward_solve_plain(Ld, M, X)
    npsr, nb, b = _check_tridiag("tridiag_forward_solve", (Ld, M), X)
    _check_kernel_shape(npsr, b)
    Ld, M, X = Ld.contiguous(), M.contiguous(), X.contiguous()
    if not X.shape[-1]:
        return torch.empty_like(X)
    return _tridiag_solve_launch("tridiag_solve_fwd_launch", "tridiag_solve_fwd", Ld, M, X)


def tridiag_backward(Ld, M, Y):
    """The backward sweep ``Z``: CPU tensors run the plain version, CUDA
    tensors the kernel (counted as ``tridiag_factor_solve_bwd``), which
    launches or raises; through :class:`TridiagBackwardSolve`, which
    records a graph only while autograd records."""
    return TridiagBackwardSolve.apply(Ld, M, Y)


def _tridiag_backward(Ld, M, Y):
    if Ld.device.type == "cpu":
        return tridiag_backward_plain(Ld, M, Y)
    npsr, nb, b = _check_tridiag("tridiag_backward", (Ld, M), Y)
    _check_kernel_shape(npsr, b)
    Ld, M, Y = Ld.contiguous(), M.contiguous(), Y.contiguous()
    if not Y.shape[-1]:
        return torch.empty_like(Y)
    return _tridiag_solve_launch("tridiag_bwd_launch", "tridiag_factor_solve_bwd", Ld, M, Y)


def tridiag_factor_solve(D, E, X):
    """Fused batched block-tridiagonal factor + solve: ``(Ld, M, Z)`` with
    ``(L L^T) Z = X``. The forward sweep factors and forward-substitutes
    (each block column read once), the backward sweep runs the reversed
    columns. CPU tensors run the plain version; CUDA tensors the two
    kernels."""
    Ld, M, Y = tridiag_forward(D, E, X)
    return Ld, M, tridiag_backward(Ld, M, Y)


# ------------------------------------------ the sweeps under autograd
#
# The JAX package differentiates its scans with XLA; here each sweep is a
# ``torch.autograd.Function`` whose backward runs kernels too, so that
# ``map_fit``'s gradient and Hessian over a banded C0 reach no plain
# version on the card. L is the block lower-bidiagonal factor: diagonal
# blocks ``Ld`` (lower triangles read) and sub-diagonal blocks ``M``
# (``M[:, k]`` is the (k, k-1) block; ``M[:, 0]`` is zero and never read).
# The two substitution sweeps are each other's adjoints (gX = L^-T gY,
# gY = L^-1 gZ), so the set is closed under differentiation; the factor's
# adjoint is kernel 1 (:func:`tridiag_factor_adjoint`) and kernel 1's is
# kernel 2 (:func:`tridiag_factor_adjoint_vjp`, once differentiable: no
# third derivative is asked for). Under ``torch.no_grad`` or with no input
# requiring grad a Function records nothing and launches as its kernel
# alone would; only the factor's fused solve (``tridiag_forward`` with X)
# keeps its one launch by leaving the Functions while autograd is idle.

def _recording(*tensors) -> bool:
    """True when autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _pattern_grad(A, B):
    """The cotangent ``-A B^T`` of the bidiagonal factor restricted to its
    pattern, for (Np, nb, b, Q) operands: ``(gLd, gM)`` with ``gLd[k] =
    -tril(A_k B_k^T)`` and ``gM[k] = -A_k B_{k-1}^T``, ``gM[0]`` zero."""
    gLd = -torch.einsum("pkiq,pkjq->pkij", A, B).tril()
    gM = torch.cat([torch.zeros_like(gLd[:, :1]),
                    -torch.einsum("pkiq,pkjq->pkij", A[:, 1:], B[:, :-1])], dim=1)
    return gLd, gM


class TridiagForwardSolve(torch.autograd.Function):
    """``Y = L^-1 X`` by the substitution-only forward sweep (B.4's kernel
    on the card). Backward: ``gX = L^-T gY`` (:class:`TridiagBackwardSolve`)
    and the factor's cotangent ``-gX Y^T`` on L's pattern."""

    @staticmethod
    def forward(ctx, Ld, M, X):
        Y = _tridiag_forward_solve(Ld, M, X)
        ctx.save_for_backward(Ld, M, Y)
        return Y

    @staticmethod
    def backward(ctx, gY):
        Ld, M, Y = ctx.saved_tensors
        gX = TridiagBackwardSolve.apply(Ld, M, gY)
        gLd, gM = _pattern_grad(gX, Y) if any(ctx.needs_input_grad[:2]) else (None, None)
        return gLd, gM, gX


class TridiagBackwardSolve(torch.autograd.Function):
    """``Z = L^-T Y`` by the backward sweep (B.5's kernel on the card).
    Backward: ``gY = L^-1 gZ`` (:class:`TridiagForwardSolve`) and the
    factor's cotangent ``-Z gY^T`` on L's pattern."""

    @staticmethod
    def forward(ctx, Ld, M, Y):
        Z = _tridiag_backward(Ld, M, Y)
        ctx.save_for_backward(Ld, M, Z)
        return Z

    @staticmethod
    def backward(ctx, gZ):
        Ld, M, Z = ctx.saved_tensors
        gY = TridiagForwardSolve.apply(Ld, M, gZ)
        gLd, gM = _pattern_grad(Z, gY) if any(ctx.needs_input_grad[:2]) else (None, None)
        return gLd, gM, gY


class TridiagFactor(torch.autograd.Function):
    """``(Ld, M)`` of ``(D, E)`` by B.4's factor sweep. Backward: kernel 1
    (:class:`TridiagFactorAdjoint`) on the saved factor, giving ``gD`` on
    the lower triangles (the triangle the sweep reads) and ``gE``."""

    @staticmethod
    def forward(ctx, D, E):
        Ld, M, _ = _tridiag_forward(D, E)
        ctx.save_for_backward(Ld, M)
        return Ld, M

    @staticmethod
    def backward(ctx, gLd, gM):
        Ld, M = ctx.saved_tensors
        return TridiagFactorAdjoint.apply(Ld, M, gLd, gM)


class TridiagFactorAdjoint(torch.autograd.Function):
    """Kernel 1, ``(gD, gE)`` from ``(Ld, M, gLd, gM)``: the factor sweep's
    adjoint (:func:`tridiag_factor_adjoint`). Its backward, reached only
    by a Hessian's second pass, is kernel 2
    (:func:`tridiag_factor_adjoint_vjp`), which reads the saved outputs
    and kernel 1's Lbar instead of recomputing kernel 1's columns."""

    @staticmethod
    def forward(ctx, Ld, M, gLd, gM):
        gD, gE, ctx.lbar = tridiag_factor_adjoint(Ld, M, gLd, gM)
        ctx.save_for_backward(Ld, M, gLd, gM, gD, gE)
        return gD, gE

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, hD, hE):
        Ld, M, gLd, gM, gD, gE = ctx.saved_tensors
        return tridiag_factor_adjoint_vjp(Ld, M, gLd, gM, hD, hE, lbar=ctx.lbar, gD=gD, gE=gE)


def _phi(A):
    """Murray's Phi: the lower triangle with the diagonal halved."""
    return A.tril() - 0.5 * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))


def tridiag_factor_adjoint_plain(Ld, M, gLd, gM):
    """Kernel 1's plain version: the reverse sweep over block columns k =
    nb - 1 ... 0 of the factor's adjoint, ``(gD, gE)``. Per block column,
    with L_k's total cotangent ``Lbar = tril(gLd_k + C_k)`` (C: the carry
    from column k + 1), the Cholesky adjoint (Murray 2016) ``G = L_k^-T
    Phi(L_k^T Lbar) L_k^-1`` and ``gD_k = tril(G + G^T) - diag(G)``; then,
    for k >= 1, the cotangent of ``M_k = E_{k-1} L_{k-1}^-T``: ``W =
    (gM_k - (G + G^T) M_k) L_{k-1}^-1`` is ``gE_{k-1}``, and ``C_{k-1} =
    -W^T M_k``. Reads only the lower triangles of ``Ld`` and ``gLd``, as
    the forward sweep's outputs are read."""
    npsr, nb, b = _check_tridiag("tridiag_factor_adjoint", (Ld, M))
    L = Ld.tril()
    carry = torch.zeros_like(L[:, 0])
    gD, gE = [None] * nb, [None] * (nb - 1)
    for k in reversed(range(nb)):
        lbar = (gLd[:, k] + carry).tril()
        X = torch.linalg.solve_triangular(L[:, k].mT, _phi(L[:, k].mT @ lbar), upper=True)
        G = torch.linalg.solve_triangular(L[:, k], X, upper=False, left=False)
        s2 = G + G.mT
        gD[k] = s2.tril() - torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))
        if k:
            W = torch.linalg.solve_triangular(L[:, k - 1], gM[:, k] - s2 @ M[:, k],
                                              upper=False, left=False)
            gE[k - 1] = W
            carry = -W.mT @ M[:, k]
    gE = torch.stack(gE, 1) if nb > 1 else Ld.new_zeros((npsr, 0, b, b))
    return torch.stack(gD, 1), gE


def tridiag_factor_adjoint_vjp_plain(Ld, M, gLd, gM, hD, hE):
    """Kernel 2's plain version: ``torch.autograd.grad`` through kernel 1's
    plain loop, the cotangents of ``(Ld, M, gLd, gM)`` for cotangents
    ``(hD, hE)`` of ``(gD, gE)``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (Ld, M, gLd, gM)]
        # gE of a single block column is an empty constant
        pairs = [(o, h) for o, h in zip(tridiag_factor_adjoint_plain(*ins), (hD, hE))
                 if o.requires_grad]
        outs, cots = zip(*pairs)
        outs = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    return tuple(torch.zeros_like(i) if o is None else o for o, i in zip(outs, ins))


def tridiag_adjoint_operations(npsr: int, nb: int, b: int, second: bool) -> int:
    """Floating-point operations of the function kernel 1 (``second=False``)
    or kernel 2 computes, per sweep, as the plain loop does it (each b x b
    product 2 b^3, each triangular solve b^3): kernel 1 three products and
    three solves a block column; kernel 2 those of kernel 1's column but
    the last product, then eight products and three solves more. The
    kernels' own counts differ (they trade each solve for a product with
    an explicit L^-1); the bound is the function's."""
    per = (9 if not second else 28) * b**3
    return npsr * nb * per


def tridiag_adjoint_bytes(npsr: int, nb: int, b: int, second: bool, itemsize: int) -> int:
    """Bytes kernel 1 or 2 must move, each input of its function read once
    and each output written once: kernel 1's function reads Ld, M, gLd and
    gM and writes gD and gE (the Lbar it also stores for kernel 2 is not
    part of it); kernel 2's reads Ld, M, gLd (as Lbar), gM, hD and hE and
    writes the four cotangents (the kernel itself reads kernel 1's Lbar, gD
    and gE in place of gLd and gM)."""
    blocks, sub = npsr * nb * b * b, npsr * (nb - 1) * b * b
    return itemsize * ((9 if second else 5) * blocks + sub)


class AdjointPlan(NamedTuple):
    """Kernel 1's or 2's launch, as ``csrc/block_tridiag.cu`` runs it (the
    kernel refuses any other): one block of ``threads`` per pulsar (grid
    ``(npsr, 1)``) at the template width ``width`` (b' = 16 for b <= 16,
    else 32: whole m16n8k8 DMMA tiles), its b' x (b' + 4) tiles in
    ``shared_bytes`` of dynamic shared memory (``route`` ``"shared"``, b' =
    16) or in a device scratch of ``scratch_bytes`` (``"scratch"``, b' =
    32)."""
    route: str
    width: int
    threads: int
    grid: tuple
    shared_bytes: int
    scratch_bytes: int


#: kernels 1 and 2's tiles a pulsar (csrc/block_tridiag.cu: kAdj1Tiles,
#: kAdj2Tiles: eight block columns' input tiles, six columns' computed
#: tiles, and the tiles of one or two steps), their block (two chain
#: warps, two inverse warps, twelve workers: kAdjThreads) and the widest
#: b' whose tiles sit in shared memory
TRIDIAG_ADJOINT_TILES = {False: 83, True: 88}
TRIDIAG_ADJOINT_THREADS = 32 * 16
TRIDIAG_ADJOINT_SHARED_MAX_WIDTH = 16


def tridiag_adjoint_plan(npsr: int, b: int, second: bool) -> AdjointPlan:
    """Kernel 1's (``second=False``) or kernel 2's launch for ``npsr``
    pulsars of blocks of ``b`` (1..32)."""
    if not 1 <= b <= TRIDIAG_STAGED_MAX_BLOCK or not 1 <= npsr <= 65535:
        raise ValueError(
            f"the factor's adjoint kernels take blocks of 1..{TRIDIAG_STAGED_MAX_BLOCK} and "
            f"1..65535 pulsars, got b = {b}, Np = {npsr}"
        )
    shared = b <= TRIDIAG_ADJOINT_SHARED_MAX_WIDTH
    width = 16 if shared else 32
    tiles = TRIDIAG_ADJOINT_TILES[second] * width * (width + 4) * 8
    return AdjointPlan("shared" if shared else "scratch", width, TRIDIAG_ADJOINT_THREADS,
                       (npsr, 1), tiles if shared else 0, 0 if shared else npsr * tiles)


def _adjoint_launch(fn_name, launch_name, second, tensors, npsr, nb, b):
    """One launch of kernel 1 or 2 (float64 only), its scratch (if the
    plan has one) allocated here, with its counts recorded as
    ``cuda.cost.*`` gauges (``obs/devprof.py``)."""
    from ..obs import devprof

    if tensors[0].dtype != torch.float64:
        raise TypeError(f"{launch_name}: the kernel takes float64 only, got {tensors[0].dtype}")
    plan = tridiag_adjoint_plan(npsr, b, second)
    scratch = tensors[0].new_empty(plan.scratch_bytes // 8) if plan.scratch_bytes else None
    _tridiag_launch(fn_name, tensors[0].device, (*tensors, scratch),
                    (npsr, nb, b, plan.threads, plan.shared_bytes), launch_name)
    devprof.record_kernel_cost(launch_name, tridiag_adjoint_operations(npsr, nb, b, second),
                               tridiag_adjoint_bytes(npsr, nb, b, second, 8))


def tridiag_factor_adjoint(Ld, M, gLd, gM):
    """Kernel 1: the factor sweep's adjoint ``(gD, gE, lbar)``, ``lbar``
    the per-column cotangents of L that kernel 2 reads (None on the CPU).
    CPU tensors run :func:`tridiag_factor_adjoint_plain`; CUDA tensors the
    kernel of ``csrc/block_tridiag.cu`` (float64, b <= 32; counted as
    ``tridiag_factor_adjoint``), which launches or raises."""
    if Ld.device.type == "cpu":
        return (*tridiag_factor_adjoint_plain(Ld, M, gLd, gM), None)
    npsr, nb, b = _check_tridiag("tridiag_factor_adjoint", (Ld, M, gLd, gM))
    ins = [t.contiguous() for t in (Ld, M, gLd, gM)]
    gD, lbar = torch.empty_like(ins[0]), torch.empty_like(ins[0])
    gE = ins[0].new_empty((npsr, nb - 1, b, b))
    _adjoint_launch("tridiag_factor_adjoint_launch", "tridiag_factor_adjoint", False,
                    (*ins, gD, gE, lbar), npsr, nb, b)
    return gD, gE, lbar


def tridiag_factor_adjoint_vjp(Ld, M, gLd, gM, hD, hE, lbar=None, gD=None, gE=None):
    """Kernel 2: the cotangents ``(hLd, hM, hgLd, hgM)`` of kernel 1's
    inputs for cotangents ``(hD, hE)`` of its outputs, a forward sweep over
    block columns. CPU tensors run :func:`tridiag_factor_adjoint_vjp_plain`;
    CUDA tensors the kernel (float64, b <= 32; counted as
    ``tridiag_factor_adjoint_vjp``), which reads kernel 1's ``lbar``,
    ``gD`` and ``gE`` (for ``Ld, M, gLd, gM``: ``gLd`` and ``gM`` are not
    read) and launches or raises."""
    if Ld.device.type == "cpu":
        return tridiag_factor_adjoint_vjp_plain(Ld, M, gLd, gM, hD, hE)
    if lbar is None or gD is None or gE is None:
        raise ValueError("tridiag_factor_adjoint_vjp: the kernel needs kernel 1's lbar, gD and gE")
    npsr, nb, b = _check_tridiag("tridiag_factor_adjoint_vjp", (Ld, M, lbar, gD, hD, gE, hE))
    for name, t in (("lbar", lbar), ("gD", gD), ("hD", hD), ("gE", gE), ("hE", hE)):
        want = (npsr, nb - (name in ("gE", "hE")), b, b)
        if tuple(t.shape) != want:
            raise ValueError(f"tridiag_factor_adjoint_vjp: {name} {tuple(t.shape)} is not {want}")
    ins = [t.contiguous() for t in (Ld, M, lbar, gD, gE, hD, hE)]
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    _adjoint_launch("tridiag_factor_adjoint_vjp_launch", "tridiag_factor_adjoint_vjp", True,
                    (*ins, *outs), npsr, nb, b)
    return tuple(outs)
