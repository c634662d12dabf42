"""Fused Woodbury assembly: plain version and CUDA kernel.

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
  ``csrc/fused_woodbury.cu``, which launches or raises. The kernel sums
  in its own order (``tile`` sets only the plain version's), so the two
  agree to a tolerance, not bitwise.

Only ``precision="highest"`` is ported: the bf16 variant waits for the
numerics observatory that gates it (ROADMAP.md items B.3 and A.16).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build, launches

#: the reference's untuned tile along Nt (the tuner is not ported)
DEFAULT_WOODBURY_TILE = 256

#: the precision policies of the reference; "bf16" is not ported yet
PRECISIONS = ("highest", "bf16")

#: the widest basis the kernel takes: (Q + 1) augmented columns in 4 x 4
#: register blocks, at most four blocks per thread of 256
MAX_COLUMNS = 175


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision != "highest":
        raise NotImplementedError(
            "the bf16 variant of the fused Woodbury assembly is not ported to "
            "pta_replicator_tpu_torch yet (ROADMAP.md item B.3, gated by A.16)"
        )


def woodbury_operations(npsr: int, ntoa: int, q: int) -> int:
    """Floating-point operations of the assembly, counted per TOA: the
    lower triangle of T^T W T (Q(Q+1)), plus 4Q + 3 for the scaling W T,
    T^T W r and r^T W r."""
    return npsr * ntoa * (q * (q + 1) + 4 * q + 3)


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


def gp_tile_terms(t, w, r):
    """One Nt-tile's contribution ``(t^T W t (Np, Q, Q), t^T W r (Np, Q),
    r^T W r (Np,))`` for a tile ``t`` (Np, tile, Q), ``w`` and ``r`` (Np,
    tile)."""
    wr = w * r
    tnt = torch.einsum("pnq,pns->pqs", t, t * w[..., None])
    d = torch.einsum("pnq,pn->pq", t, wr)
    rnr = torch.einsum("pn,pn->p", r, wr)
    return tnt, d, rnr


def fused_woodbury_plain(T, w, r, tile: int = DEFAULT_WOODBURY_TILE,
                         precision: str = "highest"):
    """``(T^T W T, T^T W r, r^T W r)`` in plain PyTorch: Nt zero-padded to
    the ``tile`` grid (padded rows carry w = 0) and the tiles accumulated
    in order from zero, as the reference's tiled fallback does."""
    _check_precision(precision)
    _check_operands(T, w, r)
    npsr, ntoa, q = T.shape
    pad = (-ntoa) % tile
    if pad:
        T = torch.nn.functional.pad(T, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
        r = torch.nn.functional.pad(r, (0, pad))
    tnt = T.new_zeros((npsr, q, q))
    d = T.new_zeros((npsr, q))
    rnr = T.new_zeros((npsr,))
    for lo in range(0, ntoa + pad, tile):
        dt, dd, dq = gp_tile_terms(T[:, lo:lo + tile], w[:, lo:lo + tile], r[:, lo:lo + tile])
        tnt, d, rnr = tnt + dt, d + dd, rnr + dq
    return tnt, d, rnr


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _bind(lib):
    lib.fused_woodbury_workspace.argtypes = [ctypes.c_int]
    lib.fused_woodbury_workspace.restype = ctypes.c_int
    lib.fused_woodbury_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.fused_woodbury_launch.restype = ctypes.c_int
    lib.fused_woodbury_error_string.argtypes = [ctypes.c_int]
    lib.fused_woodbury_error_string.restype = ctypes.c_char_p


def _splits(device, npsr: int, ntoa: int) -> int:
    """TOA ranges per pulsar: enough blocks for two per streaming
    multiprocessor, each range at least 64 TOAs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-ntoa // 64), -(-2 * sms // npsr)))


def fused_woodbury_cuda(T, w, r):
    """``(T^T W T, T^T W r, r^T W r)`` from the CUDA kernel
    (``csrc/fused_woodbury.cu``), launched on the current stream. Raises
    on a malformed input, a failed build or a refused launch."""
    _check_operands(T, w, r)
    if T.device.type != "cuda":
        raise ValueError(f"fused_woodbury_cuda needs CUDA tensors, got {T.device}")
    if not all(x.is_contiguous() for x in (T, w, r)):
        raise ValueError("fused_woodbury_update: T, w and r must be contiguous")
    npsr, ntoa, q = T.shape
    if not 1 <= q <= MAX_COLUMNS or ntoa < 1 or not 1 <= npsr <= 65535:
        raise ValueError(
            f"fused_woodbury_update: the kernel takes 1..{MAX_COLUMNS} columns, "
            f"at least one TOA and 1..65535 pulsars, got {tuple(T.shape)}"
        )
    lib = build.load("fused_woodbury", _bind)
    nsplit = _splits(T.device, npsr, ntoa)
    workspace = T.new_empty((npsr, nsplit, lib.fused_woodbury_workspace(q)))
    tnt = T.new_empty((npsr, q, q))
    d = T.new_empty((npsr, q))
    rnr = T.new_empty((npsr,))
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_woodbury_launch(
            T.data_ptr(), w.data_ptr(), r.data_ptr(), workspace.data_ptr(),
            tnt.data_ptr(), d.data_ptr(), rnr.data_ptr(),
            npsr, ntoa, q, nsplit, _DTYPE_CODES[T.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_woodbury kernel launch failed: {lib.fused_woodbury_error_string(rc).decode()}"
        )
    launches["fused_woodbury_update"] += 1
    return tnt, d, rnr


def fused_woodbury_update(T, w, r, tile: int = DEFAULT_WOODBURY_TILE,
                          precision: str = "highest"):
    """``(T^T W T (Np, Q, Q), T^T W r (Np, Q), r^T W r (Np,))`` in one pass
    over Nt. CPU tensors run the plain version (``tile`` TOAs per step);
    CUDA tensors run the kernel, which launches or raises."""
    _check_precision(precision)
    if T.device.type == "cpu":
        return fused_woodbury_plain(T, w, r, tile)
    return fused_woodbury_cuda(T, w, r)
