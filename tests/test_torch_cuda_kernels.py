"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when no CUDA device is present (a CUDA kernel has no CPU mode). Run on the
card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``. The
file needs no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pta_replicator_tpu_torch.covariance import kernels as tk
from pta_replicator_tpu_torch.kernels import launches
from pta_replicator_tpu_torch.likelihood.gp import PrecisionNotReady, require_precision_ready
from pta_replicator_tpu_torch.ops import cw as tcw
from pta_replicator_tpu_torch.ops import gp as tgp

pytestmark = pytest.mark.cuda

MODES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(npsr=5, ntoa=700, nsrc=150, evolve=True, seed=0):
    """Planes of a catalog with merging sources (NaN-guarded inside the
    span) and merged ones (valid = 0), and fold-relative times."""
    rng = np.random.default_rng(seed)
    phat = rng.normal(size=(npsr, 3))
    phat /= np.linalg.norm(phat, axis=1, keepdims=True)
    cat = [np.arccos(rng.uniform(-1, 1, nsrc)), rng.uniform(0, 2 * np.pi, nsrc),
           10 ** rng.uniform(8, 9.8, nsrc), rng.uniform(10, 500, nsrc),
           10 ** rng.uniform(-8.8, -7.4, nsrc), rng.uniform(0, 2 * np.pi, nsrc),
           rng.uniform(0, np.pi, nsrc), np.arccos(rng.uniform(-1, 1, nsrc))]
    src, psr = tcw.cw_catalog_planes(phat, *cat, pdist=1.3, t_fold=-7.7e7,
                                     evolve=evolve)
    src[8, :7] = 0.0  # a few sources merged before the fold
    u = np.sort(rng.uniform(0.0, 5.0e8, (npsr, ntoa)), axis=1)
    return u, src, psr


@pytest.mark.parametrize("psr_term,evolve", MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 3e-3)])
def test_kernel_matches_plain(cuda_device, dtype, tol, psr_term, evolve):
    u, src, psr = _inputs(evolve=evolve)
    args = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src, psr)]
    launches.clear()
    got = tcw.cw_catalog_response(*args, psr_term=psr_term, evolve=evolve)
    torch.cuda.synchronize()
    assert launches["cw_catalog_response"] == 1
    want = tcw.cw_catalog_response_plain(*args, psr_term=psr_term, evolve=evolve)
    assert bool(torch.all(torch.isfinite(got)))
    err = torch.sqrt(torch.mean((got - want) ** 2)) / torch.sqrt(torch.mean(want**2))
    assert float(err) <= tol


def test_kernel_is_deterministic_and_checks_shapes(cuda_device):
    u, src, psr = _inputs()
    args = [torch.as_tensor(a, device=cuda_device) for a in (u, src, psr)]
    a = tcw.cw_catalog_response(*args)
    b = tcw.cw_catalog_response(*args)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not fit"):
        tcw.cw_catalog_response(args[0][:2], args[1], args[2])


def _rel_rms(got, want):
    got, want = got.double(), want.double()
    return float(torch.sqrt(torch.mean((got - want) ** 2)) / torch.sqrt(torch.mean(want**2)))


@pytest.mark.parametrize("ntoa", [1, 129, 701, 1030])
@pytest.mark.parametrize("psr_term,evolve", MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 3e-3)])
def test_kernel_ragged_edge(cuda_device, dtype, tol, psr_term, evolve, ntoa):
    """Each instance against the plain version, at TOA counts that are no
    multiple of the block's span; two launches give the same bits, and the
    fold and the response each count their launches."""
    u, src, psr = _inputs(npsr=3, ntoa=ntoa, nsrc=200, evolve=evolve, seed=ntoa)
    u_t, src_t, psr_t = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src, psr))
    lib = tcw.build.load("cw_catalog", tcw._bind)
    assert lib.cw_kernel_plane_width(int(psr_term), int(evolve)) == \
        tcw.kernel_plane_width(psr_term, evolve)
    launches.clear()
    planes = tcw._cw_fold(lib, src_t, psr_t, psr_term, evolve)
    got = tcw._cw_launch(lib, u_t, planes, psr_term, evolve)
    again = tcw._cw_launch(lib, u_t, planes, psr_term, evolve)
    assert launches["cw_fold_planes"] == 1 and launches["cw_catalog_response"] == 2
    want = tcw.cw_catalog_response_plain(u_t, src_t, psr_t, psr_term, evolve)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_rms(got, want) <= tol
    assert torch.equal(got, again)


@pytest.mark.parametrize("psr_term,evolve", MODES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fold_kernel_equals_kernel_planes(cuda_device, dtype, psr_term, evolve):
    """The fold kernel computes cw_kernel_planes's products in its order:
    the same bits, padding included, on a catalog with merged sources."""
    u, src, psr = _inputs(npsr=4, ntoa=10, nsrc=300, evolve=evolve, seed=5)
    src_t, psr_t = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (src, psr))
    lib = tcw.build.load("cw_catalog", tcw._bind)
    got = tcw._cw_fold(lib, src_t, psr_t, psr_term, evolve)
    want = tcw.cw_kernel_planes(src_t, psr_t, psr_term, evolve)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_kernel_population_depth_float32_vs_float64(cuda_device):
    """The population catalog's shape at a cut depth (3 pulsars x 2,000
    TOAs x 2,000 sources, chirped with the pulsar term): each dtype against
    the plain version, float32 against the float64 kernel, and the same
    bits twice."""
    u, src, psr = _inputs(npsr=3, ntoa=2000, nsrc=2000, seed=3)
    out = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 3e-3)):
        args = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src, psr)]
        launches.clear()
        got = tcw.cw_catalog_response(*args)
        again = tcw.cw_catalog_response(*args)
        torch.cuda.synchronize()
        assert launches["cw_catalog_response"] == 2
        want = tcw.cw_catalog_response_plain(*args)
        assert bool(torch.isfinite(got).all()) and bool((got != 0).any())
        assert _rel_rms(got, want) <= tol
        assert torch.equal(got, again)
        out[dtype] = got
    assert _rel_rms(out[torch.float32], out[torch.float64]) <= 3e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_empty_catalog_sums_to_zero(cuda_device, dtype):
    u, src, psr = _inputs(npsr=2, ntoa=300, nsrc=5)
    args = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src[:, :0], psr[..., :0])]
    launches.clear()
    got = tcw.cw_catalog_response(*args)
    torch.cuda.synchronize()
    assert got.shape == (2, 300) and bool((got == 0).all())
    assert launches["cw_fold_planes"] == 0  # nothing to fold


def test_kernel_refuses_planes_that_do_not_fit(cuda_device):
    u, src, psr = _inputs(npsr=2, ntoa=300, nsrc=20)
    u_t, src_t, psr_t = (torch.as_tensor(a, device=cuda_device) for a in (u, src, psr))
    lib = tcw.build.load("cw_catalog", tcw._bind)
    planes = tcw.cw_kernel_planes(src_t, psr_t, True, True)
    with pytest.raises(ValueError, match="do not fit"):
        tcw._cw_launch(lib, u_t, planes, False, True)  # the earth-only width is 8
    with pytest.raises(ValueError, match="do not fit"):
        tcw._cw_launch(lib, u_t, planes[:, :, 1:], True, True)  # a view
    shifted = torch.empty(planes.numel() + 1, dtype=planes.dtype, device=cuda_device)[1:]
    shifted = shifted.view(planes.shape).copy_(planes)  # contiguous, 8 bytes off
    with pytest.raises(ValueError, match="do not fit"):
        tcw._cw_launch(lib, u_t, shifted, True, True)


def _woodbury(npsr, ntoa, q, dtype, device, seed=0):
    """Operands with a tenth of the rows masked (w = 0) and w at the
    likelihood's scale (1/sigma^2 ~ 1e12)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((npsr, ntoa, q))
    w = rng.uniform(0.5, 2.0, (npsr, ntoa)) * 1e12 * (rng.random((npsr, ntoa)) > 0.1)
    r = rng.standard_normal((npsr, ntoa)) * 1e-6
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in (T, w, r)]


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


#: ragged Nt throughout (no multiple of the kernel's 32-row chunk); Q + 1
#: from one 64-column panel (one panel pair) to five (15 pairs), past the
#: old kernel's 175-column cap; Nt = 5 is less than one chunk
WOODBURY_SHAPES = [(3, 100, 7), (4, 997, 123), (2, 300, 175), (2, 300, 183), (1, 130, 300),
                   (3, 5, 40)]


@pytest.mark.parametrize("shape", WOODBURY_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
def test_woodbury_kernel_matches_plain(cuda_device, shape, dtype, tol):
    T, w, r = _woodbury(*shape, dtype, cuda_device)
    launches.clear()
    got = tgp.fused_woodbury_update(T, w, r)
    torch.cuda.synchronize()
    assert launches["fused_woodbury_update"] == 1
    want = tgp.fused_woodbury_plain(T, w, r)
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == dtype
        assert bool(torch.all(torch.isfinite(g)))
        assert _rel_max(g, x) <= tol
    assert torch.equal(got[0], got[0].transpose(-1, -2))


@pytest.mark.parametrize("nsplit", [1, 2, 7])
def test_woodbury_kernel_any_split_count(cuda_device, nsplit):
    """One split scatters straight from the tiles; several go through the
    workspace and the fixed-order reduction. The wrapper sizes the
    workspace from the kernel, which must agree with the plan."""
    T, w, r = _woodbury(4, 997, 123, torch.float64, cuda_device)
    lib = tgp.build.load("fused_woodbury", tgp._bind)
    got = tgp._woodbury_launch(lib, T, w, r, nsplit)
    want = tgp.fused_woodbury_plain(T, w, r)
    for g, x in zip(got, want):
        assert _rel_max(g, x) <= 1e-12
    for q in (7, 123, 183, 300):
        plan = tgp.woodbury_plan(68, 7758, q, 132)
        assert 68 * lib.fused_woodbury_workspace(q, plan[2]) == plan[3]


def test_woodbury_kernel_is_deterministic(cuda_device):
    T, w, r = _woodbury(4, 997, 123, torch.float64, cuda_device)
    a = tgp.fused_woodbury_update(T, w, r)
    b = tgp.fused_woodbury_update(T, w, r)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_woodbury_kernel_refuses_bad_operands(cuda_device):
    T, w, r = _woodbury(3, 100, 7, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="do not fit"):
        tgp.fused_woodbury_update(T, w[:, :50], r)
    with pytest.raises(TypeError, match="neither"):
        tgp.fused_woodbury_update(T.half(), w.half(), r.half())
    with pytest.raises(TypeError, match="share"):
        tgp.fused_woodbury_update(T, w.float(), r)
    with pytest.raises(TypeError, match="share"):
        tgp.fused_woodbury_update(T, w.cpu(), r)
    with pytest.raises(ValueError, match="contiguous"):
        tgp.fused_woodbury_update(T.transpose(0, 1).contiguous().transpose(0, 1), w, r)
    with pytest.raises(ValueError, match="precision"):
        tgp.fused_woodbury_update(T, w, r, precision="fp8")
    with pytest.raises(PrecisionNotReady):
        require_precision_ready("bf16")


# ------------------------------------------------- covariance kernels

def _rel_max_t(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


#: kernel vs plain, max |error| over the largest |entry|
COV_TOL = [(torch.float64, 1e-12), (torch.float32, 1e-4)]


def _upper_tiles(m, tile, device):
    """Mask of the strictly-upper (tile x tile) tiles of an m x m matrix."""
    t = torch.arange(m, device=device) // tile
    return t[:, None] < t[None, :]


def _syrk_case(npsr, m, b, dtype, device, seed=1):
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.standard_normal((npsr, m, m)), dtype=dtype, device=device)
    L = torch.as_tensor(rng.standard_normal((npsr, m, b)), dtype=dtype, device=device)
    return C, L


#: (pulsars, tiles per side, tile): tiles of 9 and 32 mask most of a block;
#: one tile of 128 over 3 pulsars is a grid far smaller than the card, 5 x 5
#: tiles of 128 over 12 pulsars one that fills it; a tile of 200 takes two
#: block rows and four block columns, the last of each masked
SYRK_GRIDS = [(3, 3, 9), (3, 3, 32), (3, 1, 128), (12, 5, 128), (2, 2, 200)]


@pytest.mark.parametrize("npsr,nt,tile", SYRK_GRIDS)
@pytest.mark.parametrize("b", [13, 128])
@pytest.mark.parametrize("dtype,tol", COV_TOL)
def test_syrk_kernel_matches_plain(cuda_device, dtype, tol, b, npsr, nt, tile):
    m = nt * tile
    C, L = _syrk_case(npsr, m, b, dtype, cuda_device)
    want = tcw.cov_syrk_plain(C, L, tile)
    launches.clear()
    got = tcw.cov_syrk_update(C.clone(), L, tile)
    again = tcw.cov_syrk_update(C.clone(), L, tile)
    torch.cuda.synchronize()
    assert launches["cov_syrk_update"] == 2
    assert torch.equal(got, again)
    assert _rel_max_t(got, want) <= tol
    upper = _upper_tiles(m, tile, cuda_device)
    assert torch.equal(got[:, upper], C[:, upper])  # upper tiles untouched


#: (offset, tile, tiles per side, b): a view at offset 9 is only 8-byte
#: aligned in float64; the panel then also sits 8 bytes off 16-byte
#: alignment, so the kernel stages it by element copies
SYRK_VIEWS = [(32, 32, 2, 16), (9, 9, 3, 13), (9, 9, 3, 16)]


@pytest.mark.parametrize("offset,tile,nt,b", SYRK_VIEWS)
@pytest.mark.parametrize("dtype,tol", COV_TOL)
def test_syrk_kernel_updates_a_view_in_place(cuda_device, dtype, tol, offset, tile, nt, b):
    rng = np.random.default_rng(2)
    m = nt * tile
    W = torch.as_tensor(rng.standard_normal((2, offset + m, offset + m)), dtype=dtype,
                        device=cuda_device)
    flat = torch.as_tensor(rng.standard_normal(2 * m * b + 1), dtype=dtype, device=cuda_device)
    P = flat[1:].view(2, m, b)  # contiguous, one element past the allocation's start
    orig, W2 = W.clone(), W.clone()
    want = W.clone()
    want[:, offset:, offset:] = tcw.cov_syrk_plain(W[:, offset:, offset:].contiguous(), P, tile)
    out = tcw.cov_syrk_update(W[:, offset:, offset:], P, tile)
    tcw.cov_syrk_update(W2[:, offset:, offset:], P, tile)
    torch.cuda.synchronize()
    assert out.data_ptr() == W[:, offset:, offset:].data_ptr()
    assert torch.equal(W, W2)
    assert _rel_max_t(W, want) <= tol
    # the rows and columns outside the view, and the upper tiles, untouched
    assert torch.equal(W[:, :offset], orig[:, :offset]) and torch.equal(W[:, :, :offset], orig[:, :, :offset])
    upper = _upper_tiles(m, tile, cuda_device)
    assert torch.equal(out[:, upper], orig[:, offset:, offset:][:, upper])
    with pytest.raises(ValueError, match="not a multiple"):
        tcw.cov_syrk_update(W[:, offset:, offset:], P, tile + 1)


@pytest.mark.parametrize("n", [256, 300])
def test_blocked_cholesky_on_the_card(cuda_device, n):
    """A ragged n is identity-padded to the block grid."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, n, n))
    A = torch.as_tensor(A @ np.swapaxes(A, -1, -2) + n * np.eye(n), device=cuda_device)
    launches.clear()
    L = tk.dense_cholesky(A)  # blocked on a CUDA tensor
    torch.cuda.synchronize()
    assert launches["cov_syrk_update"] == -(-n // 128) - 1
    assert _rel_max_t(L, torch.linalg.cholesky(A)) <= 1e-10


def _tridiag(npsr, nb, b, q, dtype, device, ragged=0, seed=4):
    """Diagonally dominant blocks; ``ragged`` padding rows of the last
    block are identity rows (decoupled), as the banded builder pads."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((npsr, nb, b, b)) / np.sqrt(b)
    D = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(b)
    E = 0.3 * rng.standard_normal((npsr, nb - 1, b, b)) / np.sqrt(b)
    if ragged:
        D[:, -1, b - ragged:, :] = 0.0
        D[:, -1, :, b - ragged:] = 0.0
        D[:, -1, b - ragged:, b - ragged:] = np.eye(ragged)
        if nb > 1:
            E[:, -1, b - ragged:, :] = 0.0
    X = rng.standard_normal((npsr, nb, b, q))
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in (D, E, X)]


#: right-hand-side counts of the banded solver's path: the direct route's
#: single residual, a few, the GP basis (123) and a wider bank
TRIDIAG_QS = (1, 7, 123, 200)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("nb", [1, 2, 9])
@pytest.mark.parametrize("b", [1, 16, 32, 33, 128])
@pytest.mark.parametrize("dtype,tol", COV_TOL)
def test_tridiag_kernels_match_plain(cuda_device, dtype, tol, b, nb, ragged):
    """Every sweep on its route (staged for b <= 32, per-thread above; the
    fused factor + forward sweep per-thread) against the plain sweeps,
    one launch per sweep, the same bits twice."""
    for q in TRIDIAG_QS:
        D, E, X = _tridiag(3, nb, b, q, dtype, cuda_device, b // 3 if ragged else 0, seed=q)
        launches.clear()
        Ld, M, _ = tgp.tridiag_forward(D, E)  # the factor alone, as the path runs it
        Y = tgp.tridiag_forward_solve(Ld, M, X)
        Z = tgp.tridiag_backward(Ld, M, Y)
        fLd, fM, fY = tgp.tridiag_forward(D, E, X)  # the fused factor + forward sweep
        torch.cuda.synchronize()
        assert (launches["tridiag_factor_solve_fwd"], launches["tridiag_solve_fwd"],
                launches["tridiag_factor_solve_bwd"]) == (2, 1, 1)
        pLd, pM, pY = tgp.tridiag_forward_plain(D, E, X)
        for got, want in ((Ld, pLd), (fLd, pLd), (Y, pY), (fY, pY)):
            assert _rel_max_t(got, want) <= tol
        if nb > 1:
            assert _rel_max_t(M, pM) <= tol and _rel_max_t(fM, pM) <= tol
        assert _rel_max_t(Z, tgp.tridiag_backward_plain(pLd, pM, pY)) <= tol
        assert torch.equal(Ld, torch.tril(Ld)) and torch.equal(fLd, torch.tril(fLd))
        # two runs give the same bits
        again = (*tgp.tridiag_forward(D, E)[:2], tgp.tridiag_forward_solve(Ld, M, X),
                 tgp.tridiag_backward(Ld, M, Y), *tgp.tridiag_forward(D, E, X))
        for a, c in zip((Ld, M, Y, Z, fLd, fM, fY), again):
            assert torch.equal(a, c)


@pytest.mark.parametrize("b", [1, 2, 3, 5, 8, 16, 17, 32])
@pytest.mark.parametrize("dtype,tol", COV_TOL)
def test_tridiag_staged_solve_every_instance(cuda_device, dtype, tol, b):
    """Both staged lane counts of every block width (a lane per row, and
    the fewest lanes), forward and backward, against the plain sweeps,
    whichever the plan would pick."""
    npsr, nb, q = 2, 5, 9
    D, E, X = _tridiag(npsr, nb, b, q, dtype, cuda_device, seed=b)
    Ld, M, _ = tgp.tridiag_forward_plain(D, E)
    bp = 1 << (b - 1).bit_length()
    for lanes in {bp, bp // min(bp, tgp.TRIDIAG_SOLVE_MAX_ROWS)}:
        for cols in (1, min(q, tgp.TRIDIAG_SOLVE_MAX_THREADS // lanes)):
            plan = tgp.tridiag_staged_solve_plan(npsr, b, q, dtype, lanes, cols)
            for fn, plain in (("tridiag_solve_fwd_launch", tgp.tridiag_forward_solve_plain),
                              ("tridiag_bwd_launch", tgp.tridiag_backward_plain)):
                out = torch.empty_like(X)
                tgp._tridiag_launch(fn, cuda_device, (Ld, M, X, out),
                                    (npsr, nb, b, q, lanes, cols, plan.threads,
                                     plan.shared_bytes, tgp._DTYPE_CODES[dtype]), "test")
                assert _rel_max_t(out, plain(Ld, M, X)) <= tol, (fn, lanes, cols)


def test_tridiag_launch_refuses_a_plan_that_differs(cuda_device):
    """The kernel checks the plan's threads and shared bytes against its
    own: a launch with either off raises, with nothing launched."""
    D, E, X = _tridiag(2, 3, 16, 4, torch.float64, cuda_device)
    Ld, M, _ = tgp.tridiag_forward_plain(D, E)
    plan = tgp.tridiag_plan(2, 3, 16, 4, torch.float64)
    code = tgp._DTYPE_CODES[torch.float64]
    for threads, smem in ((plan.threads + 32, plan.shared_bytes), (plan.threads, plan.shared_bytes - 16)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tgp._tridiag_launch("tridiag_solve_fwd_launch", cuda_device, (Ld, M, X, torch.empty_like(X)),
                                (2, 3, 16, 4, plan.lanes, plan.columns, threads, smem, code), "test")
    factor = tgp.tridiag_plan(2, 3, 16, 0, torch.float64, factor=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        tgp._tridiag_launch("tridiag_factor_fwd_launch", cuda_device,
                            (D, E, None, torch.empty_like(D), torch.empty_like(D), None),
                            (2, 3, 16, 0, 1, factor.threads, factor.shared_bytes + 8, code), "test")


@pytest.mark.parametrize("b", [16, 33])
def test_tridiag_factor_nonpositive_pivot_gives_nan(cuda_device, b):
    """A block that is not positive definite gives NaN from its pivot on,
    as the reference's route does; nothing raises, other pulsars stay
    finite."""
    D, E, _ = _tridiag(2, 4, b, 1, torch.float64, cuda_device)
    D[0, 2, 5, 5] = -50.0
    Ld, M, _ = tgp.tridiag_forward(D, E)
    torch.cuda.synchronize()
    assert bool(torch.isnan(Ld[0, 2]).any())
    assert bool(torch.isfinite(Ld[0, :2]).all() and torch.isfinite(Ld[1]).all())
    assert bool(torch.isfinite(M[1]).all())


def test_tridiag_factor_alone_and_the_composed_route(cuda_device):
    D, E, X = _tridiag(2, 6, 16, 5, torch.float64, cuda_device)
    launches.clear()
    Ld, M = tk.block_tridiag_cholesky(D, E)  # the factor sweep with Q = 0
    Z = tk.block_tridiag_solve(Ld, M, X)
    torch.cuda.synchronize()
    assert (launches["tridiag_factor_solve_fwd"], launches["tridiag_solve_fwd"],
            launches["tridiag_factor_solve_bwd"]) == (1, 1, 1)
    Ld0, M0, _ = tgp.tridiag_forward_plain(D, E)
    assert _rel_max_t(Ld, Ld0) <= 1e-12 and _rel_max_t(M, M0) <= 1e-12
    Z0 = tgp.tridiag_backward_plain(Ld0, M0, tgp.tridiag_forward_solve_plain(Ld0, M0, X))
    assert _rel_max_t(Z, Z0) <= 1e-12
    assert _rel_max_t(tk.block_tridiag_factor_solve(D, E, X)[2], Z) <= 1e-12


# ------------------------------------------- B.1's accumulating launch (A.11)

@pytest.mark.parametrize("nsrc", [8, 129, 150, 300])
@pytest.mark.parametrize("psr_term,evolve", MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 3e-3)])
def test_accumulate_matches_plain(cuda_device, dtype, tol, psr_term, evolve, nsrc):
    """The accumulating launch against its plain version, acc + plain, at
    ragged source counts."""
    u, src, psr = _inputs(nsrc=nsrc, evolve=evolve)  # the first 7 merged (valid = 0)
    args = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src, psr)]
    acc0 = tcw.cw_catalog_response(*args, psr_term=psr_term, evolve=evolve) * 0.5
    launches.clear()
    got = tcw.cw_catalog_response_cuda(*args, psr_term=psr_term, evolve=evolve,
                                       out=acc0.clone())
    torch.cuda.synchronize()
    assert launches["cw_catalog_accumulate"] == 1 and launches["cw_catalog_response"] == 1
    want = acc0 + tcw.cw_catalog_response_plain(*args, psr_term=psr_term, evolve=evolve)
    assert bool(torch.all(torch.isfinite(got)))
    assert _rel_rms(got, want) <= tol


@pytest.mark.parametrize("width", [1, 37, 128, 1000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_streamed_launches_equal_the_monolithic_bits(cuda_device, dtype, width):
    """Tiles of any width accumulated source by source give the bits of one
    launch over the whole catalog."""
    u, src, psr = _inputs(nsrc=300)
    u, src, psr = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src, psr)]
    mono = tcw.cw_catalog_response_cuda(u, src, psr)
    acc = torch.zeros_like(u)
    for lo in range(0, src.shape[1], width):
        acc = tcw.cw_catalog_response_cuda(u, src[:, lo:lo + width].contiguous(),
                                           psr[..., lo:lo + width].contiguous(), out=acc)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc, mono, rtol=0, atol=0)


def test_accumulate_refuses_an_accumulator_that_does_not_fit(cuda_device):
    u, src, psr = [torch.as_tensor(a, device=cuda_device) for a in _inputs()]
    with pytest.raises(ValueError, match="accumulator"):
        tcw.cw_catalog_response_cuda(u, src, psr, out=torch.zeros_like(u).float())
    with pytest.raises(ValueError, match="accumulator"):
        tcw.cw_catalog_response_cuda(u, src, psr, out=torch.zeros_like(u).t())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_streamed_deterministic_delays_bitwise_on_the_card(cuda_device, dtype):
    """deterministic_delays with cgw_stream_chunk (pinned staging on a copy
    stream, the accumulating launch) equals the monolithic call bit for
    bit, at prefetch depths 1 and 2."""
    import dataclasses

    from pta_replicator_tpu_torch import deterministic_delays, flagship_workload

    batch, recipe = flagship_workload(npsr=5, ntoa=700, ncw=300, dtype=dtype)
    mono = deterministic_delays(batch, recipe)
    for depth in (1, 2):
        streamed = dataclasses.replace(recipe, cgw_stream_chunk=64, cgw_prefetch_depth=depth)
        launches.clear()
        got = deterministic_delays(batch, streamed)
        torch.cuda.synchronize()
        assert launches["cw_catalog_accumulate"] == 1  # 300 sources: one macro of 8 x 64
        torch.testing.assert_close(got, mono, rtol=0, atol=0)


def test_sweep_on_the_card_byte_identical_across_depths(cuda_device, tmp_path):
    """The sweep on the card: the pinned readback off the compute stream,
    the fused graph's dispatch thread on the caller's stream; depth 1,
    depth 2 and fused_stream give the same checkpoint bytes and arrays."""
    from pta_replicator_tpu_torch import flagship_workload
    from pta_replicator_tpu_torch.utils.sweep import sweep

    batch, recipe = flagship_workload(npsr=6, ntoa=512, ncw=20)
    results = {}
    for name, kw in (("d1", dict(pipeline_depth=1)), ("d2", dict(pipeline_depth=2)),
                     ("fused", dict(pipeline_depth=2, fused_stream=True))):
        path = str(tmp_path / f"{name}.npz")
        stats = {}
        res = sweep(5, batch, recipe, 24, path, chunk=8, fit=True, reduce_fn=None,
                    stats=stats, **kw)
        with open(path, "rb") as fh:
            results[name] = (res, fh.read())
        if name != "d1":
            assert len(stats["d2h_ms"]) == 3
    for name, (res, raw) in results.items():
        assert raw == results["d1"][1], name
        np.testing.assert_array_equal(res, results["d1"][0])
    assert np.all(np.isfinite(results["d1"][0]))


# ------------------------------------------- the design refit's shapes

#: the GLS refit's right-hand-side counts on config B's blocks (68 pulsars,
#: b = 16): the GP basis (120), the 166-column design and a chunk of 200
#: realizations; a shorter block chain keeps the plain sweeps quick
FIT_QS = (120, 166, 200)


@pytest.mark.parametrize("q", FIT_QS)
@pytest.mark.parametrize("dtype,tol", COV_TOL)
def test_tridiag_kernels_at_the_fit_widths(cuda_device, dtype, tol, q):
    """tridiag_plan takes each width on the staged route within the card's
    limits, and the substitution sweeps there match the plain ones."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tgp.tridiag_plan(68, 485, 16, q, dtype, sms=sms)
    assert plan.route == "staged" and plan.threads <= tgp.TRIDIAG_SOLVE_MAX_THREADS
    assert plan.shared_bytes <= torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert plan.grid[0] * plan.columns >= q and plan.grid[1] == 68
    D, E, X = _tridiag(68, 24, 16, q, dtype, cuda_device, seed=q)
    launches.clear()
    Ld, M, _ = tgp.tridiag_forward(D, E)
    Y = tgp.tridiag_forward_solve(Ld, M, X)
    Z = tgp.tridiag_backward(Ld, M, Y)
    torch.cuda.synchronize()
    assert (launches["tridiag_factor_solve_fwd"], launches["tridiag_solve_fwd"],
            launches["tridiag_factor_solve_bwd"]) == (1, 1, 1)
    pY = tgp.tridiag_forward_solve_plain(Ld, M, X)
    assert _rel_max_t(Y, pY) <= tol
    assert _rel_max_t(Z, tgp.tridiag_backward_plain(Ld, M, pY)) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
def test_woodbury_kernel_at_the_gls_fitted_bank_width(cuda_device, dtype, tol):
    """Q = 286: a GLS-fitted bank priced with its 166-column design beside
    the 120-column GP basis. woodbury_plan takes it (five panels, fifteen
    pairs) and the kernel matches the plain version."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    panels, pairs, nsplit, _ = tgp.woodbury_plan(68, 7758, 286, sms)
    assert (panels, pairs) == (5, 15) and nsplit >= 1
    T, w, r = _woodbury(68, 997, 286, dtype, cuda_device, seed=3)
    launches.clear()
    got = tgp.fused_woodbury_update(T, w, r)
    torch.cuda.synchronize()
    assert launches["fused_woodbury_update"] == 1
    for g, x in zip(got, tgp.fused_woodbury_plain(T, w, r)):
        assert bool(torch.all(torch.isfinite(g))) and _rel_max(g, x) <= tol


@pytest.mark.parametrize("cov", ["banded", "dense"])
def test_gls_refit_on_the_card_matches_the_cpu(cuda_device, cov):
    """realize with a GLS fit_design and a structured noise_cov, float64:
    the card (B.4/B.5 or B.2 inside C^-1) against the CPU's plain routes
    on the same draws, to 1e-10 of the largest entry."""
    import dataclasses

    from pta_replicator_tpu_torch import flagship_workload, realize
    from pta_replicator_tpu_torch.covariance import banded_from_times, kron_time_channel
    from pta_replicator_tpu_torch.models import batched as TB

    out = {}
    for device in ("cpu", cuda_device):
        batch, recipe = flagship_workload(npsr=6, ntoa=512, ncw=10, dtype=torch.float64,
                                          device=device)
        if cov == "banded":
            op = banded_from_times(batch.toas_s, batch.mask, rho=0.5, corr_s=30 * 86400.0,
                                   block=16, dtype=torch.float64, device=device)
            recipe = dataclasses.replace(recipe, log10_ecorr=None)
        else:
            op = kron_time_channel(batch.toas_s, channels=4, time_ell_s=20 * 86400.0,
                                   chan_rho=0.9, dtype=torch.float64, device=device)
        design = torch.as_tensor(np.random.default_rng(1).standard_normal((6, 512, 12)),
                                 device=device)
        recipe = dataclasses.replace(recipe, noise_cov=op, cov_log10_sigma=-6.5,
                                     fit_design=design, fit_gls=True)
        rng = np.random.default_rng(2)
        noise = {k: rng.standard_normal((4,) + s) for k, s in TB.noise_shapes(batch, recipe).items()}
        launches.clear()
        out[str(device)] = realize(None, batch, recipe, 4, fit=True, noise=noise,
                                   device=device).cpu()
        counts = dict(launches)
    if cov == "banded":
        assert counts["tridiag_solve_fwd"] > 0 and counts["tridiag_factor_solve_bwd"] > 0
    else:
        assert counts["cov_syrk_update"] > 0
    assert _rel_max(out["cuda"], out["cpu"]) <= 1e-10


# ------------------------------------------------- the bf16 rung of B.3

#: bf16 kernel vs its plain version on the card, max |error| over the
#: largest |entry| of each output: both sum the same exact products of
#: bf16 operands in float32, in another order (the CPU tests' tolerance
#: against JAX)
TOL_WOODBURY_BF16 = 1e-5

#: the bf16 kernel's shapes: the highest kernel's (one block, P <= 2;
#: clusters of 3 and 5), plus a cluster of 8 (Q = 511), strips past the
#: portable cluster size (Q = 520, P = 9) and an odd pulsar count with
#: float32 spans whose heads are not 16-byte aligned (Nt = 997, Q = 123)
BF16_WOODBURY_SHAPES = WOODBURY_SHAPES + [(1, 70, 511), (1, 70, 520), (3, 997, 123)]


@pytest.mark.parametrize("shape", BF16_WOODBURY_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_woodbury_bf16_kernel_matches_plain(cuda_device, shape, dtype):
    T, w, r = _woodbury(*shape, dtype, cuda_device)
    launches.clear()
    got = tgp.fused_woodbury_update(T, w, r, precision="bf16")
    torch.cuda.synchronize()
    assert launches["fused_woodbury_update_bf16"] == 1 and launches["fused_woodbury_update"] == 0
    want = tgp.fused_woodbury_plain(T, w, r, precision="bf16")
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == torch.float32
        assert bool(torch.all(torch.isfinite(g)))
        assert _rel_max(g, x) <= TOL_WOODBURY_BF16
    if shape[-1] > 1:  # both triangles, unmirrored, as the reference's
        assert not torch.equal(got[0], got[0].transpose(-1, -2))


def _bf16_grid_of(lib, q, itemsize):
    """(panels, mode, cluster, blocks, slots, shared bytes) as the built
    kernel's fused_woodbury_bf16_grid computes them."""
    import ctypes

    out = (ctypes.c_longlong * 6)()
    assert lib.fused_woodbury_bf16_grid(q, 1 if itemsize == 8 else 0, out) == 0
    panels, mode, cluster, blocks, slots, smem = (int(v) for v in out)
    return panels, tgp.BF16_MODES[mode], cluster, blocks, slots, smem


@pytest.mark.parametrize("nsplit", [1, 2, 7])
def test_woodbury_bf16_kernel_any_split_count(cuda_device, nsplit):
    T, w, r = _woodbury(4, 997, 123, torch.float64, cuda_device)
    lib = tgp.build.load("fused_woodbury", tgp._bind)
    got = tgp._woodbury_launch(lib, T, w, r, nsplit, "bf16")
    want = tgp.fused_woodbury_plain(T, w, r, precision="bf16")
    for g, x in zip(got, want):
        assert _rel_max(g, x) <= TOL_WOODBURY_BF16
    for q in (7, 123, 127, 128, 183, 286, 300, 511, 520):
        plan = tgp.woodbury_plan(68, 7758, q, 132, "bf16")
        assert 68 * lib.fused_woodbury_bf16_workspace(q, plan[2]) == plan[3]
        for itemsize in (4, 8):  # the kernel's launch is the plan's
            grid = tgp.woodbury_bf16_grid(68, q, plan[2], itemsize)
            assert _bf16_grid_of(lib, q, itemsize) == (
                grid.panels, grid.mode, grid.cluster, grid.blocks, grid.slots, grid.shared_bytes)


def test_woodbury_bf16_kernel_is_deterministic(cuda_device):
    T, w, r = _woodbury(4, 997, 123, torch.float32, cuda_device)
    a = tgp.fused_woodbury_update(T, w, r, precision="bf16")
    b = tgp.fused_woodbury_update(T, w, r, precision="bf16")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_woodbury_bf16_cluster_kernel_is_deterministic(cuda_device):
    """A cluster of five blocks (Q = 286) with three TOA splits: the same
    bits twice, and T^T W T unmirrored."""
    T, w, r = _woodbury(3, 997, 286, torch.float64, cuda_device)
    a = tgp.fused_woodbury_update(T, w, r, precision="bf16", nsplit=3)
    b = tgp.fused_woodbury_update(T, w, r, precision="bf16", nsplit=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[0].transpose(-1, -2))


def test_woodbury_split_knob_on_the_card(cuda_device, tmp_path):
    """The tuner's knob on the card: every candidate split count gives the
    plain version's sums; the search caches one the lookup returns."""
    from pta_replicator_tpu_torch.likelihood import tuner

    T, w, r = _woodbury(4, 997, 123, torch.float64, cuda_device)
    want = tgp.fused_woodbury_plain(T, w, r)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n in tgp.woodbury_split_candidates(4, 997, 123, sms):
        for g, x in zip(tgp.fused_woodbury_update(T, w, r, nsplit=n), want):
            assert _rel_max(g, x) <= 1e-12
    path = str(tmp_path / "cache.json")
    choice = tuner.autotune(T, w, r, reps=2, cache_path=path)
    assert choice["route"] == "cuda" and choice["nsplit"] in choice["candidates"]
    assert tuner.woodbury_knob(T, cache_path=path) == {"nsplit": choice["nsplit"]}
    assert tuner.woodbury_knob(T, "bf16", cache_path=path) == {}


def test_map_fit_on_the_card_refuses_a_covariance_and_matches_the_cpu(cuda_device):
    import dataclasses

    from pta_replicator_tpu_torch import flagship_workload, realize
    from pta_replicator_tpu_torch import likelihood as lk
    from pta_replicator_tpu_torch.covariance import banded_from_times

    start = {"gwb_log10_amplitude": -14.6, "gwb_gamma": 3.8}
    fits = {}
    for device in ("cpu", cuda_device):
        batch, recipe = flagship_workload(npsr=4, ntoa=300, ncw=5, dtype=torch.float64,
                                          device=device)
        res = realize(torch.Generator().manual_seed(3), batch.to("cpu"), recipe.to("cpu"), 1,
                      device="cpu")[0]
        fits[str(device)] = lk.map_fit(res, batch, recipe, start, device=device)
    assert fits["cuda"].converged and fits["cuda"].iterations == fits["cpu"].iterations
    np.testing.assert_allclose(fits["cuda"].x, fits["cpu"].x, rtol=1e-6)
    np.testing.assert_allclose(fits["cuda"].sigma, fits["cpu"].sigma, rtol=1e-6)
    op = banded_from_times(batch.toas_s, batch.mask, rho=0.5, corr_s=30 * 86400.0, block=16,
                           dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="A.24"):
        lk.map_fit(res, batch, dataclasses.replace(recipe, noise_cov=op), start)
