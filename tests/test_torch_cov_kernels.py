"""The covariance kernels' plain versions against the JAX package, on the
CPU: the blocked-Cholesky trailing update (``ops/cw.py``) and the blocked
factor, the block-tridiagonal factor/solve sweeps (``ops/gp.py``) and the
composed pair of ``covariance/kernels.py`` that calls them, and the
Kronecker factor algebra. The JAX side runs its Pallas kernels in interpret mode, as
its own tests do."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.covariance import kernels as JK
from pta_replicator_tpu.ops import pallas_cw, pallas_gp
from pta_replicator_tpu_torch.covariance import kernels as TK
from pta_replicator_tpu_torch.kernels import launches
from pta_replicator_tpu_torch.ops import cw as tcw
from pta_replicator_tpu_torch.ops import gp as tgp

#: kernel-level tolerances, max |error| over the largest |entry|: float64
#: sums the same products in another order; float32 carries ~sqrt(b) eps
TOL = {np.float64: 1e-12, np.float32: 1e-5}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}
JNP = {np.float64: jnp.float64, np.float32: jnp.float32}


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _spd(npsr, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((npsr, n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


# ------------------------------------------------------ blocked dense

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cov_syrk_plain_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(1)
    C = rng.standard_normal((2, 96, 96)).astype(dtype)
    L = rng.standard_normal((2, 96, 32)).astype(dtype)
    want = np.asarray(pallas_cw.cov_syrk_update(jnp.asarray(C), jnp.asarray(L), tile=32,
                                                interpret=True))
    got = tcw.cov_syrk_update(torch.as_tensor(C), torch.as_tensor(L), tile=32).numpy()
    assert got.dtype == dtype
    assert _rel_max(got, want) <= TOL[dtype]
    # strictly-upper tiles pass through untouched, as in the reference
    np.testing.assert_array_equal(got[:, :32, 32:], C[:, :32, 32:])
    np.testing.assert_array_equal(got[:, 32:64, 64:], C[:, 32:64, 64:])


def test_cov_syrk_refuses_a_ragged_tile_grid():
    C, L = torch.zeros((1, 40, 40)), torch.zeros((1, 40, 8))
    with pytest.raises(ValueError, match="not a multiple of tile"):
        tcw.cov_syrk_update(C, L, tile=32)
    with pytest.raises(ValueError, match="do not fit"):
        tcw.cov_syrk_update(C, L[:, :30], tile=8)


def test_cov_syrk_operation_count():
    assert tcw.cov_syrk_operations(2, 96, 32, 32) == 2 * 6 * 32 * 32 * 2 * 32


@pytest.mark.parametrize("itemsize", [8, 4])
def test_cov_syrk_byte_count(itemsize):
    # 3 x 3 tiles of 32: 6 lower tiles of C read and written, L (96 x 16) read
    assert tcw.cov_syrk_bytes(2, 96, 16, 32, itemsize) == itemsize * 2 * (2 * 6 * 32 * 32 + 96 * 16)
    # config D's 15 trailing updates: 13.2 GB in float64
    total = sum(tcw.cov_syrk_bytes(68, m, 128, 128, 8) for m in range(128, 2048, 128))
    assert total == 13_191_086_080


def _syrk_coverage(m, tile):
    """How often the plan's blocks (as the kernel maps blockIdx.x) cover
    each entry of one pulsar's m x m matrix; every block non-empty."""
    row_blocks, col_blocks, grid_x = tcw.syrk_plan(m, tile)
    rows, cols = tcw.SYRK_BLOCK_ROWS, tcw.SYRK_BLOCK_COLS
    count = np.zeros((m, m), dtype=int)
    for x in range(grid_x):
        pair, sub = divmod(x, row_blocks * col_blocks)
        ti, tj = tgp.woodbury_pair(pair)
        r0 = ti * tile + (sub // col_blocks) * rows
        c0 = tj * tile + (sub % col_blocks) * cols
        r1, c1 = min(r0 + rows, (ti + 1) * tile), min(c0 + cols, (tj + 1) * tile)
        assert r0 < r1 and c0 < c1
        count[r0:r1, c0:c1] += 1
    return count


#: (m, tile): config D's first and last launch, tiles narrower than a
#: block, a tile of one entry, several tiles of 128, a tile of two blocks
SYRK_PLAN_CASES = [(1920, 128), (128, 128), (27, 9), (96, 32), (5, 1), (640, 128), (300, 150),
                   (512, 256)]


@pytest.mark.parametrize("m,tile", SYRK_PLAN_CASES)
def test_syrk_plan_covers_each_lower_tile_once(m, tile):
    count = _syrk_coverage(m, tile)
    t = np.arange(m) // tile
    lower = t[:, None] >= t[None, :]  # lower tiles, diagonal tiles whole
    assert (count[lower] == 1).all() and (count[~lower] == 0).all()
    assert 1 <= tcw.syrk_plan(m, tile)[2] <= 2**31 - 1


def test_syrk_plan_fills_the_card():
    """Config D on an H100 (132 SMs): the first launch gives >= 2 blocks
    per SM (two fit on an SM at once in float64); the last, one tile pair
    per pulsar, about one."""
    first, last = tcw.syrk_plan(1920, 128), tcw.syrk_plan(128, 128)
    assert first == (1, 2, 240) and 68 * first[2] >= 2 * 132
    assert last == (1, 2, 2) and 68 * last[2] >= 132
    # the largest trailing matrix a pulsar's grid row takes at tile 128
    assert tcw.syrk_plan(128 * 2000, 128)[2] <= 2**31 - 1


@pytest.mark.parametrize("n,dtype", [(160, np.float64), (130, np.float64), (130, np.float32)])
def test_blocked_cholesky_matches_jax_pallas_interpret(n, dtype):
    """n = 130 at block 32 is the reference's ragged case: identity-padded
    to the block grid."""
    A = _spd(2, n, 7).astype(dtype)
    want = np.asarray(JK.blocked_cholesky(jnp.asarray(A), block=32, backend="pallas_interpret"))
    At = torch.as_tensor(A)
    got = TK.blocked_cholesky(At, block=32)
    assert got.shape == (2, n, n) and got.dtype == TORCH[dtype]
    assert _rel_max(got.numpy(), want) <= TOL[dtype]
    assert torch.equal(got, torch.tril(got))
    assert torch.equal(At, torch.as_tensor(A))  # the input is left as it is


def test_dense_cholesky_routes_and_solves():
    A = torch.as_tensor(_spd(3, 70, 2))
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 70, 4)))
    launches.clear()
    L_lib = TK.dense_cholesky(A)  # the library on a CPU tensor
    assert torch.equal(L_lib, torch.linalg.cholesky(A)) and not launches
    L_blk = TK.blocked_cholesky(A, block=32)
    assert _rel_max(L_blk, L_lib) <= 1e-12
    Z = TK.cholesky_solve(L_lib, X)
    np.testing.assert_allclose((A @ Z).numpy(), X.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(TK._chol_logdet(L_lib).numpy(), np.linalg.slogdet(A.numpy())[1],
                               rtol=1e-12)
    bad = A.clone()
    bad[0, 5, 5] = -1.0
    assert bool(torch.isnan(TK.dense_cholesky(bad)[0]).all())
    assert bool(torch.isfinite(TK.dense_cholesky(bad)[1]).all())


# ----------------------------------------------- block-tridiagonal

def _tridiag_operands(dtype, npsr=2, nb=5, b=4, q=3, seed=4):
    """The reference test's operands (tests/test_gp_kernels.py)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((npsr, nb, b, b))
    D = (A @ np.swapaxes(A, -1, -2) + 6.0 * np.eye(b)).astype(dtype)
    E = (0.2 * rng.standard_normal((npsr, nb - 1, b, b))).astype(dtype)
    X = rng.standard_normal((npsr, nb, b, q)).astype(dtype)
    return D, E, X


def _dense(D, E):
    npsr, nb, b, _ = D.shape
    C = np.zeros((npsr, nb * b, nb * b))
    for k in range(nb):
        C[:, k * b:(k + 1) * b, k * b:(k + 1) * b] = D[:, k]
        if k:
            C[:, k * b:(k + 1) * b, (k - 1) * b:k * b] = E[:, k - 1]
            C[:, (k - 1) * b:k * b, k * b:(k + 1) * b] = np.swapaxes(E[:, k - 1], -1, -2)
    return C


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tridiag_plain_matches_pallas_interpret(dtype):
    D, E, X = _tridiag_operands(dtype)
    want = pallas_gp.tridiag_factor_solve(*(jnp.asarray(a) for a in (D, E, X)), interpret=True)
    got = tgp.tridiag_factor_solve_plain(*(torch.as_tensor(a) for a in (D, E, X)))
    rtol = {np.float64: 1e-12, np.float32: 1e-5}[dtype]
    for g, w in zip(got, want):
        assert g.dtype == TORCH[dtype]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=rtol * 1e-2)


def test_tridiag_wrapper_runs_the_plain_version_on_the_cpu():
    D, E, X = (torch.as_tensor(a) for a in _tridiag_operands(np.float64))
    launches.clear()
    for g, w in zip(tgp.tridiag_factor_solve(D, E, X), tgp.tridiag_factor_solve_plain(D, E, X)):
        assert torch.equal(g, w)
    Ld, M, Y = tgp.tridiag_forward(D, E, X)
    assert torch.equal(tgp.tridiag_forward_solve(Ld, M, X), Y)
    assert tgp.tridiag_forward(D, E)[2] is None
    # the covariance module's functions go through the same wrappers
    assert all(torch.equal(g, w) for g, w in zip(TK.block_tridiag_cholesky(D, E), (Ld, M)))
    assert torch.equal(TK.block_tridiag_solve(Ld, M, X), tgp.tridiag_factor_solve_plain(D, E, X)[2])
    assert not launches  # no kernel on the CPU


def test_composed_pair_matches_fused_entry_and_dense():
    """The composed pair (block_tridiag_cholesky, then
    block_tridiag_solve) against the fused entry (the reference's own
    1e-12), and C Z = X against a dense assembly."""
    D, E, X = _tridiag_operands(np.float64)
    Dt, Et, Xt = (torch.as_tensor(a) for a in (D, E, X))
    Ld0, M0 = TK.block_tridiag_cholesky(Dt, Et)
    Z0 = TK.block_tridiag_solve(Ld0, M0, Xt)
    Ld, M, Z = tgp.tridiag_factor_solve(Dt, Et, Xt)
    np.testing.assert_allclose(Z.numpy(), Z0.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(Ld.numpy(), Ld0.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(M.numpy(), M0.numpy(), rtol=1e-12, atol=1e-14)
    for g, w in zip(TK.block_tridiag_factor_solve(Dt, Et, Xt), (Ld0, M0, Z0)):
        assert torch.equal(g, w)
    npsr, nb, b, q = X.shape
    C = _dense(D, E)
    np.testing.assert_allclose(C @ Z0.numpy().reshape(npsr, -1, q), X.reshape(npsr, -1, q),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(TK.block_tridiag_logdet(Ld0).numpy(),
                               np.linalg.slogdet(C)[1], rtol=1e-12)


def test_block_tridiag_kernels_match_jax():
    D, E, X = _tridiag_operands(np.float64, nb=6, b=3, q=2, seed=8)
    jD, jE, jX = (jnp.asarray(a) for a in (D, E, X))
    tD, tE, tX = (torch.as_tensor(a) for a in (D, E, X))
    jLd, jM = JK.block_tridiag_cholesky(jD, jE)
    tLd, tM = TK.block_tridiag_cholesky(tD, tE)
    assert _rel_max(tLd, jLd) <= 1e-12 and _rel_max(tM, jM) <= 1e-12
    assert _rel_max(TK.block_tridiag_solve(tLd, tM, tX), JK.block_tridiag_solve(jLd, jM, jX)) <= 1e-12
    assert _rel_max(TK.block_tridiag_matvec(tD, tE, tX), JK.block_tridiag_matvec(jD, jE, jX)) <= 1e-14
    Zs = np.random.default_rng(2).standard_normal(D.shape[:3])
    assert _rel_max(TK.block_tridiag_matmul_factor(tLd, tM, torch.as_tensor(Zs)),
                    JK.block_tridiag_matmul_factor(jLd, jM, jnp.asarray(Zs))) <= 1e-14
    # leading realization axes of the sampling map
    Z2 = torch.as_tensor(np.stack([Zs, 2 * Zs]))
    out = TK.block_tridiag_matmul_factor(tLd, tM, Z2)
    assert torch.allclose(out[1], 2 * out[0], rtol=1e-14, atol=0)


def test_tridiag_kernel_refusals_on_the_cpu_path():
    D, E, X = (torch.as_tensor(a) for a in _tridiag_operands(np.float64))
    with pytest.raises(ValueError, match="do not fit"):
        tgp.tridiag_forward(D, E, X[:, :3])
    with pytest.raises(TypeError, match="neither"):
        tgp.tridiag_backward(D.half(), D.half(), X.half())
    with pytest.raises(ValueError, match="need CUDA"):
        tgp._tridiag_launch("tridiag_bwd_launch", D.device, (), (), "x")
    with pytest.raises(ValueError, match="needs CUDA"):
        tcw.cov_syrk_cuda(torch.zeros((1, 8, 8)), torch.zeros((1, 8, 2)), tile=8)


def test_tridiag_operation_count():
    assert tgp.tridiag_operations(1, 1, 2, 3, factor=False) == 3 * 3 * 4
    assert tgp.tridiag_operations(2, 3, 3, 0, factor=True) == 6 * (2 * 27 + 9)


@pytest.mark.parametrize("itemsize", [8, 4])
def test_tridiag_byte_count(itemsize):
    # 2 pulsars x 3 blocks of 2 (2 sub-diagonal blocks each), Q = 5: a
    # substitution sweep reads Ld, M and one (2, 3, 2, 5) operand and writes
    # another; the factor sweep reads D, E (and X), writes Ld, M (and Y)
    blocks, sub, rhs = 2 * 3 * 4, 2 * 2 * 4, 2 * 3 * 2 * 5
    assert tgp.tridiag_bytes(2, 3, 2, 5, False, itemsize) == itemsize * (2 * blocks + 2 * rhs)
    assert tgp.tridiag_bytes(2, 3, 2, 0, True, itemsize) == itemsize * (3 * blocks + sub)
    assert tgp.tridiag_bytes(2, 3, 2, 5, True, itemsize) == itemsize * (3 * blocks + sub + 2 * rhs)
    # config B (68 x 485 x 16), f64: a substitution sweep at Q = 123 moves
    # 1.17 GB, the factor sweep 0.27 GB
    assert tgp.tridiag_bytes(68, 485, 16, 123, False, 8) == 1_173_560_320
    assert tgp.tridiag_bytes(68, 485, 16, 0, True, 8) == 270_032_896


#: block sizes around the staged route's edge (32) and the kernels' limit
TRIDIAG_PLAN_BLOCKS = (1, 16, 31, 32, 33, 128, 256)
TRIDIAG_PLAN_QS = (1, 7, 123, 200, 300)
#: the shared memory a block may use on an H100 (227 KB)
H100_SMEM = 232_448


def _tridiag_coverage(plan, npsr, q):
    """How often the plan's threads (as the kernel maps blockIdx and
    threadIdx) own each (pulsar, column)."""
    count = np.zeros((npsr, q), dtype=int)
    for p in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            for t in range(0, plan.threads, plan.lanes):  # the first lane of each group
                group = t // plan.lanes
                col = x * plan.columns + group
                if group < plan.columns and col < q:
                    count[p, col] += 1
    return count


@pytest.mark.parametrize("q", TRIDIAG_PLAN_QS)
@pytest.mark.parametrize("b", TRIDIAG_PLAN_BLOCKS)
def test_tridiag_plan_covers_each_column_once(b, q):
    for dtype in (torch.float64, torch.float32):
        plan = tgp.tridiag_plan(68, 485, b, q, dtype)
        assert (_tridiag_coverage(plan, 68, q) == 1).all()
        assert plan.threads % 32 == 0 and plan.threads <= 1024 and plan.shared_bytes <= H100_SMEM
        if plan.route == "staged":
            bp = 1 << (b - 1).bit_length()
            assert b <= 32 and plan.lanes in (bp, bp // min(bp, tgp.TRIDIAG_SOLVE_MAX_ROWS))
            assert plan.columns * plan.lanes <= plan.threads <= tgp.TRIDIAG_SOLVE_MAX_THREADS
        else:
            assert b > 32 and plan.lanes == 1 and plan.shared_bytes == 0
        # with right-hand sides the factor sweep (the fused factor +
        # forward sweep) takes the per-thread route, one block per pulsar
        factor = tgp.tridiag_plan(68, 485, b, q, dtype, factor=True)
        assert factor.route == "per_thread" and factor.grid == (1, 68)
        assert factor.shared_bytes <= H100_SMEM and factor.threads <= 1024


def test_tridiag_plan_routes():
    """Config B's block (16) takes the staged route in every sweep, with
    more lanes per column when there are few columns; blocks past 32 keep
    the per-thread route, whose factor tiles leave shared memory past 200
    KB (b = 128 and 256 in float64)."""
    f64 = torch.float64
    for q in (1, 123, 200):
        assert tgp.tridiag_plan(68, 485, 16, q, f64).route == "staged"
    assert tgp.tridiag_plan(68, 485, 16, 0, f64, factor=True) == tgp.TridiagPlan(
        "staged", 32, 0, 32, (68, 1), 8 * (10 * 16 * 18 + 2 * 18 + 32))
    assert tgp.tridiag_plan(68, 485, 16, 123, f64, factor=True).route == "per_thread"
    # few columns: a lane per row; many: the fewest lanes (one at b = 16,
    # two at b = 32), blocks of four warps while they fit the card's SMs
    # once, of one warp beyond
    assert tgp.tridiag_plan(68, 485, 16, 1, f64)[1:4] == (16, 1, 32)
    assert tgp.tridiag_plan(68, 485, 16, 7, f64)[1:4] == (16, 7, 128)
    assert tgp.tridiag_plan(68, 485, 16, 10, f64)[1:4] == (1, 10, 32)
    assert tgp.tridiag_plan(68, 485, 16, 123, f64)[1:5] == (1, 123, 128, (1, 68))
    assert tgp.tridiag_plan(68, 485, 16, 200, f64)[1:5] == (1, 32, 32, (7, 68))
    assert tgp.tridiag_plan(68, 485, 32, 123, f64)[1:4] == (2, 16, 32)
    assert tgp.tridiag_plan(68, 485, 16, 123, f64) == tgp.tridiag_staged_solve_plan(
        68, 16, 123, f64, 1, 123)
    assert tgp.tridiag_plan(68, 485, 33, 123, f64).route == "per_thread"
    assert tgp.tridiag_plan(68, 485, 64, 0, f64, factor=True).shared_bytes == 3 * 64 * 64 * 8
    assert tgp.tridiag_plan(68, 485, 128, 0, f64, factor=True).shared_bytes == 0
    assert tgp.tridiag_plan(68, 485, 128, 0, torch.float32, factor=True).shared_bytes == 3 * 128 * 128 * 4
    with pytest.raises(ValueError, match="no sweep"):
        tgp.tridiag_plan(68, 485, 16, 0, f64)
    with pytest.raises(ValueError, match="no sweep"):
        tgp.tridiag_plan(68, 485, 257, 1, f64)


# ------------------------------------------------------- Kronecker

def test_kron_kernels_match_jax():
    rng = np.random.default_rng(5)
    Ct, Cf = _spd(2, 6, 1) / 6.0, _spd(2, 3, 2) / 3.0
    X = rng.standard_normal((2, 18, 2))
    jLt, jLf = JK.kron_cholesky(jnp.asarray(Ct), jnp.asarray(Cf))
    tLt, tLf = TK.kron_cholesky(torch.as_tensor(Ct), torch.as_tensor(Cf))
    assert _rel_max(tLt, jLt) <= 1e-12 and _rel_max(tLf, jLf) <= 1e-12
    assert _rel_max(TK.kron_solve(tLt, tLf, torch.as_tensor(X)),
                    JK.kron_solve(jLt, jLf, jnp.asarray(X))) <= 1e-12
    np.testing.assert_allclose(TK.kron_logdet(tLt, tLf).numpy(),
                               np.asarray(JK.kron_logdet(jLt, jLf)), rtol=1e-12)
    Z = rng.standard_normal((2, 6, 3))
    assert _rel_max(TK.kron_sample_map(tLt, tLf, torch.as_tensor(Z)),
                    JK.kron_sample_map(jLt, jLf, jnp.asarray(Z))) <= 1e-14
