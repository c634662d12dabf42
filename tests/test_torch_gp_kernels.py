"""The fused Woodbury assembly of the port (ops/gp.py) against the JAX
package: its plain version against the Pallas kernel in interpret mode
and against the tiled fallback, and the fused ReducedGP build against the
composed one. On the CPU the wrapper runs the plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.likelihood import infer as jinfer
from pta_replicator_tpu.models.batched import Recipe
from pta_replicator_tpu.ops import pallas_gp
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch.kernels import launches
from pta_replicator_tpu_torch.likelihood import gp as tgp_lk
from pta_replicator_tpu_torch.likelihood import infer as tinfer
from pta_replicator_tpu_torch.ops import gp as tgp

#: (shape, tile): 100 and 384 are no multiple of their tile
SHAPES = [((3, 100, 7), 32), ((4, 384, 23), 256), ((2, 300, 183), 256), ((1, 130, 300), 64)]
#: max |error| over the largest |reference| entry of each output: the
#: port's einsum and XLA's dot sum each tile in their own order
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _operands(shape, dtype, seed=2):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal(shape)
    mask = rng.random(shape[:2]) > 0.1
    w = rng.uniform(0.5, 2.0, shape[:2]) * mask
    r = rng.standard_normal(shape[:2]) * mask
    return [a.astype(dtype) for a in (T, w, r)]


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape,tile", SHAPES)
def test_plain_matches_jax(shape, tile, dtype, reference):
    ops = _operands(shape, dtype)
    jops = [jnp.asarray(a) for a in ops]
    if reference == "pallas_interpret":
        ref = pallas_gp.fused_woodbury_update(*jops, tile=tile, interpret=True)
    else:
        ref = pallas_gp.fused_woodbury_xla(*jops, tile=tile)
    got = tgp.fused_woodbury_plain(*[torch.from_numpy(a) for a in ops], tile=tile)
    for g, x in zip(got, ref):
        assert g.dtype == torch.from_numpy(ops[0]).dtype
        assert tuple(g.shape) == x.shape
        assert _rel_max(g.numpy(), x) <= TOL[dtype]


def test_wrapper_runs_the_plain_version_on_cpu():
    ops = [torch.from_numpy(a) for a in _operands((3, 100, 7), np.float64)]
    launches.clear()
    got = tgp.fused_woodbury_update(*ops, tile=32)
    want = tgp.fused_woodbury_plain(*ops, tile=32)
    assert launches["fused_woodbury_update"] == 0
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_plain_tile_padding_is_exact():
    """A ragged tile grid (zero-padded rows carry w = 0) agrees with a
    divisible one to float64 round-off."""
    ops = [torch.from_numpy(a) for a in _operands((3, 97, 7), np.float64)]
    for a, b in zip(tgp.fused_woodbury_plain(*ops, tile=32),
                    tgp.fused_woodbury_plain(*ops, tile=97)):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-15)


def test_operands_and_precision_are_checked():
    T, w, r = [torch.from_numpy(a) for a in _operands((3, 100, 7), np.float64)]
    with pytest.raises(ValueError, match="do not fit"):
        tgp.fused_woodbury_update(T, w[:, :50], r)
    with pytest.raises(TypeError, match="share"):
        tgp.fused_woodbury_update(T, w.float(), r)
    with pytest.raises(TypeError, match="neither"):
        tgp.fused_woodbury_update(T.long(), w.long(), r.long())
    # bf16 runs at this layer, as the reference's kernel does (float32
    # outputs); the likelihood gates it on a numerics capture
    assert all(x.dtype == torch.float32
               for x in tgp.fused_woodbury_update(T, w, r, precision="bf16"))
    with pytest.raises(tgp_lk.PrecisionNotReady):
        tgp_lk.require_precision_ready("bf16")
    with pytest.raises(ValueError, match="precision"):
        tgp.fused_woodbury_update(T, w, r, precision="fp8")
    with pytest.raises(ValueError, match="CUDA"):
        tgp.fused_woodbury_cuda(T, w, r)


#: basis widths of the launch-plan sweep: Q + 1 from one panel to five
PLAN_COLUMNS = (1, 63, 64, 123, 183, 300)


@pytest.mark.parametrize("npsr", [1, 4, 68])
def test_woodbury_plan_covers_the_gram_matrix(npsr):
    """Every lower-triangle entry of the (Q + 1)-square Gram matrix lies in
    exactly one panel pair; the splits are 1..Nt, none empty; the
    workspace holds one tile per (pulsar, pair, split), none with one
    split, and never more than the blocks the plan aims at."""
    sms, ntoa, width = 132, 7758, tgp.WOODBURY_PANEL
    for q in PLAN_COLUMNS:
        panels, pairs, nsplit, workspace = tgp.woodbury_plan(npsr, ntoa, q, sms)
        assert (panels - 1) * width < q + 1 <= panels * width
        tiles = [tgp.woodbury_pair(k) for k in range(pairs)]
        assert all(0 <= j <= i < panels for i, j in tiles)
        a, b = np.tril_indices(q + 1)
        count = sum(((a // width == i) & (b // width == j)).astype(int) for i, j in tiles)
        assert np.all(count == 1)
        assert 1 <= nsplit <= ntoa
        assert (nsplit - 1) * -(-ntoa // nsplit) < ntoa  # the last split has rows
        assert workspace == (npsr * pairs * nsplit * width**2 if nsplit > 1 else 0)
        assert workspace <= tgp.WOODBURY_BLOCKS_PER_SM * sms * width**2


@pytest.mark.parametrize("npsr", [32, 68])
def test_woodbury_plan_workspace_shrinks_as_pairs_grow(npsr):
    """Where the block target sets the splits (not the TOA count), wider
    bases take fewer splits and no more workspace; once the pairs alone
    fill the target, one split and no workspace."""
    plans = [tgp.woodbury_plan(npsr, 7758, q, 132) for q in PLAN_COLUMNS]
    splits = [p[2] for p in plans]
    workspace = [p[3] for p in plans]
    assert all(x >= y for x, y in zip(splits, splits[1:]))
    assert all(x >= y for x, y in zip(workspace, workspace[1:]))
    assert workspace[-1] < workspace[0]
    assert tgp.woodbury_plan(npsr, 7758, 1000, 132)[2:] == (1, 0)


def _recipe(batch, seed=0):
    """tests/test_gp_kernels.py's noise: per-backend EFAC/EQUAD/ECORR,
    8-mode red noise and a 6-mode GWB block."""
    nb = len(batch.backend_names)
    rng = np.random.default_rng(seed)
    return Recipe(
        efac=jnp.asarray(rng.uniform(0.9, 1.4, (batch.npsr, nb))),
        log10_equad=jnp.asarray(rng.uniform(-6.8, -6.2, (batch.npsr, nb))),
        log10_ecorr=jnp.asarray(rng.uniform(-6.9, -6.4, (batch.npsr, nb))),
        rn_log10_amplitude=jnp.asarray(rng.uniform(-13.8, -13.2, batch.npsr)),
        rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, batch.npsr)),
        gwb_log10_amplitude=jnp.asarray(-14.2),
        gwb_gamma=jnp.asarray(13.0 / 3.0),
        rn_nmodes=8,
        gwb_gls_nmodes=6,
    )


@pytest.fixture(scope="module")
def setup():
    batch = synthetic_batch(npsr=6, ntoa=180, nbackend=2, seed=3, dtype=jnp.float64)
    recipe = _recipe(batch)
    res = np.random.default_rng(11).standard_normal(batch.toas_s.shape) * 1e-6
    port = (convert.batch_from_arrays(vars(batch), device="cpu"),
            convert.recipe_from_arrays(vars(recipe), device="cpu"))
    return batch, recipe, res, port


_GRID = {"rn_log10_amplitude": np.linspace(-14.0, -13.4, 4)}


def test_fused_build_matches_composed(setup):
    """The fused ReducedGP build agrees with the composed one to f64
    round-off on grid and bank evaluation, as the JAX package gates it,
    and with the JAX package's fused grid evaluation."""
    batch, recipe, res, (tb, tr) = setup
    ll = tinfer.grid_loglikelihood(res, tb, tr, _GRID, device="cpu").numpy()
    llf = tinfer.grid_loglikelihood(res, tb, tr, _GRID, fused=True, device="cpu").numpy()
    np.testing.assert_allclose(llf, ll, rtol=1e-12)
    jllf = np.asarray(jinfer.grid_loglikelihood(jnp.asarray(res), batch, recipe, _GRID,
                                                fused=True, backend="xla"))
    np.testing.assert_allclose(llf, jllf, rtol=1e-12)
    bank = np.stack([res, 0.5 * res])
    bll = tinfer.bank_loglikelihood(bank, tb, tr, device="cpu").numpy()
    bllf = tinfer.bank_loglikelihood(bank, tb, tr, fused=True, device="cpu").numpy()
    np.testing.assert_allclose(bllf, bll, rtol=1e-12)


def test_fused_build_blocks_match_composed(setup):
    """Block by block: the fused T^T C0^-1 T against the composed one, and
    the fused build's own projection against the fused project()."""
    _, _, res, (tb, tr) = setup
    composed = tgp_lk.ReducedGP.build(tb, tr)
    fused, proj = tgp_lk.ReducedGP.build_fused(tb, tr, residuals=torch.from_numpy(res), tile=64)
    assert fused.CiT is None and fused.fused
    assert _rel_max(fused.TNT, composed.TNT) <= 1e-12
    again = fused.project(torch.from_numpy(res), tb)
    assert _rel_max(proj.d, again.d) <= 1e-12
    assert _rel_max(proj.rNr, again.rNr) <= 1e-12
