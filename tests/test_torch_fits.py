"""The design refits of the port against the JAX package, float64 on the
CPU: WLS (``design_fit_subtract``) and GLS (``gls_fit_subtract``,
``gls_fit_uncertainties``) over every noise model the GLS weighting takes
(white, ECORR, red + GWB blocks, a phi = 0 row, each covariance op, a
nested low-rank op), ``finalize_residuals`` and ``realize`` with a
``fit_design``, the hoisted fit system, and a sweep whose recipe refits
with GLS.

Tolerances: fits 1e-10 of the largest |reference| entry (both sum the same
float64 products in another order; the ridged duplicate-column split is
solved by LU in both); whole realizations 1e-9, the realize tests' own
(the two packages' stochastic delays already differ at ~1e-10 before the
fit); nested low-rank samples 1e-12."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.covariance import (
    COV_STREAM_FOLD,
    LowRankCov,
    banded_from_times,
    dense_from_times,
    kron_time_channel,
)
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu_torch import convert, realize
from pta_replicator_tpu_torch.models import batched as TB
from pta_replicator_tpu_torch.utils.sweep import sweep

NPSR, NT, K = 4, 256, 10
#: fits, relative to the largest |reference| entry
TOL_FIT = 1e-10
#: whole realizations, relative to the largest |reference| entry
TOL_REALIZE = 1e-9
#: samples of a nested low-rank op, relative to the largest |entry|
TOL_SAMPLE = 1e-12


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def batch():
    """4 x 256, two backends, a masked tail on pulsar 0."""
    b = synthetic_batch(npsr=NPSR, ntoa=NT, nbackend=2, seed=1, dtype=jnp.float64)
    mask = np.asarray(b.mask).copy()
    mask[0, -9:] = 0.0
    return dataclasses.replace(b, mask=jnp.asarray(mask, b.mask.dtype),
                               ntoas=jnp.asarray(mask.sum(axis=-1), b.ntoas.dtype))


@pytest.fixture(scope="module")
def full_batch():
    """The same without a mask (the Kronecker op needs a full grid)."""
    return synthetic_batch(npsr=NPSR, ntoa=NT, nbackend=2, seed=1, dtype=jnp.float64)


def _design(batch, branch="plain"):
    """(Np, Nt, K): a quadratic, then scaled sinusoids and noise columns;
    ``zero_column`` pads the last column with zeros, ``duplicated`` repeats
    column 1 in the last (the ridge's branch)."""
    rng = np.random.default_rng(4)
    t = np.asarray(batch.toas_s)
    x = t / np.asarray(batch.tspan_s)[:, None]
    cols = [np.ones_like(x), x, x**2]
    for k in range(1, 4):
        cols += [np.sin(2 * np.pi * k * x), np.cos(2 * np.pi * k * x)]
    cols.append(rng.standard_normal(x.shape))
    M = np.stack(cols, axis=-1)
    if branch == "zero_column":
        M[..., -1] = 0.0
    elif branch == "duplicated":
        M[..., -1] = M[..., 1]
    return M * np.asarray(batch.mask)[..., None]


def _delays(batch, nreal=None):
    rng = np.random.default_rng(5)
    shape = ((nreal,) if nreal else ()) + tuple(batch.toas_s.shape)
    t = np.asarray(batch.toas_s) / np.asarray(batch.tspan_s)[:, None]
    return (rng.standard_normal(shape) * 1e-6 + 3e-6 * t**2 + 2e-6 * np.sin(7 * t)) * np.asarray(batch.mask)


def _recipe(batch, model):
    """The noise model the GLS refit is weighted by."""
    rng = np.random.default_rng(0)
    base = dict(efac=jnp.asarray(rng.uniform(0.9, 1.2, (NPSR, 2))),
                log10_equad=jnp.asarray(rng.uniform(-7.2, -6.6, (NPSR, 2))))
    gp = dict(rn_log10_amplitude=jnp.asarray(rng.uniform(-13.6, -13.2, NPSR)),
              rn_gamma=jnp.asarray(rng.uniform(3.0, 4.5, NPSR)), rn_nmodes=8,
              gwb_log10_amplitude=jnp.asarray(-14.2), gwb_gamma=jnp.asarray(13.0 / 3.0),
              gwb_gls_nmodes=5)
    t, m = np.asarray(batch.toas_s), np.asarray(batch.mask)
    if model == "ecorr":
        base["log10_ecorr"] = jnp.asarray(rng.uniform(-7.0, -6.5, (NPSR, 2)))
    elif model == "red_gwb":
        base.update(gp, log10_ecorr=jnp.asarray(-6.7))
    elif model == "phi_zero":
        base.update(gp, rn_log10_amplitude=jnp.asarray([-np.inf, -13.5, -13.4, -np.inf]))
    elif model in GLS_OPTIONS:
        base.update(gp, **GLS_OPTIONS[model])
    elif model in ("banded", "dense", "kron", "lowrank", "nested_lowrank"):
        base.update(gp)
        banded = banded_from_times(t, m, rho=0.6, corr_s=40 * 86400.0, block=16,
                                   dtype=jnp.float64)
        lowrank = lambda op, seed: LowRankCov(
            base=op, U=jnp.asarray(np.random.default_rng(seed).standard_normal((NPSR, NT, 5))
                                   * 0.3 * m[:, :, None]),
            phi=jnp.asarray(np.random.default_rng(seed + 1).uniform(0.5, 1.5, (NPSR, 5))))
        op = {
            "banded": lambda: banded,
            "dense": lambda: dense_from_times(t, m, corr_s=60 * 86400.0, dtype=jnp.float64),
            "kron": lambda: kron_time_channel(t, channels=4, time_ell_s=20 * 86400.0,
                                              chan_rho=0.8, dtype=jnp.float64),
            "lowrank": lambda: lowrank(banded, 2),
            "nested_lowrank": lambda: lowrank(lowrank(banded, 2), 6),
        }[model]()
        base.update(noise_cov=op, cov_log10_sigma=jnp.asarray(-6.3))
        if model in ("dense", "kron"):
            base["log10_ecorr"] = jnp.asarray(-6.8)  # the dense rung with ECORR
    return JB.Recipe(**base)


def _port(batch, recipe):
    return (convert.batch_from_arrays(vars(batch), device="cpu"),
            convert.recipe_from_arrays(vars(recipe), device="cpu"))


#: the GP options of the GLS weighting on top of red noise + GWB: a
#: chromatic block (index 2 and 4), the red-noise basis switches and grid
#: bounds, the turnover GWB spectrum, and TNEQUAD with ECORR
GLS_OPTIONS = {
    "chromatic_2": dict(chrom_log10_amplitude=jnp.asarray(-13.6), chrom_gamma=jnp.asarray(3.0),
                        chrom_index=jnp.asarray(2.0), chrom_nmodes=6),
    "chromatic_4": dict(chrom_log10_amplitude=jnp.asarray(-13.6), chrom_gamma=jnp.asarray(3.0),
                        chrom_index=jnp.asarray(4.0), chrom_nmodes=6),
    "rn_libstempo": dict(rn_libstempo=True),
    "rn_logf": dict(rn_logf=True),
    "rn_pshift": dict(rn_pshift=True),
    "gwb_turnover": dict(gwb_turnover=True, gwb_f0=3e-9, gwb_beta=1.5, gwb_power=2.0),
    "tnequad_ecorr": dict(tnequad=True, log10_ecorr=jnp.asarray(-6.7)),
    "rn_fmin_fmax": dict(rn_fmin=jnp.asarray(2e-9), rn_fmax=jnp.asarray(4e-8)),
}

MODELS = ["white", "ecorr", "red_gwb", "phi_zero", "banded", "dense", "kron", "lowrank",
          "nested_lowrank", *GLS_OPTIONS]


def _batch_for(model, batch, full_batch):
    return full_batch if model == "kron" else batch


# -------------------------------------------------------------- WLS

@pytest.mark.parametrize("branch", ["plain", "zero_column", "duplicated"])
def test_design_fit_subtract_matches_jax(batch, branch):
    design = _design(batch, branch)
    delays = _delays(batch)
    want = np.asarray(JB.design_fit_subtract(jnp.asarray(delays), batch, jnp.asarray(design)))
    tb, _ = _port(batch, JB.Recipe(efac=jnp.asarray(1.0)))
    got = TB.design_fit_subtract(torch.as_tensor(delays), tb, torch.as_tensor(design))
    assert np.all(np.isfinite(got.numpy()))
    assert _rel_max(got, want) <= TOL_FIT


def test_design_fit_projects_out_every_column(batch):
    """After the WLS fit the weighted residual is orthogonal to every
    column (the padding column aside), for a leading realization axis, up
    to the ridge: 1e-10 on unit-normalized columns moves the projection by
    ~1e-10 times the design's conditioning (2.1e-10 measured here)."""
    design = _design(batch, "zero_column")
    tb, _ = _port(batch, JB.Recipe(efac=jnp.asarray(1.0)))
    res = TB.design_fit_subtract(torch.as_tensor(_delays(batch, 3)), tb, torch.as_tensor(design))
    w = (tb.mask / tb.errors_s**2).numpy()
    proj = np.einsum("pnk,rpn->rpk", design[..., :-1], res.numpy() * w)
    scale = np.sqrt(np.einsum("pnk,pnk->pk", design[..., :-1] ** 2, w[..., None]))
    rnorm = np.sqrt(np.einsum("rpn,pn->rp", res.numpy() ** 2, w))
    assert np.max(np.abs(proj) / scale / rnorm[..., None]) <= 1e-8


# -------------------------------------------------------------- GLS

@pytest.mark.parametrize("model", MODELS)
def test_gls_fit_subtract_matches_jax(batch, full_batch, model):
    b = _batch_for(model, batch, full_batch)
    recipe = _recipe(b, model)
    design, delays = _design(b, "zero_column"), _delays(b)
    want = np.asarray(JB.gls_fit_subtract(jnp.asarray(delays), b, jnp.asarray(design), recipe))
    tb, tr = _port(b, recipe)
    got = TB.gls_fit_subtract(torch.as_tensor(delays), tb, torch.as_tensor(design), tr)
    assert np.all(np.isfinite(got.numpy()))
    assert _rel_max(got, want) <= TOL_FIT


@pytest.mark.parametrize("model", MODELS)
def test_gls_fit_uncertainties_match_jax(batch, full_batch, model):
    b = _batch_for(model, batch, full_batch)
    recipe = _recipe(b, model)
    design = _design(b, "zero_column")
    want = np.asarray(JB.gls_fit_uncertainties(b, jnp.asarray(design), recipe))
    tb, tr = _port(b, recipe)
    got = TB.gls_fit_uncertainties(tb, torch.as_tensor(design), tr)
    assert got.dtype == torch.float64 and got.shape == (NPSR, K)
    assert np.all(got.numpy()[:, -1] == 0.0) and np.all(got.numpy()[:, :-1] > 0.0)
    assert _rel_max(got, want) <= TOL_FIT


def test_gls_fit_uncertainties_dtype_rule(batch):
    """The batch's dtype by default; a caller whose delays have another
    dtype passes it. The system is float64 either way."""
    recipe = _recipe(batch, "red_gwb")
    tb, tr = _port(batch, recipe)
    design = torch.as_tensor(_design(batch))
    f64 = TB.gls_fit_uncertainties(tb, design, tr)
    f32 = TB.gls_fit_uncertainties(tb, design, tr, dtype=torch.float32)
    assert f64.dtype == torch.float64 and f32.dtype == torch.float32
    torch.testing.assert_close(f32, f64.float(), rtol=0, atol=0)


def test_gls_phi_zero_row_is_white_only(batch):
    """A pulsar whose red noise is off gets exactly the weighting of a
    recipe without its red-noise columns (phi = 0 modes inert)."""
    recipe = _recipe(batch, "phi_zero")
    tb, tr = _port(batch, recipe)
    design, delays = torch.as_tensor(_design(batch)), torch.as_tensor(_delays(batch))
    got = TB.gls_fit_subtract(delays, tb, design, tr)
    no_red = dataclasses.replace(tr, rn_log10_amplitude=None, rn_gamma=None)
    want = TB.gls_fit_subtract(delays, tb, design, no_red)
    assert _rel_max(got[0], want[0]) <= TOL_FIT


# ---------------------------------------------- finalize and realize

@pytest.mark.parametrize("gls", [False, True])
def test_finalize_residuals_matches_jax(batch, gls):
    recipe = dataclasses.replace(_recipe(batch, "red_gwb"),
                                 fit_design=jnp.asarray(_design(batch, "zero_column")),
                                 fit_gls=gls)
    delays = _delays(batch)
    want = np.asarray(JB.finalize_residuals(jnp.asarray(delays), batch, recipe, True))
    tb, tr = _port(batch, recipe)
    got = TB.finalize_residuals(torch.as_tensor(delays), tb, tr, True)
    assert _rel_max(got, want) <= TOL_FIT


@pytest.mark.parametrize("gls", [False, True])
def test_realize_with_fit_design_matches_jax(batch, gls):
    """``realize(..., fit=True)`` through the JAX package's replayed draws:
    the chunk's realizations go through one fit, leading."""
    recipe = dataclasses.replace(_recipe(batch, "red_gwb"),
                                 fit_design=jnp.asarray(_design(batch, "zero_column")),
                                 fit_gls=gls)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JB.realize(key, batch, recipe, 3, fit=True))
    tb, tr = _port(batch, recipe)
    got = realize(None, tb, tr, 3, fit=True, noise=jax_realize_draws(key, batch, recipe, 3),
                  device="cpu")
    assert got.shape == want.shape
    assert _rel_max(got, want) <= TOL_REALIZE


@pytest.mark.parametrize("model", ["red_gwb", "banded", "dense"])
def test_hoisted_fit_system_equals_a_rebuild(batch, model):
    """The assembly does not depend on the delays: one built ahead gives
    the same bits as the one each call builds."""
    recipe = dataclasses.replace(_recipe(batch, model), fit_design=jnp.asarray(_design(batch)),
                                 fit_gls=True)
    tb, tr = _port(batch, recipe)
    system = TB.fit_system(tb, tr)
    for seed in (1, 2):
        g = lambda: torch.Generator().manual_seed(seed)
        hoisted = realize(g(), tb, tr, 2, fit=True, system=system, device="cpu")
        rebuilt = realize(g(), tb, tr, 2, fit=True, device="cpu")
        assert torch.equal(hoisted, rebuilt)
    with pytest.raises(TypeError, match="assembled for"):
        system.subtract(torch.zeros(tb.toas_s.shape, dtype=torch.float32))


def _projection(tb, tr, res, gls):
    """max over columns of |Mn^T W r| / |r|_W, W = C^-1 (GLS, float64) or
    the white weights (WLS), Mn the W-normalized design: the share of each
    fitted column the fit left in the residual."""
    M = tr.fit_design.double() * tb.mask[..., None]
    res = res.double()
    if gls:
        cinv = TB.gls_cinv(tb, tr)
        Wr, WM = cinv(res[..., None])[..., 0], cinv(M)
    else:
        w = tb.mask / tb.errors_s**2
        Wr, WM = res * w, M * w[..., None]
    norms = torch.sqrt(torch.einsum("pnk,pnk->pk", M, WM))
    p = torch.einsum("pnk,...pn->...pk", M, Wr) / norms
    return float((p.abs() / torch.sqrt((res * Wr).sum(-1))[..., None]).max())


@pytest.mark.parametrize("gls", [False, True])
def test_fit_system_float32_projects_out_the_design(batch, gls):
    """A float32 batch's system keeps A and the norms in float64 (and the
    GLS apply: gls_cinv); its fit leaves at most 1e-5 of each column in
    the residual (measured 6.0e-7 WLS, 5.8e-7 GLS at this shape; a float32
    GLS apply 8.5e-5), the float64 fit 1e-8 (measured 2.1e-10 WLS, 5.6e-10
    GLS: the ridge's)."""
    recipe = dataclasses.replace(_recipe(batch, "red_gwb"), fit_design=jnp.asarray(_design(batch)),
                                 fit_gls=gls)
    tb, tr = _port(batch, recipe)
    system = TB.fit_system(tb.astype(torch.float32), tr)
    assert system.lu.dtype == system.norms.dtype == torch.float64
    delays = torch.as_tensor(_delays(batch, 4))
    assert _projection(tb, tr, system.subtract(delays.float()), gls) <= 1e-5
    assert _projection(tb, tr, TB.fit_system(tb, tr).subtract(delays), gls) <= 1e-8


def test_float32_gls_apply_fails_the_projection_limit(batch):
    """The control of the projection limit: the same float32 fit with its
    C^-1 apply in float32 (``gls_cinv(dtype=float32)``, the precision the
    port rejects) leaves more than 1e-5 of a column in the residual
    (measured 8.5e-5, where the float64 apply leaves 5.8e-7)."""
    recipe = dataclasses.replace(_recipe(batch, "red_gwb"), fit_design=jnp.asarray(_design(batch)),
                                 fit_gls=True)
    tb, tr = _port(batch, recipe)
    system = TB.fit_system(tb.astype(torch.float32), tr)
    cinv32 = TB.gls_cinv(tb, tr, dtype=torch.float32)
    control = dataclasses.replace(system, cinv_mat=lambda X: cinv32(X.float()).double())
    delays = torch.as_tensor(_delays(batch, 4)).float()
    assert _projection(tb, tr, control.subtract(delays), True) > 1e-5


@pytest.mark.parametrize("built,asked", [
    ("wls", "gls"), ("gls", "wls"), ("gls", "gls_narrow"), ("wls", "wls_narrow"),
])
def test_fit_system_refuses_another_fit(batch, built, asked):
    """A system assembled for one refit is refused by a recipe that asks
    for another kind of fit or a design of another shape."""
    design = _design(batch)

    def recipe(kind):
        d = design[..., :-1] if kind.endswith("_narrow") else design
        return dataclasses.replace(_recipe(batch, "red_gwb"), fit_design=jnp.asarray(d),
                                   fit_gls=kind.startswith("gls"))

    tb, tr_built = _port(batch, recipe(built))
    _, tr_asked = _port(batch, recipe(asked))
    system = TB.fit_system(tb, tr_built)
    with pytest.raises(ValueError, match="assembled for"):
        realize(torch.Generator().manual_seed(1), tb, tr_asked, 2, fit=True, system=system,
                device="cpu")


# ------------------------------------------------ nested low rank

def test_nested_lowrank_sample_matches_jax(batch):
    """A low-rank op over a low-rank op over a banded op: the port's sample
    on the replayed key tree equals the JAX sample element by element."""
    recipe = _recipe(batch, "nested_lowrank")
    jop = recipe.noise_cov
    top = convert.covop_from_arrays(vars(jop), device="cpu")
    assert type(top.base).__name__ == "LowRankCov"
    assert list(top.draw_shapes()) == ["cov", "cov_lowrank_1", "cov_lowrank"]
    key = jax.random.PRNGKey(9)
    draws = jax_realize_draws(key, batch, recipe, 2)
    s2 = np.array([0.7, 1.0, 1.3, 2.0])
    for i, k in enumerate(jax.random.split(key, 2)):
        want = jop.sample(jax.random.fold_in(k, COV_STREAM_FOLD), s2=jnp.asarray(s2))
        got = top.sample({n: torch.as_tensor(v[i]) for n, v in draws.items() if n.startswith("cov")},
                         s2=torch.as_tensor(s2))
        assert _rel_max(got, want) <= TOL_SAMPLE


def test_realize_with_nested_lowrank_matches_jax(batch):
    recipe = _recipe(batch, "nested_lowrank")
    key = jax.random.PRNGKey(12)
    want = np.asarray(JB.realize(key, batch, recipe, 2, fit=True))
    tb, tr = _port(batch, recipe)
    got = realize(None, tb, tr, 2, fit=True, noise=jax_realize_draws(key, batch, recipe, 2),
                  device="cpu")
    assert _rel_max(got, want) <= TOL_REALIZE


# ---------------------------------------------------------- the sweep

def test_sweep_with_gls_fit_design_is_byte_identical_across_depths(batch, tmp_path):
    """A sweep whose recipe refits with GLS (the system built once per
    sweep): the checkpoint's bytes are the same at depths 1 and 2, and each
    chunk equals a realize that builds its own system."""
    recipe = dataclasses.replace(_recipe(batch, "banded"), fit_design=jnp.asarray(_design(batch)),
                                 fit_gls=True)
    tb, tr = _port(batch, recipe)
    paths = {}
    for depth in (1, 2):
        path = str(tmp_path / f"d{depth}.npz")
        out = sweep(5, tb, tr, 6, path, chunk=3, fit=True, reduce_fn=None,
                    pipeline_depth=depth, device="cpu")
        paths[depth] = (path, out)
    with open(paths[1][0], "rb") as a, open(paths[2][0], "rb") as b:
        assert a.read() == b.read()
    from pta_replicator_tpu_torch.utils.sweep import chunk_seed

    for i in range(2):
        g = torch.Generator().manual_seed(chunk_seed(5, i))
        alone = realize(g, tb, tr, 3, fit=True, device="cpu").numpy()
        assert np.array_equal(paths[1][1][3 * i:3 * i + 3], alone)
    assert os.path.getsize(paths[1][0]) > 0
