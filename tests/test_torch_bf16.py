"""The bf16 rung of the fused likelihood in the port against the JAX
package, on the CPU: the plain bf16 assembly (``ops/gp.py``) against the
JAX tiled fallback and the Pallas kernel in interpret mode, the gate that
reads a numerics capture (``likelihood/gp.py::require_precision_ready``),
captures read across the two packages, and the bf16 grid and bank
likelihoods against JAX's and against the port's own float64."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.batch import synthetic_batch
from pta_replicator_tpu.likelihood import gp as jgp
from pta_replicator_tpu.likelihood import infer as jinfer
from pta_replicator_tpu.models.batched import Recipe
from pta_replicator_tpu.obs import numerics as jnum
from pta_replicator_tpu.ops import pallas_gp
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch.likelihood import gp as tgp
from pta_replicator_tpu_torch.likelihood import infer as tinfer
from pta_replicator_tpu_torch.obs import numerics as tnum
from pta_replicator_tpu_torch.ops import gp as ops_gp

#: (shape, tile): ragged Nt (no multiple of the tile), Q + 1 no multiple
#: of 64 (1, 2 and 3 panels)
SHAPES = [((3, 700, 37), 256), ((2, 301, 70), 128), ((1, 130, 150), 64)]
#: plain bf16 vs JAX, max |error| over the largest |reference| entry of
#: each output: both sum the same exact products of bf16 operands in
#: float32, tile by tile
TOL_BF16 = 1e-5
#: the port's bf16 log L against JAX's bf16 on the same capture, relative:
#: the float32 reduced algebra factors S in another library
TOL_LL_BF16_VS_JAX = 1e-6
#: the port's bf16 against its own float64 (the reference's gate)
TOL_LL_BF16_VS_F64 = 1e-3


def _operands(shape, dtype, seed=2):
    """T, w and r with a tenth of the rows masked (w = 0, r = 0)."""
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
def test_plain_bf16_matches_jax_and_the_controls_do_not(shape, tile, dtype, reference):
    """Both triangles of T^T W T, d and rnr within TOL_BF16 of JAX; the
    mirrored lower triangle and d with its rounding swapped (bf16(r)
    against bf16(w T)) fail that tolerance."""
    ops = _operands(shape, dtype)
    jops = [jnp.asarray(a) for a in ops]
    if reference == "pallas_interpret":
        ref = pallas_gp.fused_woodbury_update(*jops, tile=tile, precision="bf16", interpret=True)
    else:
        ref = pallas_gp.fused_woodbury_xla(*jops, tile=tile, precision="bf16")
    T, w, r = (torch.from_numpy(a) for a in ops)
    got = ops_gp.fused_woodbury_plain(T, w, r, tile=tile, precision="bf16")
    for g, x in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        assert _rel_max(g.numpy(), x) <= TOL_BF16
    tnt = np.asarray(ref[0])
    mirrored = np.tril(tnt) + np.swapaxes(np.tril(tnt, -1), 1, 2)
    assert _rel_max(mirrored, tnt) > TOL_BF16
    swapped = torch.einsum("pnq,pn->pq", ops_gp._bf16(T * w[..., None]), ops_gp._bf16(r))
    assert _rel_max(swapped.numpy(), ref[1]) > TOL_BF16


def test_bf16_wrapper_runs_the_plain_version_on_cpu_and_checks_precision():
    T, w, r = (torch.from_numpy(a) for a in _operands((3, 100, 7), np.float64))
    got = ops_gp.fused_woodbury_update(T, w, r, tile=32, precision="bf16")
    want = ops_gp.fused_woodbury_plain(T, w, r, tile=32, precision="bf16")
    assert all(torch.equal(g, x) and g.dtype == torch.float32 for g, x in zip(got, want))
    with pytest.raises(ValueError, match="precision"):
        ops_gp.fused_woodbury_update(T, w, r, precision="fp8")


def test_woodbury_plan_of_the_bf16_route_covers_both_triangles():
    """The bf16 route tiles every ordered panel pair: P^2 pairs, each
    entry of the (Q + 1)-square Gram matrix in exactly one tile."""
    for q in (1, 63, 123, 286):
        panels, pairs, nsplit, workspace = ops_gp.woodbury_plan(68, 7758, q, 132, "bf16")
        assert pairs == panels * panels
        assert ops_gp.woodbury_plan(68, 7758, q, 132)[1] == panels * (panels + 1) // 2
        assert workspace == (68 * pairs * nsplit * 64**2 if nsplit > 1 else 0)
        cands = ops_gp.woodbury_split_candidates(68, 7758, q, 132, "bf16")
        assert cands[0] == 1 and nsplit in cands and cands == sorted(set(cands))
        assert max(cands) == ops_gp.woodbury_max_splits(7758) == 485


# ------------------------------------------------------------ the gate

def _recipe(batch, seed=0):
    """tests/test_gp_kernels.py's noise."""
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


GRID = {"rn_log10_amplitude": np.linspace(-14.0, -13.4, 4)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_gp_kernels.py's setup, carried across, with a capture
    of each package's armed fused f64 grid call."""
    batch = synthetic_batch(npsr=6, ntoa=180, nbackend=2, seed=3, dtype=jnp.float64)
    recipe = _recipe(batch)
    res = np.asarray(jnp.asarray(np.random.default_rng(11).standard_normal(batch.toas_s.shape)
                                 * 1e-6) * batch.mask)
    tb = convert.batch_from_arrays(vars(batch), device="cpu")
    tr = convert.recipe_from_arrays(vars(recipe), device="cpu")
    port_dir, jax_dir = (str(tmp_path_factory.mktemp(n)) for n in ("port", "jax"))
    tnum.reset()
    tnum.arm()
    try:
        tinfer.grid_loglikelihood(res, tb, tr, GRID, fused=True, device="cpu")
        tnum.write(port_dir)
    finally:
        tnum.reset()
    jnum.reset()
    jnum.arm()
    try:
        jinfer.grid_loglikelihood(jnp.asarray(res), batch, recipe, GRID, fused=True, backend="xla")
        jnum.write(jax_dir)
    finally:
        jnum.disarm()
        jnum.reset()
    return batch, recipe, res, (tb, tr), port_dir, jax_dir


def test_bf16_refused_without_verdict(setup):
    _, _, res, (tb, tr), _, _ = setup
    with pytest.raises(tgp.PrecisionNotReady):
        tinfer.grid_loglikelihood(res, tb, tr, GRID, fused=True, precision="bf16", device="cpu")
    with pytest.raises(tgp.PrecisionNotReady):
        tinfer.bank_loglikelihood(np.stack([res]), tb, tr, precision="bf16", device="cpu")
    with pytest.raises(tgp.PrecisionNotReady):
        tgp.require_precision_ready("bf16", None)
    with pytest.raises(ValueError):
        tgp.require_precision_ready("fp8")
    assert tgp.require_precision_ready(None) == "highest"
    assert tgp.require_precision_ready("highest") == "highest"


def test_bf16_refused_on_unready_capture(tmp_path, setup):
    """A capture without the fused sites, an unreadable one and one whose
    verdict fails a fused site are refused, the sites named."""
    _, _, res, (tb, tr), port_dir, _ = setup
    (tmp_path / "numerics.json").write_text(json.dumps({"schema": 0, "sites": {}}))
    with pytest.raises(tgp.PrecisionNotReady) as exc:
        tinfer.grid_loglikelihood(res, tb, tr, GRID, fused=True, precision="bf16",
                                  numerics_capture=str(tmp_path), device="cpu")
    assert "gp.fused" in str(exc.value)
    (tmp_path / "numerics.json").write_text("{torn")
    with pytest.raises(tgp.PrecisionNotReady, match="unreadable"):
        tgp.require_precision_ready("bf16", str(tmp_path))
    doc = json.loads(open(f"{port_dir}/numerics.json").read())
    doc["sites"]["gp.fused_d"]["nonfinite"] = 2
    (tmp_path / "numerics.json").write_text(json.dumps(doc))
    with pytest.raises(tgp.PrecisionNotReady, match="gp.fused_d"):
        tgp.require_precision_ready("bf16", str(tmp_path / "numerics.json"))


def test_bf16_accepted_with_armed_capture(setup):
    """The port's own armed capture clears the fused sites; bf16 then
    runs (the fused route forced) and agrees with the float64 fused result
    within TOL_LL_BF16_VS_F64, as the reference gates it."""
    _, _, res, (tb, tr), port_dir, _ = setup
    verdict = tnum.ladder_verdict(json.loads(open(f"{port_dir}/numerics.json").read()))
    for site in tgp.FUSED_PRECISION_SITES:
        assert verdict[site]["ready"], (site, verdict[site])
    assert tgp.require_precision_ready("bf16", port_dir) == "bf16"
    ll64 = tinfer.grid_loglikelihood(res, tb, tr, GRID, fused=True, device="cpu").numpy()
    ll16 = tinfer.grid_loglikelihood(res, tb, tr, GRID, precision="bf16",
                                     numerics_capture=port_dir, device="cpu")
    assert ll16.dtype == torch.float64 and bool(torch.isfinite(ll16).all())
    assert np.max(np.abs(ll16.numpy() - ll64) / np.abs(ll64)) < TOL_LL_BF16_VS_F64


def test_captures_read_the_same_in_both_packages(setup):
    """A capture written by the JAX package gives the port the same
    verdict as it gives JAX, and the port's capture gives JAX the same
    verdict as it gives the port; both clear the fused sites."""
    _, _, _, _, port_dir, jax_dir = setup
    port_doc = json.loads(open(f"{port_dir}/numerics.json").read())
    jax_doc = json.loads(open(f"{jax_dir}/numerics.json").read())
    assert tnum.ladder_verdict(jax_doc) == jnum.ladder_verdict(jax_doc)
    assert jnum.ladder_verdict(port_doc) == tnum.ladder_verdict(port_doc)
    assert set(tgp.FUSED_PRECISION_SITES) <= set(port_doc["sites"]) & set(jax_doc["sites"])
    assert jgp.require_precision_ready("bf16", port_dir) == "bf16"
    assert tgp.require_precision_ready("bf16", jax_dir) == "bf16"
    for site in tgp.FUSED_PRECISION_SITES:
        assert port_doc["sites"][site]["calls"] == jax_doc["sites"][site]["calls"]
        assert np.isclose(port_doc["sites"][site]["max_abs"], jax_doc["sites"][site]["max_abs"],
                          rtol=1e-12)


def test_armed_highest_call_gives_the_disarmed_bits(setup):
    _, _, res, (tb, tr), _, _ = setup
    bank = np.stack([res, 0.5 * res])
    want = tinfer.bank_loglikelihood(bank, tb, tr, grid=GRID, fused=True, device="cpu")
    want_direct = tinfer.grid_loglikelihood(res, tb, tr, {"efac": [1.0, 1.1]}, device="cpu")
    tnum.reset()
    tnum.arm()
    try:
        got = tinfer.bank_loglikelihood(bank, tb, tr, grid=GRID, fused=True, device="cpu")
        got_direct = tinfer.grid_loglikelihood(res, tb, tr, {"efac": [1.0, 1.1]}, device="cpu")
        sites = set(tnum.snapshot()["sites"])
    finally:
        tnum.reset()
    assert torch.equal(got, want) and torch.equal(got_direct, want_direct)
    assert {"gp.fused_tnt", "gp.fused_d", "gp.fused_rnr", "gp.reduced_chol_rank",
            "gp.chol_rank", "solver.winv", "solver.logdet_c0"} <= sites


def test_bf16_grid_and_bank_match_jax_on_the_same_capture(setup):
    """Both packages priced on one capture, the JAX package's."""
    batch, recipe, res, (tb, tr), _, jax_dir = setup
    want = np.asarray(jinfer.grid_loglikelihood(
        jnp.asarray(res), batch, recipe, GRID, precision="bf16", backend="xla",
        numerics_capture=jax_dir))
    got = tinfer.grid_loglikelihood(res, tb, tr, GRID, precision="bf16",
                                    numerics_capture=jax_dir, device="cpu").numpy()
    assert np.max(np.abs(got - want) / np.abs(want)) <= TOL_LL_BF16_VS_JAX
    bank = np.stack([res, 0.5 * res, -res])
    want = np.asarray(jinfer.bank_loglikelihood(
        jnp.asarray(bank), batch, recipe, grid=GRID, precision="bf16", backend="xla",
        numerics_capture=jax_dir))
    got = tinfer.bank_loglikelihood(bank, tb, tr, grid=GRID, precision="bf16",
                                    numerics_capture=jax_dir, device="cpu").numpy()
    assert got.shape == want.shape == (4, 3)
    assert np.max(np.abs(got - want) / np.abs(want)) <= TOL_LL_BF16_VS_JAX


def test_bf16_build_blocks_are_float32_and_match_jax(setup):
    """The bf16 build's blocks, the ECORR correction in float32 from
    input-dtype pieces, against the JAX build, with a design's timing
    columns; ``project`` (the direct float64 apply, cast to float32 as the
    reference casts it) against JAX's; the reduced log L against JAX's."""
    batch, recipe, res, (tb, tr), _, _ = setup
    t = np.asarray(batch.toas_s) / np.asarray(batch.tspan_s)[:, None]
    design = np.stack([np.ones_like(t), t, t**2, np.zeros_like(t)], -1) * np.asarray(batch.mask)[..., None]
    jred, jproj = jgp.ReducedGP.build_fused(batch, recipe, residuals=jnp.asarray(res),
                                            design=jnp.asarray(design), precision="bf16",
                                            backend="xla")
    red, proj = tgp.ReducedGP.build_fused(tb, tr, residuals=torch.from_numpy(res),
                                          design=torch.from_numpy(design), precision="bf16")
    assert red.precision == "bf16" and red.TNT.dtype == torch.float32
    assert red.logdet_c0.dtype == torch.float64 and red.ndof.dtype == torch.float64
    assert _rel_max(red.TNT, jred.TNT) <= TOL_BF16
    assert _rel_max(proj.d, jproj.d) <= TOL_BF16 and _rel_max(proj.rNr, jproj.rNr) <= TOL_BF16
    again, jagain = red.project(torch.from_numpy(res), tb), jred.project(jnp.asarray(res), batch)
    assert again.d.dtype == again.rNr.dtype == torch.float32
    assert _rel_max(again.d, jagain.d) <= TOL_BF16 and _rel_max(again.rNr, jagain.rNr) <= TOL_BF16
    phi = tgp.phi_for_recipe(tb, tr)
    got = red.loglikelihood(proj, phi, per_pulsar=True)
    want = np.asarray(jred.loglikelihood(jproj, jnp.asarray(phi.numpy()), per_pulsar=True))
    assert got.dtype == torch.float64
    assert np.max(np.abs(got.numpy() - want) / np.abs(want)) <= TOL_LL_BF16_VS_JAX
    assert not torch.equal(red.TNT, red.TNT.transpose(-1, -2))  # the reference's asymmetry


def test_bf16_forces_the_fused_route_and_refuses_a_covariance(setup):
    _, _, res, (tb, tr), port_dir, _ = setup
    a = tinfer.grid_loglikelihood(res, tb, tr, GRID, precision="bf16", numerics_capture=port_dir,
                                  device="cpu")
    b = tinfer.grid_loglikelihood(res, tb, tr, GRID, fused=True, precision="bf16",
                                  numerics_capture=port_dir, device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fused=True requires a reducible grid"):
        tinfer.grid_loglikelihood(res, tb, tr, {"efac": [1.0]}, precision="bf16",
                                  numerics_capture=port_dir, device="cpu")
    from pta_replicator_tpu_torch.covariance import banded_from_times

    cov = banded_from_times(tb.toas_s, tb.mask, rho=0.5, corr_s=30 * 86400.0, block=16,
                            dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="noise_cov"):
        tinfer.grid_loglikelihood(res, tb, dataclasses.replace(tr, noise_cov=cov), GRID,
                                  precision="bf16", numerics_capture=port_dir, device="cpu")


def test_bf16_at_full_width_loses_the_timing_block_where_jax_does():
    """At 7,758 TOAs the timing-model block A = M^T C^-1 M is a small
    remainder of T^T W T's design rows once the GP columns are projected
    out, below bf16's rounding of T^T W T: A can turn indefinite and log L
    NaN. The port's bf16 gives NaN for the same pulsars as JAX's, its
    float64 stays finite, and the finite pulsars agree."""
    from pta_replicator_tpu.scenarios.compile import flagship_workload

    jb, jr = flagship_workload(npsr=3, ntoa=7758, ncw=1)
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    res = np.random.default_rng(1).standard_normal(tuple(tb.mask.shape)) * 1e-6 * tb.mask.numpy()
    t = tb.toas_s.numpy() / tb.tspan_s.numpy()[:, None]
    design = np.stack([np.ones_like(t), t, t**2], -1)
    jred, jproj = jgp.ReducedGP.build_fused(jb, jr, residuals=jnp.asarray(res),
                                            design=jnp.asarray(design), precision="bf16",
                                            backend="xla")
    want = np.asarray(jred.loglikelihood(jproj, jgp.phi_for_recipe(jb, jr), per_pulsar=True))
    phi = tgp.phi_for_recipe(tb, tr)
    got, f64 = (red.loglikelihood(proj, phi, per_pulsar=True).numpy()
                for red, proj in (
                    tgp.ReducedGP.build_fused(tb, tr, residuals=torch.from_numpy(res),
                                              design=torch.from_numpy(design), precision=p)
                    for p in ("bf16", "highest")))
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(want).any()
    assert np.all(np.isfinite(f64))
    keep = np.isfinite(want)
    assert np.max(np.abs(got[keep] - want[keep]) / np.abs(want[keep])) <= TOL_LL_BF16_VS_JAX
