"""The whole slice: the flagship workload builder and ``realize`` of the
port against the JAX package at a small shape, through ``convert``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import jax_realize_draws
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.scenarios.compile import flagship_workload as jax_flagship
from pta_replicator_tpu_torch import convert, flagship_workload, realize
from pta_replicator_tpu_torch.models import batched as TB
from pta_replicator_tpu_torch.scenarios.compile import deterministic_families

SHAPE = dict(npsr=4, ntoa=1024, ncw=12)


@pytest.fixture(scope="module")
def jax_workload():
    return jax_flagship(**SHAPE, with_fingerprint=True)


@pytest.fixture(scope="module")
def port_workload(jax_workload):
    jb, jr, _ = jax_workload
    return (convert.batch_from_arrays(vars(jb), device="cpu"),
            convert.recipe_from_arrays(vars(jr), device="cpu"))


def test_flagship_workload_bitwise_equal(jax_workload):
    jb, jr, jfp = jax_workload
    tb, tr, fp = flagship_workload(**SHAPE, with_fingerprint=True,
                                   dtype=torch.float64, device="cpu")
    assert fp == jfp
    for f in dataclasses.fields(tb):
        got, want = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(got, torch.Tensor):
            assert got.dtype == (torch.int64 if "index" in f.name or f.name == "ntoas"
                                 else torch.float64), f.name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
        else:
            assert got == want, f.name
    for f in dataclasses.fields(tr):
        got = getattr(tr, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jr, f.name)),
                                          err_msg=f.name)


def test_flagship_fingerprint_binds_shape():
    _, _, a = flagship_workload(**SHAPE, with_fingerprint=True, device="cpu")
    _, _, b = flagship_workload(npsr=4, ntoa=1024, ncw=13, with_fingerprint=True,
                                device="cpu")
    assert a != b


@pytest.mark.parametrize("fit", [True, False])
def test_realize_matches_jax(jax_workload, port_workload, fit):
    jb, jr, _ = jax_workload
    tb, tr = port_workload
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JB.realize(key, jb, jr, nreal=8, fit=fit))
    noise = jax_realize_draws(key, jb, jr, 8)
    got = realize(None, tb, tr, 8, fit=fit, noise=noise, device="cpu").numpy()
    assert got.shape == ref.shape == (8, SHAPE["npsr"], SHAPE["ntoa"])
    rms = np.sqrt(np.mean(ref**2))
    assert np.max(np.abs(got - ref)) <= 1e-9 * rms


def test_deterministic_delays_match_jax(jax_workload, port_workload):
    jb, jr, _ = jax_workload
    tb, tr = port_workload
    ref = np.asarray(JB.deterministic_delays(jb, jr))
    got = TB.deterministic_delays(tb, tr, device="cpu").numpy()
    assert np.any(ref != 0.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.max(np.abs(ref)))


def test_realize_with_every_family_matches_jax(jax_workload):
    """Chromatic noise and red-noise phase shifts too, which the flagship
    recipe leaves off."""
    jb, jr, _ = jax_workload
    jr = dataclasses.replace(
        jr, chrom_log10_amplitude=jnp.asarray(-13.8), chrom_gamma=jnp.asarray(3.0),
        chrom_index=jnp.asarray(4.0), chrom_nmodes=6, rn_pshift=True, rn_nmodes=8,
        tnequad=True, cgw_psr_term=False,
    )
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    key = jax.random.PRNGKey(8)
    ref = np.asarray(JB.realize(key, jb, jr, nreal=3, fit=True))
    noise = jax_realize_draws(key, jb, jr, 3)
    assert set(noise) == {"white", "ecorr", "red_phase", "red", "chromatic", "gwb"}
    got = realize(None, tb, tr, 3, fit=True, noise=noise, device="cpu").numpy()
    assert np.max(np.abs(got - ref)) <= 1e-9 * np.sqrt(np.mean(ref**2))


def test_generator_draws_are_reproducible(port_workload):
    tb, tr = port_workload
    run = lambda seed: realize(torch.Generator().manual_seed(seed), tb, tr, 2,
                               fit=True, device="cpu")
    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert bool(torch.all(torch.isfinite(a)))


def test_fit_projects_out_the_weighted_mean(port_workload):
    """After the float32 quadratic fit the error-weighted mean of the
    residual rows sits at rounding level, so no separate mean subtraction
    is needed: the median of |mean| / RMS is ~4e-6 at this shape in IEEE
    float32 and ~4e-3 when the fit's products are rounded to TF32's
    10-bit mantissa; the check (also chip_smoke.py's) fails above 5e-4."""
    tb, tr = port_workload
    tb32 = tb.astype(torch.float32)
    res = realize(torch.Generator().manual_seed(3), tb32, tr, 8, fit=True,
                  device="cpu")
    w = tb32.mask / tb32.errors_s**2
    mean = (res * w).sum(-1) / w.sum(-1)
    rms = torch.sqrt((res**2).mean(-1))
    assert float((mean.abs() / rms).median()) < 5e-4


def test_noise_is_validated(port_workload):
    tb, tr = port_workload
    with pytest.raises(ValueError, match="shape"):
        realize(None, tb, tr, 2, noise={"white": np.zeros((3, 4, 1024))}, device="cpu")
    with pytest.raises(ValueError, match="does not enable"):
        realize(None, tb, tr, 2, noise={"chromatic": np.zeros((2, 4, 60))}, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        realize(None, tb, tr, 2, device="cpu")


def _field_recipe(jb, jr, field):
    """The flagship recipe with ``field`` set, and the fields it travels
    with: a whole burst for a burst field, a transient (into pulsar 2 for
    ``transient_psr``) for a transient field, a WLS or GLS design for the
    fits, and a user GWB spectrum in place of the power law."""
    fam = deterministic_families(jb, seed=5, transient_psr=2 if field == "transient_psr" else 0)
    arr = lambda names: {k: jnp.asarray(fam[k]) for k in names}
    if field.startswith("burst_"):
        return dataclasses.replace(jr, **arr(TB.BURST_FIELDS))
    if field in ("transient_waveform", "transient_grid", "transient_psr"):
        return dataclasses.replace(jr, transient_psr=fam["transient_psr"],
                                   **arr(("transient_waveform", "transient_grid")))
    if field == "gwm_params":
        return dataclasses.replace(jr, **arr(("gwm_params",)))
    if field in ("fit_design", "fit_gls"):
        # the quadratic, a white column and a padding column; a column
        # inside the 60-mode GP span has its own test below
        t = np.asarray(jb.toas_s) / np.asarray(jb.tspan_s)[:, None]
        white = np.random.default_rng(6).standard_normal(t.shape)
        design = np.stack([np.ones_like(t), t, t**2, white, np.zeros_like(t)], axis=-1)
        return dataclasses.replace(jr, fit_design=jnp.asarray(design), fit_gls=field == "fit_gls")
    assert field == "gwb_user_spectrum"
    f = np.geomspace(2e-9, 6e-8, 7)
    return dataclasses.replace(jr, gwb_log10_amplitude=None, gwb_gamma=None,
                               gwb_user_spectrum=jnp.asarray(np.stack([f, 1e-15 * (f / 1e-8) ** -0.6],
                                                                      axis=1)))


@pytest.mark.parametrize("field", [
    "burst_hcross", "fit_design", "gwb_user_spectrum", "burst_grid", "gwm_params", "burst_sky",
    "transient_grid", "fit_gls", "transient_waveform", "transient_psr",
])
def test_jax_recipe_field_carries_across(jax_workload, field):
    """A JAX recipe with the field converts, realizes on the CPU with the
    JAX package's draws and matches its output (the fields the port
    refused before it ran them)."""
    jb, jr, _ = jax_workload
    jr = _field_recipe(jb, jr, field)
    tb = convert.batch_from_arrays(vars(jb), device="cpu")
    tr = convert.recipe_from_arrays(vars(jr), device="cpu")
    want_field = getattr(jr, field)
    if isinstance(want_field, (bool, int)):
        assert getattr(tr, field) == want_field
    else:
        np.testing.assert_array_equal(getattr(tr, field).numpy(), np.asarray(want_field))
    key = jax.random.PRNGKey(13)
    ref = np.asarray(JB.realize(key, jb, jr, nreal=2, fit=True))
    got = realize(None, tb, tr, 2, fit=True, noise=jax_realize_draws(key, jb, jr, 2),
                  device="cpu").numpy()
    assert np.max(np.abs(got - ref)) <= 1e-9 * np.sqrt(np.mean(ref**2))


@pytest.mark.parametrize("columns", ["sin", "sin_cos"])
def test_gls_refit_of_a_low_sinusoid_matches_jax_within_its_own_spread(jax_workload, columns):
    """A GLS design with a sinusoid of the span's period, a direction
    inside the 60-mode GP span (as a timing model's F0/F1 and astrometric
    columns are): C^-1 all but annihilates it, so the fitted residual
    carries the conditioning of a red-noise-dominated fit. The JAX
    package's own spread on the same pre-fit delays, its jitted
    ``realize`` against an eager ``finalize_residuals`` in TOA order and
    with the TOA order reversed, is 2.1e-8 (sin) and 3.4e-8 (sin_cos) of
    the RMS; the port's ``realize`` sits 1.9e-8 and 3.0e-8 from the JAX
    one. It must stay within twice the spread and within 1e-7 of the RMS
    (1e-9 for the designs of test_jax_recipe_field_carries_across, whose
    spread is 3e-10)."""
    jb, jr, _ = jax_workload
    t = np.asarray(jb.toas_s) / np.asarray(jb.tspan_s)[:, None]
    cols = [np.ones_like(t), t, t**2, np.sin(2 * np.pi * t)]
    if columns == "sin_cos":
        cols.append(np.cos(2 * np.pi * t))
    cols += [np.random.default_rng(6).standard_normal(t.shape), np.zeros_like(t)]
    design = np.stack(cols, axis=-1)
    jr = dataclasses.replace(jr, fit_design=jnp.asarray(design), fit_gls=True)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(JB.realize(key, jb, jr, nreal=2, fit=True))
    got = realize(None, convert.batch_from_arrays(vars(jb), device="cpu"),
                  convert.recipe_from_arrays(vars(jr), device="cpu"), 2, fit=True,
                  noise=jax_realize_draws(key, jb, jr, 2), device="cpu").numpy()
    per_toa = ("toas_s", "errors_s", "mask", "epoch_index", "backend_index", "freqs_mhz")
    jb_rev = dataclasses.replace(jb, **{f: getattr(jb, f)[:, ::-1] for f in per_toa})
    jr_rev = dataclasses.replace(jr, fit_design=jnp.asarray(design[:, ::-1]))
    static = JB.deterministic_delays(jb, jr)
    eager, rev = [], []
    for k in jax.random.split(key, 2):
        raw = JB.realization_delays(k, jb, jr) + static
        eager.append(np.asarray(JB.finalize_residuals(raw, jb, jr, True)))
        rev.append(np.asarray(JB.finalize_residuals(raw[:, ::-1], jb_rev, jr_rev, True))[:, ::-1])
    rms = np.sqrt(np.mean(ref**2))
    spread = max(np.max(np.abs(np.stack(x) - ref)) for x in (eager, rev)) / rms
    gap = np.max(np.abs(got - ref)) / rms
    assert gap <= 2 * spread and gap <= 1e-7, (gap, spread)


@pytest.mark.parametrize("kwargs,match", [
    (dict(burst_sky=np.zeros(3), burst_hplus=np.zeros(8)), "a burst needs all of"),
    (dict(transient_waveform=np.zeros(8)), "travel together"),
    (dict(transient_grid=np.zeros(2)), "travel together"),
    (dict(gwm_params=np.zeros(4)), "gwm_params must have shape"),
    (dict(burst_sky=np.zeros(2), burst_hplus=np.zeros(8), burst_hcross=np.zeros(8),
          burst_grid=np.zeros(2)), "burst_sky must have shape"),
    (dict(burst_sky=np.zeros(3), burst_hplus=np.zeros(8), burst_hcross=np.zeros(8),
          burst_grid=np.zeros(3)), "burst_grid must have shape"),
    (dict(transient_waveform=np.zeros(8), transient_grid=np.zeros(1)),
     "transient_grid must have shape"),
    (dict(transient_psr=-1), "transient_psr must be an int >= 0"),
    (dict(gwb_log10_amplitude=-14.0), "needs gwb_gamma"),
    (dict(gwb_user_spectrum=np.ones((4, 3))), "gwb_user_spectrum must be"),
    (dict(fit_design=np.zeros((4, 8))), "fit_design must be"),
])
def test_recipe_validation_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        TB.Recipe(**kwargs)


def test_recipe_validation_accepts_the_ported_fields():
    """The reference's "amplitude or user spectrum" rule, GLS without a
    power law, and a whole burst."""
    spec = np.stack([np.geomspace(1e-9, 1e-7, 4), np.full(4, 1e-15)], axis=1)
    TB.Recipe(gwb_log10_amplitude=-14.0, gwb_user_spectrum=spec)
    TB.Recipe(gwb_user_spectrum=spec, fit_gls=True)
    r = TB.Recipe(burst_sky=np.zeros(3), burst_hplus=np.zeros(8), burst_hcross=np.zeros(8),
                  burst_grid=np.array([0.0, 1.0]), transient_psr=np.int64(3))
    assert r.transient_psr == 3


def test_recipe_moves_and_casts_fit_design():
    r = TB.Recipe(fit_design=np.ones((2, 5, 3)), fit_gls=True)
    assert r.fit_design.dtype == torch.float64
    assert r.astype(torch.float32).fit_design.dtype == torch.float32
    assert r.to("cpu").fit_design.device.type == "cpu"


def test_convert_carries_jax_only_knobs_and_rejects_unknown(jax_workload):
    _, jr, _ = jax_workload
    fields = dict(vars(jr), cgw_backend="pallas_interpret", gwb_gls_nmodes=12)
    tr = convert.recipe_from_arrays(fields, device="cpu")
    assert tr.cgw_chunk == jr.cgw_chunk
    with pytest.raises(TypeError):
        convert.recipe_from_arrays(dict(vars(jr), no_such_field=1), device="cpu")
