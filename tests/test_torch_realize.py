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


@pytest.mark.parametrize("field,value", [
    ("burst_hcross", np.zeros(4)),
    ("fit_design", np.zeros((4, 1024, 3))),
    ("gwb_user_spectrum", np.ones((5, 2))),
    ("burst_grid", np.zeros(4)),
    ("gwm_params", np.zeros(5)),
    ("burst_sky", np.zeros(3)),
    ("transient_grid", np.zeros(2)),
    ("fit_gls", True),
])
def test_unported_recipe_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A"):
        TB.Recipe(**{field: value})


def test_convert_carries_jax_only_knobs_and_rejects_unknown(jax_workload):
    _, jr, _ = jax_workload
    fields = dict(vars(jr), cgw_backend="pallas_interpret", gwb_gls_nmodes=12)
    tr = convert.recipe_from_arrays(fields, device="cpu")
    assert tr.cgw_chunk == jr.cgw_chunk
    with pytest.raises(TypeError):
        convert.recipe_from_arrays(dict(vars(jr), no_such_field=1), device="cpu")
