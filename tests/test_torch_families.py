"""Stochastic families of the port against the JAX package at float64,
fed the JAX package's own draws (rebuilt from its public key split), plus
the host grids, the interpolation and the prior."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pta_replicator_tpu.batch import synthetic_batch as jax_synthetic_batch
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.models import gwb as jax_gwb
from pta_replicator_tpu.ops import fourier as jax_fourier
from pta_replicator_tpu.ops.orf import hellings_downs_matrix as jax_hd
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch.models import batched as TB
from pta_replicator_tpu_torch.models import gwb as tgwb
from pta_replicator_tpu_torch.ops import fourier as tfourier
from pta_replicator_tpu_torch.ops.orf import hellings_downs_matrix

NPSR, NBACKEND = 5, 2


@pytest.fixture(scope="module")
def batches():
    jb = jax_synthetic_batch(npsr=NPSR, ntoa=1024, nbackend=NBACKEND, seed=2,
                             dtype=jnp.float64)
    return jb, convert.batch_from_arrays(vars(jb), device="cpu")


def _close(port, ref, rel=1e-10):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        port.numpy(), ref, rtol=rel, atol=rel * np.max(np.abs(ref))
    )


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float64)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("tnequad", [False, True])
@pytest.mark.parametrize("table", ["scalar", "per_pulsar", "per_backend"])
def test_white_noise(batches, table, tnequad):
    jb, tb = batches
    rng = np.random.default_rng(1)
    efac, equad = {
        "scalar": (1.2, -6.5),
        "per_pulsar": (rng.uniform(0.9, 1.3, NPSR), rng.uniform(-7.5, -6, NPSR)),
        "per_backend": (rng.uniform(0.9, 1.3, (NPSR, NBACKEND)),
                        rng.uniform(-7.5, -6, (NPSR, NBACKEND))),
    }[table]
    key = jax.random.PRNGKey(11)
    ref = JB.white_noise_delays(key, jb, efac=jnp.asarray(efac),
                                log10_equad=jnp.asarray(equad), tnequad=tnequad)
    eps = _normal(key, jb.toas_s.shape)
    port = TB.white_noise_delays(None, tb, efac=efac, log10_equad=equad,
                                 tnequad=tnequad, eps=_t(eps))
    _close(port, ref)


@pytest.mark.parametrize("table", ["scalar", "per_pulsar", "per_backend"])
def test_jitter(batches, table):
    jb, tb = batches
    rng = np.random.default_rng(2)
    ecorr = {
        "scalar": np.array(-6.8),
        "per_pulsar": rng.uniform(-7.5, -6.3, NPSR),
        "per_backend": rng.uniform(-7.5, -6.3, (NPSR, NBACKEND)),
    }[table]
    key = jax.random.PRNGKey(12)
    ref = JB.jitter_delays(key, jb, jnp.asarray(ecorr))
    eps = _normal(key, (jb.npsr, jb.max_epochs))
    port = TB.jitter_delays(None, tb, ecorr, eps=_t(eps))
    _close(port, ref)


def test_backend_table_narrower_than_vocabulary_raises(batches):
    _, tb = batches
    with pytest.raises(ValueError, match="backend column"):
        TB.white_noise_delays(None, tb, efac=np.ones((NPSR, 1)),
                              eps=torch.zeros(tb.toas_s.shape, dtype=torch.float64))


RED_OPTIONS = {
    "default": {},
    "pshift": dict(pshift=True),
    "logf": dict(logf=True, fmin=2e-9, fmax=1e-7),
    "linear_fmin_fmax": dict(fmin=2e-9, fmax=1e-7),
    "modes": dict(modes=np.linspace(2e-9, 2e-8, 10)),
    "libstempo": dict(libstempo_convention=True),
    "tspan": dict(tspan_s=6e8),
}


@pytest.mark.parametrize("option", list(RED_OPTIONS))
def test_red_noise(batches, option):
    jb, tb = batches
    kw = RED_OPTIONS[option]
    rng = np.random.default_rng(3)
    amp = rng.uniform(-14.5, -13.0, NPSR)
    gamma = rng.uniform(2.0, 5.0, NPSR)
    nm = 10
    key = jax.random.PRNGKey(13)
    ref = JB.red_noise_delays(key, jb, jnp.asarray(amp), jnp.asarray(gamma),
                              nmodes=nm, **kw)
    port_kw = dict(kw)
    k_eps = key
    if kw.get("pshift"):
        k_eps, k_shift = jax.random.split(key)
        port_kw["phase_shift"] = _t(jax.random.uniform(
            k_shift, (NPSR, nm), jnp.float64, 0.0, 2.0 * jnp.pi))
    n2 = 2 * (nm if "modes" not in kw else len(kw["modes"]))
    eps = _normal(k_eps, (NPSR, n2))
    port = TB.red_noise_delays(None, tb, amp, gamma, nmodes=nm,
                               eps=_t(eps), **port_kw)
    _close(port, ref)


def test_chromatic_noise(batches):
    jb, tb = batches
    key = jax.random.PRNGKey(14)
    idx = np.array([2.0, 4.0, 2.0, 3.0, 4.0])
    ref = JB.chromatic_noise_delays(key, jb, -13.5, 3.0,
                                    chromatic_index=jnp.asarray(idx), nmodes=8)
    eps = _normal(key, (NPSR, 16))
    port = TB.chromatic_noise_delays(None, tb, -13.5, 3.0, chromatic_index=idx,
                                     nmodes=8, eps=_t(eps))
    _close(port, ref)


@pytest.mark.parametrize("variant", ["matmul", "fft", "turnover", "uncorrelated"])
def test_gwb(batches, variant):
    jb, tb = batches
    phat = np.asarray(jb.phat, np.float64)
    locs = np.stack([np.arctan2(phat[:, 1], phat[:, 0]),
                     np.arccos(np.clip(phat[:, 2], -1, 1))], axis=1)
    chol = np.linalg.cholesky(jax_hd(locs))
    if variant == "uncorrelated":
        chol = np.sqrt(2.0) * np.eye(NPSR)
    kw = dict(npts=64, howml=4)
    if variant == "fft":
        kw["synthesis"] = "fft"
    if variant == "turnover":
        kw.update(turnover=True, f0=3e-9, beta=1.5, power=2.0)
    key = jax.random.PRNGKey(15)
    ref = JB.gwb_delays(key, jb, jnp.asarray(-14.0), jnp.asarray(4.33),
                        jnp.asarray(chol), **kw)
    nf = jax_gwb.gwb_grid(jb.start_s, jb.stop_s, 64, 4)[2].shape[0]
    eps = _normal(key, (2, NPSR, nf))
    port = TB.gwb_delays(None, tb, -14.0, 4.33, chol, eps=_t(eps), **kw)
    _close(port, ref)


def test_gwb_leading_realization_axis_is_a_batch_of_single_draws(batches):
    """The realization axis written out: a (R, 2, Np, nf) draw gives the
    same R rows as R single-realization calls."""
    _, tb = batches
    chol = np.sqrt(2.0) * np.eye(NPSR)
    gen = torch.Generator().manual_seed(0)
    nf = tgwb.gwb_grid(tb.start_s, tb.stop_s, 64, 4)[2].shape[0]
    eps = torch.randn((3, 2, NPSR, nf), generator=gen, dtype=torch.float64)
    many = TB.gwb_delays(None, tb, -14.0, 4.33, chol, npts=64, howml=4, eps=eps)
    for r in range(3):
        one = TB.gwb_delays(None, tb, -14.0, 4.33, chol, npts=64, howml=4, eps=eps[r])
        torch.testing.assert_close(many[r], one, rtol=1e-12, atol=1e-20)


def test_uniform_grid_interp(batches):
    jb, tb = batches
    rng = np.random.default_rng(4)
    series = rng.normal(size=(3, NPSR, 50))
    start, stop = jb.start_s, jb.stop_s
    ref = np.stack([JB.uniform_grid_interp(jb.toas_s, start, stop, jnp.asarray(s))
                    for s in series])
    port = TB.uniform_grid_interp(tb.toas_s, torch.tensor(start, dtype=torch.float64),
                                  torch.tensor(stop, dtype=torch.float64), _t(series))
    _close(port, ref, rel=1e-13)


@pytest.mark.parametrize("npts,howml", [(64, 4), (600, 10), (100, 2.5)])
def test_gwb_grid_and_synthesis_matrices_bitwise(batches, npts, howml):
    jb, _ = batches
    for r, p in zip(jax_gwb.gwb_grid(jb.start_s, jb.stop_s, npts, howml),
                    tgwb.gwb_grid(jb.start_s, jb.stop_s, npts, howml)):
        np.testing.assert_array_equal(p, r)
    nf = tgwb.gwb_grid(jb.start_s, jb.stop_s, npts, howml)[2].shape[0]
    for r, p in zip(jax_gwb.dft_synthesis_matrices(nf, npts),
                    tgwb.dft_synthesis_matrices(nf, npts)):
        np.testing.assert_array_equal(p, r)


def test_hellings_downs_matrix_bitwise():
    rng = np.random.default_rng(5)
    locs = np.stack([rng.uniform(0, 2 * np.pi, 7), np.arccos(rng.uniform(-1, 1, 7))], 1)
    np.testing.assert_array_equal(hellings_downs_matrix(locs), jax_hd(locs))


def test_fourier_basis_and_prior(batches):
    jb, tb = batches
    freqs = jax_fourier.fourier_frequencies(np.asarray(jb.tspan_s), nmodes=30)
    F_ref = jax_fourier.fourier_basis(np.asarray(jb.toas_s), freqs)
    F = tfourier.fourier_basis(tb.toas_s, tfourier.fourier_frequencies(tb.tspan_s, 30))
    _close(F, F_ref, rel=1e-12)
    f2 = np.repeat(freqs, 2, axis=-1)
    amp, gamma = np.full(NPSR, -14.0), np.full(NPSR, 4.33)
    ref = jax_fourier.powerlaw_prior(f2, amp, gamma, np.asarray(jb.tspan_s))
    port = tfourier.powerlaw_prior(_t(f2), _t(amp), _t(gamma), tb.tspan_s)
    _close(port, ref, rel=1e-12)


def test_powerlaw_prior_float32_has_no_underflow(batches):
    """Every one of 30 modes keeps its power at float32 (the direct
    product would flush the high modes through ~1e-38 to zero)."""
    _, tb = batches
    T = tb.tspan_s.float()
    f2 = torch.repeat_interleave(tfourier.fourier_frequencies(T, 30), 2, dim=-1)
    amp = torch.full((NPSR,), -15.0)
    gamma = torch.full((NPSR,), 6.0)
    p32 = tfourier.powerlaw_prior(f2, amp, gamma, T)
    p64 = tfourier.powerlaw_prior(f2.double(), amp.double(), gamma.double(), T.double())
    assert p32.dtype == torch.float32
    assert bool(torch.all(p32 > 0))
    np.testing.assert_allclose(p32.double().numpy(), p64.numpy(), rtol=1e-4)
