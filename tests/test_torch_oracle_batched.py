"""The port's batched engine against the port's per-pulsar oracle: the
twins of the JAX package's own joins of its two paths
(``tests/test_batched.py:267-293``, ``:439-483`` and ``:930-1008``), which
need the reference fixtures and skip where those are absent. Here they run
on ``tests/_torch_dataset.py``'s ragged 4-pulsar dataset, the batch frozen
in float64 on the CPU (so every kernel wrapper takes its plain version):
the CW catalog (rtol 1e-8, atol 1e-15), the burst with memory (rtol 1e-9),
the burst and the transient (1e-5 of the oracle's RMS), and the GLS refit
of the full timing design, nested Woodbury, banded ``noise_cov`` (the
block-tridiagonal route) and dense ``noise_cov`` with ECORR (the dense
rung), against ``covariance_from_recipe`` + ``gls_fit`` (relative RMS <
1e-6, sigmas rtol 1e-6, padding columns exactly 0). The refit runs there
without the engine's ridge, which is the oracle's linear system; with the
default ridge it sits off by the ridge's own bias on a real design
(ROADMAP C.10), which a second test bounds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pta_replicator_tpu_torch as T
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.batch import freeze
from pta_replicator_tpu_torch.covariance import banded_from_times, dense_from_times
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.timing.components import full_design_matrix
from pta_replicator_tpu_torch.timing.fit import covariance_from_recipe, design_tensor, gls_fit

from _torch_dataset import small_pulsars, write_with

F64 = torch.float64


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("oracle_batched")))


@pytest.fixture()
def frozen(dirs):
    psrs = tsim.load_from_directories(*dirs)
    for p in psrs:
        tsim.make_ideal(p)
    return freeze(psrs, dtype=F64, device="cpu"), psrs


def _catalog(n=700, seed=5):
    rng = np.random.default_rng(seed)
    return dict(
        gwtheta=np.arccos(rng.uniform(-1, 1, n)), gwphi=rng.uniform(0, 2 * np.pi, n),
        mc=10 ** rng.uniform(8, 9.5, n), dist=rng.uniform(10, 500, n),
        fgw=10 ** rng.uniform(-8.8, -7.5, n), phase0=rng.uniform(0, 2 * np.pi, n),
        psi=rng.uniform(0, np.pi, n), inc=np.arccos(rng.uniform(-1, 1, n)))


@pytest.mark.parametrize("mode", [dict(), dict(evolve=False, phase_approx=True),
                                  dict(psr_term=False)],
                         ids=("chirp", "phase_approx", "earth_term"))
def test_cw_catalog_matches_the_oracle(frozen, mode):
    b, psrs = frozen
    cat = _catalog()
    tref = 53000 * 86400
    dev = B.cgw_catalog_delays(b, *cat.values(), tref_s=tref, chunk=128, **mode).numpy()
    kw = {"psrTerm": mode.get("psr_term", True), "evolve": mode.get("evolve", True),
          "phase_approx": mode.get("phase_approx", False)}
    for i, p in enumerate(psrs):
        T.add_catalog_of_cws(p, **{f"{k}_list": v for k, v in cat.items()}, tref=tref, **kw)
        oracle = p.added_signals_time[f"{p.name}_cw_catalog"]
        n = p.toas.ntoas
        np.testing.assert_allclose(dev[i, :n], oracle, rtol=1e-8, atol=1e-15)
        assert np.all(dev[i, n:] == 0.0)


def test_gw_memory_matches_the_oracle(frozen):
    b, psrs = frozen
    args = dict(strain=5e-15, gwtheta=1.1, gwphi=2.3, bwm_pol=0.7)
    t0 = float(psrs[0].toas.get_mjds()[40])
    dev = B.gw_memory_delays(b, args["strain"], args["gwtheta"], args["gwphi"],
                             args["bwm_pol"], t0).numpy()
    for i, p in enumerate(psrs):
        T.add_gw_memory(p, t0_mjd=t0, **args)
        oracle = p.added_signals_time[f"{p.name}_gw_memory"]
        np.testing.assert_allclose(dev[i, :p.toas.ntoas], oracle, rtol=1e-9, atol=1e-19)
        assert np.any(oracle != 0.0) and np.any(oracle == 0.0)


def test_burst_and_transient_match_the_oracle(frozen):
    b, psrs = frozen
    t0 = float(b.toas_s[b.mask > 0].mean())
    width = 100 * 86400.0
    hp = lambda t: 4e-9 * np.exp(-0.5 * ((t - t0) / width) ** 2)
    hc = lambda t: 2e-9 * np.sin((t - t0) / width) * np.exp(-0.5 * ((t - t0) / width) ** 2)
    lo, hi = t0 - 8 * width, t0 + 8 * width
    grid = np.linspace(lo, hi, 16384)
    dev = B.burst_delays(b, 0.9, 4.1, hp(grid), hc(grid), lo, hi, psi=0.6).numpy()
    tref = float(b.tref_mjd) * 86400.0
    for i, p in enumerate(psrs):
        T.add_burst(p, 0.9, 4.1, hp, hc, psi=0.6, tref=tref)
        oracle = p.added_signals_time[f"{p.name}_burst"]
        rms = max(np.sqrt(np.mean(oracle**2)), 1e-30)
        np.testing.assert_allclose(dev[i, :p.toas.ntoas], oracle, atol=1e-5 * rms)

    devt = B.transient_delays(b, 1, hp(grid), lo, hi).numpy()
    assert np.all(devt[0] == 0.0)
    T.add_noise_transient(psrs[1], hp, tref=tref)
    oracle = psrs[1].added_signals_time[f"{psrs[1].name}_noise_transient"]
    np.testing.assert_allclose(devt[1, :psrs[1].toas.ntoas], oracle,
                               atol=1e-5 * np.sqrt(np.mean(oracle**2)))


def gls_recipe(b, noise_cov=None):
    """The recipe of tests/test_batched.py:959-975 (per-backend EFAC,
    EQUAD, ECORR; red and chromatic noise; the GWB auto-term), on ``b``'s
    device; ``noise_cov``: None (the nested Woodbury), ``"banded"`` (no
    ECORR: the block-tridiagonal route) or ``"dense"`` (with ECORR: the
    dense rung)."""
    nb = len(b.backend_names)
    rng = np.random.default_rng(5)
    r = B.Recipe(
        efac=rng.uniform(0.9, 1.4, (b.npsr, nb)),
        log10_equad=rng.uniform(-6.8, -6.2, (b.npsr, nb)),
        log10_ecorr=rng.uniform(-6.9, -6.4, (b.npsr, nb)),
        rn_log10_amplitude=rng.uniform(-13.8, -13.2, b.npsr),
        rn_gamma=rng.uniform(3.0, 4.5, b.npsr),
        chrom_log10_amplitude=rng.uniform(-13.9, -13.4, b.npsr),
        chrom_gamma=rng.uniform(2.5, 4.0, b.npsr),
        chrom_index=2.0,
        gwb_log10_amplitude=-14.2,
        gwb_gamma=13.0 / 3.0,
    ).to(b.device)
    if noise_cov == "banded":
        op = banded_from_times(b.toas_s, b.mask, rho=0.5, corr_s=30 * 86400.0, block=16,
                               dtype=F64, device=b.device)
        r = dataclasses.replace(r, log10_ecorr=None, noise_cov=op,
                                cov_log10_sigma=torch.tensor(-6.4, dtype=F64, device=b.device))
    elif noise_cov == "dense":
        op = dense_from_times(b.toas_s, b.mask, corr_s=20 * 86400.0, dtype=F64, device=b.device)
        r = dataclasses.replace(r, noise_cov=op,
                                cov_log10_sigma=torch.tensor(-6.6, dtype=F64, device=b.device))
    return r


def oracle_gls(psrs, b, recipe, delays):
    """Per pulsar: the dense oracle's post-fit residuals and sigmas
    (``covariance_from_recipe`` + ``gls_fit`` on the full design)."""
    out = []
    for i, psr in enumerate(psrs):
        n = psr.toas.ntoas
        C = covariance_from_recipe(psr, recipe, psr_index=i, backend_names=b.backend_names)
        M, _ = full_design_matrix(psr.par, psr.toas.get_mjds(), freqs_mhz=psr.toas.freqs_mhz,
                                  f0=psr.model.f0, flags=psr.toas.flags)
        _, post, cov = gls_fit(np.asarray(delays[i][:n], np.float64), C, M, return_cov=True)
        out.append((post, np.sqrt(np.clip(np.diag(cov), 0.0, None))))
    return out


def _gls_errors(b, psrs, noise_cov, ridge):
    """(relative RMS of the post-fit residuals, largest relative sigma
    error) per pulsar against the dense oracle, the smallest eigenvalue of
    each pulsar's column-normalized M^T C^-1 M, and the design's width."""
    recipe = gls_recipe(b, noise_cov)
    rng = np.random.default_rng(5)
    delays = torch.from_numpy(rng.standard_normal(tuple(b.toas_s.shape)) * 1e-6) * b.mask
    design = torch.from_numpy(design_tensor(psrs, ntoa_max=b.ntoa_max)[0])
    post = B.gls_fit_subtract(delays, b, design, recipe, ridge=ridge).numpy()
    sig = B.gls_fit_uncertainties(b, design, recipe, ridge=ridge).numpy()
    lam = torch.linalg.eigvalsh(B._gls_design_system(b, design, recipe, 0.0)[0]).numpy()
    out = []
    for i, (ref_post, ref_sig) in enumerate(oracle_gls(psrs, b, recipe, delays.numpy())):
        n, k = psrs[i].toas.ntoas, len(ref_sig)
        assert np.all(sig[i][k:] == 0.0)  # padding columns report exactly 0
        out.append((np.sqrt(np.mean((post[i][:n] - ref_post) ** 2) / np.mean(ref_post**2)),
                    float(np.max(np.abs(sig[i][:k] / ref_sig - 1.0))), float(lam[i].min()), k))
    assert min(o[3] for o in out) < design.shape[-1]  # some pulsar has padding columns
    return out


@pytest.mark.parametrize("noise_cov", [None, "banded", "dense"],
                         ids=("nested_woodbury", "banded", "dense"))
def test_gls_fit_subtract_matches_the_dense_oracle(frozen, noise_cov):
    """The same linear system as the oracle's: the batched refit without
    its ridge (``ridge=0``) holds the dense oracle at relative RMS < 1e-6
    and the sigmas at rtol 1e-6."""
    b, psrs = frozen
    for i, (post, sig, _lam, _k) in enumerate(_gls_errors(b, psrs, noise_cov, ridge=0.0)):
        assert post < 1e-6 and sig < 1e-6, (i, post, sig)


@pytest.mark.parametrize("noise_cov", [None, "dense"], ids=("nested_woodbury", "dense"))
def test_the_default_ridge_biases_a_real_design_as_first_order_theory_says(frozen, noise_cov):
    """ROADMAP C.10: the engine's default ridge (1e-10 on the unit-
    normalized normal equations, the JAX package's) scales the weakest
    direction of a real timing design by lambda / (lambda + ridge): on this
    dataset's binary pulsars (lambda_min ~ 5e-7) that leaves ~1e-4 of the
    post-fit RMS and of the sigmas off the dense oracle (the JAX engine
    reads the same; its own test's fixture has lambda_min >> ridge). Held
    here to 10 ridge / lambda_min, so that a growth past the ridge's own
    bias fails."""
    b, psrs = frozen
    errors = _gls_errors(b, psrs, noise_cov, ridge=B._RIDGE)
    for i, (post, sig, lam, _k) in enumerate(errors):
        assert post <= 10 * B._RIDGE / lam and sig <= 10 * B._RIDGE / lam, (i, post, sig, lam)
    assert max(post for post, *_ in errors) > 1e-6  # the bias this item records
