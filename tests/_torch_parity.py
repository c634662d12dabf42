"""Shared helpers of the port-vs-JAX parity tests (tests/test_torch_*.py).

The JAX package's random stream is public contract: ``realization_delays``
splits each realization key five ways (white, ecorr, red, chromatic, gwb)
and every family draws from its subkey at a documented shape; a
correlated-noise ``noise_cov`` draws from ``fold_in(key, COV_STREAM_FOLD)``
(a low-rank op first splits that key in two: base, low rank, and again at
each nested low-rank level). These
helpers replay that contract to rebuild the exact draws, which the port
then takes as explicit noise.
"""
import numpy as np


def rel_rms(got, want) -> float:
    """RMS of the difference over the RMS of the reference."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2)))


def jax_realization_draws(key, batch, recipe) -> dict:
    """One realization's draws, keyed as the port's ``noise`` dict, rebuilt
    from the JAX package's split (models/batched.py realization_delays)."""
    import jax
    import jax.numpy as jnp

    from pta_replicator_tpu.models.gwb import gwb_grid

    dtype = batch.toas_s.dtype
    k_wn, k_ec, k_rn, k_chrom, k_gwb = jax.random.split(key, 5)
    out = {}
    if recipe.efac is not None or recipe.log10_equad is not None:
        out["white"] = jax.random.normal(k_wn, batch.toas_s.shape, dtype)
    if recipe.log10_ecorr is not None:
        out["ecorr"] = jax.random.normal(k_ec, (batch.npsr, batch.max_epochs), dtype)
    if recipe.rn_log10_amplitude is not None:
        nm = recipe.rn_nmodes if recipe.rn_modes is None else len(recipe.rn_modes)
        k_eps = k_rn
        if recipe.rn_pshift:
            k_eps, k_shift = jax.random.split(k_rn)
            out["red_phase"] = jax.random.uniform(
                k_shift, (batch.npsr, nm), dtype, 0.0, 2.0 * jnp.pi
            )
        out["red"] = jax.random.normal(k_eps, (batch.npsr, 2 * nm), dtype)
    if recipe.chrom_log10_amplitude is not None:
        out["chromatic"] = jax.random.normal(
            k_chrom, (batch.npsr, 2 * recipe.chrom_nmodes), dtype
        )
    if recipe.gwb_log10_amplitude is not None or recipe.gwb_user_spectrum is not None:
        nf = gwb_grid(batch.start_s, batch.stop_s, recipe.gwb_npts,
                      recipe.gwb_howml)[2].shape[0]
        ncol = batch.npsr if recipe.orf_cholesky is None else recipe.orf_cholesky.shape[1]
        out["gwb"] = jax.random.normal(k_gwb, (2, ncol, nf), dtype)
    op = getattr(recipe, "noise_cov", None)
    if op is not None:
        from pta_replicator_tpu.covariance.structure import COV_STREAM_FOLD, LowRankCov

        k_cov = jax.random.fold_in(key, COV_STREAM_FOLD)
        depth = 0
        while isinstance(op, LowRankCov):  # split (base, low rank) at each level
            k_cov, k_lr = jax.random.split(k_cov, 2)
            name = "cov_lowrank" if depth == 0 else f"cov_lowrank_{depth}"
            out[name] = jax.random.normal(k_lr, op.phi.shape, op.U.dtype)
            op, depth = op.base, depth + 1
        out["cov"] = jax.random.normal(k_cov, batch.toas_s.shape, _op_dtype(op))
    return {name: np.asarray(v) for name, v in out.items()}


def _op_dtype(op):
    """The dtype a JAX covariance op draws its normals in: its factor's."""
    for name in ("Ld", "L", "Lt"):
        if hasattr(op, name):
            return getattr(op, name).dtype
    raise TypeError(f"unknown covariance op {type(op).__name__}")


def jax_realize_draws(key, batch, recipe, nreal: int) -> dict:
    """The draws of JAX ``realize(key, batch, recipe, nreal)``, each with a
    leading realization axis."""
    import jax

    per = [jax_realization_draws(k, batch, recipe)
           for k in jax.random.split(key, nreal)]
    return {name: np.stack([p[name] for p in per]) for name in per[0]}
