"""The port's numpy Threefry key derivation (``utils/prng.py``) against
``jax.random``, bit for bit: ``PRNGKey``, ``fold_in`` and ``key_data`` over
the seeds a spec can carry and every scenario family index, and the
compiler's family generators, whose first draws must be the JAX
package's."""
import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pta_replicator_tpu.scenarios import compile as jcompile
from pta_replicator_tpu_torch.scenarios import compile as tcompile
from pta_replicator_tpu_torch.utils import prng

#: 0, 1, the largest 31-bit seed (the fuzz sampler's range), seeds past 32
#: bits, and the largest seed the JAX key takes (int64)
SEEDS = (0, 1, 7, 12345, 2**31 - 1, 2**32 + 5, 2**63 - 1)


def _jax_words(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax_for_every_family(seed):
    key = prng.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_bits(key), _jax_words(jkey))
    for family, index in tcompile.FAMILY_IDS.items():
        got = prng.key_bits(prng.fold_in(key, index))
        want = _jax_words(jax.random.fold_in(jkey, index))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=family)


@pytest.mark.parametrize("data", (0, 1, 2**31, 2**32 - 1))
def test_fold_in_over_the_uint32_range_and_nested(data):
    key = prng.fold_in(prng.prng_key(99), data)
    jkey = jax.random.fold_in(jax.random.PRNGKey(99), data)
    np.testing.assert_array_equal(key, _jax_words(jkey))
    np.testing.assert_array_equal(prng.fold_in(key, 5),
                                  _jax_words(jax.random.fold_in(jkey, 5)))


def test_out_of_range_seed_and_data_raise():
    for bad in (-1, 2**63):
        with pytest.raises(ValueError, match="seed"):
            prng.prng_key(bad)
    for bad in (-1, 2**32):
        with pytest.raises(ValueError, match="uint32"):
            prng.fold_in(prng.prng_key(0), bad)


def test_family_ids_are_the_jax_packages():
    assert tcompile.FAMILY_IDS == jcompile.FAMILY_IDS


@pytest.mark.parametrize("seed", (0, 3, 2**31 - 1))
def test_family_rng_first_draws_equal_jax(seed):
    for family in tcompile.FAMILY_IDS:
        np.testing.assert_array_equal(
            prng.key_bits(tcompile.family_key(seed, family)),
            _jax_words(jcompile.family_key(seed, family)))
        got = tcompile.family_rng(seed, family)
        want = jcompile.family_rng(seed, family)
        np.testing.assert_array_equal(got.uniform(size=5), want.uniform(size=5))
        assert got.integers(0, 2**31 - 1) == want.integers(0, 2**31 - 1)
