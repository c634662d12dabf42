"""The port's anisotropic ORF basis (``ops/orf.py``) against the JAX
package's, on the host in float64: ``correlated_basis`` for lmax 0-3 on
random sky positions with a coincident and an antipodal pair, equal bit
for bit (the scenario compiler's Cholesky factor needs the same bits;
the JAX test's own bound against the reference is 1e-13 of the largest
entry, which equality meets), ``assemble_orf`` with coefficients, lmax 0
against the closed-form Hellings-Downs matrix, and the ``clm`` shape
error."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.ops import orf as jorf
from pta_replicator_tpu_torch.ops import orf as torf


def _locs(n, seed):
    rng = np.random.default_rng(seed)
    locs = np.stack([rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))], axis=1)
    locs[1] = locs[0]  # coincident pair: zeta = 0
    locs[3] = [locs[2, 0] + np.pi, np.pi - locs[2, 1]]  # antipodal pair: zeta = pi
    return locs


@pytest.mark.parametrize("lmax", (0, 1, 2, 3))
def test_correlated_basis_equals_jax(lmax):
    locs = _locs(7, seed=lmax)
    got = torf.correlated_basis(locs, lmax)
    want = jorf.correlated_basis(locs, lmax)
    assert got.shape == want.shape == ((lmax + 1) ** 2, 7, 7)
    assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))
    np.testing.assert_array_equal(got, want)


def test_assemble_orf_with_coefficients_equals_jax():
    locs = _locs(6, seed=9)
    clm = [np.sqrt(4 * np.pi), 0.3, -0.2, 0.1, 0.05, -0.04, 0.03, 0.02, -0.01]
    np.testing.assert_array_equal(torf.assemble_orf(locs, clm=clm, lmax=2),
                                  jorf.assemble_orf(locs, clm=clm, lmax=2))
    np.testing.assert_array_equal(torf.assemble_orf(locs), jorf.assemble_orf(locs))


def test_lmax0_basis_equals_the_closed_form_hellings_downs():
    locs = _locs(6, seed=1)[[0, 2, 4, 5]]  # distinct positions
    orf = torf.assemble_orf(locs, lmax=0)
    np.testing.assert_allclose(orf, torf.hellings_downs_matrix(locs), atol=1e-12)
    assert np.linalg.eigvalsh(orf).min() > 0


def test_clm_of_the_wrong_shape_raises_as_jax():
    locs = _locs(4, seed=2)
    with pytest.raises(ValueError) as got:
        torf.assemble_orf(locs, clm=[1.0, 2.0], lmax=1)
    with pytest.raises(ValueError) as want:
        jorf.assemble_orf(locs, clm=[1.0, 2.0], lmax=1)
    assert str(got.value) == str(want.value)
    assert "(lmax+1)^2 = 4" in str(got.value)


def test_angular_separation_equals_jax():
    locs = _locs(5, seed=3)
    for a in range(5):
        for b in range(5):
            args = (locs[a, 0], locs[b, 0], locs[a, 1], locs[b, 1])
            assert torf.angular_separation(*args) == jorf.angular_separation(*args)
