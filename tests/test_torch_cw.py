"""CW catalog: the port's host planes and plain response against the JAX
package's planes, its Pallas kernel (interpret mode) and its scan twin."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import rel_rms
from pta_replicator_tpu.batch import synthetic_batch as jax_synthetic_batch
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu.ops import pallas_cw
from pta_replicator_tpu_torch.kernels import launches
from pta_replicator_tpu_torch.ops import cw as tcw

MODES = {
    "evolve": dict(evolve=True, phase_approx=False),
    "phase_approx": dict(evolve=False, phase_approx=True),
    "monochromatic": dict(evolve=False, phase_approx=False),
}
#: fold references: MERGING folds before the data, so the heavy
#: high-frequency sources chirp through merger inside the span (NaN guard);
#: MERGED folds at the absolute epoch, where they have merged already
#: (valid = 0)
TREF_MERGING = 53000 * 86400.0
TREF_MERGED = 0.0


@pytest.fixture(scope="module")
def batch():
    return jax_synthetic_batch(npsr=4, ntoa=1024, nbackend=2, seed=1,
                               dtype=jnp.float64)


@pytest.fixture(scope="module")
def catalog():
    """tests/test_batched.py's catalog ranges plus one source that merges
    (or has merged, by fold reference) and one quiet source."""
    n = 10
    rng = np.random.default_rng(6)
    cols = [
        np.arccos(rng.uniform(-1, 1, n)),
        rng.uniform(0, 2 * np.pi, n),
        10 ** rng.uniform(8, 9.8, n),
        rng.uniform(10, 500, n),
        10 ** rng.uniform(-8.8, -7.5, n),
        rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0, np.pi, n),
        np.arccos(rng.uniform(-1, 1, n)),
    ]
    extra = np.array([[1.0, 2.0], [0.5, 4.0], [5e9, 1e9], [20.0, 100.0],
                      [3e-7, 1e-8], [0.3, 2.0], [0.1, 1.1], [0.7, 2.2]])
    return [np.concatenate([c, e]) for c, e in zip(cols, extra)]


def _planes(batch, catalog, mode, tref, **kw):
    t_fold = batch.tref_mjd * 86400.0 - tref + batch.start_s
    args = (np.asarray(batch.phat, np.float64), *catalog)
    ref = pallas_cw.cw_catalog_planes(*args, t_fold=t_fold, xp=np, **MODES[mode], **kw)
    port = tcw.cw_catalog_planes(*args, t_fold=t_fold, **MODES[mode], **kw)
    return ref, port


@pytest.mark.parametrize("tref", [TREF_MERGING, TREF_MERGED])
@pytest.mark.parametrize("mode", list(MODES))
def test_planes_bitwise_equal(batch, catalog, mode, tref):
    ref, port = _planes(batch, catalog, mode, tref, pdist=1.3)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, np.asarray(r))


def test_planes_bitwise_equal_pphase_and_per_pulsar_pdist(batch, catalog):
    rng = np.random.default_rng(3)
    pdist = rng.uniform(0.5, 2.0, (batch.npsr, len(catalog[0])))
    pphase = rng.uniform(0, 2 * np.pi, len(catalog[0]))
    for kw in (dict(pdist=pdist), dict(pphase=pphase)):
        ref, port = _planes(batch, catalog, "evolve", TREF_MERGING, **kw)
        for r, p in zip(ref, port):
            np.testing.assert_array_equal(p, np.asarray(r))


@pytest.mark.parametrize("psr_term", [True, False])
@pytest.mark.parametrize("tref", [TREF_MERGING, TREF_MERGED])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_response_matches_pallas_interpret_and_scan(batch, catalog, mode,
                                                          tref, psr_term):
    (src, psr), _ = _planes(batch, catalog, mode, tref, pdist=1.3)
    evolve = MODES[mode]["evolve"]
    u = np.asarray(batch.toas_s) - batch.start_s
    interp = pallas_cw.cw_catalog_response(
        jnp.asarray(u), jnp.asarray(src), jnp.asarray(psr),
        psr_term=psr_term, evolve=evolve, interpret=True,
    )
    scan = JB._cw_scan_response(jnp.asarray(u), jnp.asarray(src),
                                jnp.asarray(psr), psr_term, evolve, 8)
    plain = tcw.cw_catalog_response_plain(
        torch.from_numpy(u), torch.from_numpy(src), torch.from_numpy(psr),
        psr_term=psr_term, evolve=evolve, chunk=5,
    ).numpy()
    assert np.all(np.isfinite(plain)) and np.any(plain != 0.0)
    assert rel_rms(plain, interp) <= 1e-12
    assert rel_rms(plain, scan) <= 1e-12


@pytest.mark.parametrize("psr_term", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_response_float32_within_cw_tolerance(batch, catalog, mode, psr_term):
    """float32 planes (cast last) and times against the float64 scan:
    within the cw family tolerance (scenarios/fuzz.py FAMILY_TOLERANCES)."""
    (src, psr), _ = _planes(batch, catalog, mode, TREF_MERGING, pdist=1.3)
    evolve = MODES[mode]["evolve"]
    u = np.asarray(batch.toas_s) - batch.start_s
    ref = JB._cw_scan_response(jnp.asarray(u), jnp.asarray(src),
                               jnp.asarray(psr), psr_term, evolve, 8)
    t32 = torch.from_numpy(np.array(batch.toas_s)).float()
    u32 = t32 - torch.tensor(batch.start_s, dtype=torch.float32)
    got = tcw.cw_catalog_response_plain(
        u32, torch.from_numpy(src).float(), torch.from_numpy(psr).float(),
        psr_term=psr_term, evolve=evolve,
    )
    assert got.dtype == torch.float32
    assert rel_rms(got.numpy(), ref) <= 3e-3


def test_dispatcher_sends_cpu_tensors_to_plain_version(batch, catalog):
    (src, psr), _ = _planes(batch, catalog, "evolve", TREF_MERGING)
    u = torch.from_numpy(np.asarray(batch.toas_s) - batch.start_s)
    src_t, psr_t = torch.from_numpy(src), torch.from_numpy(psr)
    launches.clear()
    got = tcw.cw_catalog_response(u, src_t, psr_t, chunk=7)
    want = tcw.cw_catalog_response_plain(u, src_t, psr_t, chunk=7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert launches["cw_catalog_response"] == 0
    # the kernel wrapper never runs the plain version: CPU tensors raise
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcw.cw_catalog_response_cuda(u, src_t, psr_t)
    with pytest.raises(TypeError, match="share dtype"):
        tcw.cw_catalog_response_cuda(u, src_t.float(), psr_t)


def test_ops_per_element_counts_the_four_variants():
    """The bound's operation count: the chirped pulsar-term variant (the
    flagship's) is the dearest, and dropping either feature is cheaper."""
    ops = tcw.OPS_PER_ELEMENT
    assert ops[(True, True)] == 100
    assert max(ops.values()) == ops[(True, True)]
    assert ops[(False, False)] == min(ops.values())
