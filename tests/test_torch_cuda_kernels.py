"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when no CUDA device is present (a CUDA kernel has no CPU mode). Run on the
card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``. The
file needs no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pta_replicator_tpu_torch.kernels import launches
from pta_replicator_tpu_torch.ops import cw as tcw

pytestmark = pytest.mark.cuda

MODES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CW kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(npsr=5, ntoa=700, nsrc=150, evolve=True, seed=0):
    """Planes of a catalog with merging sources (NaN-guarded inside the
    span) and merged ones (valid = 0), and fold-relative times."""
    rng = np.random.default_rng(seed)
    phat = rng.normal(size=(npsr, 3))
    phat /= np.linalg.norm(phat, axis=1, keepdims=True)
    cat = [np.arccos(rng.uniform(-1, 1, nsrc)), rng.uniform(0, 2 * np.pi, nsrc),
           10 ** rng.uniform(8, 9.8, nsrc), rng.uniform(10, 500, nsrc),
           10 ** rng.uniform(-8.8, -7.4, nsrc), rng.uniform(0, 2 * np.pi, nsrc),
           rng.uniform(0, np.pi, nsrc), np.arccos(rng.uniform(-1, 1, nsrc))]
    src, psr = tcw.cw_catalog_planes(phat, *cat, pdist=1.3, t_fold=-7.7e7,
                                     evolve=evolve)
    src[8, :7] = 0.0  # a few sources merged before the fold
    u = np.sort(rng.uniform(0.0, 5.0e8, (npsr, ntoa)), axis=1)
    return u, src, psr


@pytest.mark.parametrize("psr_term,evolve", MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 3e-3)])
def test_kernel_matches_plain(cuda_device, dtype, tol, psr_term, evolve):
    u, src, psr = _inputs(evolve=evolve)
    args = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (u, src, psr)]
    launches.clear()
    got = tcw.cw_catalog_response(*args, psr_term=psr_term, evolve=evolve)
    torch.cuda.synchronize()
    assert launches["cw_catalog_response"] == 1
    want = tcw.cw_catalog_response_plain(*args, psr_term=psr_term, evolve=evolve)
    assert bool(torch.all(torch.isfinite(got)))
    err = torch.sqrt(torch.mean((got - want) ** 2)) / torch.sqrt(torch.mean(want**2))
    assert float(err) <= tol


def test_kernel_is_deterministic_and_checks_shapes(cuda_device):
    u, src, psr = _inputs()
    args = [torch.as_tensor(a, device=cuda_device) for a in (u, src, psr)]
    a = tcw.cw_catalog_response(*args)
    b = tcw.cw_catalog_response(*args)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not fit"):
        tcw.cw_catalog_response(args[0][:2], args[1], args[2])
